"""The port's data-parallel mesh (`mapper_tpu_torch.parallel.mesh`) against
the JAX package's (`mapper_tpu.parallel.mesh`, on its 8 virtual CPU devices):
scores sharded over a CPU mesh of several entries equal the unsharded
scores exactly and the JAX mesh's (int16 exactly, f32 within
`tests/test_pallas_dp.py`'s 1e-5); the engine, the device pileup and the CLI
give the same results on a mesh as on one device, and as the JAX package on
its mesh; and `graft_entry.dryrun_multichip`'s five checks (the root
`__graft_entry__.dryrun_multichip`'s) on a CPU mesh.
The port's CPU mesh has MAPPER_TPU_TORCH_CPU_DEVICES entries."""

import math
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

import mapper_tpu
from benchmarks.simlib import rc_text
from mapper_tpu import cli as jax_cli
from mapper_tpu.align import pallas_dp
from mapper_tpu.align.query import Query as JaxQuery
from mapper_tpu.batch.device_pileup import DevicePileup as JaxDevicePileup
from mapper_tpu.batch.engine import BatchAligner as JaxBatchAligner
from mapper_tpu.parallel import mesh as jax_mesh
from mapper_tpu.sequence import Sequence as JaxSequence
from mapper_tpu_torch import Api, AlignmentParameters, convert
from mapper_tpu_torch import cli as torch_cli
from mapper_tpu_torch import graft_entry
from mapper_tpu_torch.align import banded
from mapper_tpu_torch.align.query import Query
from mapper_tpu_torch.batch.device_pileup import DevicePileup
from mapper_tpu_torch.batch.engine import BatchAligner
from mapper_tpu_torch.parallel import mesh as mesh_lib
from mapper_tpu_torch.sequence import Sequence
from mapper_tpu_torch.simulate import scoring_candidates
from tests.test_torch_device_pileup import JAX, PORT, _assert_same, _emissions, _merged

CPU = torch.device("cpu")
_KEYS = ("reads", "concat", "read_id", "reversed_", "win_start", "lane", "n", "m")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in several processes at once: one intra-op thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def cpu_mesh(monkeypatch, entries: int):
    monkeypatch.setenv(mesh_lib.CPU_DEVICES_ENV, str(entries))
    mesh = mesh_lib.make_mesh()
    assert mesh == (CPU,) * entries
    return mesh


def random_text(n, seed):
    rng = np.random.default_rng(seed)
    return "".join(rng.choice(list("ACGT"), size=n))


# ---- the mesh's own pieces ----------------------------------------------


@pytest.mark.parametrize("rows,entries", [(10, 4), (3, 4), (0, 2), (8, 1)])
def test_shard_bounds_cover_rows_in_order(rows, entries):
    bounds = mesh_lib.shard_bounds((CPU,) * entries, rows)
    assert len(bounds) == entries and bounds[0][0] == 0 and bounds[-1][1] == rows
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    sizes = [hi - lo for lo, hi in bounds]
    assert max(sizes) - min(sizes) <= 1 and sizes == sorted(sizes, reverse=True)


def test_shard_batch_and_replicate():
    mesh = (CPU,) * 3
    a, b = np.arange(7), torch.arange(14).reshape(7, 2)
    sa, sb = mesh_lib.shard_batch(mesh, a, b)
    assert [s.tolist() for s in sa] == [[0, 1, 2], [3, 4], [5, 6]]
    assert torch.equal(torch.cat(sb), b)
    (copies,) = mesh_lib.replicate(mesh, a)
    assert len(copies) == 3 and all(c is copies[0] for c in copies)  # one copy per device
    with pytest.raises(ValueError, match="row counts"):
        mesh_lib.shard_batch(mesh, a, np.arange(6))


def test_make_mesh_checks_its_devices(monkeypatch):
    with pytest.raises(ValueError, match="at least one"):
        mesh_lib.make_mesh([])
    with pytest.raises(ValueError, match="all CPU or all CUDA"):
        mesh_lib.make_mesh(["cpu", "meta"])
    with pytest.raises(ValueError, match="no mesh of"):
        mesh_lib.visible_devices("meta")
    monkeypatch.setenv(mesh_lib.CPU_DEVICES_ENV, "0")
    with pytest.raises(ValueError, match=">= 1"):
        mesh_lib.visible_devices("cpu")
    monkeypatch.delenv(mesh_lib.CPU_DEVICES_ENV)
    assert mesh_lib.visible_devices("cpu") == [CPU]


def test_make_mesh_takes_no_cpu_unasked(monkeypatch):
    """Without a card, the default mesh raises unless
    MAPPER_TPU_TORCH_CPU_DEVICES asks for the CPU; "cpu" passed or the
    variable set give CPU entries; the default type is "cuda"."""
    monkeypatch.delenv(mesh_lib.CPU_DEVICES_ENV, raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    assert mesh_lib.visible_devices() == []
    with pytest.raises(ValueError, match="no CUDA device is visible"):
        mesh_lib.make_mesh()
    assert mesh_lib.make_mesh(["cpu"]) == (CPU,)
    assert mesh_lib.visible_devices("cpu") == [CPU]
    monkeypatch.setenv(mesh_lib.CPU_DEVICES_ENV, "2")
    assert mesh_lib.make_mesh() == (CPU, CPU)


def test_reduce_pileup_sums_in_mesh_order():
    rng = np.random.default_rng(4)
    counts = [torch.from_numpy(rng.integers(0, 40, size=(2, 30)).astype(np.float32) / 2) for _ in range(4)]
    total = mesh_lib.reduce_pileup((CPU,) * 4, counts)
    assert torch.equal(total, counts[0] + counts[1] + counts[2] + counts[3])
    assert not any(total is c for c in counts)  # the inputs stay as they were
    jax_total = jax_mesh.reduce_pileup(
        jax_mesh.make_mesh(jax.devices()[:4]), np.stack([c.numpy() for c in counts])
    )
    np.testing.assert_array_equal(total.numpy(), np.asarray(jax_total)[0])  # JAX keeps a [1] axis
    with pytest.raises(ValueError):
        mesh_lib.reduce_pileup((CPU,) * 3, counts)


# ---- scoring --------------------------------------------------------------


@pytest.fixture(scope="module")
def gathered_inputs():
    return scoring_candidates(np.random.default_rng(5), 50, 64, 32, ref_size=4000, num_reads=16)


PARAMS = {"i16": {}, "f32": {"mutation_penalty": math.pi}}


@pytest.fixture(scope="module")
def jax_gathered(gathered_inputs):
    """JAX's gathered scorer sharded over its 8-device mesh (Pallas
    interpret mode, as its own tests run the kernel), per path."""
    mesh = jax_mesh.make_mesh(jax.devices())
    assert mesh.size == 8
    c = gathered_inputs
    concat = jax.device_put(c["concat"], NamedSharding(mesh, PartitionSpec()))
    out = {}
    for path, kwargs in PARAMS.items():
        s, u = pallas_dp.banded_scores_gathered(
            c["reads"], concat, c["read_id"], c["reversed_"], c["win_start"], c["lane"], c["n"],
            c["m"], mapper_tpu.AlignmentParameters.defaults(**kwargs), band=32, tile=8,
            interpret=True, read_bucket=8, use_pallas=True, mesh=mesh,
        )
        out[path] = np.stack([np.asarray(s), np.asarray(u)])
    return out


@pytest.mark.parametrize("entries", [2, 3, 4])
@pytest.mark.parametrize("path", ["i16", "f32"])
def test_gathered_scores_shard_over_mesh(monkeypatch, gathered_inputs, jax_gathered, path, entries):
    """Mirrors tests/test_mesh_engine.py::test_gathered_scores_shard_over_mesh;
    3 entries split the 50 rows unevenly."""
    mesh = cpu_mesh(monkeypatch, entries)
    params = AlignmentParameters.defaults(**PARAMS[path])
    assert (banded._quantize_params(params, 64, 32) is not None) == (path == "i16")
    c = gathered_inputs
    one = banded.banded_scores_gathered(*[torch.as_tensor(c[k]) for k in _KEYS], params, 32)
    # per-entry reads/reference copies, as the engine passes them, with
    # numpy and with tensor vectors
    reads, concat = mesh_lib.replicate(mesh, c["reads"], c["concat"])
    sharded = banded.banded_scores_gathered(reads, concat, *[c[k] for k in _KEYS[2:]], params, 32, mesh=mesh)
    assert torch.equal(sharded, one)
    vectors = [torch.as_tensor(c[k]) for k in _KEYS[2:]]
    assert torch.equal(banded.banded_scores_gathered(reads, concat, *vectors, params, 32, mesh=mesh), one)
    with pytest.raises(ValueError, match="one reads and reference copy per mesh entry"):
        banded.banded_scores_gathered(c["reads"], c["concat"], *vectors, params, 32, mesh=mesh)
    if path == "i16":
        np.testing.assert_array_equal(sharded.numpy(), jax_gathered[path])
    else:
        np.testing.assert_allclose(sharded.numpy(), jax_gathered[path], rtol=0, atol=1e-5)
    assert (sharded[0] < 1e8).any()


@pytest.mark.parametrize("band", [64, 128])
def test_sharded_banded_scores_match_unsharded_and_jax(monkeypatch, band):
    """`sharded_banded_scores` on host-built rows: equal to `banded_scores`
    on the whole batch, and to the JAX package's float32 sharded step within
    1e-4 (the port's int16 units against JAX's float32 sums, the tolerance
    tests/test_pallas_dp.py holds the two paths to)."""
    from tests.test_torch_banded import pair_batch

    mesh = cpu_mesh(monkeypatch, 3)
    rng = np.random.default_rng(band)
    q, w, n, m = pair_batch(rng, 20, 96, 12, band)
    params = mapper_tpu.AlignmentParameters.defaults()
    port_params = convert.parameters_from_reference(vars(params))
    got = mesh_lib.sharded_banded_scores(mesh, port_params, band)(q, w, n, m)
    assert got.shape == (20,) and got.device == CPU
    assert torch.equal(got, banded.banded_scores(q, w, n, m, port_params, band))
    want = jax_mesh.sharded_banded_scores(jax_mesh.make_mesh(jax.devices()[:4]), params, band)(q, w, n, m)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)
    assert (got < 1e8).all()


# ---- the engine -----------------------------------------------------------


def summarize(qa):
    """Each alignment's penalty and components, a component's reference
    named (its `content_key` holds the reference object's identity)."""
    if qa is None:
        return None
    return tuple(
        tuple(
            (a.get_penalty(), tuple(
                (c.get_sequence_b().name, *c.content_key()[1:]) for c in a.get_components()
            ))
            for a in alist
        )
        for alist in qa.get_alignments()
    )


def mixed_queries(ref_text, query=Query, sequence=Sequence):
    """Mirrors tests/test_mesh_engine.py::test_engine_results_identical_on_mesh:
    single-end and paired queries with SNPs, half reverse-complemented."""
    rng = np.random.default_rng(9)
    queries = []
    for i in range(200):
        pos = int(rng.integers(0, 20000 - 400))
        frag = list(ref_text[pos : pos + 300])
        for _ in range(int(rng.integers(0, 4))):
            frag[int(rng.integers(0, 300))] = "ACGT"[int(rng.integers(0, 4))]
        frag = "".join(frag)
        if i % 2 == 0:
            text = frag[:120]
            if rng.random() < 0.5:
                text = rc_text(text)
            queries.append(query(sequence.from_text(f"s{i}", text)))
        else:
            queries.append(
                query(
                    sequence.from_text(f"p{i}/1", frag[:120]),
                    sequence.from_text(f"p{i}/2", rc_text(frag[-120:])),
                    expected_inner_distance=60,
                    spacing_deviation_per_unit_penalty=30,
                )
            )
    return queries


@pytest.fixture(scope="module")
def engine_setup():
    ref_text = random_text(20000, 3)
    index = Api.new_database({"c1": ref_text})
    jax_index = mapper_tpu.Api.new_database({"c1": ref_text})
    jax_engine = JaxBatchAligner(
        jax_index, mapper_tpu.AlignmentParameters.defaults(), mesh=jax_mesh.make_mesh(jax.devices())
    )
    jax_results = jax_engine.process_batch(mixed_queries(ref_text, JaxQuery, JaxSequence), notify=False)
    single = BatchAligner(index, AlignmentParameters.defaults(), CPU).process_batch(
        mixed_queries(ref_text), notify=False
    )
    return ref_text, index, [summarize(r) for r in single], [summarize(r) for r in jax_results]


@pytest.mark.parametrize("entries", [2, 4])
def test_engine_results_identical_on_mesh(monkeypatch, engine_setup, entries):
    """Single-end and paired queries in one batch: the per-read summaries on
    a mesh equal the one-device engine's and the JAX engine's on its mesh;
    every chunk's rows went through the mesh's scorer."""
    ref_text, index, single, jax_summaries = engine_setup
    mesh = cpu_mesh(monkeypatch, entries)
    calls = []
    inner = banded._gathered_on_mesh

    def spy(mesh_arg, *args):
        calls.append(mesh_arg)
        return inner(mesh_arg, *args)

    monkeypatch.setattr(banded, "_gathered_on_mesh", spy)
    engine = BatchAligner(index, AlignmentParameters.defaults(), mesh=mesh)
    assert engine.device == CPU and engine.mesh == mesh
    got = [summarize(r) for r in engine.process_batch(mixed_queries(ref_text), notify=False)]
    for i, (a, b, c) in enumerate(zip(got, single, jax_summaries)):
        assert a == b == c, f"query {i} diverged"
    assert calls and all(m == mesh for m in calls)
    assert sum(1 for s in got if s and any(s)) >= 180


def test_engine_uploads_the_reference_once_per_device(monkeypatch, engine_setup):
    from mapper_tpu_torch.batch import engine as torch_engine

    _, index, _, _ = engine_setup
    uploads = []
    real = torch_engine.upload_reference
    monkeypatch.setattr(torch_engine, "upload_reference", lambda c, d: uploads.append(d) or real(c, d))
    engine = BatchAligner(index, AlignmentParameters.defaults(), mesh=(CPU,) * 4)
    copies = [engine._concat_device(d) for d in engine.mesh]
    assert uploads == [CPU] and all(c is copies[0] for c in copies)


# ---- the device pileup ----------------------------------------------------


@pytest.mark.parametrize("entries", [2, 3])
def test_device_pileup_on_mesh_equals_one_device(monkeypatch, entries):
    """Rows split over the mesh, one state per entry, summed at the merge:
    the same pileups as one device, as the host accumulation and as the JAX
    package's DevicePileup on its 8-device mesh."""
    mesh = cpu_mesh(monkeypatch, entries)
    seq_db, args, host = _emissions(PORT)
    one = DevicePileup(seq_db, 0.1, CPU)
    one.add_rows(*args)
    sharded = DevicePileup(seq_db, 0.1, mesh=mesh)
    # in two chunks, the second smaller than the mesh (some entries get none)
    batch, *rows = args
    sharded.add_rows(batch, *(r[: -entries + 1] for r in rows))
    sharded.add_rows(batch, *(r[-entries + 1 :] for r in rows))
    assert sharded.num_rows_accumulated == one.num_rows_accumulated == 200
    assert len(sharded._states) == entries
    got = _merged(sharded)
    _assert_same(got, host)
    want = _merged(one)
    jax_seq_db, jax_args, _ = _emissions(JAX)
    jax_dp = JaxDevicePileup(jax_seq_db, 0.1, mesh=jax_mesh.make_mesh(jax.devices()))
    jax_dp.add_rows(*jax_args)
    jax_merged = _merged(jax_dp, JAX)
    for name, p in got.items():
        for arrays in (want, jax_merged):
            np.testing.assert_array_equal(p.middle, arrays[name].middle)
            np.testing.assert_array_equal(p.end, arrays[name].end)


def test_device_must_be_the_mesh_first_entry(engine_setup):
    """A device and a mesh name one placement: the mesh's first entry, or
    the engine and the pileup refuse them."""
    _, index, _, _ = engine_setup
    mesh = (CPU,) * 2
    assert BatchAligner(index, AlignmentParameters.defaults(), CPU, mesh=mesh).device == CPU
    seq_db = index.hashblock_database.get_sequence_database()
    assert DevicePileup(seq_db, 0.1, CPU, mesh=mesh)._devices == mesh
    cuda = torch.device("cuda", 0)
    with pytest.raises(ValueError, match="not the mesh's first entry"):
        BatchAligner(index, AlignmentParameters.defaults(), cuda, mesh=mesh)
    with pytest.raises(ValueError, match="not the mesh's first entry"):
        DevicePileup(seq_db, 0.1, cuda, mesh=mesh)


# ---- the CLI ----------------------------------------------------------------

OUTPUTS = {
    "--out-sam": "out.sam",
    "--out-vcf": "out.vcf",
    "--out-mutations": "mutations.txt",
    "--out-refs-map-count": "refs.txt",
    "--out-unaligned": "unaligned.fasta",
}


@pytest.fixture(scope="module")
def cli_inputs(tmp_path_factory):
    """Mirrors tests/test_mesh_engine.py::test_cli_devices_flag_byte_identical's
    inputs: two contigs, 300 reads with SNPs and 1-2 bp indels, half
    reverse-complemented, and 6 unalignable reads."""
    root = tmp_path_factory.mktemp("mesh_cli")
    rng = np.random.default_rng(17)
    ref_text = random_text(30000, 13)
    (root / "ref.fasta").write_text(">chr1\n" + ref_text[:18000] + "\n>chr2\n" + ref_text[18000:] + "\n")
    lines = []
    for i in range(300):
        pos = int(rng.integers(0, 30000 - 160))
        frag = list(ref_text[pos : pos + 160])
        for _ in range(int(rng.integers(0, 4))):
            frag[int(rng.integers(0, 150))] = "ACGT"[int(rng.integers(0, 4))]
        if i % 4 == 0:  # indel reads exercise the gapped finalization path
            j = int(rng.integers(15, 130))
            if rng.random() < 0.5:
                del frag[j : j + int(rng.integers(1, 3))]
            else:
                frag.insert(j, "ACGT"[int(rng.integers(0, 4))])
        text = "".join(frag[:150])
        if rng.random() < 0.5:
            text = rc_text(text)
        lines.append(f">r{i}\n{text}\n")
    lines += [f">u{i}\n{random_text(150, 100 + i)}\n" for i in range(6)]
    (root / "reads.fasta").write_text("".join(lines))
    return root


def run_cli(main, root, out_dir, extra):
    out_dir.mkdir()
    args = ["--reference", str(root / "ref.fasta"), "--queries", str(root / "reads.fasta"), *extra]
    for flag, name in OUTPUTS.items():
        args += [flag, str(out_dir / name)]
    assert main(args) == 0
    return {name: (out_dir / name).read_bytes() for name in OUTPUTS.values()}


def test_cli_devices_flag_byte_identical(monkeypatch, tmp_path, cli_inputs):
    """`--devices 4` on a 4-entry CPU mesh writes the same five outputs as
    `--devices 1` and as `python -m mapper_tpu --devices 4` on JAX's mesh."""
    monkeypatch.setenv("MAPPER_TPU_TORCH_DEVICE", "cpu")
    monkeypatch.setenv(mesh_lib.CPU_DEVICES_ENV, "4")
    sharded_calls = []
    inner = banded._gathered_on_mesh
    monkeypatch.setattr(banded, "_gathered_on_mesh", lambda *a: sharded_calls.append(a[0]) or inner(*a))
    one = run_cli(torch_cli.main, cli_inputs, tmp_path / "one", ["--devices", "1"])
    assert not sharded_calls
    four = run_cli(torch_cli.main, cli_inputs, tmp_path / "four", ["--devices", "4"])
    assert sharded_calls and all(m == (CPU,) * 4 for m in sharded_calls)
    jax_four = run_cli(jax_cli.main, cli_inputs, tmp_path / "jax", ["--devices", "4"])
    for name in OUTPUTS.values():
        assert four[name] == one[name] == jax_four[name], name
    assert four["out.sam"].count(b"\n") > 300 and four["unaligned.fasta"].count(b">u") == 6


def test_cli_devices_beyond_visible_is_a_usage_error(monkeypatch, tmp_path, cli_inputs):
    """As in the JAX CLI: exit code 1 with the count named."""
    env = {"MAPPER_TPU_TORCH_DEVICE": "cpu", mesh_lib.CPU_DEVICES_ENV: "2"}
    proc = subprocess.run(
        [sys.executable, "-m", "mapper_tpu_torch", "--reference", str(cli_inputs / "ref.fasta"),
         "--queries", str(cli_inputs / "reads.fasta"), "--out-sam", str(tmp_path / "o.sam"),
         "--devices", "3"],
        env={**os.environ, **env}, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 1
    assert "--devices 3 requested but only 2 visible" in proc.stderr


# ---- dryrun_multichip's five checks ------------------------------------


@pytest.mark.parametrize("check", ["scores", "pileup", "sharded_index", "engine", "cli"])
def test_dryrun_multichip_checks(monkeypatch, check):
    """`graft_entry.dryrun_multichip(4)`'s checks (the root
    `__graft_entry__.dryrun_multichip`'s five) on a 4-entry CPU mesh, each
    the function the dryrun calls."""
    mesh = cpu_mesh(monkeypatch, 4)
    graft_entry.CHECKS[check](mesh)
