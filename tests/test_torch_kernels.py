"""The hand-written CUDA kernels against their plain PyTorch versions, on the
card (the scorers, the probes, and the device-candidates kernels KC1 and KC2
on `tests/torch_candidate_workloads.py`'s workloads, 1,000 bp reads and a
5,000 bp read), and the device pileup on the card against the same on the CPU.
Skipped without one.  Imports neither JAX nor the JAX package, so it also
runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py
"""

import sys

import numpy as np
import pytest
import torch

from benchmarks.simlib import random_reference
from mapper_tpu_torch.align import banded, kernels
from mapper_tpu_torch import Api
from mapper_tpu_torch.align.params import AlignmentParameters
from mapper_tpu_torch.batch import device_candidates as dc
from mapper_tpu_torch.batch.candidates import ReadBatch
from mapper_tpu_torch.batch.engine import single_end_band, upload_reference
from mapper_tpu_torch.batch.device_pileup import DevicePileup
from mapper_tpu_torch.pileup import MatchDatabase
from mapper_tpu_torch.probe_i16 import probes
from mapper_tpu_torch.sequence import Sequence, SequenceDatabase, sort_and_complement
from mapper_tpu_torch.simulate import scoring_candidates
import torch_candidate_workloads as wl

pytestmark = pytest.mark.cuda

_KEYS = ("reads", "concat", "read_id", "reversed_", "win_start", "lane", "n", "m")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _tensors(cands, device):
    return [torch.as_tensor(cands[k]).to(device) for k in _KEYS]


def _with_edges(cands, lq):
    """The cases the warp kernels must take like the block ones: windows at
    both ends of the reference (one starting before it, clamped), reads
    longer than the width (n > lq, scored BIG with every diagonal summed),
    and reversed candidates."""
    cands = {k: np.array(v) for k, v in cands.items()}
    end = cands["concat"].shape[0]
    cands["win_start"][:3] = (0, -5, end - lq // 2)
    cands["n"][3:5] = lq + 7
    cands["reversed_"][5:9] = True
    return cands


def _kernel_and_plain(cands, params, band, device):
    args = _tensors(cands, device)
    got = banded.banded_scores_gathered(*args, params, band)
    plain = banded._gathered_core(*banded._normalize(*args), params, band)
    torch.cuda.synchronize()
    return got.cpu().numpy(), plain.cpu().numpy()


@pytest.mark.parametrize("band", [16, 32, 64, 128])
def test_banded_i16_equals_plain(cuda, band):
    params = AlignmentParameters.defaults()
    cands = scoring_candidates(np.random.default_rng(band), 2048, 192, band)
    assert banded._quantize_params(params, 192, band) is not None
    before = kernels.LAUNCHES["banded_i16"]
    got, plain = _kernel_and_plain(cands, params, band, cuda)
    assert kernels.LAUNCHES["banded_i16"] == before + 1
    np.testing.assert_array_equal(got, plain)
    # and the CPU plain version on the same inputs
    cpu = banded.banded_scores_gathered(*_tensors(cands, torch.device("cpu")), params, band)
    np.testing.assert_array_equal(got, cpu.numpy())
    assert (got[0] < 1e8).mean() > 0.5


@pytest.mark.parametrize(
    "band,lq,mutation,num",
    [
        (64, 256, np.pi, 512), (128, 1024, 1.0, 512),
        # the warp kernel at both its bands, candidate counts that leave the
        # last block of four partly filled
        (64, 1024, 1.0, 4 * 127 + 1), (64, 2048, 1.0, 4 * 32 + 3),
        (128, 256, np.pi, 4 * 127 + 3), (128, 2048, 1.0, 4 * 32 + 1),
        # the block kernel
        (32, 256, np.pi, 509), (32, 1024, 1.0, 511), (32, 2048, 1.0, 129),
    ],
)
def test_banded_f32_matches_plain(cuda, band, lq, mutation, num):
    """Bit for bit: --fmad=false and the reference's operation order, in the
    warp kernel (bands 64 and 128) as in the block kernel (other bands)."""
    params = AlignmentParameters.defaults(mutation_penalty=mutation)
    assert banded._quantize_params(params, lq, band) is None
    cands = _with_edges(scoring_candidates(np.random.default_rng(lq + band), num, lq, band), lq)
    before = kernels.LAUNCHES["banded_f32"]
    got, plain = _kernel_and_plain(cands, params, band, cuda)
    assert kernels.LAUNCHES["banded_f32"] == before + 1
    np.testing.assert_array_equal(got, plain)
    assert (got[0] < 1e8).mean() > 0.5


def _host_rows(cands, band, device, chunk=128):
    """The host-window rows of a candidate batch, on `device`."""
    reads, concat, read_id, reversed_, win_start, _, n, m = banded._normalize(
        *_tensors(cands, device)
    )
    q, w = banded._gather_codes(reads, concat, read_id, reversed_, win_start, n, band)
    return banded._host_rows(q, w, n, m, band, chunk)


@pytest.mark.parametrize(
    "band,lq,num",
    [(64, 192, 256), (128, 192, 256), (128, 1024, 256), (64, 1024, 257), (128, 1024, 255),
     (32, 1024, 253)],
)
def test_diag_out_matches_plain(cuda, band, lq, num):
    """banded_i16 / banded_f32 on host rows fill every diagonal's sum (the
    1,024-wide rows take f32 at default penalties), exactly.  Called
    directly, whatever route "pen" takes at band 64."""
    params = AlignmentParameters.defaults()
    cands = _with_edges(scoring_candidates(np.random.default_rng(band + lq), num, lq, band), lq)
    rows = _host_rows(cands, band, cuda)
    quant = banded._quantize_params(params, rows[0].shape[1], band)
    got_d = torch.empty((num, band), dtype=torch.float32, device=cuda)
    before = dict(kernels.LAUNCHES)
    if quant is None:
        name = "banded_f32"
        out = kernels.banded_f32(
            *banded._rows_as_candidates(*rows), banded._params_tuple(params), band, diag_out=got_d
        )
    else:
        name = "banded_i16"
        out = kernels.banded_i16(
            *banded._rows_as_candidates(*rows), quant[1], banded._inv(quant[0]), band,
            diag_out=got_d,
        )
    got_s = out[0]
    want_s, want_d = banded.banded_scores(
        *[r.cpu() for r in rows], params, band=band, return_diag_sums=True
    )
    torch.cuda.synchronize()
    assert name == ("banded_f32" if lq == 1024 else "banded_i16")
    assert kernels.LAUNCHES[name] == before[name] + 1
    np.testing.assert_array_equal(got_s.cpu().numpy(), want_s.numpy())
    np.testing.assert_array_equal(got_d.cpu().numpy(), want_d.numpy())


def _unequal_pairs(n, lq):
    """Pairs of very unequal lengths for the packed kernel, which pairs row
    i with row i + ceil(B / 2): n = 1 against n = lq both ways round, n = 0
    against lq, and n > lq (rows 3-4 of `_with_edges`) against their
    partners."""
    n = n.clone()
    hb = (n.shape[0] + 1) // 2
    n[10:20], n[10 + hb:20 + hb] = 1, lq
    n[20:30], n[20 + hb:30 + hb] = lq, 1
    n[30], n[30 + hb] = 0, lq
    n[3:5] = lq + 7
    return n


def _packed_and_k1(rows, params):
    """banded_i16_packed and banded_i16 on the same host rows at band 64, and
    the plain version's (scores, diagonal sums)."""
    q, w, n, m = rows
    scale, ints = banded._quantize_params(params, q.shape[1], 64)
    before = dict(kernels.LAUNCHES)
    got = kernels.banded_i16_packed(q, w, n, m, ints, banded._inv(scale))
    assert kernels.LAUNCHES["banded_i16_packed"] == before["banded_i16_packed"] + 1
    diag = torch.empty((q.shape[0], 64), dtype=torch.float32, device=q.device)
    k1 = kernels.banded_i16(*banded._rows_as_candidates(*rows), ints, banded._inv(scale), 64, diag_out=diag)
    plain = banded.banded_scores(*[r.cpu() for r in rows], params, band=64, return_diag_sums=True)
    torch.cuda.synchronize()
    return got, (k1[0], diag), plain


@pytest.mark.parametrize("num", [2047, 2048])
def test_banded_i16_packed_equals_plain(cuda, num):
    """The packed kernel equals the plain version and banded_i16 on the same
    host rows, scores and diagonal sums, with B odd (a pad row in the last
    pair) and even, pairs of very unequal n, n > LQ and windows at the
    reference's ends; and variant "pen" at band 64 takes the packed kernel."""
    params = AlignmentParameters.defaults()
    cands = _with_edges(scoring_candidates(np.random.default_rng(num), num, 192, 64), 192)
    q, w, n, m = _host_rows(cands, 64, cuda)
    rows = (q, w, _unequal_pairs(n, q.shape[1]), m)
    got, k1, plain = _packed_and_k1(rows, params)
    for g, u, p in zip(got, k1, plain):
        assert torch.equal(g.cpu(), p) and torch.equal(g, u)
    assert (got[0] < 1e8).float().mean() > 0.5
    before = dict(kernels.LAUNCHES)
    routed = banded.banded_scores(*rows, params, band=64, return_diag_sums=True)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["banded_i16_packed"] == before["banded_i16_packed"] + 1
    assert kernels.LAUNCHES["banded_i16"] == before["banded_i16"]
    assert all(torch.equal(r, g) for r, g in zip(routed, got))


@pytest.mark.parametrize("variant,name", [("roll", "banded_roll_f32"), ("chunk", "banded_chunk_f32")])
@pytest.mark.parametrize("band", [32, 64, 128])
@pytest.mark.parametrize("lq,chunk,num", [(1024, 128, 512), (200, 64, 512), (1024, 128, 509)])
def test_roll_and_chunk_match_plain(cuda, variant, name, band, lq, chunk, num):
    """Exactly, against `banded._pen_core`: both run their warp kernel at
    bands 64 and 128 ("roll" K4's with one chunk the width of the row) and
    their block kernel at band 32."""
    params = AlignmentParameters.defaults()
    cands = scoring_candidates(np.random.default_rng(lq + band), num, lq, band)
    rows = _host_rows(cands, band, cuda, chunk)
    before = kernels.LAUNCHES[name]
    got = banded.banded_scores(*rows, params, band=band, chunk=chunk, variant=variant)
    assert kernels.LAUNCHES[name] == before + 1
    plain = banded.banded_scores(*[r.cpu() for r in rows], params, band=band, chunk=chunk, variant=variant)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got.cpu().numpy(), plain.numpy())
    assert (got < 1e8).float().mean() > 0.5


@pytest.mark.parametrize("band", [32, 64, 128])
@pytest.mark.parametrize("chunk", [64, 1, 256])
def test_chunk_kernel_takes_a_ragged_last_chunk(cuda, band, chunk):
    """Width 200 in chunks of 64 (the last cut short), of 1, and of 256 (one
    chunk wider than the rows): equal to the roll kernel and to the plain
    version."""
    params6 = banded._params_tuple(AlignmentParameters.defaults())
    cands = scoring_candidates(np.random.default_rng(200 + band), 4 * 127 + 3, 200, band)
    q, w, n, m = _host_rows(cands, band, cuda, chunk=8)
    assert q.shape[1] == 200
    got = kernels.banded_chunk_f32(q, w, n, m, params6, band, chunk)
    want = kernels.banded_roll_f32(q, w, n, m, params6, band)
    plain = banded._pen_core(q.to(torch.int32), w.to(torch.int32), n, m, params6, band)[0]
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(got, plain)


@pytest.mark.parametrize("band", [64, 128])
def test_chunk_roll_and_pen_f32_agree(cuda, band):
    """K4, K5 and "pen" f32 (K2's warp kernel on the rows) give the plain
    version's scores bit for bit on the same rows."""
    params = AlignmentParameters.defaults()
    cands = scoring_candidates(np.random.default_rng(band), 4 * 64 + 1, 1024, band)
    rows = _host_rows(cands, band, cuda)
    assert banded._quantize_params(params, rows[0].shape[1], band) is None
    before = dict(kernels.LAUNCHES)
    scores = {
        variant: banded.banded_scores(*rows, params, band=band, variant=variant)
        for variant in ("chunk", "roll", "pen")
    }
    torch.cuda.synchronize()
    for name in ("banded_chunk_f32", "banded_roll_f32", "banded_f32"):
        assert kernels.LAUNCHES[name] == before[name] + 1
    plain = banded.banded_scores(*[r.cpu() for r in rows], params, band=band, variant="roll")
    for variant in ("chunk", "roll", "pen"):
        assert torch.equal(scores[variant].cpu(), plain), variant
    assert (scores["pen"] < 1e8).float().mean() > 0.5


# penalties of whole units (scale 1), so the int16 path takes wide rows
_UNIT_PARAMS = dict(mutation_penalty=3.0, indel_start_penalty=2.0, indel_extension_penalty=1.0,
                    ambiguity_penalty=3.0, additional_insertion_extension_penalty=1.0)


@pytest.mark.parametrize("name,band,lq", [
    ("banded_roll_f32", 64, 6144), ("banded_roll_f32", 128, 6144), ("banded_i16_packed", 64, 3200),
])
def test_rows_above_48_kb_of_shared_memory(cuda, name, band, lq):
    """A width whose warp layout needs more than the 48 KB a block takes
    without opting in: the launch opts in, and the scores (and K3's
    diagonal sums) equal the plain version's."""
    assert kernels.smem_bytes(name, lq, band) > 48 * 1024
    rng = np.random.default_rng(lq + band)
    cands = _with_edges(scoring_candidates(rng, 4 * 16 + 3, lq, band, num_reads=64), lq)
    q, w, n, m = _host_rows(cands, band, cuda)
    assert q.shape[1] == lq
    if name == "banded_roll_f32":
        params = AlignmentParameters.defaults()
        got = kernels.banded_roll_f32(q, w, n, m, banded._params_tuple(params), band)
        plain = banded.banded_scores(q.cpu(), w.cpu(), n.cpu(), m.cpu(), params, band=band, variant="roll")
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), plain)
        assert (got < 1e8).float().mean() > 0.5
        return
    params = AlignmentParameters.defaults(**_UNIT_PARAMS)
    assert banded._quantize_params(params, lq, 64)[0] == 1
    got, k1, plain = _packed_and_k1((q, w, _unequal_pairs(n, lq), m), params)
    for g, u, p in zip(got, k1, plain):
        assert torch.equal(g.cpu(), p) and torch.equal(g, u)
    assert (got[0] < 1e8).float().mean() > 0.5


def test_host_row_wrappers_skip_an_empty_batch(cuda):
    q = torch.zeros((0, 128), dtype=torch.uint8, device=cuda)
    w = torch.zeros((0, 256), dtype=torch.uint8, device=cuda)
    n = torch.zeros(0, dtype=torch.int32, device=cuda)
    before = dict(kernels.LAUNCHES)
    params6 = banded._params_tuple(AlignmentParameters.defaults())
    assert kernels.banded_roll_f32(q, w, n, n, params6, 128).shape == (0,)
    assert kernels.banded_chunk_f32(q, w, n, n, params6, 128, 128).shape == (0,)
    scores, diag = kernels.banded_i16_packed(q, w, n, n, (30, 1, 63, 18, 60, 15), 1 / 30)
    assert scores.shape == (0,) and diag.shape == (0, 64)
    params = AlignmentParameters.defaults()
    for band in (64, 128):
        scores, diag = banded.banded_scores(q, w, n, n, params, band=band, return_diag_sums=True)
        assert scores.shape == (0,) and diag.shape == (0, band)
    assert kernels.LAUNCHES == before


def test_wrapper_rejects_bad_inputs(cuda):
    cands = scoring_candidates(np.random.default_rng(3), 64, 64, 32)
    args = banded._normalize(*_tensors(cands, cuda))
    bad = list(args)
    bad[4] = bad[4].to(torch.int32)  # win_start must be int64
    with pytest.raises(ValueError):
        kernels.banded_f32(*bad, banded._params_tuple(AlignmentParameters.defaults()), 32)
    with pytest.raises(ValueError):
        kernels.banded_f32(*[a.cpu() for a in args], (1.0,) * 6, 32)


@pytest.mark.parametrize(
    "stage,body", [(stage, body) for stage, bodies in probes.STAGES.items() for body in bodies]
)
def test_probe_body_equals_plain(cuda, stage, body):
    """Each probe body's kernel equals its plain version exactly: on the
    probes' own input, over the whole int16 range (adds wrap), and on
    blocks of the other widths the kernel takes."""
    rng = np.random.default_rng(sum(map(ord, stage + body)))
    blocks = [
        probes.probe_input(cuda),
        torch.from_numpy(rng.integers(-2**15, 2**15, (probes.T, probes.B)).astype(np.int16)).to(cuda),
        torch.from_numpy(rng.integers(-2**15, 2**15, (7, 256)).astype(np.int16)).to(cuda),
        torch.from_numpy(rng.integers(-2**15, 2**15, (9, 64)).astype(np.int16)).to(cuda),
    ]
    for x in blocks:
        before = kernels.LAUNCHES[f"probe_i16_{stage}"]
        got = probes.run(stage, body, x)
        assert kernels.LAUNCHES[f"probe_i16_{stage}"] == before + 1
        want = probes.plain(stage, body, x)
        torch.cuda.synchronize()
        assert got.dtype == torch.int16 and got.shape == want.shape
        assert torch.equal(got, want)
        assert torch.equal(got.cpu(), probes.plain(stage, body, x.cpu()))


def test_probe_kernel_refuses_other_lane_counts(cuda):
    x = torch.zeros((7, 200), dtype=torch.int16, device=cuda)
    before = dict(kernels.LAUNCHES)
    with pytest.raises(ValueError, match="lanes"):
        probes.run("e", "sub", x)
    assert kernels.LAUNCHES == before


def test_device_pileup_on_the_card_equals_the_cpu(cuda):
    rng = np.random.default_rng(11)
    contigs = sort_and_complement(
        [Sequence.from_text("c1", random_reference(rng, 5000)),
         Sequence.from_text("c2", random_reference(rng, 3000))]
    )
    seq_db = SequenceDatabase(contigs)
    reads, rid, rev, gstart, n = [], [], [], [], []
    for i in range(4000):  # many rows per position: the atomic adds collide
        k = int(rng.integers(0, 2)) * 2  # forward contigs sit at even indices here
        assert contigs[k].complemented_from is None
        length = int(rng.integers(60, 150))
        off = int(rng.integers(0, len(contigs[k]) - length))
        reads.append(Sequence.from_text(f"r{i}", contigs[k].get_range(off, length)))
        rid.append(i)
        rev.append(bool(rng.random() < 0.5))
        gstart.append(int(seq_db.starts[k]) + off)
        n.append(length)
    args = (ReadBatch.from_sequences(reads), np.array(rid), np.array(rev), np.array(gstart),
            np.array(n), np.ones(len(rid), dtype=np.float32))
    merged = []
    for device in (cuda, torch.device("cpu")):
        pileup = DevicePileup(seq_db, 0.1, device)
        pileup.add_rows(*args)
        db = MatchDatabase(0.1)
        pileup.merge_into(db)
        merged.append({s.name: p for s, p in db.group_by_position().items()})
    assert set(merged[0]) == set(merged[1]) == {"c1", "c2"}
    for name, p in merged[0].items():
        np.testing.assert_array_equal(p.middle, merged[1][name].middle)
        np.testing.assert_array_equal(p.end, merged[1][name].end)


def _recording_guard(entered):
    """A `torch.cuda.device` that also records the device of every guard the
    kernel wrappers enter (a subclass: torch checks its type)."""

    class RecordingGuard(torch.cuda.device):
        def __init__(self, device):
            if sys._getframe(1).f_globals["__name__"] == kernels.__name__:
                entered.append(torch.device(device))
            super().__init__(device)

    return RecordingGuard


def _launch_every_scorer(device):
    """One launch of each of the five scorers and of the probe kernel, with
    its tensors on `device`; returns each output beside its plain version."""
    params = AlignmentParameters.defaults()
    quant = banded._quantize_params(params, 64, 64)
    params6 = banded._params_tuple(params)
    cands = scoring_candidates(np.random.default_rng(8), 40, 64, 64)
    args = banded._normalize(*_tensors(cands, device))
    cpu_args = [a.cpu() for a in args]
    q, w = banded._gather_codes(*args[:5], args[6], 64)
    q, w = q.to(torch.uint8).contiguous(), w.to(torch.uint8).contiguous()
    n, m = args[6], args[7]
    x = probes.probe_input(device)
    return [
        (kernels.banded_i16(*args, quant[1], banded._inv(quant[0]), 64),
         banded._gathered_core(*cpu_args, params, 64)),
        (kernels.banded_f32(*args, params6, 64), None),
        (kernels.banded_i16_packed(q, w, n, m, quant[1], banded._inv(quant[0]))[0], None),
        (kernels.banded_roll_f32(q, w, n, m, params6, 64), None),
        (kernels.banded_chunk_f32(q, w, n, m, params6, 64, 32), None),
        (probes.run("e", "sub", x), probes.plain("e", "sub", x.cpu())),
    ]


def test_every_launch_enters_its_tensors_device_guard(cuda, monkeypatch):
    """Each wrapper makes its tensors' device current while it launches (the
    launcher opts in to shared memory and launches on the current device).
    One card can only show that the guard is entered with the tensors'
    device; with a second card the launches on cuda:1, made while cuda:0 is
    current, also equal their plain versions."""
    entered = []
    monkeypatch.setattr(torch.cuda, "device", _recording_guard(entered))
    _launch_every_scorer(torch.device("cuda", 0))
    assert entered == [torch.device("cuda", 0)] * 6
    torch.cuda.synchronize()
    if torch.cuda.device_count() > 1:
        entered.clear()
        other = torch.device("cuda", 1)
        with torch.cuda.device(0):
            outputs = _launch_every_scorer(other)
        torch.cuda.synchronize(other)
        assert entered == [other] * 6
        for got, plain in outputs:
            assert got.device == other
            if plain is not None:
                assert torch.equal(got.cpu(), plain)


def test_two_shards_on_one_card_equal_one_device(cuda):
    """A mesh of two entries of one card: the gathered scorer launches
    banded_i16 once a shard, each on its own stream, and equals the
    one-device call; `sharded_banded_scores` equals `banded_scores`."""
    from mapper_tpu_torch.parallel import mesh as mesh_lib

    mesh = mesh_lib.make_mesh([cuda, cuda])
    assert mesh == (torch.device("cuda", 0),) * 2
    params = AlignmentParameters.defaults()
    cands = scoring_candidates(np.random.default_rng(12), 1001, 192, 64)
    one = banded.banded_scores_gathered(*_tensors(cands, cuda), params, 64)
    before = kernels.LAUNCHES["banded_i16"]
    reads, concat = mesh_lib.replicate(mesh, cands["reads"], cands["concat"])
    sharded = banded.banded_scores_gathered(reads, concat, *[cands[k] for k in _KEYS[2:]], params, 64, mesh=mesh)
    assert kernels.LAUNCHES["banded_i16"] == before + 2
    assert sharded.device == mesh[0] and torch.equal(sharded, one)
    rng = np.random.default_rng(13)
    q = torch.from_numpy(rng.integers(1, 5, size=(301, 150)).astype(np.uint8)).to(cuda)
    w = torch.from_numpy(rng.integers(1, 5, size=(301, 150 + 64)).astype(np.uint8)).to(cuda)
    n = torch.full((301,), 150, dtype=torch.int32, device=cuda)
    m = torch.full((301,), 150 + 64, dtype=torch.int32, device=cuda)
    got = mesh_lib.sharded_banded_scores(mesh, params, 64)(q, w, n, m)
    assert torch.equal(got, banded.banded_scores(q, w, n, m, params, 64))


def test_mesh_pileup_and_sharded_index_on_one_card(cuda):
    """`DevicePileup(mesh=...)` and `ShardedIndex` over two entries of one
    card equal their CPU counterparts."""
    from mapper_tpu_torch import Api
    from mapper_tpu_torch.batch.candidates import collect_batch_seeds
    from mapper_tpu_torch.parallel.sharded_index import ShardedIndex

    mesh = (cuda, cuda)
    rng = np.random.default_rng(14)
    ref = random_reference(rng, 20_000)
    contigs = sort_and_complement([Sequence.from_text("c1", ref)])
    seq_db = SequenceDatabase(contigs)
    reads = [Sequence.from_text(f"r{i}", ref[p : p + 150])
             for i, p in enumerate(rng.integers(0, 20_000 - 150, size=500))]
    offsets = [ref.find(r.get_text()) for r in reads]
    args = (ReadBatch.from_sequences(reads), np.arange(500), rng.random(500) < 0.5,
            np.array(offsets) + int(seq_db.starts[0]), np.full(500, 150), np.ones(500, np.float32))
    merged = []
    for pileup in (DevicePileup(seq_db, 0.1, mesh=mesh), DevicePileup(seq_db, 0.1, torch.device("cpu"))):
        pileup.add_rows(*args)
        db = MatchDatabase(0.1)
        pileup.merge_into(db)
        merged.append({s.name: p for s, p in db.group_by_position().items()})
    for name, p in merged[0].items():
        np.testing.assert_array_equal(p.middle, merged[1][name].middle)
        np.testing.assert_array_equal(p.end, merged[1][name].end)
    db = Api.new_database({"c1": ref}).hashblock_database
    _, _, _, num_bp, key, _ = collect_batch_seeds(ReadBatch.from_sequences(reads[:64]), db)
    got = ShardedIndex(db, mesh).lookup(num_bp, key)
    want = ShardedIndex(db, (torch.device("cpu"),) * 2).lookup(num_bp, key)
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g, w_)


# ---- the device-candidates kernels (csrc/candidates.cu) --------------------


def _long_reads(length, count, seed):
    rng = np.random.default_rng(seed)
    ref = wl.random_text(rng, 60_000)
    return {"chr1": ref}, wl.random_reads(rng, ref, count, length=length) + wl.random_reads(rng, ref, 2)


CARD_WORKLOADS = {
    **{name: lambda name=name: wl.build(name) for name in wl.WORKLOADS},
    "reads_1000bp": lambda: _long_reads(1000, 8, 21),
    # its row takes the scratch buffer
    "read_5000bp": lambda: _long_reads(5000, 1, 22),
}


def _fused_inputs(contigs, reads, device):
    """fused_inputs on `device`, with the engine's band and half-windows."""
    db = Api.new_database(contigs).hashblock_database
    batch = ReadBatch.from_sequences([Sequence.from_text(n, t) for n, t in reads])
    params = AlignmentParameters.defaults()
    band, shift = single_end_band(batch.lengths, params)
    concat = upload_reference(db.get_sequence_database().concatenated_codes(), device)
    return dc.fused_inputs(batch, db, concat, shift, band), params, band


@pytest.mark.parametrize("name", sorted(CARD_WORKLOADS))
def test_candidates_kernels_equal_plain(cuda, name):
    """KC1's table equals candidates_plain's on the card and on the CPU, and
    KC2's rows equal fused_rows_plain's on the same table (torch.equal, the
    same dtypes); one launch each.  The fused program on the card equals its
    CPU run word for word."""
    contigs, reads = CARD_WORKLOADS[name]()
    inputs, params, band = _fused_inputs(contigs, reads, cuda)
    cpu_inputs, _, _ = _fused_inputs(contigs, reads, torch.device("cpu"))
    width = inputs["codes"].shape[1]
    assert kernels.candidates_in_scratch(width) == (name == "read_5000bp")
    before = dict(kernels.LAUNCHES)
    table = dc.candidates_program(inputs)
    rows = dc.fused_rows(table.clone(), inputs, band)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["candidates"] == before["candidates"] + 1
    assert kernels.LAUNCHES["fused_rows"] == before["fused_rows"] + 1
    assert torch.equal(table, dc.candidates_plain(inputs))
    assert torch.equal(table.cpu(), dc.candidates_plain(cpu_inputs))
    for got, want in zip(rows, dc.fused_rows_plain(table, inputs, band)):
        assert got.dtype == want.dtype and torch.equal(got, want)
    got = dc.fused_program(inputs, params, band)
    assert torch.equal(got.cpu(), dc.fused_program(cpu_inputs, params, band))



@pytest.mark.parametrize("k_out", [3, 40])
def test_candidates_kernels_at_other_rank_counts(cuda, k_out):
    """KC1's table and KC2's rows equal their plain versions at other rank
    counts than the engine's 8: KC2 stages a tile's table rows in shared
    memory up to 32 ranks and reads them where they lie past that."""
    contigs, reads = wl.build("score_budget")
    inputs, _, band = _fused_inputs(contigs, reads, cuda)
    table = dc.candidates_program(inputs, k_out)
    rows = dc.fused_rows(table.clone(), inputs, band, k_out)
    torch.cuda.synchronize()
    assert torch.equal(table, dc.candidates_plain(inputs, k_out))
    for got, want in zip(rows, dc.fused_rows_plain(table, inputs, band, k_out)):
        assert got.dtype == want.dtype and torch.equal(got, want)
