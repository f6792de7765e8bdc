"""Multi-process runs of the port (`mapper_tpu_torch.parallel.multihost`):
two CLI processes, each aligning its round-robin share of the queries on
the CPU, write all five outputs byte-identical to the port's one-process
run and to the JAX package's one-process run (`mapper_tpu.cli`), with the
file barrier and with a gloo process group (`--coordinator`), and leave no
shard behind for a later run into the same paths.  Mirrors
tests/test_multihost.py, with unit tests of the host copies it merges with
(RoundRobinQueries, merge_sam_shards, merge_pileup_shards,
wait_for_files)."""

import os
import pickle
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from benchmarks.simlib import rc_text
from mapper_tpu import cli as jax_cli
from mapper_tpu_torch.parallel import multihost
from mapper_tpu_torch.pileup import MatchDatabase
from mapper_tpu_torch.sequence import Sequence, SequenceBuilder, sort_and_complement

REPO = Path(__file__).resolve().parent.parent
OUTPUTS = {
    "--out-sam": "out.sam",
    "--out-vcf": "out.vcf",
    "--out-mutations": "mutations.txt",
    "--out-refs-map-count": "refs.txt",
    "--out-unaligned": "unaligned.fasta",
}


def random_text(n, seed):
    rng = np.random.default_rng(seed)
    return "".join(rng.choice(list("ACGT"), size=n))


def start_cli(args):
    """`python -m mapper_tpu_torch` on the CPU, one intra-op thread."""
    env = dict(os.environ, MAPPER_TPU_TORCH_DEVICE="cpu", OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.Popen(
        [sys.executable, "-m", "mapper_tpu_torch", *args],
        cwd=REPO, env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
    )


def finish(procs, timeout=600):
    """Waits for every process (killing any still running at the timeout)
    and returns their stderr texts; every exit code must be 0."""
    errs = []
    for p in procs:
        try:
            errs.append(p.communicate(timeout=timeout)[1].decode())
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
    for p, err in zip(procs, errs):
        assert p.returncode == 0, err[-3000:]
    return errs


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """Mirrors tests/test_multihost.py's inputs: two contigs, 240 reads with
    SNPs and 1-2 bp indels, half reverse-complemented, plus 5 unalignable
    reads (the unaligned output) and the serial run's outputs."""
    root = tmp_path_factory.mktemp("multihost")
    rng = np.random.default_rng(41)
    ref_text = random_text(20000, 43)
    (root / "ref.fasta").write_text(">k1\n" + ref_text[:11000] + "\n>k2\n" + ref_text[11000:] + "\n")
    lines = []
    for i in range(240):
        pos = int(rng.integers(0, 20000 - 140))
        frag = list(ref_text[pos : pos + 140])
        for _ in range(int(rng.integers(0, 3))):
            frag[int(rng.integers(0, 130))] = "ACGT"[int(rng.integers(0, 4))]
        if i % 4 == 0:  # indel reads exercise the gapped finalization path
            j = int(rng.integers(15, 110))
            if rng.random() < 0.5:
                del frag[j : j + int(rng.integers(1, 3))]
            else:
                frag.insert(j, "ACGT"[int(rng.integers(0, 4))])
        text = "".join(frag[:130])
        if rng.random() < 0.5:
            text = rc_text(text)
        lines.append(f">r{i}\n{text}\n")
        if i % 48 == 0:
            lines.append(f">u{i}\n{random_text(130, 1000 + i)}\n")
    (root / "reads.fasta").write_text("".join(lines))
    one_process_runs(root)
    return root


@pytest.fixture(scope="module")
def dense_inputs(tmp_path_factory):
    """1,000 reads of 150 bp on a 2 kb reference, half with a 1-3 bp indel:
    positions where two processes' reads insert different texts, which the
    VCF lists in the order a one-process run met them; and the serial run's
    outputs."""
    from benchmarks.simlib import random_reference, write_reference
    from mapper_tpu_torch.simulate import simulate_reads

    root = tmp_path_factory.mktemp("multihost_dense")
    rng = np.random.default_rng(0)
    ref = random_reference(rng, 2000)
    write_reference(str(root / "ref.fasta"), {"chr1": ref})
    reads = simulate_reads(rng, ref, 1000, 150, 0.01, 0.5, "s")
    reads += [(f"u{i}", random_text(150, 2000 + i)) for i in range(3)]
    (root / "reads.fasta").write_text("".join(f">{name}\n{text}\n" for name, text in reads))
    one_process_runs(root)
    return root


def cli_args(root, tag, out_root=None):
    """The CLI's arguments for the inputs in `root`, its outputs in
    `out_root` (default `root`) / `tag`."""
    out = (root if out_root is None else out_root) / tag
    args = ["--reference", str(root / "ref.fasta"), "--queries", str(root / "reads.fasta")]
    for flag, name in OUTPUTS.items():
        args += [flag, str(out / name)]
    return args


def one_process_runs(root):
    """The port's one-process run (`serial`) and the JAX package's
    (`jax`, in this process on its CPU devices) of the inputs in `root`."""
    (root / "serial").mkdir()
    finish([start_cli(cli_args(root, "serial"))])
    (root / "jax").mkdir()
    assert jax_cli.main(cli_args(root, "jax") + ["--devices", "1"]) == 0


def two_process_run(root, tag, barrier, out_root=None):
    """Both processes run concurrently; process 0 merges the shards."""
    extra = []
    if barrier == "coordinator":
        extra = ["--coordinator", f"127.0.0.1:{free_port()}"]
    procs = [
        start_cli(cli_args(root, tag, out_root) + ["--num-processes", "2", "--process-id", str(k), *extra])
        for k in range(2)
    ]
    errs = finish(procs)
    assert "Process 1 done" in errs[1] and "Align phase:" in errs[0] and "Align phase:" in errs[1]


def assert_one_process_outputs(root, out):
    """The five outputs in `out` equal the port's and the JAX package's
    one-process runs of the inputs in `root`; no shard is left in `out`."""
    for name in OUTPUTS.values():
        serial = (root / "serial" / name).read_bytes()
        assert (out / name).read_bytes() == serial, f"{name} diverged across process counts"
        assert serial == (root / "jax" / name).read_bytes(), f"{name} diverged from the JAX package"
    assert sorted(p.name for p in out.iterdir()) == sorted(OUTPUTS.values())


@pytest.mark.parametrize(
    "workload,barrier", [("inputs", "files"), ("inputs", "coordinator"), ("dense_inputs", "files")]
)
def test_two_process_run_matches_single(request, workload, barrier):
    """Both processes run concurrently; process 0 merges the shards."""
    inputs = request.getfixturevalue(workload)
    tag = f"multi_{barrier}"
    (inputs / tag).mkdir()
    two_process_run(inputs, tag, barrier)
    assert_one_process_outputs(inputs, inputs / tag)
    unaligned = (inputs / "serial" / "unaligned.fasta").read_bytes()
    assert unaligned.count(b">u") == (5 if workload == "inputs" else 3)
    assert (inputs / "serial" / "out.sam").read_bytes().count(b"\n") > 240


def test_second_run_into_the_same_paths_merges_its_own_shards(tmp_path, inputs, dense_inputs):
    """Process 0 removes the shards and markers it merged: a second
    two-process run of other inputs into the same output paths waits for
    its own and writes its own inputs' outputs."""
    (tmp_path / "out").mkdir()
    for root in (dense_inputs, inputs):
        two_process_run(root, "out", "files", out_root=tmp_path)
        assert_one_process_outputs(root, tmp_path / "out")


# ---- the host copies the merge uses -------------------------------------


def _builders(n):
    return [SequenceBuilder().set_name(f"q{i}").add("ACGT") for i in range(n)]


@pytest.mark.parametrize("process_id", [0, 1, 2])
def test_round_robin_queries_keep_global_ids(process_id):
    rr = multihost.RoundRobinQueries(iter(_builders(8)), process_id, 3)
    got = [b.build() for b in rr]
    assert [s.identifier for s in got] == list(range(process_id + 1, 9, 3))
    assert [s.name for s in got] == [f"q{i - 1}" for i in range(process_id + 1, 9, 3)]
    assert rr.num_global == 8


def test_merge_sam_shards_in_global_order(tmp_path):
    paths = []
    for k, ids in enumerate(([1, 3, 5], [2, 4])):
        path = tmp_path / f"s{k}.pkl"
        with open(path, "wb") as f:
            pickle.dump({"header": "@HD\n", "entries": [(i, f"row{i}\n") for i in ids]}, f)
        paths.append(str(path))

    class Out(list):
        write = list.append

    out = Out()
    multihost.merge_sam_shards(paths, out)
    assert "".join(out) == "@HD\n" + "".join(f"row{i}\n" for i in range(1, 6))


def test_merge_pileup_shards_sums_and_keeps_first_contributor(tmp_path):
    """Arrays add; an insertion seen by both processes sums its weights and
    takes its example read from the smaller global id; a contig only the
    other process covered is created."""
    contigs = sort_and_complement([Sequence.from_text("k1", "ACGTACGTAC"), Sequence.from_text("k2", "TTGCA")])
    k1, k2 = (s for s in contigs if s.complemented_from is None)

    def database(fill):
        db = MatchDatabase(0.1)
        db.set_contig_order(contigs)
        for seq, (value, insertions) in fill.items():
            pileup = db._pileup_for(seq)
            pileup.middle += value
            pileup.end += 2 * value
            pileup.deletion_start_middle += value
            pileup.insertions.update(insertions)
        return db

    mine = database({k1: (1.0, {(3, "G"): [1.0, 0.0, "r7", 7], (5, "T"): [0.5, 0.0, "r2", 2]})})
    theirs = database({
        k1: (0.5, {(3, "G"): [0.0, 1.0, "r4", 4], (5, "T"): [1.0, 0.5, "r9", 9]}),
        k2: (2.0, {}),
    })
    path = str(tmp_path / "p1.pkl")
    multihost.save_pileup_shard(theirs, path)
    multihost.merge_pileup_shards(mine, [path])
    merged = {seq.name: p for seq, p in mine.group_by_position().items()}
    assert set(merged) == {"k1", "k2"}
    np.testing.assert_array_equal(merged["k1"].middle, np.full((6, 10), 1.5))
    np.testing.assert_array_equal(merged["k1"].end, np.full((6, 10), 3.0))
    np.testing.assert_array_equal(merged["k2"].deletion_start_middle, np.full(5, 2.0))
    assert merged["k1"].insertions == {(3, "G"): [1.0, 1.0, "r4", 4], (5, "T"): [1.5, 0.5, "r2", 2]}


def test_merged_insertions_keep_the_one_process_order(tmp_path):
    """A position's insertions are listed (VCF, mutations) in the order a
    one-process run first met them: by their first contributor's global id,
    also when the other process met the earlier one."""
    contigs = sort_and_complement([Sequence.from_text("k1", "ACGTACGTAC")])
    (k1,) = (s for s in contigs if s.complemented_from is None)
    mine, theirs = MatchDatabase(0.1), MatchDatabase(0.1)
    for db, insertions in (
        (mine, {(5, "A"): [1.0, 0.0, "r6", 6], (2, "C"): [1.0, 0.0, "r8", 8]}),
        (theirs, {(5, "GA"): [1.0, 0.0, "r3", 3], (2, "C"): [0.0, 1.0, "r1", 1], (7, "T"): [1.0, 0.0, "r7", 7]}),
    ):
        db.set_contig_order(contigs)
        db._pileup_for(k1).insertions.update(insertions)
    path = str(tmp_path / "p1.pkl")
    multihost.save_pileup_shard(theirs, path)
    multihost.merge_pileup_shards(mine, [path])
    (pileup,) = mine.group_by_position().values()
    assert list(pileup.insertions) == [(2, "C"), (5, "GA"), (5, "A"), (7, "T")]


def test_wait_for_files(tmp_path):
    present = tmp_path / "a.done"
    present.write_text("done\n")
    multihost.wait_for_files([str(present)], timeout_s=1.0)
    with pytest.raises(TimeoutError, match="b.done"):
        multihost.wait_for_files([str(present), str(tmp_path / "b.done")], timeout_s=0.3)
