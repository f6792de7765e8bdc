"""The port's device pileup (`mapper_tpu_torch.batch.device_pileup`) against
the JAX package's (`mapper_tpu.batch.device_pileup`) and the host
MatchDatabase accumulation: the same rows give the same pileups exactly, and
the port's CLI with MAPPER_TPU_DEVICE_PILEUP=1 writes VCF and mutations
byte-identical to the JAX CLI with the same setting and to the port without
it.  The port runs on the CPU here (MAPPER_TPU_TORCH_DEVICE=cpu)."""

import sys
import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmarks.simlib import random_reference, rc_text, write_reference
from mapper_tpu import cli as jax_cli
from mapper_tpu.align.blocks import (
    AlignedBlock,
    QueryAlignment,
    QueryAlignments,
    new_sequence_alignment,
)
from mapper_tpu.align.params import AlignmentParameters
from mapper_tpu.batch.candidates import ReadBatch
from mapper_tpu.batch.device_pileup import DevicePileup as JaxDevicePileup
from mapper_tpu.pileup import MatchDatabase
from mapper_tpu.sequence import Sequence, SequenceDatabase, sort_and_complement
from mapper_tpu_torch import cli as torch_cli
from mapper_tpu_torch.batch import device_pileup
from mapper_tpu_torch.batch.device_pileup import DevicePileup
from mapper_tpu_torch.simulate import simulate_reads, write_fastq

QEF = 0.1


@pytest.fixture(scope="module")
def emissions():
    """Two contigs and 200 clean full-length ungapped emissions on them
    (reverse-complemented reads and SNPs included), as the engine hands them
    to `add_rows`, with the host MatchDatabase's pileups of the same."""
    rng = np.random.default_rng(3)
    contigs = sort_and_complement(
        [Sequence.from_text("c1", random_reference(rng, 3000)),
         Sequence.from_text("c2", random_reference(rng, 2000))]
    )
    seq_db = SequenceDatabase(contigs)
    forward = [s for s in contigs if s.complemented_from is None]
    index = {id(s): k for k, s in enumerate(contigs)}
    reads, rows = [], []
    for i in range(200):
        contig = forward[int(rng.integers(0, len(forward)))]
        n = int(rng.integers(80, 150))
        off = int(rng.integers(0, len(contig) - n))
        frag = list(contig.get_range(off, n))
        for _ in range(int(rng.integers(0, 3))):
            frag[int(rng.integers(0, n))] = "ACGT"[int(rng.integers(0, 4))]
        text = "".join(frag)
        reversed_ = bool(rng.random() < 0.5)
        reads.append(Sequence.from_text(f"r{i}", rc_text(text) if reversed_ else text))
        rows.append((i, reversed_, contig, off, n))

    params = AlignmentParameters.defaults()
    host_db = MatchDatabase(QEF)
    results = []
    for i, reversed_, contig, off, n in rows:
        seq_a = reads[i].reverse_complement() if reversed_ else reads[i]
        alignment = new_sequence_alignment([AlignedBlock(seq_a, contig, 0, off, n, n)], False, params)
        results.append(QueryAlignments.single_component([reads[i]], [QueryAlignment(alignment)]))
    host_db.add_alignments(results)
    args = (
        ReadBatch.from_sequences(reads),
        np.array([r[0] for r in rows]),
        np.array([r[1] for r in rows], dtype=bool),
        np.array([int(seq_db.starts[index[id(r[2])]]) + r[3] for r in rows]),
        np.array([r[4] for r in rows]),
        np.ones(len(rows), dtype=np.float32),
    )
    return seq_db, args, host_db.group_by_position()


def _merged(pileup):
    db = MatchDatabase(QEF)
    pileup.merge_into(db)
    return {seq.name: p for seq, p in db.group_by_position().items()}


def _assert_same(got, want):
    assert set(got) == {seq.name for seq in want}
    for seq, p in want.items():
        np.testing.assert_array_equal(got[seq.name].middle, p.middle)
        np.testing.assert_array_equal(got[seq.name].end, p.end)


def test_pileups_equal_jax_and_host(emissions):
    seq_db, args, host = emissions
    port = DevicePileup(seq_db, QEF, torch.device("cpu"))
    port.add_rows(*args)
    jax_dp = JaxDevicePileup(seq_db, QEF)
    jax_dp.add_rows(*args)
    assert port.num_rows_accumulated == jax_dp.num_rows_accumulated == 200
    got = _merged(port)
    _assert_same(got, host)
    jax_merged = _merged(jax_dp)
    for name, p in got.items():
        np.testing.assert_array_equal(p.middle, jax_merged[name].middle)
        np.testing.assert_array_equal(p.end, jax_merged[name].end)


def test_rows_added_from_many_threads_all_count(emissions):
    """The CLI adds rows from a pool of threads: with more threads than
    cores and a short switch interval, no update is lost."""
    seq_db, (batch, rid, rev, gstart, n, weight), host = emissions
    port = DevicePileup(seq_db, QEF, torch.device("cpu"))
    parts = np.array_split(np.arange(len(rid)), 20)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [
            threading.Thread(target=port.add_rows, args=(batch, rid[i], rev[i], gstart[i], n[i], weight[i]))
            for i in parts
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert port.num_rows_accumulated == len(rid)
    _assert_same(_merged(port), host)


def test_reference_above_the_cap_is_refused():
    """Above 2^26 compact positions the constructor raises ValueError, which
    the CLI takes as "keep the host path", as the JAX package does."""
    fake = SimpleNamespace(
        starts=np.array([0, 2**26 + 1], dtype=np.int64),
        get_all=lambda: [SimpleNamespace(complemented_from=None)],
    )
    with pytest.raises(ValueError, match="too large"):
        DevicePileup(fake, QEF, torch.device("cpu"))
    with pytest.raises(ValueError, match="too large"):
        JaxDevicePileup(fake, QEF)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    root = tmp_path_factory.mktemp("pileup_inputs")
    rng = np.random.default_rng(23)
    ref = random_reference(rng, 30_000)
    write_reference(str(root / "ref.fasta"), {"cA": ref[:18_000], "cB": ref[18_000:]})
    write_fastq(root / "reads.fastq", simulate_reads(rng, ref, 300, 150, snp_rate=0.01, indel_fraction=0.2))
    mates1, mates2 = [], []
    for i in range(120):
        pos = int(rng.integers(0, 18_000 - 400))
        frag = ref[pos : pos + 350]
        mates1.append((f"p{i}/1", frag[:120]))
        mates2.append((f"p{i}/2", rc_text(frag[-120:])))
    write_fastq(root / "m1.fastq", mates1)
    write_fastq(root / "m2.fastq", mates2)
    return root


QUERIES = {
    "single": lambda root: ["--queries", str(root / "reads.fastq")],
    "paired": lambda root: [
        "--paired-queries", str(root / "m1.fastq"), str(root / "m2.fastq"), "--spacing", "110", "50",
    ],
}


def _run(main, inputs, out_dir, kind):
    out_dir.mkdir()
    args = ["--reference", str(inputs / "ref.fasta"), *QUERIES[kind](inputs),
            "--out-vcf", str(out_dir / "out.vcf"), "--out-mutations", str(out_dir / "mutations.txt")]
    assert main(args) == 0
    return (out_dir / "out.vcf").read_bytes(), (out_dir / "mutations.txt").read_bytes()


@pytest.mark.parametrize("kind", ["single", "paired"])
def test_cli_outputs_byte_identical(monkeypatch, capsys, tmp_path, inputs, kind):
    monkeypatch.setenv("MAPPER_TPU_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("MAPPER_TPU_DEVICE_PILEUP", "1")
    want = _run(jax_cli.main, inputs, tmp_path / "jax", kind)
    capsys.readouterr()
    got = _run(torch_cli.main, inputs, tmp_path / "torch", kind)
    counted = [line for line in capsys.readouterr().err.splitlines() if line.startswith("Device pileup:")]
    assert len(counted) == 1 and int(counted[0].split()[2]) > 0, counted
    monkeypatch.delenv("MAPPER_TPU_DEVICE_PILEUP")
    host = _run(torch_cli.main, inputs, tmp_path / "host", kind)
    assert got == want
    assert got == host
    assert got[0].count(b"\n") > 100


def test_cli_above_the_cap_keeps_the_host_path(monkeypatch, capsys, tmp_path, inputs):
    monkeypatch.setenv("MAPPER_TPU_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("MAPPER_TPU_DEVICE_PILEUP", "1")
    monkeypatch.setattr(device_pileup, "MAX_POSITIONS", 1000)
    got = _run(torch_cli.main, inputs, tmp_path / "capped", "single")
    err = capsys.readouterr().err
    assert "Device pileup:" not in err
    assert "Device pileup not taken, the pileup stays on the host: reference too large" in err
    monkeypatch.delenv("MAPPER_TPU_DEVICE_PILEUP")
    assert got == _run(torch_cli.main, inputs, tmp_path / "host", "single")
