"""The frozen generator draws what the originals draw, and the cells'
samples are the bytes they were."""

import hashlib

import numpy as np
import pytest

from benchmarks import simlib
from mapper_tpu_torch.simulate import simulate_reads
from portbench import cells, generate, run


def test_reference_and_single_reads_equal_the_originals():
    ref = generate.random_reference(np.random.default_rng(3), 50_000)
    assert ref == simlib.random_reference(np.random.default_rng(3), 50_000)
    got = generate.simulate_reads(np.random.default_rng(5), ref, 400, 150, 0.01, 0.1)
    want = simulate_reads(np.random.default_rng(5), ref, 400, 150, 0.01, 0.1, "r")
    assert list(zip(got.names, got.texts)) == want


def test_pairs_without_indels_equal_simlib(tmp_path):
    ref = generate.random_reference(np.random.default_rng(3), 50_000)
    m1, m2 = generate.simulate_paired(np.random.default_rng(7), ref, 300, 150, 100, 30, 0.007, 0.0)
    simlib.simulate_paired(str(tmp_path / "a_1.fa"), str(tmp_path / "a_2.fa"), ref, 300, seed=7)
    generate.write_fasta(tmp_path / "b_1.fa", m1.names, m1.texts)
    generate.write_fasta(tmp_path / "b_2.fa", m2.names, m2.texts)
    for mate in (1, 2):
        assert (tmp_path / f"b_{mate}.fa").read_text() == (tmp_path / f"a_{mate}.fa").read_text()


def test_origins_place_every_read():
    """Each read's recorded origin holds it: the forward-strand bases match
    the reference there but for SNPs and the planted indel."""
    rng = np.random.default_rng(9)
    ref_text = generate.random_reference(rng, 100_000)
    ref = generate.encode(ref_text)
    single = generate.simulate_reads(rng, ref_text, 300, 150, 0.01, 0.1)
    pairs = generate.simulate_paired(rng, ref_text, 150, 150, 100, 30, 0.01, 0.1)
    indels = 0
    for reads in (single, *pairs):
        for k, text in enumerate(reads.texts):
            codes = generate.encode(text)
            if reads.reverse[k]:
                codes = generate.reverse_complement(codes)
            span = int(reads.span[k])
            indels += span != 150
            if span == 150:
                assert (codes != ref[reads.start[k] : reads.start[k] + 150]).sum() < 12
            else:  # the first 10 bases precede any indel
                assert (codes[:10] != ref[reads.start[k] : reads.start[k] + 10]).sum() < 4
    assert indels > 0


def test_single_reads_on_a_random_strand_equal_simlib(tmp_path):
    ref = generate.random_reference(np.random.default_rng(3), 50_000)
    got = generate.simulate_single(np.random.default_rng(11), ref, 40, 1500, 0.02)
    simlib.simulate_single(str(tmp_path / "a.fa"), ref, 40, read_length=1500, snp_rate=0.02, seed=11)
    generate.write_fasta(tmp_path / "b.fa", got.names, got.texts)
    assert (tmp_path / "b.fa").read_text() == (tmp_path / "a.fa").read_text()
    assert got.reverse.any() and not got.reverse.all()
    codes = generate.encode(ref)
    for k, text in enumerate(got.texts):
        forward = generate.encode(text)
        if got.reverse[k]:
            forward = generate.reverse_complement(forward)
        assert got.span[k] == 1500 and (forward != codes[got.start[k] : got.start[k] + 1500]).sum() < 75


def test_planted_reference_equals_the_config5_builder():
    """bench_config5_longreads.py's reference (lines 29-36), at a smaller
    size: a random base, then three copies of its first segment at 2%
    SNPs."""
    rng = np.random.default_rng(5)
    base = simlib.random_reference(rng, 100_000 - 3 * 4_000)
    segment = np.array(list(base[:4_000]))
    want = base + "".join("".join(simlib.mutate(rng, segment, 0.02)) for _ in range(3))
    got, planted = generate.planted_reference(np.random.default_rng(5), 100_000, 4_000, 3, 0.02)
    assert got == want
    assert planted.starts == [0, 88_000, 92_000, 96_000] and planted.segment == 4_000


# sha256 of the files `make_sample` writes, the reads' origins and the
# reference's codes, at the tests' size, as the generator gave them before
# the optional keys of planted copies, single-end reads on a random strand
# and split reads were added
SAMPLE_DIGESTS = {
    ("se150_gapped", 2**31 + 41): "4b31f5ab28c126139c3c8b51e62d309e09348361884cf55e434be6b886b9bd34",
    ("se150_gapped", 5): "05ce4d4270d9afb4bd7791041a983f7fedf517a153d4c7b59dbf48a041f453fe",
    ("pe150_gapped", 2**31 + 41): "4dbef859f15b3b75d02807b98d861dba8768c59f5238dbc6c4d18ec821fe7d2f",
    ("pe150_gapped", 5): "b7b5172d7a9fba84a2938e35df3bf3019f1b8fd8c1f5a4e3c7ab9a4cd4a072bc",
}


@pytest.mark.parametrize("workload,seed", sorted(SAMPLE_DIGESTS))
def test_the_cells_samples_are_unchanged(tiny_root, tmp_path, workload, seed):
    work = tmp_path / "work"
    work.mkdir()
    sample = run.make_sample(cells.load(tiny_root, workload), seed, work)
    h = hashlib.sha256()
    for path in sorted(work.iterdir()):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    for reads in sample.reads:
        for origin in (reads.start, reads.span, reads.reverse):
            h.update(np.ascontiguousarray(origin).tobytes())
    h.update(sample.ref.tobytes())
    assert h.hexdigest() == SAMPLE_DIGESTS[(workload, seed)] and sample.planted is None
