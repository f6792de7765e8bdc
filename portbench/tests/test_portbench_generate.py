"""The frozen generator draws what the originals draw."""

import numpy as np

from benchmarks import simlib
from mapper_tpu_torch.simulate import simulate_reads
from portbench import generate


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
