"""References and reads for the device-candidates tests, built from numpy
seeds: `tests/test_torch_device_candidates.py` holds the port's plain
programs against the JAX package's on them, `tests/test_torch_kernels.py`
the CUDA kernels against the plain programs.  Imports neither JAX nor the
JAX package.

Besides clean reads on one contig, several contigs and a repetitive
reference, the workloads set each of the program's fallback flags and its
scored-row budget:
- `fallback_reasons`: a read that leaves blocks unmerged after NUM_LEVELS
  levels ("AT" x 30 then 90 random bases), a 400 bp read with more than
  V_SLOTS seeds, reads from a 300 bp unit repeated ten times whose matches
  pass P_SLOTS vote entries (their top ranks tie, broken by key), and
  periodic reads whose ranks tie at one vote;
- `score_budget`: 140 periodic reads that each keep 8 rows, past the 1,024
  rows `score_rows` gives a chunk of 140;
- `many_contigs`: 40 contigs, for the sequence search of every match.

And the edges of the kernels' layouts (KC1's team and vote table, KC2's
tiles):
- `vote_keys_full`: a 250 bp read of "TCTC" repeated, whose seeds' matches
  on a random reference pass P_SLOTS vote entries, each of the 1,024 it
  keeps a key of its own: KC1's vote table at its fullest, beside eight
  clean reads;
- `contigs_deep`: 300 contigs (600 sequences with their reverse
  complements), a sequence search of ten steps for every match;
- `one_read`: a chunk of one read; `ragged_chunk`: 131 reads, a multiple
  neither of the reads a KC1 block takes nor of a KC2 tile's 128;
- `rows_tiles`: 100 clean reads, then 160 periodic reads that keep 8 rows
  each: three KC2 tiles, and the 1,024 rows `score_rows` gives the chunk
  run out inside the second."""

import numpy as np

from mapper_tpu_torch import basepairs


def random_text(rng, n):
    return "".join(np.array(list("ACGT"))[rng.integers(0, 4, size=n)])


def random_reads(rng, ref_text, n, length=150, snp=0.02, rc_fraction=0.5, prefix="r"):
    """(name, text) reads drawn from `ref_text`, as tests/test_device_candidates.py
    draws them."""
    bases = np.array(list("ACGT"))
    reads = []
    for i in range(n):
        pos = int(rng.integers(0, len(ref_text) - length))
        read = np.array(list(ref_text[pos : pos + length]))
        snps = rng.random(length) < snp
        read[snps] = bases[rng.integers(0, 4, size=int(snps.sum()))]
        text = "".join(read)
        if rng.random() < rc_fraction:
            text = basepairs.decode(basepairs.reverse_complement(basepairs.encode(text)))
        reads.append((f"{prefix}{i}", text))
    return reads


def periodic_reads(rng, n):
    """Reads of a random 3-4 bp unit repeated, 120-150 bp: their seeds
    match the random reference at one vote each."""
    reads = []
    for i in range(n):
        unit = random_text(rng, int(rng.integers(3, 5)))
        reads.append((f"per{i}", (unit * 60)[: int(rng.integers(120, 151))]))
    return reads


def single_contig(rng):
    ref = random_text(rng, 120_000)
    return {"chr1": ref}, random_reads(rng, ref, 96)


def multi_contig(rng):
    contigs = {f"g{i}": random_text(rng, size) for i, size in enumerate((60_000, 30_000, 9_000))}
    reads = []
    for text in contigs.values():
        reads.extend(random_reads(rng, text, 16))
    # mixed lengths, contig-edge reads, and a high-SNP read
    reads.extend(random_reads(rng, contigs["g0"], 8, length=80))
    reads.extend(random_reads(rng, contigs["g1"], 8, length=37, snp=0.1))
    reads.append(("edge0", contigs["g2"][:150]))
    reads.append(("edge1", contigs["g2"][-150:]))
    return contigs, reads


def repetitive(rng):
    unit = random_text(rng, 500)
    ref = unit * 60 + random_text(rng, 20_000)
    return {"rep": ref}, random_reads(rng, ref, 96, snp=0.01)


def _plain_and_repeat(rng):
    plain = random_text(rng, 50_000)
    unit = random_text(rng, 300)
    return {"plain": plain, "repeat": unit * 10 + random_text(rng, 20_000)}


# the reads of `fallback_reasons` that set one flag each
UNCONVERGED, SEED_OVERFLOW = "unconverged", "seed_overflow"
ENTRY_OVERFLOW = tuple(f"entry_overflow{i}" for i in range(4))


def fallback_reasons(rng):
    contigs = _plain_and_repeat(rng)
    plain, repeat = contigs["plain"], contigs["repeat"]
    reads = random_reads(rng, plain, 24)
    reads.append((UNCONVERGED, "AT" * 30 + plain[100:190]))
    reads.append((SEED_OVERFLOW, plain[5000:5400]))
    for name in ENTRY_OVERFLOW:
        pos = int(rng.integers(0, 3000 - 150))
        reads.append((name, repeat[pos : pos + 150]))
    reads.extend(periodic_reads(rng, 4))
    return contigs, reads


def score_budget(rng):
    return _plain_and_repeat(rng), periodic_reads(rng, 140)


def many_contigs(rng):
    contigs = {f"c{i}": random_text(rng, int(rng.integers(1_500, 4_000))) for i in range(40)}
    reads = []
    for i, text in enumerate(contigs.values()):
        reads.extend(random_reads(rng, text, 1 + i % 2, prefix=f"c{i}_"))
    return contigs, reads


def vote_keys_full(rng):
    ref = random_text(rng, 50_000)
    return {"plain": ref}, [("vote_keys", ("TCTC" * 63)[:250])] + random_reads(rng, ref, 8)


def contigs_deep(rng):
    contigs = {f"d{i}": random_text(rng, int(rng.integers(300, 600))) for i in range(300)}
    reads = []
    for i, text in enumerate(list(contigs.values())[::10]):
        reads.extend(random_reads(rng, text, 1, length=120, prefix=f"d{10 * i}_"))
    return contigs, reads


def one_read(rng):
    ref = random_text(rng, 20_000)
    return {"one": ref}, random_reads(rng, ref, 1)


def ragged_chunk(rng):
    ref = random_text(rng, 40_000)
    return {"ragged": ref}, random_reads(rng, ref, 131)


def rows_tiles(rng):
    contigs = _plain_and_repeat(rng)
    return contigs, random_reads(rng, contigs["plain"], 100) + periodic_reads(rng, 160)


# name -> (seed, builder)
WORKLOADS = {
    "single_contig": (11, single_contig), "multi_contig": (12, multi_contig),
    "repetitive": (13, repetitive), "fallback_reasons": (14, fallback_reasons),
    "score_budget": (15, score_budget), "many_contigs": (16, many_contigs),
    "vote_keys_full": (17, vote_keys_full), "contigs_deep": (18, contigs_deep),
    "one_read": (19, one_read), "ragged_chunk": (20, ragged_chunk), "rows_tiles": (21, rows_tiles),
}


def build(name):
    """(contigs, reads) of workload `name`."""
    seed, make = WORKLOADS[name]
    return make(np.random.default_rng(seed))
