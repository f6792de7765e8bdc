"""Seeded synthetic data for the smoke run and the tests: reads sampled from
a reference with SNPs and short indels, a FASTQ writer, and candidate batches
for the scoring kernels.  numpy only, so the same inputs can be handed to both
packages.  References and FASTA files come from `benchmarks/simlib.py`."""

from __future__ import annotations

import numpy as np

from mapper_tpu_torch import basepairs

_CODES = np.array([1, 2, 4, 8], dtype=np.uint8)


def simulate_reads(
    rng: np.random.Generator,
    ref_text: str,
    num_reads: int,
    length: int,
    snp_rate: float = 0.01,
    indel_fraction: float = 0.1,
    prefix: str = "r",
) -> list[tuple[str, str]]:
    """(name, text) reads of `length` bases from random positions: SNPs at
    `snp_rate` per base, a 1-3 bp insertion or deletion in `indel_fraction`
    of the reads, and every other read reverse-complemented."""
    ref = basepairs.encode(ref_text)
    reads = []
    for i in range(num_reads):
        indel = int(rng.integers(1, 4)) if rng.random() < indel_fraction else 0
        pos = int(rng.integers(0, len(ref) - length - indel))
        read = ref[pos : pos + length + indel].copy()
        if indel:
            j = int(rng.integers(10, length - 10))
            if rng.random() < 0.5:
                read = np.concatenate([read[:j], read[j + indel :]])  # deletion
            else:
                ins = _CODES[rng.integers(0, 4, size=indel)]
                read = np.concatenate([read[:j], ins, read[j:]])[:length]
        read = read[:length]
        snps = rng.random(length) < snp_rate
        read[snps] = _CODES[rng.integers(0, 4, size=int(snps.sum()))]
        if i % 2 == 1:
            read = basepairs.reverse_complement(read)
        reads.append((f"{prefix}{i}", basepairs.decode(read)))
    return reads


def write_fastq(path, records) -> None:
    with open(path, "w") as f:
        for name, text in records:
            f.write(f"@{name}\n{text}\n+\n{'I' * len(text)}\n")


def scoring_candidates(
    rng: np.random.Generator,
    num_cands: int,
    lq: int,
    band: int,
    ref_size: int = 200_000,
    num_reads: int = 512,
) -> dict:
    """A candidate batch in the layout of `banded_scores_gathered`: reads
    sampled from a random reference (with a few ambiguous codes) carrying
    SNPs and short indels, half stored reverse-complemented and scored as
    reversed; windows placed around the true offset, some clamped at the
    reference's end; lanes partly outside the band."""
    concat = _CODES[rng.integers(0, 4, size=ref_size)]
    amb = rng.integers(0, ref_size, size=ref_size // 500)
    concat[amb] = rng.integers(1, 16, size=amb.shape[0]).astype(np.uint8)
    shift = band // 4
    reads = np.zeros((num_reads, lq), dtype=np.uint8)
    n_read = rng.integers(lq // 2, lq + 1, size=num_reads)
    start = rng.integers(0, ref_size - lq - 8, size=num_reads)
    start[: num_reads // 16] = ref_size - n_read[: num_reads // 16]  # at the end
    rev_read = rng.random(num_reads) < 0.5
    for r in range(num_reads):
        n = int(n_read[r])
        codes = concat[start[r] : start[r] + n + 4].copy()
        snps = rng.random(codes.shape[0]) < 0.02
        codes[snps] = _CODES[rng.integers(0, 4, size=int(snps.sum()))]
        if rng.random() < 0.3 and n > 24:
            j, d = int(rng.integers(8, n - 8)), int(rng.integers(1, 4))
            codes = np.concatenate([codes[:j], codes[j + d :]])
        codes = codes[:n]
        n_read[r] = codes.shape[0]
        if rev_read[r]:
            codes = basepairs.reverse_complement(codes)
        reads[r, : codes.shape[0]] = codes
    read_id = rng.integers(0, num_reads, size=num_cands)
    reversed_ = rev_read[read_id] ^ (rng.random(num_cands) < 0.1)
    n = n_read[read_id].astype(np.int64)
    jitter = rng.integers(-2, 3, size=num_cands)
    win_start = np.clip(start[read_id] - shift + jitter, 0, ref_size - 1).astype(np.int64)
    m = np.minimum(n + 2 * shift, ref_size - win_start).astype(np.int64)
    lane = rng.integers(-3, band + 3, size=num_cands).astype(np.int64)
    return {
        "reads": reads,
        "concat": concat,
        "read_id": read_id.astype(np.int64),
        "reversed_": reversed_,
        "win_start": win_start,
        "lane": lane,
        "n": n,
        "m": m,
    }
