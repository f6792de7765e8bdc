"""The benchmark's traffic generator: a seeded random reference and reads
sampled from it, written as FASTA/FASTQ, with each read's origin kept for
the reference comparison.

Frozen copies of `benchmarks/simlib.py` (`random_reference`,
`simulate_paired`) and `mapper_tpu_torch/simulate.py` (`simulate_reads`):
for the same generator state they draw the same numbers in the same order
and give the same reads (`portbench/tests/test_portbench_generate.py` holds
them equal today).  Later edits to those files do not move this yardstick.  The paired
copy can also plant a 1-3 bp insertion or deletion in a mate as
`simulate_reads` does; with `indel_fraction` 0 it draws nothing more.

Bases are 4-bit codes A=1, C=2, G=4, T=8, as the program encodes them."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

CODES = np.array([1, 2, 4, 8], dtype=np.uint8)
# code -> ASCII, and code -> complement code (A<->T, C<->G)
DECODE = np.full(16, ord("N"), dtype=np.uint8)
DECODE[CODES] = np.frombuffer(b"ACGT", dtype=np.uint8)
ENCODE = np.zeros(256, dtype=np.uint8)
ENCODE[np.frombuffer(b"ACGT", dtype=np.uint8)] = CODES
COMPLEMENT = np.zeros(16, dtype=np.uint8)
COMPLEMENT[CODES] = CODES[::-1]


def encode(text: str) -> np.ndarray:
    return ENCODE[np.frombuffer(text.encode("ascii"), dtype=np.uint8)]


def decode(codes: np.ndarray) -> str:
    return DECODE[codes].tobytes().decode("ascii")


def reverse_complement(codes: np.ndarray) -> np.ndarray:
    return COMPLEMENT[codes[::-1]]


def random_reference(rng: np.random.Generator, size: int) -> str:
    """simlib.random_reference: one draw of `size` integers."""
    return DECODE[CODES[rng.integers(0, 4, size=size)]].tobytes().decode("ascii")


@dataclass
class Reads:
    """Reads as written, and where each came from: `start` is the first
    forward-strand reference base its bases cover, `span` how many reference
    bases they cover, `reverse` whether the read's text is the reverse
    complement of the forward strand there."""

    names: list[str]
    texts: list[str]
    start: np.ndarray
    span: np.ndarray
    reverse: np.ndarray


def _draw_indel(rng, indel_fraction: float) -> int:
    """The paired copy's indel length (0: none); draws nothing when
    `indel_fraction` is 0, so pairs without indels stay simlib's."""
    if indel_fraction <= 0:
        return 0
    return int(rng.integers(1, 4)) if rng.random() < indel_fraction else 0


def _cut(rng, ref_codes, pos, length, indel):
    """simulate_reads' cut: (`length` codes from `pos` with the indel
    planted, reference bases they cover)."""
    read = ref_codes[pos : pos + length + indel].copy()
    span = length
    if indel:
        j = int(rng.integers(10, length - 10))
        if rng.random() < 0.5:
            read = np.concatenate([read[:j], read[j + indel :]])  # deletion
            span = length + indel
        else:
            ins = CODES[rng.integers(0, 4, size=indel)]
            read = np.concatenate([read[:j], ins, read[j:]])[:length]
            span = length - indel
    return read[:length], span


def simulate_reads(rng: np.random.Generator, ref_text: str, num_reads: int, length: int,
                   snp_rate: float, indel_fraction: float, prefix: str = "r") -> Reads:
    """mapper_tpu_torch.simulate.simulate_reads: SNPs at `snp_rate` a base, a
    1-3 bp insertion or deletion in `indel_fraction` of the reads, every
    other read reverse-complemented."""
    ref = encode(ref_text)
    names, texts = [], []
    start = np.zeros(num_reads, dtype=np.int64)
    span = np.zeros(num_reads, dtype=np.int64)
    reverse = np.zeros(num_reads, dtype=bool)
    for i in range(num_reads):
        indel = int(rng.integers(1, 4)) if rng.random() < indel_fraction else 0
        pos = int(rng.integers(0, len(ref) - length - indel))
        read, span[i] = _cut(rng, ref, pos, length, indel)
        snps = rng.random(length) < snp_rate
        read[snps] = CODES[rng.integers(0, 4, size=int(snps.sum()))]
        if i % 2 == 1:
            read = reverse_complement(read)
            reverse[i] = True
        start[i] = pos
        names.append(f"{prefix}{i}")
        texts.append(decode(read))
    return Reads(names, texts, start, span, reverse)


def _mutate(rng, read: np.ndarray, snp_rate: float) -> np.ndarray:
    """simlib.mutate on codes."""
    snps = rng.random(read.shape[0]) < snp_rate
    k = int(snps.sum())
    if k:
        read = read.copy()
        read[snps] = CODES[rng.integers(0, 4, size=k)]
    return read


def simulate_paired(rng: np.random.Generator, ref_text: str, num_pairs: int, length: int,
                    inner_mean: float, inner_sd: float, snp_rate: float,
                    indel_fraction: float) -> tuple[Reads, Reads]:
    """simlib.simulate_paired: FR pairs, mate 1 forward and mate 2 the
    reverse complement of the downstream segment, the inner distance normal
    (`inner_mean`, `inner_sd`), half the fragments on the reverse strand
    (mates swapped).  With `indel_fraction` > 0 each mate may carry an
    insertion or deletion drawn as in `simulate_reads`, before its SNPs."""
    ref = encode(ref_text)
    n = len(ref_text)
    room = 3 if indel_fraction > 0 else 0  # a deletion's extra reference bases
    mates = [([], [], np.zeros(num_pairs, np.int64), np.zeros(num_pairs, np.int64),
              np.zeros(num_pairs, bool)) for _ in range(2)]
    for i in range(num_pairs):
        inner = max(-length // 2, int(rng.normal(inner_mean, inner_sd)))
        frag = 2 * length + inner
        pos = int(rng.integers(0, max(1, n - frag - room)))
        cut = []
        for seg_start in (pos, pos + length + inner):
            indel = _draw_indel(rng, indel_fraction)
            codes, span = _cut(rng, ref, seg_start, length, indel)
            cut.append((_mutate(rng, codes, snp_rate), seg_start, span))
        (c1, s1, n1), (c2, s2, n2) = cut
        m1 = (c1, s1, n1, False)
        m2 = (reverse_complement(c2), s2, n2, True)
        if rng.random() < 0.5:
            # reverse-strand fragment: R1 reads the right end inward, R2 the left
            m1, m2 = m2, m1
        for mate, (codes, seg_start, span, rev) in enumerate((m1, m2)):
            names, texts, starts, spans, reverse = mates[mate]
            names.append(f"p{i}/{mate + 1}")
            texts.append(decode(codes))
            starts[i], spans[i], reverse[i] = seg_start, span, rev
    first, second = (Reads(*m) for m in mates)
    return first, second


def write_fasta(path, names, texts, width: int | None = None) -> None:
    with open(path, "w") as f:
        for name, text in zip(names, texts):
            if width is None:
                f.write(f">{name}\n{text}\n")
            else:
                f.write(f">{name}\n")
                for i in range(0, len(text), width):
                    f.write(text[i : i + width] + "\n")


def write_fastq(path, names, texts) -> None:
    with open(path, "w") as f:
        for name, text in zip(names, texts):
            f.write(f"@{name}\n{text}\n+\n{'I' * len(text)}\n")
