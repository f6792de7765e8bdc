"""Judges the inferred ancestor that `--out-ancestor` writes, against the
copies the generator planted (`generate.Planted`) and nothing else.

X-Mapper's ancestor inference (AncestryDetector) walks outward over every
duplication of three or more instances.  At each offset it takes the
unique plurality base of the instances still walking (none on a tie), and
where a walking copy's base differs from it, writes the union of the two
into that copy's position of an overridden reference named `<contig>-anc`
(`_write_differences`).  With three or more walkers a unique plurality is
carried by two of them at least.  The walkers are the copies, column by
column, and where a block of the copies reads the same on the reverse
strand at its edges, the copies read backwards too: a duplication groups
each block with its reverse complement when their edge texts (the first
and last ceil(L / 4) bases, L from log2 of the reference's length to twice
that) agree, and such a walker reads the complement of the base mirrored
about the block's centre.  So a sound ancestor holds the reference's base
everywhere, differs from it only inside the planted copies, and there by
one base at most, carried by two walkers or more: two copies in that
column, or copies read backwards near a block that reads the same on both
strands.  Of four copies, one whose base three carry is never widened by
the forward walk.  The walk's extent is the program's, so where the
copies' consensus reached the ancestor is read, not required: it is
`ancestor_columns_missing`, held to a limit set from runs.

Bases are 4-bit codes (A=1, C=2, G=4, T=8); an IUPAC letter is the OR of
its bases."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from portbench.generate import COMPLEMENT
from portbench.reference.align import POPCOUNT

IUPAC = {"A": 1, "C": 2, "G": 4, "T": 8, "M": 3, "R": 5, "W": 9, "S": 6, "Y": 10, "K": 12,
         "V": 7, "H": 11, "D": 13, "B": 14, "N": 15}
BASES = (1, 2, 4, 8)
DECODE = np.zeros(256, dtype=np.uint8)  # any other letter: no base
for _letter, _code in IUPAC.items():
    DECODE[ord(_letter)] = DECODE[ord(_letter.lower())] = _code


def parse_fasta(text: str) -> list[tuple[str, np.ndarray]]:
    """(name, codes) of each record."""
    records = []
    for chunk in text.split(">")[1:]:
        name, _, body = chunk.partition("\n")
        records.append((name.strip(), DECODE[np.frombuffer("".join(body.split()).encode("ascii"), dtype=np.uint8)]))
    return records


@dataclass
class Bounds:
    """What the planted copies allow: `ceiling`, the reference's base ORed,
    inside the copies, with every base that two or more walkers can carry
    at that column (the walk adds one of them, never two), and `floor`, the
    reference's base ORed with the copies' consensus (a base that a strict
    majority of three or more copies carry in that column).  `inside` marks
    the copies' positions."""

    ceiling: np.ndarray
    floor: np.ndarray
    inside: np.ndarray


# columns past a reverse-read block's ends that its backward walkers may
# still vote on, in block lengths: a walker starts with a score of L / 10,
# gains 0.1 a base it shares with the plurality and loses 0.9 a base it
# does not, and the mirrored bases past the block share it by chance alone
REACH = 1


def mirrored_blocks(cols: np.ndarray, ref_len: int) -> list[tuple[int, int]]:
    """(first column, length) of every block of the copies `cols` [copies,
    segment] whose edge texts read the same on the reverse strand: the
    blocks whose duplication also walks the copies backwards."""
    lmin = max(1, (ref_len - 1).bit_length())  # log2, rounded up, of the reference's length
    seg = cols.shape[1]
    found = set()
    for length in range(lmin, 2 * lmin + 1):
        n = seg - length + 1
        if n <= 0:
            break
        edge = (length + 3) // 4
        for row in cols:
            same = np.ones(n, dtype=bool)
            for i in range(edge):
                same &= row[i : i + n] == COMPLEMENT[row[length - 1 - i : length - 1 - i + n]]
            found.update((int(a), length) for a in np.nonzero(same)[0])
    return sorted(found)


def bounds(ref: np.ndarray, planted) -> Bounds:
    """The bounds of `planted` (`generate.Planted`; None: no copies)."""
    ceiling, floor = ref.copy(), ref.copy()
    inside = np.zeros(ref.shape[0], dtype=bool)
    if planted is None:
        return Bounds(ceiling, floor, inside)
    seg, starts = planted.segment, np.asarray(planted.starts)
    cols = np.stack([ref[s : s + seg] for s in starts])  # [copies, segment]
    carried = np.stack([((cols & base) != 0).sum(axis=0) for base in BASES])  # [4, segment]
    shared = np.zeros(seg, dtype=np.uint8)
    consensus = np.zeros(seg, dtype=np.uint8)
    for k, base in enumerate(BASES):
        shared[carried[k] >= 2] |= base
        consensus[(carried[k] >= 3) & (2 * carried[k] > cols.shape[0])] |= base
    for a, length in mirrored_blocks(cols, ref.shape[0]):
        # a backward walker at column c reads the complement of column
        # 2a + L - 1 - c, the copies' flanks included
        c = np.arange(max(0, a - REACH * length), min(seg, a + length + REACH * length))
        g = starts[:, None] + (2 * a + length - 1 - c)[None, :]  # [copies, columns]
        backward = np.where((g >= 0) & (g < ref.shape[0]), COMPLEMENT[ref[np.clip(g, 0, ref.shape[0] - 1)]], 0)
        for k, base in enumerate(BASES):
            walkers = carried[k, c] + (backward == base).sum(axis=0)
            shared[c[walkers >= 2]] |= base
    for s in starts:
        ceiling[s : s + seg] |= shared
        floor[s : s + seg] |= consensus
        inside[s : s + seg] = True
    return Bounds(ceiling, floor, inside)


def judge(text: str, ref: np.ndarray, contig: str, planted) -> tuple[dict, np.ndarray]:
    """(the numbers compared, the checked ancestor) of the written FASTA
    `text`.  The checked ancestor is the written one with every base cut
    back to what the copies allow, so that a fault cannot lower a penalty:
    the rows and the optimum are worked out against it."""
    b = bounds(ref, planted)
    records = parse_fasta(text)
    faults = abs(len(records) - 1)
    checked = ref.copy()
    if records:
        name, anc = records[0]
        n = min(anc.shape[0], ref.shape[0])
        faults += int(name != f"{contig}-anc") + abs(anc.shape[0] - ref.shape[0])
        anc, r = anc[:n], ref[:n]
        faults += int(((anc & r) != r).sum())  # the reference's base left out
        faults += int((~b.inside[:n] & (anc != r)).sum())  # a change outside the copies
        added = anc & ~r
        # a base the walk cannot add, or more than the one base it adds
        faults += int((b.inside[:n] & (((added & ~b.ceiling[:n]) != 0) | (POPCOUNT[added] > 1))).sum())
        checked[:n] |= anc & b.ceiling[:n]
    missing = int(((b.floor & ~checked) != 0).sum())
    return {"ancestor_faults": faults, "ancestor_columns_missing": missing}, checked
