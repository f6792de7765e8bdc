"""Reads the program's SAM and holds each row against the reference text.

A row is sound when its SEQ is the read (reverse-complemented on the
reverse strand), its CIGAR consumes the whole read and stays inside the
contig, and the penalty of that alignment, worked out again here from the
reference's bases, is the row's `AS:f`.  Paired rows must also name their
mate as the SAM specification says.  The least penalty of a read's rows
is then held against the reference's own optimum (`align.glocal_optimum`)."""

from __future__ import annotations

import re
from dataclasses import dataclass

import numpy as np

from portbench.generate import ENCODE, reverse_complement, decode, encode

CIGAR = re.compile(r"(\d+)([MIDS])")
FLAG_PAIRED, FLAG_PROPER, FLAG_MATE_UNMAPPED = 1, 2, 8
FLAG_REVERSE, FLAG_MATE_REVERSE, FLAG_FIRST, FLAG_SECOND = 16, 32, 64, 128


@dataclass
class Rows:
    qname: list[str]
    flag: np.ndarray
    rname: list[str]
    pos: np.ndarray  # 0-based
    cigar: list[str]
    rnext: list[str]
    pnext: np.ndarray  # 1-based, as written
    seq: list[str]
    score: np.ndarray  # AS:f
    malformed: int  # lines that are not rows of this layout


def parse(text: str) -> Rows:
    qname, flag, rname, pos, cigar, rnext, pnext, seq, score = ([] for _ in range(9))
    malformed = 0
    for line in text.splitlines():
        if not line or line[0] == "@":
            continue
        f = line.split("\t")
        if len(f) < 12 or not f[-1].startswith("AS:f:"):
            malformed += 1
            continue
        try:
            row = (int(f[1]), int(f[3]) - 1, int(f[7]), float(f[-1][5:]))
        except ValueError:
            malformed += 1
            continue
        qname.append(f[0])
        rname.append(f[2])
        cigar.append(f[5])
        rnext.append(f[6])
        seq.append(f[9])
        flag.append(row[0])
        pos.append(row[1])
        pnext.append(row[2])
        score.append(row[3])
    return Rows(qname, np.array(flag, dtype=np.int64), rname, np.array(pos, dtype=np.int64), cigar, rnext,
                np.array(pnext, dtype=np.int64), seq, np.array(score, dtype=np.float64), malformed)


def blocks(cigar: str) -> list[tuple[int, str]] | None:
    parts = CIGAR.findall(cigar)
    if "".join(n + op for n, op in parts) != cigar:
        return None
    return [(int(n), op) for n, op in parts]


def ref_span(cigar_blocks) -> int:
    return sum(n for n, op in cigar_blocks if op in "MD")


def row_penalties(rows: Rows, ref: np.ndarray, contig: str, pen: dict) -> np.ndarray:
    """Each row's penalty in tenths, worked out from the reference; -1 where
    the row cannot be an alignment (another contig, a malformed CIGAR, a
    CIGAR that does not consume SEQ, bases outside the contig)."""
    out = np.full(len(rows.qname), -1, dtype=np.int64)
    full = {}
    for i, (cig, seq) in enumerate(zip(rows.cigar, rows.seq)):
        if rows.rname[i] != contig:
            continue
        if cig == f"{len(seq)}M":
            full.setdefault(len(seq), []).append(i)
            continue
        parsed = blocks(cig)
        if parsed is None or sum(n for n, op in parsed if op in "MIS") != len(seq):
            continue
        q = encode(seq)
        qi, ri, total = 0, int(rows.pos[i]), 0
        if ri < 0 or ri + ref_span(parsed) > ref.shape[0]:
            continue
        for n, op in parsed:
            if op == "M":
                total += int(((q[qi : qi + n] & ref[ri : ri + n]) == 0).sum()) * pen["mutation"]
                qi, ri = qi + n, ri + n
            elif op == "I":
                total += pen["ins_open"] + n * pen["ins_ext"]
                qi += n
            elif op == "D":
                total += pen["del_open"] + n * pen["del_ext"]
                ri += n
            else:  # S: query bases past a contig's end
                total += n * pen["unaligned"]
                qi += n
        out[i] = total
    for length, idx in full.items():
        idx = np.array(idx)
        pos = rows.pos[idx]
        ok = (pos >= 0) & (pos + length <= ref.shape[0])
        idx, pos = idx[ok], pos[ok]
        q = ENCODE[np.frombuffer("".join(rows.seq[i] for i in idx).encode("ascii"), dtype=np.uint8)]
        r = ref[pos[:, None] + np.arange(length)[None, :]]
        out[idx] = ((q.reshape(-1, length) & r) == 0).sum(axis=1) * pen["mutation"]
    return out


def mate_faults(rows: Rows) -> np.ndarray:
    """Rows whose pairing fields break the SAM specification: a proper pair
    is two rows in turn, first then second mate, each naming the other's
    contig, position and strand; a row whose mate is unmapped names none."""
    bad = np.zeros(len(rows.qname), dtype=bool)
    i = 0
    n = len(rows.qname)
    while i < n:
        f = int(rows.flag[i])
        if not f & FLAG_PAIRED:
            i += 1
            continue
        if f & FLAG_MATE_UNMAPPED:
            bad[i] = rows.rnext[i] != "*" or rows.pnext[i] != 0 or bool(f & FLAG_PROPER)
            i += 1
            continue
        j = i + 1
        if not (f & FLAG_PROPER and f & FLAG_FIRST and j < n):
            bad[i] = True
            i += 1
            continue
        g = int(rows.flag[j])
        ok = (g & FLAG_PAIRED and g & FLAG_PROPER and g & FLAG_SECOND
              and rows.qname[i].rsplit("/", 1)[0] == rows.qname[j].rsplit("/", 1)[0])
        for a, b in ((i, j), (j, i)):
            fa, fb = int(rows.flag[a]), int(rows.flag[b])
            ok = ok and rows.rnext[a] == rows.rname[b] and rows.pnext[a] == rows.pos[b] + 1
            ok = ok and bool(fa & FLAG_MATE_REVERSE) == bool(fb & FLAG_REVERSE)
        bad[i] = bad[j] = not ok
        i += 2
    return bad


def seq_faults(rows: Rows, names: dict, texts: list[str]) -> np.ndarray:
    """Rows whose read is unknown or whose SEQ is not that read on the strand
    the flag states."""
    bad = np.zeros(len(rows.qname), dtype=bool)
    for i, (name, seq) in enumerate(zip(rows.qname, rows.seq)):
        k = names.get(name)
        if k is None:
            bad[i] = True
            continue
        text = texts[k]
        if rows.flag[i] & FLAG_REVERSE:
            text = decode(reverse_complement(encode(text)))
        bad[i] = seq != text
    return bad
