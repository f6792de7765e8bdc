"""The per-position summaries worked out again from the SAM's alignments.

The SAM's rows are first held against the reference (`sam.py`); this
module then sums what each row says about each reference position, as
X-Mapper's MatchDatabase defines it, and writes the mutations and VCF lines
that sum must give (the formats of X-Mapper's MutationsWriter and of the
port's VCF writer, copied here and frozen):

- a read with N alignment choices gives each 1/N; a pair's choices are
  pairs of rows, and where both mates cover a position each gives half;
- a base within `end_fraction` of either end of its read counts as
  "end", any other as "middle";
- a deleted reference base counts as a deletion allele; a deletion that
  starts in the middle of a read also counts as a deletion start;
- an insertion counts at the reference position it precedes, keyed by its
  inserted text."""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from portbench.generate import DECODE, ENCODE
from portbench.reference.sam import FLAG_MATE_UNMAPPED, FLAG_PAIRED, Rows, blocks, ref_span

ROW_DEL = 5
ROW_CHARS = "ACGTN-"
CODE_TO_ROW = np.full(16, 4, dtype=np.int64)
CODE_TO_ROW[[1, 2, 4, 8]] = [0, 1, 2, 3]


@dataclass
class Pileup:
    middle: np.ndarray  # [6, n] weights
    end: np.ndarray
    deletion_start_middle: np.ndarray  # [n]
    insertions: dict = field(default_factory=dict)  # (pos, text) -> [middle, end]


def row_weights(rows: Rows) -> tuple[np.ndarray, list[tuple[int, int] | None]]:
    """Each row's weight (1 over its read's or pair's choices) and, for a
    row of a proper pair, the reference range both mates cover."""
    n = len(rows.qname)
    weight = np.zeros(n)
    overlap: list[tuple[int, int] | None] = [None] * n
    groups: dict[str, list[list[int]]] = {}
    i = 0
    while i < n:
        f = int(rows.flag[i])
        if f & FLAG_PAIRED and not f & FLAG_MATE_UNMAPPED and i + 1 < n:
            key = "pair:" + rows.qname[i].rsplit("/", 1)[0]
            groups.setdefault(key, []).append([i, i + 1])
            i += 2
        else:
            groups.setdefault(rows.qname[i], []).append([i])
            i += 1
    for choices in groups.values():
        for choice in choices:
            weight[choice] = 1.0 / len(choices)
            if len(choice) == 2 and rows.rname[choice[0]] == rows.rname[choice[1]]:
                spans = []
                for r in choice:
                    parsed = blocks(rows.cigar[r]) or []
                    spans.append((int(rows.pos[r]), int(rows.pos[r]) + ref_span(parsed)))
                lo, hi = max(s for s, _ in spans), min(e for _, e in spans)
                if lo < hi:
                    overlap[choice[0]] = overlap[choice[1]] = (lo, hi)
    return weight, overlap


def pileup(rows: Rows, usable: np.ndarray, ref_len: int, end_fraction: float) -> Pileup:
    """Sums the `usable` rows (those `sam.row_penalties` could place)."""
    weight, overlap = row_weights(rows)
    bins = {0: [], 1: []}  # middle / end: (allele rows, positions, weights)
    starts = []
    insertions: dict = {}
    full_idx = {}
    for i in np.nonzero(usable)[0].tolist():
        seq = rows.seq[i]
        if rows.cigar[i] == f"{len(seq)}M" and overlap[i] is None:
            full_idx.setdefault(len(seq), []).append(i)
            continue
        q = ENCODE[np.frombuffer(seq.encode("ascii"), dtype=np.uint8)]
        length = len(seq)
        margin = end_fraction * length
        w0 = weight[i]
        lohi = overlap[i]
        qi, ri = 0, int(rows.pos[i])
        for n, op in blocks(rows.cigar[i]):
            if op == "M":
                q_idx = np.arange(qi, qi + n)
                r_idx = np.arange(ri, ri + n)
                is_end = np.minimum(q_idx, length - 1 - q_idx) < margin
                w = np.full(n, w0)
                if lohi is not None:
                    w = np.where((r_idx >= lohi[0]) & (r_idx < lohi[1]), w0 * 0.5, w)
                alleles = CODE_TO_ROW[q[q_idx]]
                bins[0].append((alleles[~is_end], r_idx[~is_end], w[~is_end]))
                bins[1].append((alleles[is_end], r_idx[is_end], w[is_end]))
                qi, ri = qi + n, ri + n
            elif op == "D":
                r_idx = np.arange(ri, ri + n)
                is_end = min(qi, length - qi) < margin
                w = np.full(n, w0)
                if lohi is not None:
                    w = np.where((r_idx >= lohi[0]) & (r_idx < lohi[1]), w0 * 0.5, w)
                bins[1 if is_end else 0].append((np.full(n, ROW_DEL), r_idx, w))
                if not is_end:
                    starts.append((ri, w[0]))
                ri += n
            elif op == "I":
                text = seq[qi : qi + n]
                is_end = min(qi, length - qi) < margin
                w = w0
                if lohi is not None and lohi[0] <= ri < lohi[1]:
                    w = w0 * 0.5
                entry = insertions.setdefault((ri, text), [0.0, 0.0])
                entry[1 if is_end else 0] += w
                qi += n
            else:  # S: not aligned, not counted
                qi += n
    for length, idx in full_idx.items():
        idx = np.array(idx)
        q = ENCODE[np.frombuffer("".join(rows.seq[i] for i in idx).encode("ascii"), dtype=np.uint8)]
        q = q.reshape(-1, length)
        q_idx = np.arange(length)
        is_end = np.minimum(q_idx, length - 1 - q_idx) < end_fraction * length
        r_idx = rows.pos[idx][:, None] + q_idx[None, :]
        w = np.broadcast_to(weight[idx][:, None], q.shape)
        alleles = CODE_TO_ROW[q]
        bins[0].append((alleles[:, ~is_end].ravel(), r_idx[:, ~is_end].ravel(), w[:, ~is_end].ravel()))
        bins[1].append((alleles[:, is_end].ravel(), r_idx[:, is_end].ravel(), w[:, is_end].ravel()))
    sums = []
    for k in (0, 1):
        if bins[k]:
            a, p, w = (np.concatenate(x) for x in zip(*bins[k]))
            sums.append(np.bincount(a * ref_len + p, weights=w, minlength=6 * ref_len).reshape(6, ref_len))
        else:
            sums.append(np.zeros((6, ref_len)))
    dsm = np.zeros(ref_len)
    for pos, w in starts:
        dsm[pos] += w
    return Pileup(sums[0], sums[1], dsm, insertions)


def format_number(x: float) -> str:
    """Depths and fractions: integers without a decimal point, else at most
    six decimals."""
    if x == int(x):
        return str(int(x))
    return repr(round(float(x), 6)).rstrip("0").rstrip(".")


def mutation_lines(p: Pileup, ref: np.ndarray, contig: str, t: dict) -> list[str]:
    """The mutations file's rows (without its header), in its order, under
    the thresholds `t` (MutationDetectionParameters)."""
    n = ref.shape[0]
    totals = p.middle[:ROW_DEL].sum(axis=0) + p.end[:ROW_DEL].sum(axis=0)
    combined = p.middle + p.end
    middle_totals = p.middle.sum(axis=0)
    ref_chars = DECODE[ref]
    rows = []
    for row in range(4):
        code = [1, 2, 4, 8][row]
        weights = combined[row]
        for pos in np.nonzero((weights > 0) & (ref != code))[0].tolist():
            depth = totals[pos] + combined[ROW_DEL, pos]
            support = weights[pos]
            if depth < t["min_snp_total_depth"] or depth <= 0 or support / depth < t["min_snp_depth_fraction"]:
                continue
            rows.append((pos, 1, f"{contig}\t{pos + 1}\t{chr(ref_chars[pos])}\t{ROW_CHARS[row]}\t"
                                 f"{format_number(depth)}\t{format_number(support / depth)}"))
    del_middle = p.middle[ROW_DEL]
    for start in np.nonzero(p.deletion_start_middle > 0)[0].tolist():
        support = p.deletion_start_middle[start]
        depth = middle_totals[start]
        if (depth < t["min_indel_total_start_depth"] or depth <= 0
                or support / depth < t["min_indel_start_depth_fraction"]):
            continue
        end = start + 1
        while end < n and del_middle[end] > 0:
            cd, cs = middle_totals[end], del_middle[end]
            if (cd < t["min_indel_continuation_total_depth"] or cd <= 0
                    or cs / cd < t["min_indel_continuation_depth_fraction"]):
                break
            end += 1
        text = DECODE[ref[start:end]].tobytes().decode("ascii")
        rows.append((start, 2, f"{contig}\t{start + 1}\t{text}\t{'-' * (end - start)}\t"
                               f"{format_number(depth)}\t{format_number(support / depth)}"))
    for (pos, text), (mid_w, _end_w) in sorted(p.insertions.items()):
        if mid_w <= 0:
            continue
        depth = max(middle_totals[pos] if pos < n else middle_totals[n - 1], mid_w)
        if depth < t["min_indel_total_start_depth"] or depth <= 0 or mid_w / depth < t["min_indel_start_depth_fraction"]:
            continue
        rows.append((pos, 0, f"{contig}\t{pos}\t{'-' * len(text)}\t{text}\t"
                             f"{format_number(depth)}\t{format_number(mid_w / depth)}"))
    return [line for _, _, line in sorted(rows, key=lambda r: (r[0], r[1]))]


def _levels(x: np.ndarray):
    """(distinct values, each element's index among them); depths are
    nearly always whole or half numbers, which need no sort."""
    twice = x * 2
    if np.array_equal(np.floor(twice), twice):
        idx = twice.astype(np.int64)
        return np.arange(int(idx.max(initial=0)) + 1) / 2.0, idx
    return np.unique(x, return_inverse=True)


def vcf_lines(p: Pileup, ref: np.ndarray, contig: str, min_depth: float) -> list[str]:
    """The VCF's rows (without its header): one per covered position of at
    least `min_depth`, observed alleles as allele=middle+end, insertions
    after them as ins:TEXT=middle+end, the support column '.'."""
    middle_depth = p.middle.sum(axis=0)
    end_depth = p.end.sum(axis=0)
    total = middle_depth + end_depth
    present = (p.middle > 0) | (p.end > 0)
    ins_by_pos: dict[int, list] = {}
    for (pos, text), (mid_w, end_w) in p.insertions.items():
        ins_by_pos.setdefault(pos, []).append((text, mid_w, end_w))
    keep = np.nonzero((total > 0) & (total >= min_depth))[0]
    ref_chars = DECODE[ref[keep]].tobytes().decode("ascii")
    mid_c, end_c = middle_depth[keep].tolist(), end_depth[keep].tolist()
    cache: dict[float, str] = {}

    def fmt(v: float) -> str:
        s = cache.get(v)
        if s is None:
            s = cache[v] = format_number(v)
        return s

    # a position whose one allele is its reference base has one of few texts:
    # built once per distinct (base, middle, end) and gathered
    n_alleles = present[:, keep].sum(axis=0)
    ref_rows = CODE_TO_ROW[ref[keep]]
    simple = (n_alleles == 1) & present[ref_rows, keep]
    if ins_by_pos:
        simple &= ~np.isin(keep, np.fromiter(ins_by_pos, dtype=np.int64))
    mid_u, mid_i = _levels(middle_depth[keep])
    end_u, end_i = _levels(end_depth[keep])
    key = (ref_rows * mid_u.shape[0] + mid_i) * end_u.shape[0] + end_i
    key_u, key_i = np.unique(key, return_inverse=True)
    texts = []
    for k in key_u.tolist():
        e, rest = k % end_u.shape[0], k // end_u.shape[0]
        rc, m, e = ROW_CHARS[rest // mid_u.shape[0]], fmt(float(mid_u[rest % mid_u.shape[0]])), fmt(float(end_u[e]))
        texts.append(f"\t{rc}\t{m}\t{e}\t{rc}={m}+{e}\t.")
    prefix = contig + "\t"
    lines = [prefix + pos + text for pos, text in
             zip(map(str, (keep + 1).tolist()), np.array(texts, dtype=object)[key_i].tolist())]
    cplx = np.nonzero(~simple)[0]
    mids, ends = p.middle[:, keep[cplx]].T.tolist(), p.end[:, keep[cplx]].T.tolist()
    for k, mid6, end6 in zip(cplx.tolist(), mids, ends):
        pos = int(keep[k])
        alleles = [f"{ROW_CHARS[r]}={fmt(mid6[r])}+{fmt(end6[r])}" for r in range(6) if mid6[r] + end6[r] > 0]
        alleles += [f"ins:{text}={fmt(m)}+{fmt(e)}" for text, m, e in ins_by_pos.get(pos, [])]
        lines[k] = (f"{contig}\t{pos + 1}\t{ref_chars[k]}\t{fmt(mid_c[k])}\t{fmt(end_c[k])}\t"
                    f"{';'.join(alleles)}\t.")
    return lines
