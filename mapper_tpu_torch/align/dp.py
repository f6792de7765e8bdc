"""The exact local aligner: ungapped check + optimal gapped DP.

This is the semantic core of candidate extension.  It reproduces the observable
behavior of the reference's LocalAligner chain
(StraightAligner -> SkipHighAmbiguity_Aligner -> HashBlock_Aligner ->
BlockAligner -> ... -> PathAligner; QueryMatch_Aligner.buildAligner,
QueryMatch_Aligner.java:18-29) with a direct formulation:

- StraightAligner's semantics (StraightAligner.java:13-71): compute the
  ungapped alignment at the predicted offset; prefer it on ties; only search
  for gapped alignments with a budget capped at the ungapped penalty rate.
- SkipHighAmbiguity (SkipHighAmbiguity_Aligner.java:13-27): no indel search
  when >= 1/4 of the reference section is ambiguous (integer division — note
  sections shorter than 4 bases never get an indel search).
- PathAligner's semantics (PathAligner.java): optimal glocal alignment of the
  query section into the reference window under the penalty model, with
    * free leading/trailing reference overhangs,
    * query bases hanging past a contig end charged UnalignedPenalty each and
      reported as unaligned tails (PathAligner.java:120-150, 592-595),
    * the new-indel pruning rules next to mismatches / before perfect matches
      (java:597-667) which canonicalize equal-penalty paths,
    * traceback preferring insertion, then deletion, then diagonal runs with
      maximal-extension walks (java:195-264),
    * right-shift indel justification (justify, java:307-352).
  The reference reaches the same optimum through a chain of bound-proving
  heuristics (HashBlock_Aligner) and divide-and-conquer (BlockAligner); here a
  single exact DP replaces them — the TPU path batches this same DP as a
  Pallas kernel and the heuristics become batched masked filters.

The search direction heuristic (PathAligner.chooseSearchReverse, java:17-53)
is reproduced because which query end may hang off a contig edge depends on it;
a reverse search runs the same forward DP on reversed sequences and mirrors the
result.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from mapper_tpu_torch import basepairs
from mapper_tpu_torch.align.blocks import (
    AlignedBlock,
    SequenceAlignment,
    new_sequence_alignment,
)
from mapper_tpu_torch.sequence import Sequence

DISALLOWED = 1000000.0  # PathAligner.java:771


@dataclass
class AlignmentAnalysis:
    """AlignmentAnalysis.java: hints threaded through the aligner chain."""

    predicted_best_offset: int = 0
    confident_about_best_offset: bool = False
    max_insertion_extension_penalty: float = 0.0
    max_deletion_extension_penalty: float = 0.0


def straight_alignment(
    query: Sequence,
    ref: Sequence,
    q_start: int,
    q_end: int,
    r_start: int,
    r_end: int,
    offset: int,
    params,
    reference_reversed: bool,
) -> SequenceAlignment | None:
    """The ungapped alignment at a fixed offset, clamped to the window
    (StraightAligner.straightAlignment, java:73-94)."""
    qs, qe, rs, re = q_start, q_end, r_start, r_end
    if qs + offset > rs:
        rs = qs + offset
    else:
        qs = rs - offset
    if qe + offset < re:
        re = qe + offset
    else:
        qe = re - offset
    if qe <= qs:
        return None
    block = AlignedBlock(query, ref, qs, rs, qe - qs, re - rs)
    return new_sequence_alignment([block], reference_reversed, params)


def _choose_search_reverse(
    qc: np.ndarray, rc: np.ndarray, diagonal: int, overlap_length: int
) -> bool:
    """PathAligner.chooseSearchReverse (java:17-53): search from the end where
    mismatches are denser; defaults to reverse."""
    i = np.arange(overlap_length, dtype=np.int64)
    j = i - diagonal
    valid = (j >= 0) & (j < rc.shape[0])
    iv = i[valid]
    mism = (qc[iv] & rc[j[valid]]) == 0
    n_mismatch = int(np.count_nonzero(mism))
    n_match = int(iv.shape[0]) - n_mismatch
    if n_mismatch > 1 and n_match > 1:
        sum_mismatch = int(iv[mism].sum())
        sum_match = int(iv.sum()) - sum_mismatch
        return (sum_mismatch // n_mismatch) > (sum_match // n_match)
    return True


def _forward_dp(
    qc: np.ndarray,
    rc: np.ndarray,
    params,
    may_extend: bool,
    max_ins_ext: float,
):
    """Fill the DP tables in forward orientation.  Returns (best, insx, insy).

    Cell (x, y) = x query chars and y reference chars consumed.  Mirrors
    PathAligner.computeUpdated (java:573-719) including the new-indel pruning
    rules and the unaligned-query rule at the last reference row."""
    n = qc.shape[0]
    m = rc.shape[0]
    codes = np.arange(16, dtype=np.uint8)
    sub = params.base_penalty(codes[:, None], codes[None, :]).astype(np.float64)

    best = np.full((n + 1, m + 1), DISALLOWED)
    insx = np.full((n + 1, m + 1), DISALLOWED)
    insy = np.full((n + 1, m + 1), DISALLOWED)

    start_ins_start = params.get_starting_insertion_start_penalty()
    ins_open = params.insertion_start_penalty + params.insertion_extension_penalty
    ins_ext = params.insertion_extension_penalty
    del_open = params.deletion_start_penalty + params.deletion_extension_penalty
    del_ext = params.deletion_extension_penalty
    unaligned = params.unaligned_penalty

    # initial nodes (PathAligner.java:120-150)
    if m >= n:
        best[0, 0 : m - n + 1] = 0.0
        insx[0, 0 : m - n + 1] = start_ins_start if may_extend else DISALLOWED
    else:
        best[0 : n - m + 1, 0] = 0.0
    if may_extend:
        init_ins_count = int(max_ins_ext / params.deletion_extension_penalty)
        for i in range(1, min(init_ins_count, n + 1)):
            best[i, 0] = i * unaligned  # saveNode overwrites (java:141-150,523-538)
            insx[i, 0] = DISALLOWED
            insy[i, 0] = DISALLOWED

    pen = sub[qc[:, None], rc[None, :]]  # pen[x-1, y-1]
    match_ok = basepairs.can_match(qc[:, None], rc[None, :])  # [x-1, y-1]
    fully_amb_q = basepairs.is_fully_ambiguous(qc)
    fully_amb_r = basepairs.is_fully_ambiguous(rc)

    # new-insertion allowed masks per (x, y), x,y in 1..n / 1..m
    # (PathAligner.java:597-628 for insX; 640-667 for insY)
    allow_new_x = np.ones((n + 1, m + 1), dtype=bool)
    # prev: query[x-2] vs ref[y-1] mismatched -> disallow
    if n >= 2:
        allow_new_x[2:, 1:] &= match_ok[:-1, :]
    # next: query[x-1] vs ref[y] perfect or fully ambiguous -> disallow
    nx = (pen == 0) | fully_amb_q[:, None] | fully_amb_r[None, :]  # [x-1, y]
    allow_new_x[1:, 1:m] &= ~nx[:, 1:]

    allow_new_y = np.ones((n + 1, m + 1), dtype=bool)
    # prev: query[x-1] vs ref[y-2] mismatched -> disallow
    if m >= 2:
        allow_new_y[1:, 2:] &= match_ok[:, :-1]
    # next: query[x] vs ref[y-1] perfect or fully ambiguous -> disallow
    ny = (pen == 0) | fully_amb_q[:, None] | fully_amb_r[None, :]  # [x, y-1]
    allow_new_y[1:n, 1:] &= ~ny[1:, :]

    for x in range(1, n + 1):
        prev_best = best[x - 1]
        prev_insx = insx[x - 1]
        # insX row (vectorized): from the left neighbor in x
        new_ins = np.where(allow_new_x[x, 1:], prev_best[1:] + ins_open, DISALLOWED)
        ext_ins = prev_insx[1:] + ins_ext
        row_insx = np.minimum(new_ins, ext_ins)
        if may_extend and m >= 1:
            row_insx[m - 1] = prev_best[m] + unaligned  # java:592-595
        insx[x, 1:] = row_insx
        overlay = prev_best[:-1] + pen[x - 1]

        # sequential y-scan coupling best and insY
        row_best = best[x]
        row_insy = insy[x]
        b_prev = row_best[0]
        iy_prev = row_insy[0]
        for y in range(1, m + 1):
            new_del = b_prev + del_open if allow_new_y[x, y] else DISALLOWED
            iy = min(new_del, iy_prev + del_ext)
            b = min(overlay[y - 1], row_insx[y - 1], iy)
            row_insy[y] = iy
            row_best[y] = b
            b_prev = b
            iy_prev = iy

    return best, insx, insy


def _traceback(
    best: np.ndarray,
    insx: np.ndarray,
    insy: np.ndarray,
    goal_y: int,
    params,
    may_extend: bool,
):
    """Walk back from (n, goal_y) collecting (start_a, start_b, len_a, len_b)
    in reverse order (PathAligner.java:195-264).  Unaligned-tail steps (the
    may_extend rule at the last reference row) produce no blocks."""
    n = best.shape[0] - 1
    m = best.shape[1] - 1
    ins_open = params.insertion_start_penalty + params.insertion_extension_penalty
    ins_ext = params.insertion_extension_penalty
    del_open = params.deletion_start_penalty + params.deletion_extension_penalty
    del_ext = params.deletion_extension_penalty

    i, j = n, goal_y
    blocks: list[tuple[int, int, int, int]] = []

    # trailing unaligned query bases at the end of the contig: consume without
    # emitting blocks (they are charged UnalignedPenalty by the final accounting)
    while i != 0 and j == m and may_extend and best[i, j] == insx[i, j]:
        expected = best[i - 1, j] + params.unaligned_penalty
        if insx[i, j] != expected:
            break
        i -= 1

    while i != 0 and j != 0:
        b = best[i, j]
        if b == insx[i, j] and not (j == m and may_extend):
            old_i = i
            i -= 1
            while i != 0:
                other_new = best[i, j] + ins_open
                other_ext = insx[i, j] + ins_ext
                if other_new < other_ext:
                    break
                i -= 1
            blocks.append((i, j, old_i - i, 0))
        elif b == insx[i, j] and j == m and may_extend:
            # unaligned trailing step not caught above (mixed path): no block
            i -= 1
        elif b == insy[i, j]:
            old_j = j
            j -= 1
            while j != 0:
                other_new = best[i, j] + del_open
                other_ext = insy[i, j] + del_ext
                if other_new < other_ext:
                    break
                j -= 1
            blocks.append((i, j, 0, old_j - j))
        else:
            old_i, old_j = i, j
            i -= 1
            j -= 1
            while i != 0 and j != 0:
                if best[i, j] == insx[i, j] or best[i, j] == insy[i, j]:
                    break
                i -= 1
                j -= 1
            blocks.append((i, j, old_i - i, old_j - j))
    blocks.reverse()
    return blocks


def _justify(blocks: list[AlignedBlock], params) -> list[AlignedBlock]:
    """Right-shift indels across equal characters (PathAligner.justify,
    java:307-352) so equal-penalty placements are canonical."""
    sections = list(blocks)
    i = 1
    while i < len(sections) - 1:
        while True:
            left = sections[i - 1]
            middle = sections[i]
            right = sections[i + 1]
            if (middle.length_a > 0) == (middle.length_b > 0):
                break  # not an indel
            if left.length_a == 0 or left.length_b == 0:
                break
            if right.length_a == 0 or right.length_b == 0:
                break
            if middle.length_a > 0:
                # insertion: shift right across matching A chars
                if (
                    left.sequence_a.codes[left.end_a - 1]
                    != middle.sequence_a.codes[middle.end_a - 1]
                ):
                    break
            else:
                # deletion: shift right across matching B chars
                if (
                    left.sequence_b.codes[left.end_b - 1]
                    != middle.sequence_b.codes[middle.end_b - 1]
                ):
                    break
            sections[i - 1] = AlignedBlock(
                left.sequence_a,
                left.sequence_b,
                left.start_a,
                left.start_b,
                left.length_a - 1,
                left.length_b - 1,
            )
            sections[i] = AlignedBlock(
                middle.sequence_a,
                middle.sequence_b,
                middle.start_a - 1,
                middle.start_b - 1,
                middle.length_a,
                middle.length_b,
            )
            sections[i + 1] = AlignedBlock(
                right.sequence_a,
                right.sequence_b,
                right.start_a - 1,
                right.start_b - 1,
                right.length_a + 1,
                right.length_b + 1,
            )
        i += 1
    # drop removable leading sections (PathAligner.canRemoveSection, java:358-366)
    while sections and _can_remove(sections[0]):
        sections.pop(0)
    return sections


def _can_remove(block: AlignedBlock) -> bool:
    if block.length_a <= 0 and block.length_b <= 0:
        return True
    if (block.start_a <= 0 and block.length_a <= 0) or (
        block.start_b <= 0 and block.length_b <= 0
    ):
        return True
    return False


def _run_dp(qc, rc, params, may_extend, max_ins_ext, max_interesting):
    """Fill + traceback, via the native library when available (the numpy
    implementation is the semantic oracle; tests assert block equality).
    Returns blocks in start->goal order, or None when no alignment fits."""
    import os

    if os.environ.get("MAPPER_TPU_NATIVE", "1") != "0":
        from mapper_tpu_torch.native import native_dp_align

        native = native_dp_align(qc, rc, params, may_extend, max_ins_ext, max_interesting)
        if native is not None:
            blocks, _goal = native
            if blocks.shape[0] == 0:
                return None
            return [tuple(int(v) for v in row) for row in blocks[::-1]]

    best, insx, insy = _forward_dp(qc, rc, params, may_extend, max_ins_ext)
    n = qc.shape[0]
    goals = best[n, :]
    goal_y = int(np.argmin(goals))  # tie -> smallest y (first goal reached)
    goal_penalty = float(goals[goal_y])
    if goal_penalty > max_interesting + 0.000001:
        return None
    raw = _traceback(best, insx, insy, goal_y, params, may_extend)
    return raw if raw else None


def path_align(
    query: Sequence,
    ref: Sequence,
    q_start: int,
    q_end: int,
    r_start: int,
    r_end: int,
    params,
    analysis: AlignmentAnalysis,
    reference_reversed: bool,
) -> SequenceAlignment | None:
    """Optimal gapped alignment of query[q_start:q_end] into ref[r_start:r_end]
    (PathAligner.align semantics)."""
    qc = query.codes[q_start:q_end]
    rc = ref.codes[r_start:r_end]
    n, m = qc.shape[0], rc.shape[0]
    if n == 0 or m == 0:
        return None
    max_interesting = n * params.max_error_rate

    diagonal = r_start - (q_start + analysis.predicted_best_offset)
    overlap_start = max(q_start, r_start - analysis.predicted_best_offset)
    overlap_end = min(q_end, r_end - analysis.predicted_best_offset)
    overlap_length = max(0, overlap_end - overlap_start)
    search_reverse = _choose_search_reverse(qc, rc, diagonal, overlap_length)

    if search_reverse:
        may_extend = r_start == 0
        dp_q, dp_r = qc[::-1], rc[::-1]
    else:
        may_extend = r_end == len(ref)
        dp_q, dp_r = qc, rc

    raw = _run_dp(
        dp_q,
        dp_r,
        params,
        may_extend,
        analysis.max_insertion_extension_penalty,
        max_interesting,
    )
    if raw is None or not raw:
        return None

    blocks: list[AlignedBlock] = []
    if search_reverse:
        # mirror reversed-local coordinates back to forward-local
        for (sa, sb, la, lb) in reversed(raw):
            fa = n - (sa + la)
            fb = m - (sb + lb)
            blocks.append(
                AlignedBlock(query, ref, q_start + fa, r_start + fb, la, lb)
            )
    else:
        for (sa, sb, la, lb) in raw:
            blocks.append(AlignedBlock(query, ref, q_start + sa, r_start + sb, la, lb))

    sections = _justify(blocks, params)
    if not sections:
        return None
    result = new_sequence_alignment(sections, reference_reversed, params)
    # final rounding-error check (PathAligner.java:286-291)
    if result.get_aligned_penalty() > max_interesting + 0.000001:
        return None
    return result


def local_align(
    query: Sequence,
    ref: Sequence,
    q_start: int,
    q_end: int,
    r_start: int,
    r_end: int,
    params,
    analysis: AlignmentAnalysis,
) -> SequenceAlignment | None:
    """The full LocalAligner-chain semantics: ungapped first with ties broken
    toward no indels (StraightAligner.java:13-71), then the exact gapped DP."""
    # "reference reversed" is tracked via whether sequence A is the
    # reverse-complement query (StraightAligner.java:93, PathAligner.java:351)
    reference_reversed = query.complemented_from is not None
    max_interesting = (q_end - q_start) * params.max_error_rate

    # native fast path: the whole local_align (straight + gapped DP + justify
    # + penalty accounting) in one C call, bit-identical to the Python path
    # below (numpy-exact pairwise penalty sums; differential tests in
    # tests/test_native_local_align.py).  Applicable whenever the analysis
    # budgets follow _align_match_uncached's formula (the only caller).
    import os as _os

    if (
        q_start == 0
        and q_end == len(query)
        and _os.environ.get("MAPPER_TPU_NATIVE", "1") != "0"
        and analysis.max_insertion_extension_penalty
        == max_interesting - params.insertion_start_penalty
        and analysis.max_deletion_extension_penalty
        == max_interesting - params.deletion_start_penalty
    ):
        from mapper_tpu_torch.native import native_local_align_one

        res = native_local_align_one(
            query.codes,
            ref.codes,
            r_start,
            r_end,
            analysis.predicted_best_offset,
            r_start == 0,
            r_end == len(ref),
            analysis.confident_about_best_offset,
            params.max_error_rate,
            params,
        )
        if res is not None:
            status, rows, total, aligned = res
            if status == -1:
                return None
            blocks = [
                AlignedBlock(query, ref, sa, r_start + sb, la, lb)
                for sa, sb, la, lb in rows.tolist()
            ]
            return SequenceAlignment(blocks, reference_reversed, total, aligned)

    simple = straight_alignment(
        query,
        ref,
        q_start,
        q_end,
        r_start,
        r_end,
        analysis.predicted_best_offset,
        params,
        reference_reversed,
    )
    simple_pen = simple.get_aligned_penalty() if simple is not None else float("inf")
    if simple is not None and simple_pen <= 0:
        return simple

    indel_penalty = min(
        params.get_starting_insertion_start_penalty() + params.insertion_extension_penalty,
        params.deletion_start_penalty + params.deletion_extension_penalty,
    )
    if analysis.confident_about_best_offset and simple is not None:
        if simple_pen <= indel_penalty or (
            analysis.max_insertion_extension_penalty <= 0
            and analysis.max_deletion_extension_penalty <= 0
        ):
            return simple if simple_pen <= max_interesting else None
        if indel_penalty > max_interesting:
            return None

    # SkipHighAmbiguity (java:13-27): integer division threshold
    ref_section = ref.codes[r_start:r_end]
    num_amb = int(np.count_nonzero(basepairs.is_ambiguous(ref_section)))
    gapped = None
    if num_amb < (r_end - r_start) // 4:
        sub_params = params
        if simple is not None:
            rate = simple_pen / (q_end - q_start)
            if rate < params.max_error_rate:
                sub_params = params.clone(max_error_rate=rate)
        gapped = path_align(
            query, ref, q_start, q_end, r_start, r_end, sub_params, analysis, reference_reversed
        )

    if gapped is None or (simple is not None and gapped.get_aligned_penalty() >= simple_pen):
        if simple is not None and simple_pen <= max_interesting:
            return simple
    return gapped
