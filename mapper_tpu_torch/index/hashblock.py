"""Content-defined multi-scale hashblock/gapmer scheme, vectorized.

This reimplements — bit-for-bit — the deterministic hashing scheme of the
reference (HashBlock.java, HashBlock_BaseRow.java, HashBlock_ParentRow.java,
HashBlock_Stream.java): a "pyramid" of rows where row 0 has one 1-bp block per
position and each next row merges adjacent blocks whose content-derived flags
request it.  Identical substrings always produce identical block patterns and
hashes, which is what makes exact-hash seed lookup work.  Block count decays
~3/4 per row so the total work is O(n) (HashBlock_Stream.java:13-15).

Where the reference walks linked objects one block at a time, this
implementation represents a whole row as a struct-of-arrays and computes the
next row for the entire sequence with numpy — the same data layout the device
index consumes.  Java's 32/64-bit wrapping arithmetic is reproduced exactly
(int64 intermediates with two's-complement truncation back to int32; note the
asymmetric int32 wrap of `rightContentHash + 1` in HashBlock.mergeHashes,
HashBlock.java:261-269).

Ambiguity (IUPAC codes like N) expands into conditional blocks in the reference
(MultiHashBlock.java, HashBlock_ParentRow.java:98-127).  The vectorized path
here handles concrete bases; `scalar.py` contains the faithful object-model
implementation used for sequences containing ambiguity codes and as a
differential-testing oracle.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from mapper_tpu_torch import basepairs

MERGE_MULTIPLIER = 54323
MERGE_LENGTH_MULTIPLIER = 323
GAPMER_MULTIPLIER = 7654337
_GAPMER_MULTIPLIER_INVERSE = pow(GAPMER_MULTIPLIER, -1, 1 << 32)


def max_gapmer_num_basepairs_used(starting_length: int) -> int:
    """HashBlock.getMaxGapmerNumBasepairsUsed (HashBlock.java:11-13)."""
    return starting_length + starting_length * 9 // 8 + 1


def max_gapmer_length(starting_length: int) -> int:
    return starting_length + starting_length * 9 // 4 + 1


@dataclass
class BlockRow:
    """One pyramid row as a struct-of-arrays, sorted by start index.

    `seg` optionally labels which segment (read) each block belongs to when a
    whole batch of reads is processed as one concatenated array; merging never
    crosses segment boundaries."""

    level: int
    start: np.ndarray  # int64[n]
    length: np.ndarray  # int32[n]
    fwd: np.ndarray  # int32[n] forward-content hash
    rev: np.ndarray  # int32[n] reverse-complement-content hash
    req_l: np.ndarray  # bool[n] requestMergeLeft
    req_r: np.ndarray  # bool[n]
    next_l: np.ndarray  # bool[n] nextRequestMergeLeft
    next_r: np.ndarray  # bool[n]
    gap_dir: np.ndarray  # int8[n] -1 left gap, +1 right gap, 0 none
    extra_gapmer: np.ndarray  # int32[n] extraGapmerLength
    seg: np.ndarray | None = None  # int32[n] segment (read) id

    def __len__(self) -> int:
        return int(self.start.shape[0])

    @property
    def end(self) -> np.ndarray:
        return self.start + self.length

    def min_length(self) -> int:
        return int(self.length.min()) if len(self) else 1 << 30


def _i32(x: np.ndarray) -> np.ndarray:
    """Two's-complement truncation to int32 (Java (int) cast)."""
    return x.astype(np.int64).astype(np.uint32).astype(np.int32)


def base_row(codes: np.ndarray, seg: np.ndarray | None = None) -> BlockRow:
    """Row 0: one block per concrete base (HashBlock_BaseRow.java:27-56 non-ambiguous
    branch; hash values per HashBlock.hashChar, HashBlock.java:171-188).

    `codes` must contain only concrete bases (A/C/G/T nibbles); callers with
    ambiguity go through the scalar path.  With `seg`, codes are a batch of
    reads concatenated into one array and blocks carry their read id.
    """
    v = basepairs.TWO_BIT_TABLE[codes].astype(np.int32)
    if np.any(v < 0):
        raise ValueError("base_row requires concrete bases; use the scalar path for ambiguity")
    n = v.shape[0]
    return BlockRow(
        level=0,
        start=np.arange(n, dtype=np.int64),
        length=np.ones(n, dtype=np.int32),
        fwd=v,
        rev=(3 - v).astype(np.int32),
        req_l=v < 2,
        req_r=v >= 2,
        next_l=(v & 1) == 0,
        next_r=(v & 1) == 1,
        gap_dir=np.zeros(n, dtype=np.int8),
        extra_gapmer=np.zeros(n, dtype=np.int32),
        seg=None if seg is None else np.asarray(seg, dtype=np.int32),
    )


def _merge_hashes(l_len, l_hash, r_len, r_hash) -> np.ndarray:
    """HashBlock.mergeHashes(int,int,int,int) (HashBlock.java:261-269), with
    Java's exact overflow behavior."""
    with np.errstate(over="ignore"):
        rotated_left = (l_hash.astype(np.int64) + 1) * (
            MERGE_MULTIPLIER + MERGE_LENGTH_MULTIPLIER * r_len.astype(np.int64)
        )
        # (rightContentHash + 1) wraps in int32 before the widening multiply
        rotated_right = _i32(r_hash.astype(np.int64) + 1).astype(np.int64) * l_len.astype(
            np.int64
        )
        long_top_bits = rotated_left + rotated_right
    return _i32(long_top_bits.astype(np.int64) + (long_top_bits >> np.int64(32)))


def merge_row(row: BlockRow) -> BlockRow:
    """Compute the next pyramid row: each adjacent pair of blocks merges iff
    left.requestMergeRight or right.requestMergeLeft
    (HashBlock_ParentRow.shouldMergeBlocks, java:200-208), with the merged
    block's hashes and merge flags from HashBlock's merging constructor
    (HashBlock.java:20-44, 192-259)."""
    n = len(row)
    if n < 2:
        return BlockRow(
            level=row.level + 1,
            start=np.zeros(0, dtype=np.int64),
            length=np.zeros(0, dtype=np.int32),
            fwd=np.zeros(0, dtype=np.int32),
            rev=np.zeros(0, dtype=np.int32),
            req_l=np.zeros(0, dtype=bool),
            req_r=np.zeros(0, dtype=bool),
            next_l=np.zeros(0, dtype=bool),
            next_r=np.zeros(0, dtype=bool),
            gap_dir=np.zeros(0, dtype=np.int8),
            extra_gapmer=np.zeros(0, dtype=np.int32),
            seg=None if row.seg is None else np.zeros(0, dtype=np.int32),
        )

    # left parent = block i, right parent = block i+1
    l = slice(0, n - 1)
    r = slice(1, n)
    should = (row.end[l] >= row.start[r]) & (row.req_r[l] | row.req_l[r])
    if row.seg is not None:
        should &= row.seg[l] == row.seg[r]  # never merge across reads
    (idx,) = np.nonzero(should)
    li, ri = idx, idx + 1

    l_len = row.length[li]
    r_len = row.length[ri]
    l_fwd = row.fwd[li]
    r_fwd = row.fwd[ri]
    l_rev = row.rev[li]
    r_rev = row.rev[ri]

    start = row.start[li]
    length = (row.start[ri] + row.length[ri] - start).astype(np.int32)
    fwd = _merge_hashes(l_len, l_fwd, r_len, r_fwd)
    rev = _merge_hashes(r_len, r_rev, l_len, l_rev)

    # --- merge-request flags (HashBlock.mergeHashes body, java:196-258) ---
    req_l = np.ones(idx.shape[0], dtype=bool)
    req_r = np.ones(idx.shape[0], dtype=bool)
    next_l = np.ones(idx.shape[0], dtype=bool)
    next_r = np.ones(idx.shape[0], dtype=bool)

    anchor_exists = l_fwd != r_rev
    anchor_is_right = l_fwd > r_rev
    asym = anchor_exists & (fwd != rev)

    is_reverse = fwd < rev
    invert = is_reverse == anchor_is_right

    # anchor parent's next-flags, with the both-true tiebreak
    a_nl = np.where(anchor_is_right, row.next_l[ri], row.next_l[li])
    a_nr = np.where(anchor_is_right, row.next_r[ri], row.next_r[li])
    both = a_nl & a_nr
    a_nr = np.where(both & anchor_is_right, False, a_nr)
    a_nl = np.where(both & ~anchor_is_right, False, a_nl)

    # other parent's next-flags, with the both-true tiebreak
    o_nl = np.where(anchor_is_right, row.next_l[li], row.next_l[ri])
    o_nr = np.where(anchor_is_right, row.next_r[li], row.next_r[ri])
    both_o = o_nl & o_nr
    # other is the right parent when the anchor is the left parent
    o_nl = np.where(both_o & ~anchor_is_right, False, o_nl)
    o_nr = np.where(both_o & anchor_is_right, False, o_nr)

    req_l = np.where(asym, a_nl != invert, req_l)
    req_r = np.where(asym, a_nr != invert, req_r)
    next_l = np.where(asym, o_nl != invert, next_l)
    next_r = np.where(asym, o_nr != invert, next_r)

    diff_len = l_len != r_len
    req_l = np.where(diff_len, l_len > r_len, req_l)
    req_r = np.where(diff_len, ~(l_len > r_len), req_r)
    next_l = np.where(diff_len, ~(l_len > r_len), next_l)
    next_r = np.where(diff_len, l_len > r_len, next_r)

    asym_hash = fwd != rev
    both_req = req_l & req_r
    req_l = np.where(asym_hash & both_req, fwd > rev, req_l)
    req_r = np.where(asym_hash & both_req, ~(fwd > rev), req_r)
    both_next = next_l & next_r
    next_l = np.where(asym_hash & both_next, req_l, next_l)
    next_r = np.where(asym_hash & both_next, ~req_l, next_r)

    # --- gap direction (HashBlock merging constructor, java:26-40) ---
    gap_dir = np.zeros(idx.shape[0], dtype=np.int8)
    req_differ = req_l != req_r
    gap_dir = np.where(req_differ, np.where(req_l, 1, -1), gap_dir).astype(np.int8)
    gap_dir = np.where(
        ~req_differ & anchor_exists, np.where(anchor_is_right, 1, -1), gap_dir
    ).astype(np.int8)

    # extraGapmerLength (java:43): Java int division truncates toward zero
    extra_raw = (l_len.astype(np.int64) + r_len.astype(np.int64) - length.astype(np.int64))
    extra_gapmer = np.where(
        extra_raw >= 0, extra_raw // 4, -((-extra_raw) // 4)
    ).astype(np.int32)

    return BlockRow(
        level=row.level + 1,
        start=start,
        length=length,
        fwd=fwd,
        rev=rev,
        req_l=req_l,
        req_r=req_r,
        next_l=next_l,
        next_r=next_r,
        gap_dir=gap_dir,
        extra_gapmer=extra_gapmer,
        seg=None if row.seg is None else row.seg[li],
    )


class GapmerPrefixes:
    """Precomputed prefix tables over one sequence for O(1)-per-block gapmer
    extension hashes (the polynomial loops of HashBlock.withGapAndExtension,
    HashBlock.java:108-139, evaluated with modular prefix sums in uint32)."""

    def __init__(self, codes: np.ndarray):
        n = codes.shape[0]
        fwd_vals = basepairs.GAPMER_CHAR_VALUE_TABLE[codes].astype(np.uint64)
        comp_vals = basepairs.GAPMER_CHAR_VALUE_TABLE[
            basepairs.COMPLEMENT_TABLE[codes]
        ].astype(np.uint64)

        mod_mask = np.uint64(0xFFFFFFFF)
        b = np.uint64(GAPMER_MULTIPLIER)
        ib = np.uint64(_GAPMER_MULTIPLIER_INVERSE)
        with np.errstate(over="ignore"):
            # cumulative powers mod 2^32: uint64 wraparound preserves the low
            # 32 bits of products (2^32 divides 2^64), so one accumulate + mask
            pow_b = np.full(n + 1, b, dtype=np.uint64)
            pow_b[0] = 1
            np.multiply.accumulate(pow_b, out=pow_b)
            pow_b &= mod_mask
            inv_pow_b = np.full(n + 1, ib, dtype=np.uint64)
            inv_pow_b[0] = 1
            np.multiply.accumulate(inv_pow_b, out=inv_pow_b)
            inv_pow_b &= mod_mask
            # left-gap hash: H = sum_{i in [s,e)} fwd_vals[i] * B^(i - s)
            #              = invB^s * sum fwd_vals[i] * B^i        (mod 2^32)
            r_terms = (fwd_vals * pow_b[:n]) & mod_mask
            self.pref_fwd = np.zeros(n + 1, dtype=np.uint64)
            np.cumsum(r_terms, out=self.pref_fwd[1:])
            self.pref_fwd &= mod_mask
            # right-gap hash: H = sum_{i in [s,e)} comp_vals[i] * B^(e-1-i)
            #              = B^(e-1) * sum comp_vals[i] * invB^i   (mod 2^32)
            s_terms = (comp_vals * inv_pow_b[:n]) & mod_mask
            self.pref_comp = np.zeros(n + 1, dtype=np.uint64)
            np.cumsum(s_terms, out=self.pref_comp[1:])
            self.pref_comp &= mod_mask
        self.pow_b = pow_b
        self.inv_pow_b = inv_pow_b
        self.n = n

    def left_hash(self, ext_start: np.ndarray, ext_end: np.ndarray) -> np.ndarray:
        """Hash of forward chars from ext_end-1 down to ext_start (java:114-121)."""
        mod_mask = np.uint64(0xFFFFFFFF)
        with np.errstate(over="ignore"):
            diff = (self.pref_fwd[ext_end] - self.pref_fwd[ext_start]) & mod_mask
            h = (diff * self.inv_pow_b[ext_start]) & mod_mask
        return h.astype(np.uint32).astype(np.int32)

    def right_hash(self, ext_start: np.ndarray, ext_end: np.ndarray) -> np.ndarray:
        """Hash of complemented chars from ext_start up to ext_end-1 (java:130-137)."""
        mod_mask = np.uint64(0xFFFFFFFF)
        with np.errstate(over="ignore"):
            diff = (self.pref_comp[ext_end] - self.pref_comp[ext_start]) & mod_mask
            e1 = np.maximum(ext_end, 1) - 1
            h = (diff * self.pow_b[e1]) & mod_mask
        return h.astype(np.uint32).astype(np.int32)


@dataclass
class GapmerRow:
    """Gapmers for one pyramid row (aligned with a filtered subset of blocks).

    A gapmer's polarity uses only its hashes — Gapped_HashBlock is constructed
    via HashBlock(int,int) so its merge flags are all false
    (Gapped_HashBlock.java:7-11, HashBlock.isPrimaryPolarity, java:329-340).
    When gap_dir == 0 the original block *is* its own gapmer and keeps its own
    flags (HashBlock.java:103-104).
    """

    start: np.ndarray  # int64: start of the whole gapped shape
    length: np.ndarray  # int32: total span including the gap
    num_basepairs_used: np.ndarray  # int32
    fwd: np.ndarray  # int32
    rev: np.ndarray  # int32
    primary: np.ndarray  # bool: isPrimaryPolarity
    secondary: np.ndarray  # bool: isSecondaryPolarity
    block_index: np.ndarray  # index into the source row's arrays
    is_self: np.ndarray  # bool: gapmer is the ungapped block itself (gap_dir == 0)

    def __len__(self) -> int:
        return int(self.start.shape[0])

    @property
    def lookup_key(self) -> np.ndarray:
        return np.where(self.primary, self.fwd, self.rev)


def expand_gapmers(
    row: BlockRow,
    prefixes: GapmerPrefixes,
    seg_bounds: tuple[np.ndarray, np.ndarray] | None = None,
) -> GapmerRow:
    """Vectorized HashBlock.withGapAndExtension (HashBlock.java:67-150) for every
    block in a row.  Blocks whose extension would run off the sequence are
    dropped (the reference returns null for them).

    For batched (concatenated) input, `seg_bounds` = (starts, ends) arrays
    indexed by segment id bound each block's extension to its own read; the
    modular prefix arithmetic telescopes within a read so global prefixes stay
    exact."""
    n = len(row)
    if seg_bounds is not None and row.seg is not None:
        lo_bound = seg_bounds[0][row.seg]
        hi_bound = seg_bounds[1][row.seg]
    else:
        lo_bound = np.int64(0)
        hi_bound = np.int64(prefixes.n)
    length64 = row.length.astype(np.int64)

    # targetExtraLength = length + |max(fwd, rev)| % 3 + extraGapmerLength, with
    # Java int abs (abs(MIN_VALUE) stays negative) and truncated remainder
    m = np.maximum(row.fwd, row.rev)
    abs_m = _i32(np.abs(m.astype(np.int64)))  # wraps like Java Math.abs(int)
    abs_m64 = abs_m.astype(np.int64)
    rem = np.where(abs_m64 >= 0, abs_m64 % 3, -((-abs_m64) % 3))
    target_extra = length64 + rem + row.extra_gapmer.astype(np.int64)
    gap = length64 // 2
    ext_len = target_extra - gap

    left_gap = row.gap_dir < 0
    right_gap = row.gap_dir > 0
    no_gap = row.gap_dir == 0

    ext_start = np.zeros(n, dtype=np.int64)
    ext_end = np.zeros(n, dtype=np.int64)
    # left gap: extension is before the block
    ext_end_l = row.start - gap
    ext_start_l = ext_end_l - ext_len
    # right gap: extension is after the block
    ext_start_r = row.start + length64 + gap
    ext_end_r = ext_start_r + ext_len
    ext_start = np.where(left_gap, ext_start_l, np.where(right_gap, ext_start_r, 0))
    ext_end = np.where(left_gap, ext_end_l, np.where(right_gap, ext_end_r, 0))

    valid = no_gap | (left_gap & (ext_start >= lo_bound)) | (
        right_gap & (ext_end <= hi_bound)
    )
    (keep,) = np.nonzero(valid)

    k_left = left_gap[keep]
    k_right = right_gap[keep]
    k_no = no_gap[keep]
    k_ext_start = np.clip(ext_start[keep], 0, prefixes.n)
    k_ext_end = np.clip(ext_end[keep], 0, prefixes.n)

    ext_hash = np.zeros(keep.shape[0], dtype=np.int32)
    if np.any(k_left):
        ext_hash = np.where(
            k_left, prefixes.left_hash(k_ext_start, k_ext_end), ext_hash
        )
    if np.any(k_right):
        ext_hash = np.where(
            k_right, prefixes.right_hash(k_ext_start, k_ext_end), ext_hash
        )

    with np.errstate(over="ignore"):
        fwd = np.where(k_no, row.fwd[keep], _i32(row.fwd[keep].astype(np.int64) + ext_hash))
        rev = np.where(k_no, row.rev[keep], _i32(row.rev[keep].astype(np.int64) + ext_hash))

    k_len = length64[keep]
    k_gap = gap[keep]
    k_ext_len = ext_len[keep]
    total_len = np.where(k_no, k_len, k_len + k_gap + k_ext_len).astype(np.int32)
    num_bp = np.where(k_no, k_len, k_len + k_ext_len).astype(np.int32)
    start = np.where(k_left, ext_start[keep], row.start[keep])

    # polarity: gapmers have all-false merge flags so polarity falls through to
    # the hash comparison; ungapped self-gapmers keep the block's flags
    row_req_l = row.req_l[keep]
    row_req_r = row.req_r[keep]
    flags_differ = row_req_l != row_req_r
    primary = np.where(
        k_no & flags_differ, row_req_l, fwd >= rev
    )
    secondary = np.where(
        k_no & flags_differ, row_req_r, fwd <= rev
    )

    return GapmerRow(
        start=start,
        length=total_len,
        num_basepairs_used=num_bp,
        fwd=fwd,
        rev=rev,
        primary=primary,
        secondary=secondary,
        block_index=keep,
        is_self=k_no,
    )


def build_pyramid(codes: np.ndarray, max_level: int | None = None) -> list[BlockRow]:
    """All pyramid rows for a concrete-base sequence, bottom-up, until rows run
    out of blocks (or `max_level` rows have been built)."""
    rows = [base_row(codes)]
    while len(rows[-1]) >= 2:
        if max_level is not None and rows[-1].level >= max_level:
            break
        rows.append(merge_row(rows[-1]))
    return rows
