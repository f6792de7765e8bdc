"""Faithful object-model implementation of the hashblock pyramid.

This mirrors the reference classes one-to-one (HashBlock.java,
HashBlock_BaseRow.java, HashBlock_ParentRow.java, MultiHashBlock.java,
ConditionalHashBlock.java, SequenceCondition.java) including IUPAC-ambiguity
expansion into conditional blocks.  It serves two purposes:

1. the fallback path for sequences containing ambiguity codes (the vectorized
   path in hashblock.py requires concrete bases), and
2. a differential-testing oracle for the vectorized path.

It is deliberately un-optimized; speed comes from the vectorized path.
"""

from __future__ import annotations

import numpy as np

from mapper_tpu_torch import basepairs
from mapper_tpu_torch.index.hashblock import (
    GAPMER_MULTIPLIER,
    MERGE_LENGTH_MULTIPLIER,
    MERGE_MULTIPLIER,
    max_gapmer_length,
    max_gapmer_num_basepairs_used,
)

_I32_MASK = 0xFFFFFFFF
MAX_NUM_COMBINATIONS_TO_EXPAND = 64  # HashBlock_ParentRow.java:10


def _i32(x: int) -> int:
    x &= _I32_MASK
    return x - (1 << 32) if x >= (1 << 31) else x


def _i64(x: int) -> int:
    x &= 0xFFFFFFFFFFFFFFFF
    return x - (1 << 64) if x >= (1 << 63) else x


class ScalarHashBlock:
    """HashBlock.java — one content-defined block."""

    __slots__ = (
        "start",
        "length",
        "num_basepairs_used",
        "fwd",
        "rev",
        "gap_dir",
        "extra_gapmer",
        "req_l",
        "req_r",
        "next_l",
        "next_r",
        "gapped_block1_length",
        "gapped_gap_length",
        # index into a precomputed native walk sequence (-1 = not from one);
        # lets consumers pair prefetched lookup results with the block even
        # after reordering (align/candidates.py pending_blocks)
        "walk_index",
    )

    def __init__(self, start: int, length: int):
        self.start = start
        self.length = length
        self.num_basepairs_used = length
        self.fwd = 0
        self.rev = 0
        self.gap_dir = 0
        self.extra_gapmer = 0
        self.req_l = False
        self.req_r = False
        self.next_l = False
        self.next_r = False
        self.gapped_block1_length = -1
        self.gapped_gap_length = 0
        self.walk_index = -1

    # --- constructors ---------------------------------------------------

    @staticmethod
    def from_char(two_bit: int, index: int) -> "ScalarHashBlock":
        """HashBlock(char, index) + hashChar (HashBlock.java:60-65,171-188);
        `two_bit` is 0..3 for A,C,G,T."""
        b = ScalarHashBlock(index, 1)
        b.fwd = two_bit
        b.rev = 3 - two_bit
        b.req_l = two_bit // 2 == 0
        b.req_r = not b.req_l
        b.next_l = two_bit % 2 == 0
        b.next_r = not b.next_l
        return b

    @staticmethod
    def merged(left: "ScalarHashBlock", right: "ScalarHashBlock") -> "ScalarHashBlock":
        """HashBlock(Sequence, startIndex, length, leftParent, rightParent)
        (HashBlock.java:20-44)."""
        b = ScalarHashBlock(left.start, right.end - left.start)
        b._merge_hashes(left, right)
        if b.req_l != b.req_r:
            b.gap_dir = 1 if b.req_l else -1
        else:
            if left.fwd != right.rev:
                b.gap_dir = 1 if left.fwd > right.rev else -1
        extra = left.length + right.length - b.length
        b.extra_gapmer = int(extra / 4) if extra >= 0 else -((-extra) // 4)
        return b

    @property
    def end(self) -> int:
        return self.start + self.length

    def _merge_hashes(self, left: "ScalarHashBlock", right: "ScalarHashBlock") -> None:
        """HashBlock.mergeHashes (HashBlock.java:192-259)."""
        self.fwd = _merge_hash_values(left.length, left.fwd, right.length, right.fwd)
        self.rev = _merge_hash_values(right.length, right.rev, left.length, left.rev)

        self.req_l = self.req_r = True
        self.next_l = self.next_r = True
        anchor = other = None
        if left.fwd != right.rev:
            if left.fwd > right.rev:
                anchor, other = right, left
            else:
                anchor, other = left, right

        if anchor is not None and self.fwd != self.rev:
            is_reverse = self.fwd < self.rev
            invert = is_reverse == (anchor is right)

            a_nl, a_nr = anchor.next_l, anchor.next_r
            if a_nl and a_nr:
                if anchor is right:
                    a_nr = False
                else:
                    a_nl = False
            o_nl, o_nr = other.next_l, other.next_r
            if o_nl and o_nr:
                if other is right:
                    o_nl = False
                else:
                    o_nr = False

            self.req_l = a_nl != invert
            self.req_r = a_nr != invert
            self.next_l = o_nl != invert
            self.next_r = o_nr != invert

        if left.length != right.length:
            self.req_l = left.length > right.length
            self.req_r = not self.req_l
            self.next_l = not self.req_l
            self.next_r = not self.next_l

        if self.fwd != self.rev:
            if self.req_l and self.req_r:
                self.req_l = self.fwd > self.rev
                self.req_r = not self.req_l
            if self.next_l and self.next_r:
                self.next_l = self.req_l
                self.next_r = not self.next_l

    # --- gapmer ---------------------------------------------------------

    def with_gap_and_extension(self, codes: np.ndarray) -> "ScalarHashBlock | None":
        """HashBlock.withGapAndExtension (HashBlock.java:67-150)."""
        m = max(self.fwd, self.rev)
        abs_m = _i32(abs(m))  # Java Math.abs(int) wraps on MIN_VALUE
        rem = abs_m % 3 if abs_m >= 0 else -((-abs_m) % 3)
        target_extra = self.length + rem + self.extra_gapmer
        gap = self.length // 2
        ext_len = target_extra - gap

        if self.gap_dir == 0:
            return self

        # Horner evaluation of the extension hash: mod-2^32 multiplication and
        # addition are sign-agnostic, so one mask per step and one sign
        # correction at the end reproduce the per-step Java int casts exactly
        if self.gap_dir < 0:
            ext_end = self.start - gap
            ext_start = ext_end - ext_len
            if ext_start < 0:
                return None
            vals = basepairs.GAPMER_CHAR_VALUE_TABLE[codes[ext_start:ext_end]][
                ::-1
            ].tolist()
            result = ScalarHashBlock(ext_start, ext_len + gap + self.length)
            result.gapped_block1_length = ext_len
            result.gapped_gap_length = gap
        else:
            ext_start = self.end + gap
            ext_end = ext_start + ext_len
            if ext_end > codes.shape[0]:
                return None
            vals = basepairs.GAPMER_CHAR_VALUE_TABLE[
                basepairs.COMPLEMENT_TABLE[codes[ext_start:ext_end]]
            ].tolist()
            result = ScalarHashBlock(self.start, self.length + gap + ext_len)
            result.gapped_block1_length = self.length
            result.gapped_gap_length = gap
        ext_hash = 0
        for v in vals:
            ext_hash = (ext_hash * GAPMER_MULTIPLIER + v) & 0xFFFFFFFF
        if ext_hash >= 0x80000000:
            ext_hash -= 0x100000000
        result.fwd = _i32(self.fwd + ext_hash)
        result.rev = _i32(self.rev + ext_hash)
        result.num_basepairs_used = self.length + ext_len
        if result.num_basepairs_used > max_gapmer_num_basepairs_used(self.length):
            raise AssertionError("gapmer exceeded expected num basepairs used")
        if result.length > max_gapmer_length(self.length):
            raise AssertionError("gapmer exceeded expected length")
        return result

    # --- polarity (HashBlock.java:322-340) -------------------------------

    def is_primary_polarity(self) -> bool:
        if self.req_l != self.req_r:
            return self.req_l
        return self.fwd >= self.rev

    def is_secondary_polarity(self) -> bool:
        if self.req_l != self.req_r:
            return self.req_r
        return self.fwd <= self.rev

    def lookup_key(self) -> int:
        return self.fwd if self.is_primary_polarity() else self.rev


def _merge_hash_values(l_len: int, l_hash: int, r_len: int, r_hash: int) -> int:
    """HashBlock's merge-hash combiner (HashBlock.java:261-269) with the Java
    32/64-bit wraparound inlined — the hottest scalar-path function; addition
    and multiplication are sign-agnostic mod 2^64, so only the int32 cast of
    (r_hash+1), the arithmetic >> 32, and the final casts need signing."""
    rh = (r_hash + 1) & 0xFFFFFFFF
    if rh >= 0x80000000:
        rh -= 0x100000000
    t = (
        (l_hash + 1) * (MERGE_MULTIPLIER + MERGE_LENGTH_MULTIPLIER * r_len)
        + rh * l_len
    ) & 0xFFFFFFFFFFFFFFFF
    if t >= 0x8000000000000000:
        t -= 0x10000000000000000
    lo = t & 0xFFFFFFFF
    if lo >= 0x80000000:
        lo -= 0x100000000
    hi = (t >> 32) & 0xFFFFFFFF
    if hi >= 0x80000000:
        hi -= 0x100000000
    v = (lo + hi) & 0xFFFFFFFF
    return v - 0x100000000 if v >= 0x80000000 else v


class Condition:
    """SequenceCondition.java — sorted (position -> concrete code) constraints."""

    __slots__ = ("keys", "values")

    ALWAYS: "Condition"

    def __init__(self, keys: tuple[int, ...] = (), values: tuple[int, ...] = ()):
        self.keys = keys
        self.values = values

    def intersect(self, other: "Condition") -> "Condition | None":
        ka, va = self.keys, self.values
        kb, vb = other.keys, other.values
        if not kb:
            return self
        if not ka:
            return other
        # dominant case: two single-position conditions
        if len(ka) == 1 and len(kb) == 1:
            a, b = ka[0], kb[0]
            if a == b:
                return self if va[0] == vb[0] else None
            if a < b:
                return Condition((a, b), (va[0], vb[0]))
            return Condition((b, a), (vb[0], va[0]))
        # keys are maintained sorted (single-key constructors + this merge),
        # so a two-pointer merge avoids the dict + sort per call
        out_k: list[int] = []
        out_v: list[int] = []
        i = j = 0
        la, lb = len(ka), len(kb)
        while i < la and j < lb:
            a, b = ka[i], kb[j]
            if a == b:
                if va[i] != vb[j]:
                    return None
                out_k.append(a)
                out_v.append(va[i])
                i += 1
                j += 1
            elif a < b:
                out_k.append(a)
                out_v.append(va[i])
                i += 1
            else:
                out_k.append(b)
                out_v.append(vb[j])
                j += 1
        out_k.extend(ka[i:])
        out_v.extend(va[i:])
        out_k.extend(kb[j:])
        out_v.extend(vb[j:])
        return Condition(tuple(out_k), tuple(out_v))

    def complexity(self) -> int:
        return len(self.values)


Condition.ALWAYS = Condition()


class ConditionalBlock:
    __slots__ = ("block", "condition")

    def __init__(self, block: ScalarHashBlock | None, condition: Condition):
        self.block = block
        self.condition = condition


class MultiBlock:
    """MultiHashBlock.java — alternate conditional blocks at one slot."""

    __slots__ = ("possibilities",)

    def __init__(self, possibilities: list[ConditionalBlock]):
        self.possibilities = possibilities

    @property
    def start(self) -> int:
        starts = [c.block.start for c in self.possibilities if c.block is not None]
        return min(starts) if starts else -1

    @property
    def end(self) -> int:
        ends = [c.block.end for c in self.possibilities if c.block is not None]
        return max(ends) if ends else -1

    def min_length(self) -> int:
        lengths = [c.block.length for c in self.possibilities if c.block is not None]
        return min(lengths) if lengths else -1


Slot = ScalarHashBlock | MultiBlock


def scalar_base_row(codes: np.ndarray) -> list[Slot]:
    """HashBlock_BaseRow (java:27-56): one slot per position; ambiguous positions
    expand into a MultiBlock with one conditional block per possible base."""
    row: list[Slot] = []
    for i in range(codes.shape[0]):
        code = int(codes[i])
        two_bit = int(basepairs.TWO_BIT_TABLE[code])
        if two_bit >= 0:
            row.append(ScalarHashBlock.from_char(two_bit, i))
        else:
            possibilities = []
            for base in basepairs.possibilities(code):
                tb = int(basepairs.TWO_BIT_TABLE[base])
                possibilities.append(
                    ConditionalBlock(ScalarHashBlock.from_char(tb, i), Condition((i,), (base,)))
                )
            row.append(MultiBlock(possibilities))
    return row


def _should_merge(left: ScalarHashBlock, right: ScalarHashBlock) -> bool:
    if left.end < right.start:
        return False
    return left.req_r or right.req_l


def _maybe_merge(left: ScalarHashBlock, right: ScalarHashBlock) -> ScalarHashBlock | None:
    if _should_merge(left, right):
        return ScalarHashBlock.merged(left, right)
    return None


def scalar_merge_row(row: list[Slot]) -> list[Slot]:
    """HashBlock_ParentRow.maybeMakeBlock / expand (java:69-191)."""
    out: list[Slot] = []
    for i in range(len(row) - 1):
        left_slot = row[i]
        right_slot = row[i + 1]
        if isinstance(left_slot, ScalarHashBlock) and isinstance(right_slot, ScalarHashBlock):
            merged = _maybe_merge(left_slot, right_slot)
            if merged is not None:
                out.append(merged)
            continue
        # ambiguity path: expand combinations
        merge_options: list[ConditionalBlock] = []
        left_possibilities = (
            left_slot.possibilities
            if isinstance(left_slot, MultiBlock)
            else [ConditionalBlock(left_slot, Condition.ALWAYS)]
        )
        for left_option in left_possibilities:
            if left_option.block is not None:
                _expand(row, left_option.block, left_option.condition, i, merge_options)
            else:
                merge_options.append(ConditionalBlock(None, left_option.condition))
        if 0 < len(merge_options) <= MAX_NUM_COMBINATIONS_TO_EXPAND:
            if any(option.block is not None for option in merge_options):
                out.append(MultiBlock(merge_options))
    return out


def _expand(
    row: list[Slot],
    left_block: ScalarHashBlock,
    starting_condition: Condition,
    slot_index: int,
    results: list[ConditionalBlock],
) -> None:
    """HashBlock_ParentRow.expand (java:137-191).

    `slot_index` is the index of the slot after which to find the right
    neighbor (the reference keys on start positions; slots here are in order).
    """
    if slot_index + 1 >= len(row):
        return
    next_slot = row[slot_index + 1]
    next_possibilities = (
        next_slot.possibilities
        if isinstance(next_slot, MultiBlock)
        else [ConditionalBlock(next_slot, Condition.ALWAYS)]
    )
    found_intersection = False
    for right_option in next_possibilities:
        intersection = starting_condition.intersect(right_option.condition)
        if intersection is None:
            if found_intersection:
                break
            continue
        found_intersection = True
        if len(results) > MAX_NUM_COMBINATIONS_TO_EXPAND:
            return
        right_block = right_option.block
        if right_block is None:
            _expand(row, left_block, intersection, slot_index + 1, results)
            continue
        merged = _maybe_merge(left_block, right_block)
        results.append(ConditionalBlock(merged, intersection))


def scalar_pyramid(codes: np.ndarray, max_level: int | None = None) -> list[list[Slot]]:
    rows = [scalar_base_row(codes)]
    while len(rows[-1]) >= 2:
        if max_level is not None and len(rows) - 1 >= max_level:
            break
        rows.append(scalar_merge_row(rows[-1]))
    return rows


def iter_concrete_blocks(row: list[Slot]):
    """Yields (block, is_conditional) for each concrete block in a row, expanding
    MultiBlocks."""
    for slot in row:
        if isinstance(slot, ScalarHashBlock):
            yield slot, False
        else:
            for option in slot.possibilities:
                if option.block is not None:
                    yield option.block, True
