"""Candidate generation on the engine's device: pyramid -> gapmers -> index
lookup -> offset voting -> per-read top-K, and the same program fused with
the banded scorer over the kept candidate rows, as PyTorch tensor programs.

Counterpart of `mapper_tpu/batch/device_candidates.py`.  The per-read
content-defined pyramid (HashBlock.java's merge rules, bit for bit) is
computed for a whole padded [B, L] read batch with masked dense rows: blocks
never compact, they invalidate, and each block finds its next valid neighbor
with a reversed running minimum over the valid slot indices.  Seed lookup
gathers into the merged index held on the device; offset voting counts equal
keys with a per-row sort, and top-K takes K rounds of (votes desc, key asc).

Java's `long` arithmetic of HashBlock.mergeHashes (HashBlock.java:261-269)
runs in int64 tensors; the uint32 gapmer arithmetic runs in int64 masked to
32 bits, its products split into 16-bit halves so that no intermediate
leaves int64.

The candidate table equals `batch/candidates.py`'s `generate_candidates` on
every read the fixed budgets let through (NUM_LEVELS pyramid levels, V_SLOTS
usable seeds, P_SLOTS vote entries); the others are flagged for the host.
The fused program scores the kept rows with `banded_scores_gathered`.

Each program has a plain version here (`candidates_plain`, and
`fused_rows_plain` for the kept rows' compaction and geometry) and a
hand-written CUDA kernel (`align/csrc/candidates.cu`: KC1
`candidates_kernel`, a team of threads a read, its votes counted in a
table without a sort, and KC2 `fused_rows_kernel`, one thread a read over
many blocks).  `candidates_program`, `fused_rows` and `fused_program`
take the plain versions on a CPU tensor and launch the kernels on a CUDA
tensor; any other device raises.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from mapper_tpu_torch.align import kernels
from mapper_tpu_torch.align.banded import banded_scores_gathered
from mapper_tpu_torch.index.hashblock import (
    GAPMER_MULTIPLIER,
    _GAPMER_MULTIPLIER_INVERSE,
    MERGE_LENGTH_MULTIPLIER,
    MERGE_MULTIPLIER,
)

NUM_LEVELS = 16
# seeds whose index bin holds more positions do not vote (the host pass's
# default, batch/candidates.py)
MAX_MATCHES_PER_SEED = 12
# read rows are padded to a multiple of this width
LENGTH_BUCKET = 64
# a clean 150 bp read yields ~300 usable seeds (every block of every level in
# the interesting-size window), nearly all single-match
V_SLOTS = 512
P_SLOTS = 1024
# the fused program scores ceil(B * C_PER_READ / SCORE_TILE) * SCORE_TILE
# candidate rows a chunk; rows past that budget flag their read for the host.
# 1024 is the JAX engine's default scoring tile, kept so that the same reads
# are flagged as there
SCORE_TILE = 1024
C_PER_READ = 1.5

_MASK32 = 0xFFFFFFFF
_SIGN32 = 0x80000000
# the top-K key of an empty rank (no valid key reaches it: every key is
# below 2 * n_seqs * span + bias < 2^31)
_NO_KEY = 2**31 - 1
# the sort key of an empty vote slot, above every valid key
_EMPTY_SLOT = 2**62


# ---------------------------------------------------------------------------
# Java int/long arithmetic in int64 tensors
# ---------------------------------------------------------------------------


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """Java's (int) cast of an int64 value, kept in int64."""
    return ((x & _MASK32) ^ _SIGN32) - _SIGN32


def _mulmod32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a * b) mod 2^32 for a, b in [0, 2^32), in 16-bit halves of b so that
    no product passes 2^48."""
    low = a * (b & 0xFFFF)
    high = ((a * (b >> 16)) & 0xFFFF) << 16
    return (low + high) & _MASK32


def _merge_hashes_device(l_len, l_hash, r_len, r_hash):
    """HashBlock.mergeHashes (HashBlock.java:261-269) on int64 tensors
    holding int32 values.

    rotated_left  = ((long) l_hash + 1) * (54323 + 323 * r_len)
    rotated_right = (long)(int)(r_hash + 1) * (long) l_len
    result        = (int)(sum + (sum >> 32))   [arithmetic shift]
    """
    rotated_left = (l_hash + 1) * (MERGE_MULTIPLIER + MERGE_LENGTH_MULTIPLIER * r_len)
    rotated_right = _wrap32(r_hash + 1) * l_len
    total = rotated_left + rotated_right
    return _wrap32(total + (total >> 32))


# ---------------------------------------------------------------------------
# masked dense pyramid rows
# ---------------------------------------------------------------------------

# nibble -> 2-bit code (A=0 C=1 G=2 T=3); ambiguity must be pre-filtered
_TWO_BIT = np.full(16, -1, dtype=np.int64)
_TWO_BIT[[1, 2, 4, 8]] = [0, 1, 2, 3]
# nibble -> gapmer char value (A..T -> 1..4) and complemented value
_GAP_VAL = np.zeros(16, dtype=np.int64)
_GAP_VAL[[1, 2, 4, 8]] = [1, 2, 3, 4]
_GAP_VAL_COMP = np.zeros(16, dtype=np.int64)
_GAP_VAL_COMP[[1, 2, 4, 8]] = [4, 3, 2, 1]


def _upload(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """`a` on `device`; to a card through pinned memory without blocking the
    host (a pageable copy would wait for the work queued before it)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _base_row(codes: torch.Tensor, valid: torch.Tensor, two_bit: torch.Tensor) -> dict:
    """Level-0 row over [B, L] nibble codes: one 1-bp block per position."""
    b, l = codes.shape
    v = two_bit[codes.long()]
    return {
        "start": torch.arange(l, device=codes.device).expand(b, l),
        "length": torch.ones((b, l), dtype=torch.int64, device=codes.device),
        "fwd": v,
        "rev": 3 - v,
        "req_l": v < 2,
        "req_r": v >= 2,
        "next_l": (v & 1) == 0,
        "next_r": (v & 1) == 1,
        "gap_dir": torch.zeros((b, l), dtype=torch.int64, device=codes.device),
        "extra": torch.zeros((b, l), dtype=torch.int64, device=codes.device),
        "valid": valid,
    }


def _propagate_next_valid(fields: list, valid: torch.Tensor):
    """For each slot i, each field's value at the smallest valid slot j > i,
    and whether such a slot exists (fields read 0 / False where none does).
    The slot comes from a running minimum of the valid slots' indices taken
    from the right, then one gather per field."""
    b, l = valid.shape
    idx = torch.arange(l, device=valid.device).expand(b, l)
    slot = torch.where(valid, idx, l)
    from_here = torch.flip(torch.cummin(torch.flip(slot, [1]), dim=1).values, [1])
    after = torch.cat([from_here[:, 1:], torch.full((b, 1), l, device=valid.device)], dim=1)
    has = after < l
    at = torch.clamp(after, max=l - 1)
    out = []
    for f in fields:
        g = torch.gather(f, 1, at)
        out.append(g & has if f.dtype == torch.bool else torch.where(has, g, 0))
    return out, has


def _merge_row_device(row: dict) -> dict:
    """One pyramid level: each valid block merges with its next valid neighbor
    when the pair requests it (HashBlock_ParentRow.shouldMergeBlocks +
    HashBlock's merging constructor; the flag algebra of
    index/hashblock.py::merge_row).  The merged block keeps the left parent's
    slot; everything else invalidates."""
    valid = row["valid"]
    (r_len, r_fwd, r_rev, r_start, r_req_l, r_next_l, r_next_r), has_r = _propagate_next_valid(
        [
            row["length"], row["fwd"], row["rev"], row["start"],
            row["req_l"], row["next_l"], row["next_r"],
        ],
        valid,
    )
    l_len = row["length"]
    l_fwd = row["fwd"]
    l_rev = row["rev"]

    end_l = row["start"] + l_len
    should = (end_l >= r_start) & (row["req_r"] | r_req_l)
    new_valid = valid & has_r & should

    length = r_start + r_len - row["start"]
    fwd = _merge_hashes_device(l_len, l_fwd, r_len, r_fwd)
    rev = _merge_hashes_device(r_len, r_rev, l_len, l_rev)

    anchor_exists = l_fwd != r_rev
    anchor_is_right = l_fwd > r_rev
    asym = anchor_exists & (fwd != rev)
    is_reverse = fwd < rev
    invert = is_reverse == anchor_is_right

    a_nl = torch.where(anchor_is_right, r_next_l, row["next_l"])
    a_nr = torch.where(anchor_is_right, r_next_r, row["next_r"])
    both = a_nl & a_nr
    a_nr = torch.where(both & anchor_is_right, False, a_nr)
    a_nl = torch.where(both & ~anchor_is_right, False, a_nl)

    o_nl = torch.where(anchor_is_right, row["next_l"], r_next_l)
    o_nr = torch.where(anchor_is_right, row["next_r"], r_next_r)
    both_o = o_nl & o_nr
    o_nl = torch.where(both_o & ~anchor_is_right, False, o_nl)
    o_nr = torch.where(both_o & anchor_is_right, False, o_nr)

    req_l = torch.where(asym, a_nl != invert, True)
    req_r = torch.where(asym, a_nr != invert, True)
    next_l = torch.where(asym, o_nl != invert, True)
    next_r = torch.where(asym, o_nr != invert, True)

    diff_len = l_len != r_len
    lg = l_len > r_len
    req_l = torch.where(diff_len, lg, req_l)
    req_r = torch.where(diff_len, ~lg, req_r)
    next_l = torch.where(diff_len, ~lg, next_l)
    next_r = torch.where(diff_len, lg, next_r)

    asym_hash = fwd != rev
    both_req = req_l & req_r
    fg = fwd > rev
    req_l = torch.where(asym_hash & both_req, fg, req_l)
    req_r = torch.where(asym_hash & both_req, ~fg, req_r)
    both_next = next_l & next_r
    next_l = torch.where(asym_hash & both_next, req_l, next_l)
    next_r = torch.where(asym_hash & both_next, ~req_l, next_r)

    req_differ = req_l != req_r
    gap_dir = torch.where(
        req_differ,
        torch.where(req_l, 1, -1),
        torch.where(anchor_exists, torch.where(anchor_is_right, 1, -1), 0),
    )

    # extraGapmerLength: Java int division truncates toward zero
    extra = torch.div(l_len + r_len - length, 4, rounding_mode="trunc")

    return {
        "start": row["start"],
        "length": length,
        "fwd": fwd,
        "rev": rev,
        "req_l": req_l,
        "req_r": req_r,
        "next_l": next_l,
        "next_r": next_r,
        "gap_dir": gap_dir,
        "extra": extra,
        "valid": new_valid,
    }


# ---------------------------------------------------------------------------
# gapmer expansion (HashBlock.withGapAndExtension, HashBlock.java:67-150)
# ---------------------------------------------------------------------------


def _power_tables(n: int) -> tuple[np.ndarray, np.ndarray]:
    """GAPMER_MULTIPLIER^i and its inverse's powers mod 2^32, i in [0, n)."""
    pow_host = np.empty(n, dtype=np.int64)
    inv_host = np.empty(n, dtype=np.int64)
    pb, ib = 1, 1
    for i in range(n):
        pow_host[i] = pb
        inv_host[i] = ib
        pb = (pb * GAPMER_MULTIPLIER) & _MASK32
        ib = (ib * _GAPMER_MULTIPLIER_INVERSE) & _MASK32
    return pow_host, inv_host


# the power tables held with the index cover reads up to this width; a wider
# batch uploads its own
_POWER_WIDTH = 4096


def _code_tables(device: torch.device) -> dict:
    """The per-nibble and power tables the program reads, on `device`."""
    pow_host, inv_host = _power_tables(_POWER_WIDTH + 2)
    return {
        "two_bit": _upload(_TWO_BIT, device),
        "gap_val": _upload(_GAP_VAL, device),
        "gap_val_comp": _upload(_GAP_VAL_COMP, device),
        "pow": _upload(pow_host, device),
        "inv_pow": _upload(inv_host, device),
    }


def _gapmer_prefixes_device(codes: torch.Tensor, tables: dict):
    """Per-read modular prefix tables [B, L+1] (uint32 values in int64) and
    the shared power tables [L+2]."""
    b, l = codes.shape
    device = codes.device
    idx = codes.long()
    fwd_vals = tables["gap_val"][idx]
    comp_vals = tables["gap_val_comp"][idx]
    if l + 2 <= tables["pow"].shape[0]:
        pow_b, inv_pow_b = tables["pow"][: l + 2], tables["inv_pow"][: l + 2]
    else:
        pow_b, inv_pow_b = (_upload(t, device) for t in _power_tables(l + 2))
    # each term is below 2^35 and a row sums at most L of them: the int64
    # prefix sums are exact, then taken mod 2^32
    zero_col = torch.zeros((b, 1), dtype=torch.int64, device=device)
    pref_fwd = torch.cat([zero_col, torch.cumsum(fwd_vals * pow_b[:l], dim=1) & _MASK32], dim=1)
    pref_comp = torch.cat([zero_col, torch.cumsum(comp_vals * inv_pow_b[:l], dim=1) & _MASK32], dim=1)
    return pref_fwd, pref_comp, pow_b, inv_pow_b


def _expand_gapmers_device(row, pref_fwd, pref_comp, pow_b, inv_pow_b, lengths):
    """Per-block gapmer for one row: (key, num_bp, start, length, primary,
    valid).  Blocks whose extension would leave the read are invalidated
    (the reference returns null for them)."""
    length = row["length"]
    # targetExtraLength = length + |max(fwd, rev)| % 3 + extra, Java
    # semantics: abs(Integer.MIN_VALUE) stays MIN_VALUE, % truncates
    m = torch.maximum(row["fwd"], row["rev"])
    abs_m = torch.where(m < 0, _wrap32(-m), m)
    rem = torch.fmod(abs_m, 3)
    target_extra = length + rem + row["extra"]
    gap = torch.div(length, 2, rounding_mode="floor")
    ext_len = target_extra - gap

    left_gap = row["gap_dir"] < 0
    right_gap = row["gap_dir"] > 0
    no_gap = row["gap_dir"] == 0

    ext_end_l = row["start"] - gap
    ext_start_l = ext_end_l - ext_len
    ext_start_r = row["start"] + length + gap
    ext_end_r = ext_start_r + ext_len
    ext_start = torch.where(left_gap, ext_start_l, torch.where(right_gap, ext_start_r, 0))
    ext_end = torch.where(left_gap, ext_end_l, torch.where(right_gap, ext_end_r, 0))

    n = lengths[:, None]  # per-read length bound
    in_bounds = no_gap | (left_gap & (ext_start >= 0)) | (right_gap & (ext_end <= n))
    valid = row["valid"] & in_bounds

    lmax = pref_fwd.shape[1] - 1
    cs = torch.clamp(ext_start, 0, lmax)
    ce = torch.clamp(ext_end, 0, lmax)
    d_fwd = (torch.gather(pref_fwd, 1, ce) - torch.gather(pref_fwd, 1, cs)) & _MASK32
    left_hash = _mulmod32(d_fwd, inv_pow_b[cs])
    d_comp = (torch.gather(pref_comp, 1, ce) - torch.gather(pref_comp, 1, cs)) & _MASK32
    right_hash = _mulmod32(d_comp, pow_b[torch.clamp(ce, min=1) - 1])
    ext_hash = torch.where(left_gap, left_hash, right_hash)

    fwd = torch.where(no_gap, row["fwd"], _wrap32(row["fwd"] + ext_hash))
    rev = torch.where(no_gap, row["rev"], _wrap32(row["rev"] + ext_hash))

    total_len = torch.where(no_gap, length, length + gap + ext_len)
    num_bp = torch.where(no_gap, length, length + ext_len)
    start = torch.where(left_gap, ext_start, row["start"])

    flags_differ = row["req_l"] != row["req_r"]
    primary = torch.where(no_gap & flags_differ, row["req_l"], fwd >= rev)
    key = torch.where(primary, fwd, rev)
    return key, num_bp, start, total_len, primary, valid


# ---------------------------------------------------------------------------
# lookup + voting + top-K
# ---------------------------------------------------------------------------


def _rank_compact(fields: list, valid: torch.Tensor, width: int):
    """Compact each row's valid entries (in order) into `width` slots by a
    running-count rank and a scatter into `width + 1` columns whose last one,
    which takes the invalid and the overflowing entries, is cut off.  Returns
    (compacted fields, per-row valid-entry counts)."""
    b, n = valid.shape
    rank = torch.cumsum(valid.to(torch.int64), dim=1) - 1
    counts = rank[:, -1] + 1 if n else torch.zeros(b, dtype=torch.int64, device=valid.device)
    slot = torch.where(valid & (rank < width), rank, width)
    out = []
    for f in fields:
        tgt = torch.zeros((b, width + 1), dtype=f.dtype, device=f.device)
        tgt.scatter_(1, slot, f)
        out.append(tgt[:, :width])
    return out, counts


def _device_of(inputs: dict, what: str) -> torch.device:
    device = inputs["codes"].device
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {device}")
    return device


def candidates_program(inputs: dict, k_out: int = 8) -> torch.Tensor:
    """The candidates program on `program_inputs`, on their device: [B, 2K+1]
    int32, per read the top-K vote keys (`_NO_KEY` where the rank is empty),
    their votes and the fallback flag.  `candidates_plain` on the CPU, KC1
    (`kernels.candidates`) on a card."""
    if _device_of(inputs, "candidates_program").type == "cpu":
        return candidates_plain(inputs, k_out)
    return kernels.candidates(
        inputs["codes"], inputs["lengths"], inputs["index"], inputs["max_size"], inputs["min_size"],
        inputs["n_seqs"], inputs["span"], inputs["bias"], k_out,
    )


def _plain_seeds(inputs: dict) -> dict:
    """The candidates program's first half in PyTorch tensor operations:
    pyramid, gapmers and the size filter, the passing seeds compacted to
    V_SLOTS slots in level-major order, and their bin lookup.  Returns the
    seeds' fields, "bin" and "matches" (0 where a seed is not usable), per
    read "seeds" (the passing seeds before V_SLOTS clips them) and
    "unconverged"."""
    codes, lengths, index = inputs["codes"], inputs["lengths"], inputs["index"]
    max_size, min_size = inputs["max_size"], inputs["min_size"]
    b, l = codes.shape
    device = codes.device
    valid0 = torch.arange(l, device=device)[None, :] < lengths[:, None]
    row = _base_row(codes, valid0, index["two_bit"])
    pref_fwd, pref_comp, pow_b, inv_pow_b = _gapmer_prefixes_device(codes, index)

    per_level = []
    for _ in range(NUM_LEVELS):
        row = _merge_row_device(row)
        key, num_bp, start, length, primary, valid = _expand_gapmers_device(
            row, pref_fwd, pref_comp, pow_b, inv_pow_b, lengths
        )
        ok = valid & (num_bp >= min_size) & (num_bp <= max_size)
        per_level.append((key, num_bp, start, length, primary.to(torch.int64), ok))

    # reads the fixed level count didn't finish: the host path would keep
    # merging (fallback flag)
    unconverged = torch.any(row["valid"] & (row["length"] <= max_size), dim=1) & (
        row["valid"].sum(dim=1) >= 2
    )

    def _flat(i):  # [B, NLEV * L], level-major per read
        return torch.stack([lv[i] for lv in per_level], dim=1).reshape(b, NUM_LEVELS * l)

    # ---- compact valid seeds to V slots, then look up bin counts ----
    (c_key, c_nb, c_start, c_len, c_primary), seed_counts = _rank_compact(
        [_flat(i) for i in range(5)], _flat(5), V_SLOTS
    )
    c_valid = torch.arange(V_SLOTS, device=device)[None, :] < torch.clamp(seed_counts, max=V_SLOTS)[:, None]
    nb = torch.clamp(c_nb, 0, index["capacities"].shape[0] - 1)
    cap = index["capacities"][nb]
    c_bin = index["bases"][nb] + torch.remainder(c_key, cap)  # floor mod
    c_bin = torch.where(c_valid, c_bin, 0)
    cnt = index["counts"][c_bin].long()
    limit = torch.clamp(index["caps"][nb], max=MAX_MATCHES_PER_SEED)
    usable = c_valid & (cnt > 0) & (cnt <= limit)
    return {
        "start": c_start, "length": c_len, "primary": c_primary, "valid": c_valid,
        "bin": c_bin, "matches": torch.where(usable, cnt, 0),
        "seeds": seed_counts, "unconverged": unconverged,
    }


def candidates_plain(inputs: dict, k_out: int = 8) -> torch.Tensor:
    """The candidates program in PyTorch tensor operations (KC1's plain
    version): pyramid, gapmers, lookup, votes by a per-row sort, top-K."""
    lengths, index = inputs["lengths"], inputs["index"]
    n_seqs, span, bias = inputs["n_seqs"], inputs["span"], inputs["bias"]
    b = lengths.shape[0]
    device = lengths.device
    seeds = _plain_seeds(inputs)
    c_start, c_len, c_primary, c_valid = seeds["start"], seeds["length"], seeds["primary"], seeds["valid"]
    c_bin, c_cnt = seeds["bin"], seeds["matches"]
    seed_overflow = seeds["seeds"] > V_SLOTS

    # ---- expand matches: [B, V, M] encoded global positions ----
    j = torch.arange(MAX_MATCHES_PER_SEED, device=device)[None, None, :]
    pos_valid = c_valid[:, :, None] & (j < c_cnt[:, :, None])
    pos_idx = torch.where(pos_valid, index["offsets"][c_bin].long()[:, :, None] + j, 0)
    pos = index["values"][pos_idx].long()

    # ---- fold to (strand, forward contig, offset) vote keys ----
    # global position -> sequence: #(seq_starts[1:] <= pos)
    seq = torch.searchsorted(index["seq_starts_tail"], pos, right=True)
    pos_off = pos - index["seq_starts"][seq]
    prim3 = c_primary[:, :, None] != 0
    len3 = c_len[:, :, None]
    start3 = c_start[:, :, None]
    rc_seq = index["rc_index"][seq]
    folded_seq = torch.where(prim3, seq, rc_seq)
    folded_off = torch.where(prim3, pos_off, index["seq_lengths"][rc_seq] - pos_off - len3)
    mrev = index["rev_flags"][folded_seq] != 0
    fwd_idx = index["fwd_index"][folded_seq]
    contig_len = index["seq_lengths"][fwd_idx]
    read_len3 = lengths[:, None, None]
    offv = torch.where(
        mrev,
        (contig_len - (folded_off + len3)) - (read_len3 - (start3 + len3)),
        folded_off - start3,
    )
    vote_key = (mrev.to(torch.int64) * n_seqs + fwd_idx) * span + (offv + bias)

    # ---- compact vote entries to P slots ----
    (p_key,), entry_counts = _rank_compact(
        [vote_key.reshape(b, V_SLOTS * MAX_MATCHES_PER_SEED)],
        pos_valid.reshape(b, V_SLOTS * MAX_MATCHES_PER_SEED),
        P_SLOTS,
    )
    entry_overflow = entry_counts > P_SLOTS
    p_valid = torch.arange(P_SLOTS, device=device)[None, :] < torch.clamp(entry_counts, max=P_SLOTS)[:, None]

    # ---- votes: each valid slot's count of equal valid keys in its row ----
    keyed = torch.where(p_valid, p_key, _EMPTY_SLOT)
    ordered = torch.sort(keyed, dim=1).values
    votes = torch.searchsorted(ordered, keyed, right=True) - torch.searchsorted(ordered, keyed)
    votes = torch.where(p_valid, votes, 0)

    # ---- top-K rounds: votes desc, key asc (the host path's lexsort order) ----
    remaining = p_valid
    out_keys, out_votes = [], []
    for _ in range(k_out):
        best_cnt = torch.where(remaining, votes, 0).amax(dim=1)
        is_best = remaining & (votes == best_cnt[:, None]) & (best_cnt[:, None] > 0)
        best_key = torch.where(is_best, p_key, _NO_KEY).amin(dim=1)
        out_keys.append(best_key)
        out_votes.append(best_cnt)
        remaining = remaining & (p_key != best_key[:, None])
    fallback = seeds["unconverged"] | seed_overflow | entry_overflow
    # one stacked int32 output: one copy back to the host
    return torch.cat(
        [torch.stack(out_keys, dim=1), torch.stack(out_votes, dim=1), fallback.to(torch.int64)[:, None]],
        dim=1,
    ).to(torch.int32)


# ---------------------------------------------------------------------------
# host side
# ---------------------------------------------------------------------------


def device_index_arrays(database, device, lock=None):
    """The merged index and the strand tables as tensors on `device`, cached
    on the database per device and rebuilt when the index grows (under
    `lock`, where threads share the cache).  The bin counts, offsets and
    values are int32 (the bulk of the bytes); the per-size and per-sequence
    tables int64; beside them the code and power tables of the pyramid.
    Returns None when any component exceeds int32 (the host path handles
    those)."""
    from mapper_tpu_torch.batch.candidates import _strand_tables

    device = torch.device(device)
    with lock or contextlib.nullcontext():
        merged = database.merged_index()
        caches = database.__dict__.setdefault("_device_index_cache", {})
        cached = caches.get(str(device))
        if cached is not None and cached["through"] == merged["through"]:
            return cached["arrays"]
        values = merged["values"]
        rev_flags, fwd_index, seq_lengths = _strand_tables(database)
        seq_db = database.get_sequence_database()
        if (
            values.shape[0] >= 2**31
            or merged["counts"].shape[0] >= 2**31
            or (values.shape[0] and int(values.max()) >= 2**31)
            or seq_db.starts[-1] >= 2**31
            or int(seq_lengths.max(initial=0)) >= 2**31
        ):
            arrays = None
        else:
            def up(a, dtype):
                return _upload(np.asarray(a, dtype=dtype), device)

            starts = up(seq_db.starts, np.int64)
            arrays = {
                **_code_tables(device),
                "capacities": up(merged["capacities"], np.int64),
                "caps": up(merged["caps"], np.int64),
                "bases": up(merged["bases"], np.int64),
                "counts": up(merged["counts"], np.int32),
                "offsets": up(merged["offsets"], np.int32),
                "values": up(merged["values"], np.int32),
                "rev_flags": up(rev_flags, np.int64),
                "fwd_index": up(fwd_index, np.int64),
                "seq_lengths": up(seq_lengths, np.int64),
                "rc_index": up(database._rc_index, np.int64),
                "seq_starts": starts,
                "seq_starts_tail": starts[1:].contiguous(),
            }
        caches[str(device)] = {"through": merged["through"], "arrays": arrays}
        return arrays


def program_inputs(batch, database, device, lock=None):
    """The candidates program's inputs for an ambiguity-free ReadBatch: a
    dict of the read codes [B, L] (L the longest read rounded up to
    LENGTH_BUCKET) and lengths on `device`, the index tensors and the
    scalars, or None where the reference declines the batch (an index or a
    reference past int32, an empty batch or database, a vote key space past
    int32)."""
    device = torch.device(device)
    index = device_index_arrays(database, device, lock)
    if index is None:
        return None
    seq_db = database.get_sequence_database()
    n_seqs = seq_db.get_num_sequences()
    if n_seqs == 0 or batch.num_reads == 0:
        return None
    max_len = int(batch.lengths.max())
    longest_contig = int(max((len(s) for s in seq_db.get_all()), default=1))
    span = longest_contig + 2 * max_len + 2
    bias = max_len + 1
    if 2 * n_seqs * span + bias >= 2**31:
        return None
    b = batch.num_reads
    l = -(-max_len // LENGTH_BUCKET) * LENGTH_BUCKET
    codes = np.zeros((b, l), dtype=np.uint8)
    seg = batch.seg.astype(np.int64)
    codes[seg, np.arange(batch.codes.shape[0]) - batch.starts[seg]] = batch.codes
    return {
        "codes": _upload(codes, device),
        "lengths": _upload(batch.lengths.astype(np.int64), device),
        "index": index,
        "max_size": int(database.get_hashed_length()),
        "n_seqs": n_seqs,
        "span": span,
        "bias": bias,
        "min_size": int(database.get_min_interesting_size()),
    }


def generate_candidates_device(batch, database, device, max_candidates_per_read: int = 8):
    """Candidate generation on `device` for an ambiguity-free ReadBatch.

    Returns (CandidateTable, fallback_read_ids): the reads the fixed budgets
    could not finish (pyramid unconverged after NUM_LEVELS, more than V_SLOTS
    usable seeds, more than P_SLOTS vote entries) are listed for the host
    path.  Returns None where `program_inputs` declines the batch."""
    inputs = program_inputs(batch, database, device)
    if inputs is None:
        return None
    out = candidates_program(inputs, int(max_candidates_per_read))
    return _decode_output(
        out.cpu().numpy(), int(max_candidates_per_read), inputs["n_seqs"], inputs["span"], inputs["bias"]
    )


# ---------------------------------------------------------------------------
# fused candidates + banded scoring: one device program, one copy a chunk
# ---------------------------------------------------------------------------


def fused_program(inputs: dict, params, band: int, k_out: int = 8) -> torch.Tensor:
    """The candidates program on `fused_inputs` and the banded scoring of
    the kept candidate rows, on their device.

    Returns one flat int32 vector: the [B*(2K+1)] candidate table (keys,
    votes, fallback flag) followed by the [2*C] float32 scores (banded, then
    ungapped at the voted lane) bit-cast to int32, for the kept rows in
    read-major, vote-rank-minor order: the order the host reproduces from
    the decoded table, so no row metadata needs to come back."""
    table = candidates_program(inputs, k_out)
    table, *rows = fused_rows(table, inputs, band, k_out)
    scores = banded_scores_gathered(inputs["codes"], inputs["concat"], *rows, params, band)  # [2, C] float32
    return torch.cat([table.reshape(-1), scores.reshape(-1).view(torch.int32)])


def fused_rows(table: torch.Tensor, inputs: dict, band: int, k_out: int = 8) -> tuple:
    """The kept rows of the candidates program's `table` and their scoring
    geometry, on their device: (table with the C-budget overflow in its
    fallback column, then `banded_scores_gathered`'s read_id, reversed_,
    win_start, lane, n and m over `score_rows(B)` rows).
    `fused_rows_plain` on the CPU, KC2 (`kernels.fused_rows`, which updates
    `table` in place) on a card."""
    if _device_of(inputs, "fused_rows").type == "cpu":
        return fused_rows_plain(table, inputs, band, k_out)
    index = inputs["index"]
    return kernels.fused_rows(
        table, inputs["lengths"], inputs["shift"], index["seq_lengths"], index["seq_starts"],
        inputs["n_seqs"], inputs["span"], inputs["bias"], score_rows(table.shape[0]), band, k_out,
    )


def fused_rows_plain(table: torch.Tensor, inputs: dict, band: int, k_out: int = 8) -> tuple:
    """`fused_rows` in PyTorch tensor operations (KC2's plain version); the
    returned table is a new tensor."""
    lengths, index = inputs["lengths"], inputs["index"]
    n_seqs, span, bias = inputs["n_seqs"], inputs["span"], inputs["bias"]
    b = table.shape[0]
    c_slots = score_rows(b)
    device = table.device
    table = table.long()

    keys = table[:, :k_out]
    votes = table[:, k_out : 2 * k_out]
    top = votes[:, 0:1]
    keep = (votes > 0) & ((top < 6) | (votes * 3 >= top))

    # decode candidate fields (floor division and modulo, as the host's numpy)
    offv = torch.remainder(keys, span) - bias
    rest = torch.div(keys, span, rounding_mode="floor")
    seq = torch.remainder(rest, n_seqs)
    mrev = torch.div(rest, n_seqs, rounding_mode="floor")

    # rank-compact the kept rows (read-major, rank-minor) to C slots
    read_id2 = torch.arange(b, device=device)[:, None].expand(b, k_out)
    flat_keep = keep.reshape(1, -1)
    (c_read, c_mrev, c_seq, c_offv), total = _rank_compact(
        [f.reshape(1, -1) for f in (read_id2, mrev, seq, offv)], flat_keep, c_slots
    )
    c_read, c_mrev, c_seq, c_offv = c_read[0], c_mrev[0], c_seq[0], c_offv[0]
    rank_all = torch.cumsum(flat_keep[0].to(torch.int64), dim=0) - 1
    # reads whose rows fell past the C budget: fallback
    dropped = flat_keep[0] & (rank_all >= c_slots)
    c_valid = torch.arange(c_slots, device=device) < torch.clamp(total[0], max=c_slots)
    overflow_reads = torch.any(dropped.reshape(b, k_out), dim=1)
    table[:, 2 * k_out] |= overflow_reads.to(torch.int64)

    # scoring geometry (the host replays it in numpy)
    n_row = lengths[c_read]
    shift_row = inputs["shift"][c_read]
    contig_len = index["seq_lengths"][c_seq]
    win_start_local = torch.clamp(c_offv - shift_row, min=0)
    win_end_local = torch.minimum(contig_len, c_offv + n_row + shift_row)
    w_len = torch.clamp(win_end_local - win_start_local, min=1)
    lane = c_offv - win_start_local
    win_start_global = index["seq_starts"][c_seq] + win_start_local
    n_row = torch.where(c_valid, torch.clamp(n_row, min=1), 1)
    return (
        table.to(torch.int32), c_read, c_mrev != 0, win_start_global, torch.clamp(lane, 0, band - 1),
        n_row.to(torch.int32), w_len.to(torch.int32),
    )


def score_rows(num_reads: int) -> int:
    """The fused program's scored-row budget for a chunk of `num_reads`."""
    return -(-int(num_reads * C_PER_READ) // SCORE_TILE) * SCORE_TILE


def fused_inputs(batch, database, concat, shift, band: int, lock=None):
    """`program_inputs` plus the fused program's own (the reference codes on
    the device, the per-read half-window `shift`), or None where the
    reference declines the batch, which adds a concat whose windows could
    pass int32."""
    inputs = program_inputs(batch, database, concat.device, lock)
    if inputs is None:
        return None
    if int(concat.shape[0]) + int(batch.lengths.max()) + band >= 2**31:
        return None
    inputs["concat"] = concat
    inputs["shift"] = _upload(np.asarray(shift, dtype=np.int64), concat.device)
    return inputs


def fused_candidates_scores(
    batch,
    database,
    concat,
    params,
    shift,
    band: int,
    max_candidates_per_read: int = 8,
    lock=None,
):
    """Fused candidates and scoring for an ambiguity-free ReadBatch on the
    device of `concat` (the reference codes, `engine.upload_reference`).

    Returns (out, finish), or None where `fused_inputs` declines the batch.
    `out` is the program's int32 vector on the host: on a CUDA device a
    pinned buffer whose copy is still in flight behind a CUDA event.
    finish() waits for the copy and returns (CandidateTable,
    fallback_read_ids, banded [rows], ungapped [rows]), the scores in the
    table's row order."""
    inputs = fused_inputs(batch, database, concat, shift, band, lock)
    if inputs is None:
        return None
    k_out = int(max_candidates_per_read)
    dev_out = fused_program(inputs, params, band, k_out)
    if dev_out.is_cuda:
        out = torch.empty(dev_out.shape, dtype=dev_out.dtype, pin_memory=True)
        out.copy_(dev_out, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
    else:
        out, done = dev_out, None
    b = batch.num_reads
    c_slots = score_rows(b)
    n_seqs, span, bias = inputs["n_seqs"], inputs["span"], inputs["bias"]

    def finish():
        if done is not None:
            done.synchronize()
        flat = out.numpy()
        table_flat = flat[: b * (2 * k_out + 1)].reshape(b, 2 * k_out + 1)
        scores = flat[b * (2 * k_out + 1) :].view(np.float32).reshape(2, c_slots)
        table, fallback_ids = _decode_output(table_flat, k_out, n_seqs, span, bias)
        rows = len(table)
        # rows past the C budget were not scored (their reads carry the
        # fallback flag); inf keeps them out of every decision
        banded = np.full(rows, np.inf, dtype=np.float64)
        ungapped = np.full(rows, np.inf, dtype=np.float64)
        k = min(rows, c_slots)
        banded[:k] = scores[0, :k]
        ungapped[:k] = scores[1, :k]
        return table, fallback_ids, banded, ungapped

    return out, finish


def _decode_output(out: np.ndarray, k_out: int, n_seqs: int, span: int, bias: int):
    """[B, 2K+1] int32 -> (CandidateTable, fallback_read_ids)."""
    from mapper_tpu_torch.batch.candidates import CandidateTable

    keys = out[:, :k_out].astype(np.int64)
    votes = out[:, k_out : 2 * k_out]
    fallback = out[:, 2 * k_out] != 0
    present = votes > 0
    # the vote-noise filter (filtered ranks still consume top-K slots, as in
    # the host paths)
    top = votes[:, 0:1]
    keep = present & ((top < 6) | (votes * 3 >= top))
    read_idx, rank_idx = np.nonzero(keep)
    key = keys[read_idx, rank_idx]
    offv = key % span - bias
    rest = key // span
    seq = (rest % n_seqs).astype(np.int32)
    mrev = (rest // n_seqs).astype(bool)
    table = CandidateTable(
        read_idx.astype(np.int32),
        mrev,
        seq,
        offv,
        votes[read_idx, rank_idx].astype(np.int32),
    )
    return table, np.nonzero(fallback)[0]
