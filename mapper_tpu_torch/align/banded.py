"""Banded affine-gap DP scoring in PyTorch: the plain versions and the
entry point that routes CUDA tensors to the hand-written kernels.

Counterpart of `mapper_tpu/align/pallas_dp.py`.  The scoring model is the
same: a glocal banded DP in band coordinate k = y - x over the query
positions x, with per-base mismatch/ambiguity penalties from the 4-bit
nibble codes, separate insertion/deletion open+extend costs, a free leading
window skip (`best0 = 0` where k <= m) and a free trailing skip (the score is
captured at x + 1 == n over the lanes with x + 1 + k <= m).

Two number formats, chosen by `_quantize_params` alone:
- int16 units of 1/scale saturating at INF16 (`_pen_core_i16`), exact;
- float32 (`_pen_core`), bit-for-bit the reference's operation order.

Two entry points:
- `banded_scores_gathered` scores candidates against a reference held on the
  device (the engine's path);
- `banded_scores` scores host-built query rows against host-built windows,
  with the variants "pen" (int16 or f32; on the card at band 64 the int16
  rows are packed two candidates per warp), "roll" and "chunk".

The plain functions here are the CPU path and the oracle that the CUDA
kernels (`align/kernels.py`, `align/csrc/banded_dp.cu`) are held against.
"""

from __future__ import annotations

import numpy as np
import torch

from mapper_tpu_torch.align import kernels

BIG = 1e9
INF16 = 16384  # saturation "infinity" for the int16 fixed-point path
DEFAULT_CHUNK = 128


def _quantize_params(params, lq: int, band: int):
    """Fixed-point scale for the int16 path: the smallest integer scale
    <= 1024 making every penalty unit an exact integer (defaults are
    1/30-rational: mutation 1, ambiguity/3 = 1/30, ins open 2.1, ...).
    Returns (scale, int unit tuple) or None when the parameters are not
    exactly representable or a worst-case in-band score could saturate."""
    # quantize the exact float64 parameter values (the f32-rounded tuple the
    # float path uses is off integer multiples by ~1e-6: f32(2.1)*30 != 63)
    units = (
        float(params.mutation_penalty),
        float(params.ambiguity_penalty) / 3.0,
        float(params.insertion_start_penalty) + float(params.insertion_extension_penalty),
        float(params.insertion_extension_penalty),
        float(params.deletion_start_penalty) + float(params.deletion_extension_penalty),
        float(params.deletion_extension_penalty),
    )
    for scale in range(1, 1025):
        scaled = [u * scale for u in units]
        if all(abs(s - round(s)) < 1e-6 for s in scaled):
            ints = tuple(int(round(s)) for s in scaled)
            # saturation is monotone, so any true score below the ceiling is
            # exact; leave 2x headroom over the padded-length accept budget
            # (query_len * MaxErrorRate, AlignmentParameters.java:23-27)
            budget = lq * max(params.max_error_rate, 0.5) * scale
            if 2 * budget >= INF16:
                return None
            # no int16 overflow before the saturating clamp: the largest
            # pre-clamp value is INF16 + band * unit
            if INF16 + band * max(ints) >= 2**15 - 1:
                return None
            return scale, ints
    return None


def _params_tuple(params):
    """The six float32-rounded penalties of the f32 path: mutation,
    ambiguity, insertion open (start + extension), insertion extension,
    deletion open, deletion extension."""
    return tuple(
        float(np.float32(v))
        for v in (
            params.mutation_penalty,
            params.ambiguity_penalty,
            params.insertion_start_penalty + params.insertion_extension_penalty,
            params.insertion_extension_penalty,
            params.deletion_start_penalty + params.deletion_extension_penalty,
            params.deletion_extension_penalty,
        )
    )


def _popcount4(union):
    return (union & 1) + ((union >> 1) & 1) + ((union >> 2) & 1) + ((union >> 3) & 1)


def _ambiguity_table(ambiguity: float, device) -> torch.Tensor:
    """f32(ambiguity * f32(popcount - 1) / 3) for popcount 1..4, each step an
    IEEE float32 operation in the reference's order.  A table keeps the
    division exact on every device (PyTorch turns a division by a Python
    scalar on CUDA into a multiplication by its reciprocal)."""
    amb = np.float32(ambiguity)
    vals = [amb * np.float32(i) / np.float32(3.0) for i in range(4)]
    return torch.tensor(np.array(vals, dtype=np.float32), device=device)


def _base_penalty(q, w, amb_table, mutation):
    """Float32 penalty between 4-bit codes (int32 tensors): the ambiguity
    share of the union's extra bits when the codes can match (looked up in
    `_ambiguity_table`), the mutation penalty (a 0-dim float32 tensor)
    otherwise."""
    union = q | w
    can_match = (q & w) != 0
    amb = amb_table[(_popcount4(union) - 1).clamp(0, 3)]
    return torch.where(can_match, amb, mutation)


def _base_penalty_i16(q, w, mutation_i: int, amb_unit_i: int):
    """Integer penalty units between 4-bit codes: amb_unit per extra union
    bit when compatible, mutation units otherwise (int32 in, int32 out)."""
    union = q | w
    can_match = (q & w) != 0
    return torch.where(can_match, amb_unit_i * (_popcount4(union) - 1), mutation_i).to(
        torch.int32
    )


def _steps(band: int):
    """The Kogge-Stone strides 1, 2, 4, ... below `band`."""
    step = 1
    while step < band:
        yield step
        step *= 2


def _dp_step(x, state, pen, n, m, k_range, consts, band: int, inf, sat):
    """One query-position step of the banded DP, shared by the int16-unit
    and the float32 paths.

    state: (best, ins_x, result); best/ins_x [B, BAND], result [B].
    pen [B, BAND] is the penalty of the diagonal step at x; n/m [B, 1].
    `sat` is the saturating clamp of the int path (identity for f32) and
    `inf` its ceiling (INF16, or BIG)."""
    best, ins_x, result = state
    ins_open, ins_ext, del_open, step_ext = consts
    b = best.shape[0]
    w_valid = (x + k_range) < m
    active = x < n
    fill = torch.full((b, 1), inf, dtype=best.dtype, device=best.device)

    diag_new = torch.where(w_valid & active, sat(best + pen), fill)
    ins_candidates = sat(torch.minimum(ins_x + ins_ext, best + ins_open))
    ins_shifted = torch.cat([ins_candidates[:, 1:], fill], dim=1)
    ins_new = torch.where(active, ins_shifted, fill)
    best_after = torch.minimum(diag_new, ins_new)

    # deletion chain within the new row: min-plus Kogge-Stone scan along the
    # band (the reference's order, so the float path rounds identically)
    chain = sat(torch.cat([fill, best_after[:, :-1]], dim=1) + del_open)
    for step in _steps(band):
        moved = torch.cat([fill.expand(b, step), chain[:, :-step]], dim=1)
        chain = torch.minimum(chain, sat(moved + step_ext[step]))
    chain = torch.where(w_valid & active, chain, fill)

    best_new = torch.minimum(best_after, chain)
    best = torch.where(active, best_new, best)
    ins_x = torch.where(active, ins_new, ins_x)

    finished = (x + 1) == n  # [B, 1]
    tail_valid = ((x + 1) + k_range) <= m  # window skip after the query is free
    captured = torch.where(tail_valid, best, fill).amin(dim=1)
    result = torch.where(finished[:, 0], captured, result)
    return best, ins_x, result


def _run_dp(pen_of, n, m, lq: int, band: int, consts, dtype, inf, sat):
    """The DP over x in [0, lq) with penalty rows from `pen_of(x)`; also
    accumulates the per-diagonal ungapped sums in x order."""
    b = n.shape[0]
    device = n.device
    n = n.reshape(-1, 1)
    m = m.reshape(-1, 1)
    k_range = torch.arange(band, device=device)[None, :]
    best = torch.where(
        k_range <= m,
        torch.zeros((), dtype=dtype, device=device),
        torch.full((), inf, dtype=dtype, device=device),
    )
    ins_x = torch.full((b, band), inf, dtype=dtype, device=device)
    result = torch.full((b,), inf, dtype=dtype, device=device)
    diag = torch.zeros((b, band), dtype=dtype, device=device)
    zero = torch.zeros((), dtype=dtype, device=device)
    state = (best, ins_x, result)
    for x in range(lq):
        pen = pen_of(x)
        diag = diag + torch.where(x < n, pen, zero)
        state = _dp_step(x, state, pen, n, m, k_range, consts, band, inf, sat)
    return state[2], diag


def _pen_core_i16(q_codes, w_codes, n, m, ints, band: int):
    """Fixed-point DP: int32 codes [B, LQ] and windows [B, LQ + BAND] in,
    (scores [B], diag_sums [B, BAND]) out in integer units of 1/scale, every
    value clamped to INF16 exactly as the int16 reference clamps it."""
    lq = q_codes.shape[1]
    mutation_i, amb_unit_i, ins_open, ins_ext, del_open, del_ext = (int(v) for v in ints)

    def sat(v):
        return torch.clamp_max(v, INF16)

    def pen_of(x):
        return _base_penalty_i16(
            q_codes[:, x : x + 1], w_codes[:, x : x + band], mutation_i, amb_unit_i
        )

    step_ext = {s: s * del_ext for s in _steps(band)}
    return _run_dp(
        pen_of, n, m, lq, band, (ins_open, ins_ext, del_open, step_ext),
        torch.int32, INF16, sat,
    )


def _pen_core(q_codes, w_codes, n, m, params6, band: int):
    """Float32 DP: as `_pen_core_i16` with the six float32 penalties of
    `_params_tuple`; outputs in penalty units, BIG where no path fits."""
    lq = q_codes.shape[1]
    mutation, ambiguity, ins_open, ins_ext, del_open, del_ext = params6
    amb_table = _ambiguity_table(ambiguity, q_codes.device)
    mutation_t = torch.tensor(np.float32(mutation), device=q_codes.device)

    def pen_of(x):
        return _base_penalty(
            q_codes[:, x : x + 1], w_codes[:, x : x + band], amb_table, mutation_t
        )

    # step * del_ext is a float32 product in the reference
    step_ext = {s: float(np.float32(s) * np.float32(del_ext)) for s in _steps(band)}
    return _run_dp(
        pen_of, n, m, lq, band, (ins_open, ins_ext, del_open, step_ext),
        torch.float32, BIG, lambda v: v,
    )


def _inv(scale: int) -> float:
    return float(np.float32(1.0) / np.float32(scale))


def _from_units(scores_i, diag_i, scale: int):
    """Integer-unit scores and diagonal sums to float32 penalty units: BIG
    at or above INF16, else times f32(1) / f32(scale)."""
    inv = _inv(scale)
    scores = torch.where(
        scores_i >= INF16,
        torch.tensor(BIG, dtype=torch.float32, device=scores_i.device),
        scores_i.to(torch.float32) * inv,
    )
    return scores, diag_i.to(torch.float32) * inv


def banded_scores_reference(q_codes, w_codes, n, m, params, band: int):
    """Plain float32 banded DP scores for host-built query and window codes:
    [B] float32, BIG where no alignment fits the band.  Windows shorter than
    LQ + BAND are zero-padded."""
    q = torch.as_tensor(np.asarray(q_codes), dtype=torch.int32)
    w = torch.as_tensor(np.asarray(w_codes), dtype=torch.int32)
    needed = q.shape[1] + band
    if w.shape[1] < needed:
        w = torch.nn.functional.pad(w, (0, needed - w.shape[1]))
    n_t = torch.as_tensor(np.asarray(n), dtype=torch.int32).reshape(-1)
    m_t = torch.as_tensor(np.asarray(m), dtype=torch.int32).reshape(-1)
    scores, _ = _pen_core(q, w, n_t, m_t, _params_tuple(params), band)
    return scores


def _gather_codes(reads_u8, concat_u8, read_id, reversed_, win_start, n, band: int):
    """Per-candidate query codes (reverse-complemented on the device where
    `reversed_`) and reference windows clamped to the concat's end."""
    lq = reads_u8.shape[1]
    q_fwd = reads_u8[read_id].to(torch.int32)  # [B, LQ]
    # complement = nibble bit-reversal (basepairs.COMPLEMENT_TABLE), order
    # reversed over the first n chars, zero past n
    comp = ((q_fwd & 1) << 3) | ((q_fwd & 2) << 1) | ((q_fwd & 4) >> 1) | ((q_fwd & 8) >> 3)
    pos = torch.arange(lq, device=reads_u8.device)[None, :]
    n_col = n.reshape(-1, 1)
    rc_idx = torch.clamp(n_col - 1 - pos, 0, lq - 1)
    rc = torch.gather(comp, 1, rc_idx.to(torch.int64))
    rc = torch.where(pos < n_col, rc, torch.zeros((), dtype=rc.dtype, device=rc.device))
    q_codes = torch.where(reversed_.reshape(-1, 1), rc, q_fwd)

    w_idx = win_start.reshape(-1, 1) + torch.arange(lq + band, device=concat_u8.device)[None, :]
    w_idx = torch.clamp(w_idx, 0, concat_u8.shape[0] - 1)
    w_codes = concat_u8[w_idx].to(torch.int32)
    return q_codes, w_codes


def _gathered_core(reads_u8, concat_u8, read_id, reversed_, win_start, lane, n, m, params, band: int):
    """Plain version of the fused candidate scorer: [2, B] float32, row 0
    the banded score, row 1 the ungapped penalty of the window diagonal at
    `lane` (clamped into the band)."""
    lq = reads_u8.shape[1]
    b = read_id.shape[0]
    q_codes, w_codes = _gather_codes(reads_u8, concat_u8, read_id, reversed_, win_start, n, band)
    quant = _quantize_params(params, lq, band)
    if quant is not None:
        scores, diag_sums = _from_units(
            *_pen_core_i16(q_codes, w_codes, n, m, quant[1], band), quant[0]
        )
    else:
        scores, diag_sums = _pen_core(q_codes, w_codes, n, m, _params_tuple(params), band)
    rows = torch.arange(b, device=diag_sums.device)
    ungapped = diag_sums[rows, torch.clamp(lane, 0, band - 1)]
    return torch.stack([scores, ungapped])


def _normalize(reads_u8, concat, read_id, reversed_, win_start, lane, n, m):
    """The argument dtypes the kernels take, on the tensors' own device."""
    return (
        reads_u8.to(torch.uint8).contiguous(),
        concat.to(torch.uint8).contiguous(),
        read_id.to(torch.int64).contiguous(),
        reversed_.to(torch.bool).contiguous(),
        win_start.to(torch.int64).contiguous(),
        lane.to(torch.int64).contiguous(),
        n.to(torch.int32).reshape(-1).contiguous(),
        m.to(torch.int32).reshape(-1).contiguous(),
    )


def banded_scores_gathered(
    reads_u8, concat, read_id, reversed_, win_start, lane, n, m, params, band: int, mesh=None,
):
    """Fused candidate scoring against a reference held on the device.

    reads_u8 [R, LQ] uint8 (0-padded rows, forward orientation only);
    concat [N] uint8: the concatenated reference codes (`upload_reference`);
    read_id/reversed_/win_start/lane/n/m: per-candidate vectors on the same
    device.  Returns [2, B] float32: the banded score (BIG where no path
    fits) and the ungapped penalty of the diagonal at `lane`.

    The int16/f32 choice is `_quantize_params(params, LQ, band)`.  A CPU
    tensor takes the plain version; a CUDA tensor launches the kernel.

    With a `mesh` (`parallel.mesh.make_mesh`) the candidate rows shard over
    it in contiguous slices (numpy or tensor vectors, moved to each entry's
    device), each scored on its entry's device, and the [2, B] result lies
    on the mesh's first device in row order.  `reads_u8` and `concat` are
    then lists of one copy per mesh entry (`parallel.mesh.replicate`)."""
    if mesh is not None:
        return _gathered_on_mesh(
            mesh, reads_u8, concat, (read_id, reversed_, win_start, lane, n, m), params, band
        )
    device = reads_u8.device
    args = _normalize(reads_u8, concat, read_id, reversed_, win_start, lane, n, m)
    if device.type == "cpu":
        return _gathered_core(*args, params, band)
    if device.type != "cuda":
        raise ValueError(f"banded_scores_gathered: unsupported device {device}")
    lq = reads_u8.shape[1]
    quant = _quantize_params(params, lq, band)
    if quant is not None:
        return kernels.banded_i16(*args, quant[1], _inv(quant[0]), band)
    return kernels.banded_f32(*args, _params_tuple(params), band)


def _gathered_on_mesh(mesh, reads_u8, concat, vectors, params, band: int):
    """`banded_scores_gathered` with the candidate rows sharded over `mesh`:
    the port's `shard_map` of `_gathered_core` (`pallas_dp._gathered_fn`)."""
    from mapper_tpu_torch.parallel import mesh as mesh_lib

    reads, refs = reads_u8, concat
    if not all(isinstance(c, (list, tuple)) and len(c) == len(mesh) for c in (reads, refs)):
        raise ValueError("banded_scores_gathered: one reads and reference copy per mesh entry")

    def shard(device, reads_d, concat_d, *vecs):
        return banded_scores_gathered(reads_d, concat_d, *vecs, params, band).to(mesh[0])

    shards = mesh_lib.shard_batch(mesh, *vectors)
    outs = mesh_lib.on_shards(
        mesh, shard, [(reads[i], refs[i], *(s[i] for s in shards)) for i in range(len(mesh))]
    )
    return torch.cat(outs, dim=1)


def _host_rows(q_codes, w_codes, n, m, band: int, chunk: int):
    """The host-window layout on the tensors' device: query codes zero-padded
    to lq_padded = ceil(LQ / chunk) * chunk, windows zero-padded or cut to
    lq_padded + band (uint8), and n/m as int32 vectors."""
    q = torch.as_tensor(q_codes)
    device = q.device
    b, lq = q.shape
    lq_padded = -(-lq // chunk) * chunk
    q_rows = torch.zeros((b, lq_padded), dtype=torch.uint8, device=device)
    q_rows[:, :lq] = q
    w = torch.as_tensor(w_codes, device=device)
    width = min(w.shape[1], lq_padded + band)
    w_rows = torch.zeros((b, lq_padded + band), dtype=torch.uint8, device=device)
    w_rows[:, :width] = w[:, :width]

    def lengths(v):
        return torch.as_tensor(v, device=device).to(torch.int32).reshape(-1).contiguous()

    return q_rows, w_rows, lengths(n), lengths(m)


def _rows_as_candidates(q_rows, w_rows, n, m):
    """The gathered kernels' arguments for host rows: each row is its own
    read, scored forward, against its window laid end to end with the
    others as the reference."""
    b = q_rows.shape[0]
    idx = torch.arange(b, device=q_rows.device)
    return (
        q_rows, w_rows.reshape(-1), idx, torch.zeros(b, dtype=torch.bool, device=q_rows.device),
        idx * w_rows.shape[1], torch.zeros_like(idx), n, m,
    )


def banded_scores(
    q_codes, w_codes, n, m, params, band: int = 128, chunk: int = DEFAULT_CHUNK,
    variant: str = "pen", return_diag_sums: bool = False,
):
    """Banded-DP scores of host-built rows: q_codes [B, LQ] (0-padded codes),
    w_codes [B, LW] windows, n/m [B] their lengths, all on one device.  A CPU
    tensor takes the plain versions; a CUDA tensor launches the kernels.

    The query width is padded to a multiple of `chunk` and the windows to
    that width + band; the int16/f32 choice is `_quantize_params` at the
    padded width.  variant "pen" returns scores [B] float32 (BIG where no
    path fits), with (scores, diag_sums [B, band]) when `return_diag_sums`.
    On the card, int16 rows at band 64 take the packed kernel (two candidates
    a warp, one in each int16 half), bit-identical to banded_i16 and faster
    than it on the same rows, timed in turns (PERF.md); other "pen" rows take
    banded_i16 or banded_f32.  "roll" and any other variant ("chunk") return
    the float32 scores only, through the whole-row and the chunked kernel.
    An empty batch launches nothing."""
    device = torch.as_tensor(q_codes).device
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"banded_scores: unsupported device {device}")
    q, w, n_t, m_t = _host_rows(q_codes, w_codes, n, m, band, chunk)
    if q.shape[0] == 0:
        scores = torch.empty(0, dtype=torch.float32, device=device)
        if variant == "pen" and return_diag_sums:
            return scores, torch.empty((0, band), dtype=torch.float32, device=device)
        return scores
    params6 = _params_tuple(params)
    quant = _quantize_params(params, q.shape[1], band) if variant == "pen" else None
    if device.type == "cpu":
        qi, wi = q.to(torch.int32), w.to(torch.int32)
        if quant is None:
            scores, diag = _pen_core(qi, wi, n_t, m_t, params6, band)
        else:
            scores, diag = _from_units(*_pen_core_i16(qi, wi, n_t, m_t, quant[1], band), quant[0])
        if variant != "pen":
            return scores
    else:
        if variant == "roll":
            return kernels.banded_roll_f32(q, w, n_t, m_t, params6, band)
        if variant != "pen":
            return kernels.banded_chunk_f32(q, w, n_t, m_t, params6, band, chunk)
        if quant is not None and band == kernels.PACKED_BAND:
            scores, diag = kernels.banded_i16_packed(q, w, n_t, m_t, quant[1], _inv(quant[0]))
        else:
            diag = torch.empty((q.shape[0], band), dtype=torch.float32, device=device)
            rows = _rows_as_candidates(q, w, n_t, m_t)
            if quant is None:
                out = kernels.banded_f32(*rows, params6, band, diag_out=diag)
            else:
                out = kernels.banded_i16(*rows, quant[1], _inv(quant[0]), band, diag_out=diag)
            scores = out[0]
    if return_diag_sums:
        return scores, diag
    return scores
