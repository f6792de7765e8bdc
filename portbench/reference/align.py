"""The least penalty of each read's alignment near its origin, worked out
from the generated reads and reference alone.

The penalty model is X-Mapper's (AlignmentParameters, the CLI's defaults):
a mismatch costs `mutation`, an insertion of k bases `ins_open + k *
ins_ext`, a deletion of k reference bases `del_open + k * del_ext`.  The
whole read is aligned (glocal) and the reference may overhang it on both
sides for free.  All penalties are whole tenths, so the dynamic programme
runs in int32 tenths and is exact.

One row of the programme is one read base; the columns are the window's
bases.  Insertions and matches come from the row above; deletions run
along the row, as a running minimum (`torch.cummin`), so a row is a dozen
tensor operations over every read of a block at once."""

from __future__ import annotations

import numpy as np
import torch

INF = 1 << 28
# bases by which a read's window is wider than its origin on each side: room
# for the traffic's 1-3 bp indels, with margin
PAD = 8


def tenths(x: float) -> int:
    t = round(x * 10)
    if abs(t - x * 10) > 1e-9:
        raise ValueError(f"penalty {x} is not a whole number of tenths")
    return int(t)


def penalties(config: dict) -> dict:
    """The configuration's penalties in tenths."""
    p = config["penalties"]
    return {k: tenths(v) for k, v in p.items()}


def windows(ref_len: int, start: np.ndarray, span: np.ndarray):
    """(first base, width) of each read's window: its origin `PAD` bases
    wider on each side, clamped to the reference."""
    lo = np.maximum(start - PAD, 0)
    hi = np.minimum(start + span + PAD, ref_len)
    return lo, int((hi - lo).max())


def _gather(ref: torch.Tensor, lo: torch.Tensor, width: int):
    idx = lo[:, None] + torch.arange(width, device=ref.device)[None, :]
    valid = idx < ref.shape[0]
    return torch.where(valid, ref[idx.clamp(max=ref.shape[0] - 1)], torch.zeros_like(ref[:1])), valid


def glocal_optimum(ref: np.ndarray, reads: np.ndarray, lo: np.ndarray, width: int, pen: dict,
                   device, block: int = 32768) -> np.ndarray:
    """Least penalty (tenths) of each read of `reads` [R, L] (codes, in the
    forward strand's orientation) aligned whole into the reference bases
    [lo, lo + width)."""
    ref_t = torch.as_tensor(ref, device=device)
    out = np.empty(reads.shape[0], dtype=np.int64)
    mis, io, ie, do, de = pen["mutation"], pen["ins_open"], pen["ins_ext"], pen["del_open"], pen["del_ext"]
    cols = torch.arange(width + 1, device=device, dtype=torch.int32)
    for b0 in range(0, reads.shape[0], block):
        q = torch.as_tensor(reads[b0 : b0 + block], device=device)
        w, valid = _gather(ref_t, torch.as_tensor(lo[b0 : b0 + block], device=device), width)
        r = q.shape[0]
        inf = torch.full((r, 1), INF, dtype=torch.int32, device=device)
        h = torch.zeros((r, width + 1), dtype=torch.int32, device=device)  # row 0: free start
        ins = torch.full_like(h, INF)
        for i in range(q.shape[1]):
            sub = torch.where((q[:, i : i + 1] & w) != 0, 0, mis).to(torch.int32)
            sub = torch.where(valid, sub, INF)
            diag = torch.cat([inf, h[:, :-1] + sub], dim=1)
            ins = torch.minimum(h + (io + ie), ins + ie)
            h0 = torch.minimum(diag, ins).clamp_(max=INF)
            # deletion ending at column j: open after column k < j, extend j - k
            run = torch.cummin(h0 - de * cols, dim=1).values
            dele = torch.cat([inf, run[:, :-1] + (do + de) + de * (cols[1:] - 1)], dim=1)
            h = torch.minimum(h0, dele).clamp_(max=INF)
        out[b0 : b0 + r] = h.min(dim=1).values.cpu().numpy()
    return out


def best_ungapped(ref: np.ndarray, reads: np.ndarray, lo: np.ndarray, width: int, pen: dict,
                  device, block: int = 32768) -> tuple[np.ndarray, np.ndarray]:
    """(least penalty in tenths, its first reference base) of each read
    placed without gaps anywhere in its window: the control's alignment,
    a scorer that never searches for an indel."""
    ref_t = torch.as_tensor(ref, device=device)
    n = reads.shape[1]
    pen_out = np.empty(reads.shape[0], dtype=np.int64)
    pos_out = np.empty(reads.shape[0], dtype=np.int64)
    for b0 in range(0, reads.shape[0], block):
        q = torch.as_tensor(reads[b0 : b0 + block], device=device)
        lo_t = torch.as_tensor(lo[b0 : b0 + block], device=device)
        w, valid = _gather(ref_t, lo_t, width)
        shifts = width - n + 1
        windows_ = w.unfold(1, n, 1)[:, :shifts]  # [R, shifts, n]
        ok = valid.unfold(1, n, 1)[:, :shifts].all(dim=2)
        mism = ((windows_ & q[:, None, :]) == 0).sum(dim=2).to(torch.int64) * pen["mutation"]
        mism = torch.where(ok, mism, INF)
        best = mism.min(dim=1)
        pen_out[b0 : b0 + q.shape[0]] = best.values.cpu().numpy()
        pos_out[b0 : b0 + q.shape[0]] = (lo_t + best.indices).cpu().numpy()
    return pen_out, pos_out
