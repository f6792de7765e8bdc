"""The card's peaks and K1's least time, frozen from `chip_smoke.py`
(`DP_RATES`, `cells_of`, `bound`) so that later edits there do not move
this yardstick.

Peaks of one NVIDIA H100 SXM at its 700 W limit: memory 3.35 TB/s (NVIDIA's
data sheet); 132 SMs at the 1.98 GHz boost clock, each with 64 int32 lanes,
so 16.7 T int32 operations a second.  An int32 lane takes two int16 in one
s16x2 instruction (SIMD `__vmins2`, DPX `__viaddmin_s16x2`), so the int16
DP runs at twice that: 33.5 T int16 operations a second.  K1's DP cell
needs 10 int16 operations: the penalty lookup; the diagonal add and clamp;
the insertion's extend and clamp, then its open and their min (2); the min
of the diagonal and the insertion; the deletion's open and clamp, then its
extend and the min with the chain (2); the final min; the validity select;
the diagonal sum's add."""

from __future__ import annotations

MEM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
I16_OPS_PER_S = 2 * INT32_OPS_PER_S
I16_OPS_PER_CELL = 10


def k1_least_seconds(cells: float, moved_bytes: float) -> float:
    """The least time of one K1 call: the larger of its DP cells' int16
    operations over the card's rate and its bytes (each input read once,
    each output written once) over the memory rate."""
    return max(cells * I16_OPS_PER_CELL / I16_OPS_PER_S, moved_bytes / MEM_BYTES_PER_S)


def is_k1(kernel_name: str) -> bool:
    """K1's kernels as the device trace names them: the warp kernel at bands
    64 and 128, the block kernel on int16 elsewhere."""
    return "banded_i16_warp_kernel" in kernel_name or (
        "banded_kernel<" in kernel_name and "I16" in kernel_name)


def cells_of(n, lq: int, band: int):
    """DP cells of a call's rows: min(n, lq) read positions times the band,
    as a device scalar (read once, after the window)."""
    import torch

    return torch.clamp(n.to(torch.int64), max=lq).sum() * band
