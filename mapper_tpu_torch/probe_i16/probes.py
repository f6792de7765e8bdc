"""The int16 probe bodies of `benchmarks/probe_i16` (P1-P9), each with its
plain PyTorch version, and `run`, which takes a body to its kernel on a CUDA
tensor and to its plain version on a CPU tensor.

Every body maps an int16 block x [T, B] (rows are the probes' T, lanes their
B) to int16 [T, B], or [T, 1] for the bodies that reduce a row.  The plain
versions compute in int16 as the JAX bodies do: adds and subtracts wrap
modulo 2^16 and `>>` is arithmetic (PyTorch's int16 ops do both, and
`torch.where` of an int16 tensor and a Python int stays int16); `u16min`
goes through int32 `& 0xFFFF`, since CPU PyTorch lacks most uint16 ops.
The lane constants of the bodies (`k < 40`, `k <= 100`, `k < 120`, ...) are
the probes' own, whatever B is.
"""

from __future__ import annotations

import numpy as np
import torch

from mapper_tpu_torch.align import kernels

T, B = 64, 128  # the probes' block
INF16 = 16384
CONST = 37  # f.py's bound

# stage -> its bodies, in the probe's order (kernels.probe_i16 numbers them so)
STAGES: dict[str, tuple[str, ...]] = {
    "a": ("copy", "add_sat", "concat_shift", "where_iota", "select_cast", "widen_reduce",
          "narrow_out", "scratch_i16", "kogge_stone"),
    "b": ("add_full", "add_only_scalar", "min_only_scalar", "ks_full"),
    "c": ("min_where", "ks_where", "reduce_i32"),
    "d": ("amin", "ks_amin"),
    "e": ("sub", "shr", "band", "vec_add"),
    "f": ("i32min", "u16min", "f32min", "mulsel", "i32cmp"),
    "g": ("reduce", "where1d", "where1d_i32cmp", "select2", "step"),
    "h": ("s1_diag", "s2_ins", "s3_chain_open", "s4_ks_loop"),
    "i": ("a_scalar_select_add", "b_add_imin", "c_select_of_imin", "d_select_feed_imin"),
}
# the `pl.pallas_call` site each stage's kernel replaces (its probe() helper)
SITES = {
    stage: f"benchmarks/probe_i16/{stage}.py:{line}"
    for stage, line in zip(STAGES, (19, 14, 14, 14, 14, 27, 25, 20, 15))
}
REDUCES = frozenset(
    {("a", "widen_reduce"), ("a", "narrow_out"), ("c", "reduce_i32"), ("g", "reduce"),
     ("g", "where1d"), ("g", "where1d_i32cmp")}
)


def probe_input(device="cpu") -> torch.Tensor:
    """The JAX probes' own input: arange(T * B) % 100, int16 [T, B]."""
    x = np.arange(T * B, dtype=np.int16).reshape(T, B) % 100
    return torch.from_numpy(x).to(device)


# -- helpers: the jnp idioms of the probes, in int16 -------------------------


def _full(x, value, cols=None):
    cols = x.shape[1] if cols is None else cols
    return torch.full((x.shape[0], cols), value, dtype=torch.int16, device=x.device)


def _lane(x):
    """broadcasted_iota over the lanes, [1, B]."""
    return torch.arange(x.shape[1], device=x.device)[None, :]


def _min(a, b):
    return torch.minimum(a, b) if isinstance(b, torch.Tensor) else torch.clamp(a, max=b)


def _amin(a, b):
    """d.py's arithmetic min b + (d & (d >> 15)), d = a - b, wrapping."""
    d = a - b
    return (d & (d >> 15)) + b


def _sat(v, mn=_min):
    return mn(v, INF16)


def _shift_right(x, step, fill):
    """concatenate([full((T, step), fill), x[:, :-step]], axis=1)"""
    return torch.cat([_full(x, fill, step), x[:, :-step]], dim=1)


def _shift_left1(x, fill):
    """concatenate([x[:, 1:], full((T, 1), fill)], axis=1)"""
    return torch.cat([x[:, 1:], _full(x, fill, 1)], dim=1)


def _ks(chain, ext, mn=_min):
    """The min-plus Kogge-Stone scan: chain = min(chain, min(moved + step * ext, INF16))."""
    step = 1
    while step < chain.shape[1]:
        moved = _shift_right(chain, step, INF16)
        chain = mn(chain, mn(moved + step * ext, INF16))
        step *= 2
    return chain


def _row_min(x):
    """min over the lanes, widened to int32 and narrowed back: [T, 1]."""
    return x.to(torch.int32).amin(dim=1, keepdim=True).to(torch.int16)


# the pieces of g.step (h.s1-s4): ins_open 63, ins_ext 18, del_open 60, del_ext 15
def _best0(x):
    return torch.where(_lane(x) <= 100, _full(x, 0), INF16)


def _diag(x, best):
    return torch.where(_lane(x) < 120, _sat(best + x), INF16)


def _ins_shift(best, ins):
    return _shift_left1(_sat(_min(ins + 18, best + 63)), INF16)


def _chain_open(best_after):
    return _sat(_shift_right(best_after, 1, INF16) + 60)


def _step(x):
    best, ins = _best0(x), _full(x, INF16)
    best_after = _min(_diag(x, best), _ins_shift(best, ins))
    chain = _ks(_chain_open(best_after), 15)
    chain = torch.where(_lane(x) < 120, chain, INF16)
    return _min(best_after, chain)


def _mulsel(x):
    d = (x + 7) - CONST
    neg = (d >> 15) & 1
    return d * neg + CONST


def _select_cast(x):
    out = _full(x, 4)
    for value, code in ((8, 3), (4, 2), (2, 1), (1, 0)):  # the first true condition wins
        out = torch.where(x == value, code, out)
    return out


PLAIN = {
    ("a", "copy"): lambda x: x.clone(),
    ("a", "add_sat"): lambda x: _sat(x + 3),
    ("a", "concat_shift"): lambda x: _shift_right(x, 1, 7),
    ("a", "where_iota"): lambda x: torch.where(_lane(x) < 40, x, 5),
    ("a", "select_cast"): _select_cast,
    ("a", "widen_reduce"): _row_min,
    ("a", "narrow_out"): lambda x: x[:, :1].clone(),
    ("a", "scratch_i16"): lambda x: x.clone(),
    ("a", "kogge_stone"): lambda x: _ks(x, 3),
    ("b", "add_full"): lambda x: _sat(x + 3),
    ("b", "add_only_scalar"): lambda x: x + 3,
    ("b", "min_only_scalar"): lambda x: _min(x, 90),
    ("b", "ks_full"): lambda x: _ks(x, 3),
    ("c", "min_where"): lambda x: _min(x + 7, 50),
    ("c", "ks_where"): lambda x: _ks(x, 3),
    ("c", "reduce_i32"): _row_min,
    ("d", "amin"): lambda x: _amin(x + 7, 50),
    ("d", "ks_amin"): lambda x: _ks(x, 3, _amin),
    ("e", "sub"): lambda x: x - 3,
    ("e", "shr"): lambda x: x >> 15,
    ("e", "band"): lambda x: x & 7,
    ("e", "vec_add"): lambda x: x + x,
    ("f", "i32min"): lambda x: _min((x + 7).to(torch.int32), CONST).to(torch.int16),
    ("f", "u16min"): lambda x: _min((x + 7).to(torch.int32) & 0xFFFF, CONST).to(torch.int16),
    ("f", "f32min"): lambda x: _min((x + 7).to(torch.float32), float(CONST)).to(torch.int16),
    ("f", "mulsel"): _mulsel,
    ("f", "i32cmp"): lambda x: torch.where((x + 7).to(torch.int32) < CONST, x + 7, CONST),
    ("g", "reduce"): _row_min,
    ("g", "where1d"): lambda x: torch.where(_row_min(x) > 0, _row_min(x), 7),
    ("g", "where1d_i32cmp"): lambda x: torch.where(_row_min(x) > 0, _row_min(x), 7),
    ("g", "select2"): lambda x: torch.where(_lane(x) < 50, x, 3),
    ("g", "step"): _step,
    ("h", "s1_diag"): lambda x: _diag(x, _best0(x)),
    ("h", "s2_ins"): lambda x: _min(_diag(x, _best0(x)), _ins_shift(_best0(x), _full(x, INF16))),
    ("h", "s3_chain_open"): lambda x: _chain_open(torch.where(_lane(x) <= 100, x, INF16)),
    ("h", "s4_ks_loop"): lambda x: _ks(x, 15),
    ("i", "a_scalar_select_add"): lambda x: _best0(x) + x,
    ("i", "b_add_imin"): lambda x: _sat(x + 3),
    ("i", "c_select_of_imin"): lambda x: torch.where(_lane(x) < 120, _sat(x + 3), INF16),
    ("i", "d_select_feed_imin"): lambda x: _sat(_best0(x) + x),
}


def _np_ks(x):
    chain = x.astype(np.int32)
    step = 1
    while step < chain.shape[1]:
        moved = np.concatenate([np.full((chain.shape[0], step), INF16), chain[:, :-step]], axis=1)
        chain = np.minimum(chain, np.minimum(moved + step * 3, INF16))
        step *= 2
    return chain.astype(np.int16)


def _np_min(x):
    return np.minimum(x + 7, CONST).astype(np.int16)


# the numpy checks of the JAX stages (d.py:50-60, f.py:51-52), on numpy int16
NUMPY_CHECKS = {
    ("d", "amin"): lambda x: np.minimum(x + 7, 50).astype(np.int16),
    ("d", "ks_amin"): _np_ks,
    **{("f", body): _np_min for body in STAGES["f"]},
}


def plain(stage: str, body: str, x: torch.Tensor) -> torch.Tensor:
    """The body's plain PyTorch version, on x's device."""
    return PLAIN[(stage, body)](x)


def run(stage: str, body: str, x: torch.Tensor) -> torch.Tensor:
    """Body `body` of probe stage `stage` on an int16 [rows, lanes] tensor:
    the plain version on a CPU tensor, the kernel (kernels.probe_i16) on a
    CUDA tensor."""
    index = STAGES[stage].index(body)
    if x.dtype != torch.int16 or x.dim() != 2:
        raise ValueError(f"probe {stage}.{body}: expected int16 [rows, lanes], got {x.dtype} {tuple(x.shape)}")
    if x.device.type == "cpu":
        return plain(stage, body, x)
    if x.device.type != "cuda":
        raise ValueError(f"probe {stage}.{body}: unsupported device {x.device}")
    return kernels.probe_i16(stage, index, x.contiguous(), (stage, body) in REDUCES)
