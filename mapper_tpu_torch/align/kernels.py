"""Build, bind and launch the hand-written CUDA kernels of `csrc/`.

The sources (`banded_dp.cu`, `probe_i16.cu`, and the DP step they share,
`dp_core.cuh`) are compiled at first use by `nvcc`, one process per source,
all started together, and linked into one shared library with a plain C
interface, under a lock, into `mapper_tpu_torch/_build/`, keyed by the
sha256 of every source and header and of the flags, and loaded with ctypes.
There is no fallback: a missing `nvcc` or a failed build raises with the
compiler's message.

Three kinds of entry:
- `banded_i16` and `banded_f32` score candidates against a reference held on
  the device (reads, reference and per-candidate indices);
- `banded_i16_packed`, `banded_roll_f32` and `banded_chunk_f32` score
  host-built rows: query codes q [B, LQ] and windows w [B, LW >= LQ + band],
  uint8, with lengths n and m;
- `probe_i16` runs one body of the int16 probe kernels (P1-P9) on an int16
  [rows, lanes] block.

Each wrapper checks its tensors, allocates its outputs with `torch.empty`,
launches on the current CUDA stream, raises if the launch reported an error,
and adds one to its entry of `LAUNCHES`.  An empty candidate batch returns the
empty outputs without a launch, and is not counted.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-Xcompiler", "-fPIC",
]
PROBE_STAGES = "abcdefghi"  # P1-P9, benchmarks/probe_i16/{a..i}.py

# launches per kernel since the last reset (a run sets them to 0 itself)
LAUNCHES = {
    "banded_i16": 0,
    "banded_f32": 0,
    "banded_i16_packed": 0,
    "banded_roll_f32": 0,
    "banded_chunk_f32": 0,
    **{f"probe_i16_{stage}": 0 for stage in PROBE_STAGES},
}
PACKED_BAND = 64  # banded_i16_packed's per-candidate band (kHalf in the source)
_SMEM_LIMIT = 48 * 1024  # dynamic shared memory a block takes without opting in

_LOCK = threading.Lock()
_LIB = None

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_INT, _F32 = ctypes.c_int, ctypes.c_float
_COMMON_ARGS = [_P, _I64, _P, _I64, _P, _P, _P, _P, _P, _P, _I64, _INT]
_ROW_ARGS = [_P, _I64, _P, _I64, _P, _P, _I64]  # q, lq, w, lw, n, m, B


def find_nvcc() -> str | None:
    """`$CUDA_HOME/bin/nvcc`, else `nvcc` on PATH, else the toolkit's
    default install location."""
    candidates = []
    for var in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(var):
            candidates.append(Path(os.environ[var]) / "bin" / "nvcc")
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(Path(on_path))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file() and os.access(c, os.X_OK):
            return str(c)
    return None


def sources() -> list[Path]:
    """The `.cu` files the library is compiled from."""
    return sorted(CSRC.glob("*.cu"))


def _check_nvcc(cmd, returncode, stderr, what):
    if returncode != 0:
        raise RuntimeError(f"nvcc failed ({returncode}) {what}:\n{' '.join(cmd)}\n{stderr}")


def compile_library(target: Path) -> None:
    """Compile every source into the shared library `target` (written
    atomically): one nvcc per source, all started together, then one link
    (2.9-3.3 s on an H100 host, against 5.1-5.3 s for one `nvcc -shared`
    over every source).  Raises RuntimeError when nvcc is missing or fails."""
    nvcc = find_nvcc()
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, PATH and "
            "/usr/local/cuda/bin): the CUDA kernels cannot be built"
        )
    target.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=target.parent) as tmp:
        jobs = []
        for src in sources():
            obj = str(Path(tmp) / f"{src.stem}.o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            jobs.append((src, obj, cmd, proc))
        # every compiler has ended before any failure is raised
        stderrs = [proc.communicate()[1] for *_, proc in jobs]
        for (src, _, cmd, proc), stderr in zip(jobs, stderrs):
            _check_nvcc(cmd, proc.returncode, stderr, f"building {src.name}")
        lib = str(Path(tmp) / "kernels.so")
        cmd = [nvcc, "-shared", "-o", lib, *(obj for _, obj, _, _ in jobs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        _check_nvcc(cmd, proc.returncode, proc.stderr, "linking the kernels")
        os.replace(lib, target)


def library_path(build_dir: Path | None = None) -> Path:
    """The library's path, keyed by every file of `csrc/` (sources and the
    headers they include) and by the compiler flags."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        digest.update(f"\0{path.name}\0".encode() + path.read_bytes())
    return (build_dir or BUILD_DIR) / f"kernels_{digest.hexdigest()[:16]}.so"


def library(build_dir: Path | None = None):
    """The loaded kernel library, built first if this source's build is
    missing.  Thread-safe; the first caller pays the build."""
    global _LIB
    with _LOCK:
        if _LIB is not None and build_dir is None:
            return _LIB
        path = library_path(build_dir)
        if not path.exists():
            compile_library(path)
        lib = ctypes.CDLL(str(path))
        signatures = {
            "mapper_banded_i16": _COMMON_ARGS + [_INT] * 6 + [_F32, _P, _P, _P],
            "mapper_banded_f32": _COMMON_ARGS + [_F32] * 6 + [_P, _P, _P],
            "mapper_banded_i16_packed": _ROW_ARGS + [_INT] * 6 + [_F32, _P, _P, _P],
            "mapper_banded_roll_f32": _ROW_ARGS + [_INT] + [_F32] * 6 + [_P, _P],
            "mapper_banded_chunk_f32": _ROW_ARGS + [_INT, _INT] + [_F32] * 6 + [_P, _P],
            "mapper_probe_i16": [_INT, _INT, _P, _P, _I64, _INT, _INT, _P],
        }
        for name, argtypes in signatures.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = _INT
        if build_dir is None:
            _LIB = lib
        return lib


def reset_launches() -> None:
    with _LOCK:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def _count(name: str) -> None:
    with _LOCK:
        LAUNCHES[name] += 1


def _check(name, t, dtype, ndim, device):
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: {t.dim()} dims, expected {ndim}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def _cuda_device(t):
    if t.device.type != "cuda":
        raise ValueError(f"the CUDA kernels take CUDA tensors, got {t.device}")
    return t.device


def _check_band(band):
    if not 1 <= band <= 1024:
        raise ValueError(f"band {band} outside [1, 1024]")


def _check_smem(smem, lq):
    if smem > _SMEM_LIMIT:
        raise ValueError(f"read width {lq} too large for the kernel's shared memory")


def _prepare(reads, concat, read_id, reversed_, win_start, lane, n, m, band, diag_out=None):
    device = _cuda_device(reads)
    _check("reads", reads, torch.uint8, 2, device)
    _check("concat", concat, torch.uint8, 1, device)
    _check("read_id", read_id, torch.int64, 1, device)
    _check("reversed_", reversed_, torch.bool, 1, device)
    _check("win_start", win_start, torch.int64, 1, device)
    _check("lane", lane, torch.int64, 1, device)
    _check("n", n, torch.int32, 1, device)
    _check("m", m, torch.int32, 1, device)
    b = read_id.shape[0]
    for name, t in (("reversed_", reversed_), ("win_start", win_start), ("lane", lane), ("n", n), ("m", m)):
        if t.shape[0] != b:
            raise ValueError(f"{name}: {t.shape[0]} rows, expected {b}")
    _check_band(band)
    lq = reads.shape[1]
    _check_smem(2 * band * 4 + 2 * lq + band, lq)
    if b >= 2**31:
        raise ValueError(f"{b} candidates exceed one launch")
    if concat.shape[0] == 0 or reads.shape[0] == 0:
        raise ValueError("empty reference or read matrix")
    if diag_out is not None:
        _check("diag_out", diag_out, torch.float32, 2, device)
        if tuple(diag_out.shape) != (b, band):
            raise ValueError(f"diag_out: shape {tuple(diag_out.shape)}, expected {(b, band)}")
    out = torch.empty((2, b), dtype=torch.float32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    common = [
        reads.data_ptr(), lq, concat.data_ptr(), concat.shape[0],
        read_id.data_ptr(), reversed_.data_ptr(), win_start.data_ptr(),
        lane.data_ptr(), n.data_ptr(), m.data_ptr(), b, band,
    ]
    return out, stream, common


def _ptr(t):
    return None if t is None else t.data_ptr()


def banded_i16(
    reads, concat, read_id, reversed_, win_start, lane, n, m, ints, inv: float, band: int,
    diag_out=None,
):
    """K1: int16-unit banded DP (`ints` from `_quantize_params`, `inv` =
    f32(1) / f32(scale)).  Returns [2, B] float32 on the reads' device; a
    float32 [B, band] `diag_out` also receives every diagonal's sum."""
    out, stream, common = _prepare(
        reads, concat, read_id, reversed_, win_start, lane, n, m, band, diag_out
    )
    if out.shape[1] == 0:
        return out
    lib = library()
    err = lib.mapper_banded_i16(
        *common, *(int(v) for v in ints), float(inv), out.data_ptr(), _ptr(diag_out), stream
    )
    if err != 0:
        raise RuntimeError(f"banded_i16 launch failed: CUDA error {err}")
    _count("banded_i16")
    return out


def banded_f32(
    reads, concat, read_id, reversed_, win_start, lane, n, m, params6, band: int, diag_out=None
):
    """K2: float32 banded DP (`params6` from `_params_tuple`).  Returns
    [2, B] float32 on the reads' device; a float32 [B, band] `diag_out` also
    receives every diagonal's sum."""
    out, stream, common = _prepare(
        reads, concat, read_id, reversed_, win_start, lane, n, m, band, diag_out
    )
    if out.shape[1] == 0:
        return out
    lib = library()
    err = lib.mapper_banded_f32(
        *common, *(float(v) for v in params6), out.data_ptr(), _ptr(diag_out), stream
    )
    if err != 0:
        raise RuntimeError(f"banded_f32 launch failed: CUDA error {err}")
    _count("banded_f32")
    return out


def _prepare_rows(q, w, n, m, band, smem):
    """Checks for the host-row kernels; returns (B, stream, leading args)."""
    device = _cuda_device(q)
    _check("q", q, torch.uint8, 2, device)
    _check("w", w, torch.uint8, 2, device)
    _check("n", n, torch.int32, 1, device)
    _check("m", m, torch.int32, 1, device)
    b, lq = q.shape
    for name, rows in (("w", w.shape[0]), ("n", n.shape[0]), ("m", m.shape[0])):
        if rows != b:
            raise ValueError(f"{name}: {rows} rows, expected {b}")
    _check_band(band)
    if w.shape[1] < lq + band:
        raise ValueError(f"w: width {w.shape[1]} < read width {lq} + band {band}")
    _check_smem(smem, lq)
    if b >= 2**31:
        raise ValueError(f"{b} candidates exceed one launch")
    stream = torch.cuda.current_stream(device).cuda_stream
    return b, stream, [q.data_ptr(), lq, w.data_ptr(), w.shape[1], n.data_ptr(), m.data_ptr(), b]


def banded_i16_packed(q, w, n, m, ints, inv: float):
    """K3: the int16-unit DP at band 64, two candidates per block (rows i
    and i + ceil(B / 2)).  Returns (scores [B], diag_sums [B, 64]), float32,
    in penalty units."""
    lq = q.shape[1]
    smem = 2 * 2 * PACKED_BAND * 4 + 2 * (2 * lq + PACKED_BAND)
    b, stream, rows = _prepare_rows(q, w, n, m, PACKED_BAND, smem)
    scores = torch.empty(b, dtype=torch.float32, device=q.device)
    diag = torch.empty((b, PACKED_BAND), dtype=torch.float32, device=q.device)
    if b == 0:
        return scores, diag
    lib = library()
    err = lib.mapper_banded_i16_packed(
        *rows, *(int(v) for v in ints), float(inv), scores.data_ptr(), diag.data_ptr(), stream
    )
    if err != 0:
        raise RuntimeError(f"banded_i16_packed launch failed: CUDA error {err}")
    _count("banded_i16_packed")
    return scores, diag


def banded_roll_f32(q, w, n, m, params6, band: int):
    """K5: float32 banded DP with the penalty computed in the kernel, whole
    rows staged once.  Returns scores [B] float32."""
    lq = q.shape[1]
    b, stream, rows = _prepare_rows(q, w, n, m, band, 2 * band * 4 + 2 * lq + band)
    scores = torch.empty(b, dtype=torch.float32, device=q.device)
    if b == 0:
        return scores
    lib = library()
    err = lib.mapper_banded_roll_f32(
        *rows, band, *(float(v) for v in params6), scores.data_ptr(), stream
    )
    if err != 0:
        raise RuntimeError(f"banded_roll_f32 launch failed: CUDA error {err}")
    _count("banded_roll_f32")
    return scores


def banded_chunk_f32(q, w, n, m, params6, band: int, chunk: int):
    """K4: K5's function with the rows staged `chunk` query positions at a
    time, so shared memory does not grow with the read width.  Returns
    scores [B] float32."""
    if chunk < 1:
        raise ValueError(f"chunk {chunk} < 1")
    b, stream, rows = _prepare_rows(q, w, n, m, band, 2 * band * 4 + 2 * chunk + band)
    scores = torch.empty(b, dtype=torch.float32, device=q.device)
    if b == 0:
        return scores
    lib = library()
    err = lib.mapper_banded_chunk_f32(
        *rows, band, chunk, *(float(v) for v in params6), scores.data_ptr(), stream
    )
    if err != 0:
        raise RuntimeError(f"banded_chunk_f32 launch failed: CUDA error {err}")
    _count("banded_chunk_f32")
    return scores


def probe_i16(stage: str, body: int, x, reduces: bool):
    """P1-P9: body number `body` of probe stage `stage` (a ... i, bodies in
    the probe's order) on x [rows, lanes] int16, lanes <= 1024.  Returns
    int16 [rows, 1] for a body that reduces each row (`reduces`), else
    [rows, lanes]."""
    device = _cuda_device(x)
    _check("x", x, torch.int16, 2, device)
    if len(stage) != 1 or stage not in PROBE_STAGES:
        raise ValueError(f"probe stage {stage!r} not one of {PROBE_STAGES}")
    rows, lanes = x.shape
    if not 1 <= lanes <= 1024:
        raise ValueError(f"{lanes} lanes outside [1, 1024]")
    if rows >= 2**31:
        raise ValueError(f"{rows} rows exceed one launch")
    out_cols = 1 if reduces else lanes
    out = torch.empty((rows, out_cols), dtype=torch.int16, device=device)
    if rows == 0:
        return out
    lib = library()
    stream = torch.cuda.current_stream(device).cuda_stream
    err = lib.mapper_probe_i16(
        PROBE_STAGES.index(stage), int(body), x.data_ptr(), out.data_ptr(), rows, lanes,
        out_cols, stream,
    )
    if err != 0:
        raise RuntimeError(f"probe_i16_{stage} body {body} launch failed: CUDA error {err}")
    _count(f"probe_i16_{stage}")
    return out
