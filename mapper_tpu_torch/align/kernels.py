"""Build, bind and launch the hand-written CUDA kernels of `csrc/`.

The sources (`banded_dp.cu`, `probe_i16.cu`, `candidates.cu`, the DP step
the first two share, `dp_core.cuh`, and the launch all share, `launch.cuh`)
are compiled at first use by `nvcc`, one process per source,
all started together, and linked into one shared library with a plain C
interface, under a lock, into `mapper_tpu_torch/_build/`, keyed by the
sha256 of every source and header and of the flags, and loaded with ctypes.
There is no fallback: a missing `nvcc` or a failed build raises with the
compiler's message.

Four kinds of entry:
- `banded_i16` and `banded_f32` score candidates against a reference held on
  the device (reads, reference and per-candidate indices);
- `banded_i16_packed`, `banded_roll_f32` and `banded_chunk_f32` score
  host-built rows: query codes q [B, LQ] and windows w [B, LW >= LQ + band],
  uint8, with lengths n and m;
- `probe_i16` runs one body of the int16 probe kernels (P1-P9) on an int16
  [rows, lanes] block, lanes 64, 128 or 256;
- `candidates` (KC1) and `fused_rows` (KC2) run the device-candidates
  program of `batch/device_candidates.py`: the per-read top-K vote table
  from the read codes and the merged index, a team of threads a read, and
  the scoring rows of the table's kept entries, one thread a read over
  many blocks.
`banded_i16`, `banded_f32`, `banded_roll_f32` and `banded_chunk_f32` run one
warp a candidate at the bands of `WARP_BANDS`, one block a candidate
elsewhere; `banded_i16_packed` (band 64 only) runs one warp a pair of
candidates.  A launch that needs more than 48 KB of shared memory opts in
first, up to `_SMEM_LIMIT`, which each wrapper checks.

Each wrapper checks its tensors, allocates its outputs with `torch.empty`,
launches on the current CUDA stream of the tensors' device with that device
current on the host thread (the launcher opts in to shared memory and launches
on the current device), raises if the launch reported an error, and adds one to
its entry of `LAUNCHES`.  An empty candidate batch returns the
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
    "candidates": 0,
    "fused_rows": 0,
}
PACKED_BAND = 64  # banded_i16_packed's per-candidate band (kHalf in the source)
# the bands banded_i16, banded_f32, banded_roll_f32 and banded_chunk_f32 run
# one warp per candidate at (warp_band in the source)
WARP_BANDS = (64, 128)
_CANDS_PER_BLOCK = 4  # the warp kernels' candidates a block (kCandsPerBlock)
_PAIRS_PER_BLOCK = 8  # the packed kernel's pairs a block (kPairsPerBlock)
_PEN_TABLE = 16 * 16  # the warp kernels' penalty table entries (kPenTable)
_PEN_ENTRY_BYTES = {
    "banded_i16": 2, "banded_f32": 4, "banded_i16_packed": 2, "banded_roll_f32": 4,
    "banded_chunk_f32": 4,
}
PROBE_LANES = (64, 128, 256)  # the lane counts the probe kernel takes
# dynamic shared memory a block may take on sm_90 (kSmemOptIn): a launch above
# the 48 KB default opts in first
_SMEM_LIMIT = 232448
# candidates_kernel's (KC1) teams: a read's threads.  Rows up to
# _NARROW_WIDTH take _NARROW_WARPS warps, _NARROW_READS reads a block;
# wider rows one block of _WIDE_WARPS warps (kNarrowWidth, kNarrowWarps,
# kNarrowReads, kWideWarps)
_NARROW_WIDTH = 256
_NARROW_WARPS = 2
_NARROW_READS = 2
_WIDE_WARPS = 8
# a team's fixed shared memory (kTeamFixedSmem): the exchange slots, the
# seed list; then one region for the row or, after the levels, the vote
# table of 2 x P_SLOTS int32 keys and 16-bit counts (kHashBytes)
_CANDIDATES_FIXED_SMEM = 2 * 8 * 8 + 512 * 4 * 4
_CANDIDATES_HASH_BYTES = 2048 * 4 + 2048 * 2
# a team that would take more than this keeps its row in the scratch
# buffer, so that two reads stay resident on a multiprocessor (kRowSmemLimit)
_CANDIDATES_ROW_LIMIT = 232448 // 2
# resident blocks a multiprocessor a launch with the row in its scratch
# buffer takes: its grid, and the buffer's slices
_SCRATCH_BLOCKS_PER_SM = 4
# fused_rows_kernel (KC2): reads a block, one a thread (kRowsTile), and the
# most ranks whose table rows it stages in shared memory (kStagedRanks)
_ROWS_TILE = 128
_STAGED_RANKS = 32

_LOCK = threading.Lock()
_LIB = None

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_INT, _F32 = ctypes.c_int, ctypes.c_float
_COMMON_ARGS = [_P, _I64, _P, _I64, _P, _P, _P, _P, _P, _P, _I64, _INT]
_ROW_ARGS = [_P, _I64, _P, _I64, _P, _P, _I64]  # q, lq, w, lw, n, m, B

# each launcher's ctypes argument types (every one returns a CUDA error as int)
_SIGNATURES = {
    "mapper_banded_i16": _COMMON_ARGS + [_INT] * 6 + [_F32, _P, _P, _P],
    "mapper_banded_f32": _COMMON_ARGS + [_F32] * 6 + [_P, _P, _P],
    "mapper_banded_i16_packed": _ROW_ARGS + [_INT] * 6 + [_F32, _P, _P, _P],
    "mapper_banded_roll_f32": _ROW_ARGS + [_INT] + [_F32] * 6 + [_P, _P],
    "mapper_banded_chunk_f32": _ROW_ARGS + [_INT, _INT] + [_F32] * 6 + [_P, _P],
    "mapper_probe_i16": [_INT, _INT, _P, _P, _I64, _INT, _INT, _P],
    "mapper_candidates": [_P, _I64, _P, _I64, _P, _P, _P, _I64, _P, _P, _P, _P, _P, _P, _P, _P,
                          _P, _I64] + [_I64] * 5 + [_INT, _P, _P, _I64, _P],
    "mapper_fused_rows": [_P, _I64, _INT, _P, _P, _P, _P, _I64, _I64, _I64, _I64, _INT]
                         + [_P] * 6 + [_P, _P],
}


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


def sources(csrc: Path | None = None) -> list[Path]:
    """The `.cu` files the library is compiled from (`csrc`, default CSRC)."""
    return sorted((csrc or CSRC).glob("*.cu"))


def _check_nvcc(cmd, returncode, stderr, what):
    if returncode != 0:
        raise RuntimeError(f"nvcc failed ({returncode}) {what}:\n{' '.join(cmd)}\n{stderr}")


def compile_library(target: Path, csrc: Path | None = None) -> None:
    """Compile every source of `csrc` (default CSRC) into the shared library
    `target` (written atomically): one nvcc per source, all started together,
    then one link (2.9-3.3 s on an H100 host, against 5.1-5.3 s for one
    `nvcc -shared` over every source).  Raises RuntimeError when nvcc is missing or fails."""
    nvcc = find_nvcc()
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, PATH and "
            "/usr/local/cuda/bin): the CUDA kernels cannot be built"
        )
    target.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=target.parent) as tmp:
        jobs = []
        for src in sources(csrc):
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


def library_path(build_dir: Path | None = None, csrc: Path | None = None) -> Path:
    """The library's path, keyed by every file of `csrc` (default CSRC: the
    sources and the headers they include) and by the compiler flags."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted((csrc or CSRC).glob("*.cu*")):
        digest.update(f"\0{path.name}\0".encode() + path.read_bytes())
    return (build_dir or BUILD_DIR) / f"kernels_{digest.hexdigest()[:16]}.so"


def library(build_dir: Path | None = None, csrc: Path | None = None):
    """The loaded kernel library, built first if this source's build is
    missing; from another source directory `csrc` (a variant an experiment
    builds) when one is given.  Thread-safe; the first caller pays the build."""
    global _LIB
    shared = build_dir is None and csrc is None
    with _LOCK:
        if _LIB is not None and shared:
            return _LIB
        path = library_path(build_dir, csrc)
        if not path.exists():
            compile_library(path, csrc)
        lib = ctypes.CDLL(str(path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = _INT
        if shared:
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


def _block_smem(width: int, band: int) -> int:
    """A block kernel's dynamic shared memory (`block_smem` in the source):
    two ping-pong buffers of `band` 4-byte values, the query codes [width]
    and the window [width + band]."""
    return 2 * band * 4 + 2 * width + band


def _warp_smem(width: int, band: int, entry: int) -> int:
    """A warp kernel's (`warp_smem`): the penalty table of `entry`-byte
    values, then per warp its query codes [width] and window [width + band]."""
    return _PEN_TABLE * entry + _CANDS_PER_BLOCK * (2 * width + band)


def candidates_row_bytes(width: int) -> int:
    """The bytes of one read's row in candidates_kernel (`row_bytes`): two
    lists of `width` 17-byte blocks, two prefix tables of width + 1 4-byte
    sums and their two power tables, rounded up to 16 bytes."""
    return (2 * width * 17 + 4 * (width + 1) * 4 + 15) // 16 * 16


def _candidates_team_smem(width: int, scratch: bool) -> int:
    """A KC1 team's shared memory (`team_smem`): the fixed part and the
    larger of the row (unless it lives in the scratch buffer) and the vote
    table, which share one region."""
    row = 0 if scratch else candidates_row_bytes(width)
    return _CANDIDATES_FIXED_SMEM + max(row, _CANDIDATES_HASH_BYTES)


def candidates_in_scratch(width: int) -> bool:
    """Whether candidates_kernel keeps a read's row in a scratch buffer:
    where its team's shared memory with the row would leave room for fewer
    than two reads on a multiprocessor (a 5,000 bp read's; a 1,000 bp
    read's stays on chip)."""
    return _candidates_team_smem(width, False) > _CANDIDATES_ROW_LIMIT


def candidates_team(width: int) -> tuple[int, int]:
    """(warps a read, reads a block) of a candidates launch at row width
    `width`."""
    if width <= _NARROW_WIDTH and not candidates_in_scratch(width):
        return _NARROW_WARPS, _NARROW_READS
    return _WIDE_WARPS, 1


def fused_rows_status_words(num_reads: int) -> int:
    """The int64 status words a fused_rows launch takes: the tile ticket
    and one a tile of `_ROWS_TILE` reads."""
    return 1 + -(-num_reads // _ROWS_TILE)


def smem_bytes(name: str, lq: int, band: int = 0, chunk: int | None = None, k_out: int = 8) -> int:
    """The dynamic shared memory a launch of kernel `name` takes at read
    width `lq` (and `chunk`, for banded_chunk_f32): the sum its launcher in
    `banded_dp.cu` or `candidates.cu` passes.  banded_chunk_f32's warp
    kernel stages min(chunk, lq) positions at a time: a chunk wider than the
    rows is one chunk either way; banded_roll_f32's stages the whole row.
    `candidates` takes its block's teams' (`candidates_smem`), `fused_rows`
    its tile of the table at `k_out` ranks, staged up to `_STAGED_RANKS`
    (`rows_smem`); neither takes a band."""
    if name == "candidates":
        scratch = candidates_in_scratch(lq)
        return candidates_team(lq)[1] * _candidates_team_smem(lq, scratch)
    if name == "fused_rows":
        return 16 + _ROWS_TILE // 32 * 4 + (_ROWS_TILE * (2 * k_out + 1) * 4 if k_out <= _STAGED_RANKS else 0)
    if name == "banded_i16_packed":  # pair_smem: two rows a warp, their codes a byte
        return _PEN_TABLE * _PEN_ENTRY_BYTES[name] + _PAIRS_PER_BLOCK * (2 * lq + PACKED_BAND)
    warp = band in WARP_BANDS
    width = lq if chunk is None else (min(chunk, lq) if warp else chunk)
    if warp:
        return _warp_smem(width, band, _PEN_ENTRY_BYTES[name])
    return _block_smem(width, band)


def _check_smem(smem, lq):
    if smem > _SMEM_LIMIT:
        raise ValueError(f"read width {lq} too large for the kernel's shared memory")


def _prepare(kernel, reads, concat, read_id, reversed_, win_start, lane, n, m, band, diag_out=None):
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
    _check_smem(smem_bytes(kernel, lq, band), lq)
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
    float32 [B, band] `diag_out` also receives every diagonal's sum.  At
    bands 64 and 128 (`WARP_BANDS`) one warp scores a candidate; any other
    band takes the block kernel, one block a candidate."""
    out, stream, common = _prepare(
        "banded_i16", reads, concat, read_id, reversed_, win_start, lane, n, m, band, diag_out
    )
    if out.shape[1] == 0:
        return out
    lib = library()
    with torch.cuda.device(reads.device):
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
    receives every diagonal's sum.  At `WARP_BANDS` one warp scores a
    candidate, elsewhere one block, bit-identical."""
    out, stream, common = _prepare(
        "banded_f32", reads, concat, read_id, reversed_, win_start, lane, n, m, band, diag_out
    )
    if out.shape[1] == 0:
        return out
    lib = library()
    with torch.cuda.device(reads.device):
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
    """K3: the int16-unit DP at band 64, two candidates per warp (rows i
    and i + ceil(B / 2), one in each int16 half of the DP's registers).
    Returns (scores [B], diag_sums [B, 64]), float32, in penalty units."""
    smem = smem_bytes("banded_i16_packed", q.shape[1], PACKED_BAND)
    b, stream, rows = _prepare_rows(q, w, n, m, PACKED_BAND, smem)
    scores = torch.empty(b, dtype=torch.float32, device=q.device)
    diag = torch.empty((b, PACKED_BAND), dtype=torch.float32, device=q.device)
    if b == 0:
        return scores, diag
    lib = library()
    with torch.cuda.device(q.device):
        err = lib.mapper_banded_i16_packed(
            *rows, *(int(v) for v in ints), float(inv), scores.data_ptr(), diag.data_ptr(), stream
        )
    if err != 0:
        raise RuntimeError(f"banded_i16_packed launch failed: CUDA error {err}")
    _count("banded_i16_packed")
    return scores, diag


def banded_roll_f32(q, w, n, m, params6, band: int):
    """K5: float32 banded DP with the penalty computed in the kernel, whole
    rows staged once.  Returns scores [B] float32.  At `WARP_BANDS` one warp
    scores a candidate (K4's warp kernel with one chunk the width of the
    row), elsewhere one block."""
    smem = smem_bytes("banded_roll_f32", q.shape[1], band)
    b, stream, rows = _prepare_rows(q, w, n, m, band, smem)
    scores = torch.empty(b, dtype=torch.float32, device=q.device)
    if b == 0:
        return scores
    lib = library()
    with torch.cuda.device(q.device):
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
    scores [B] float32.  At `WARP_BANDS` one warp scores a candidate,
    elsewhere one block."""
    if chunk < 1:
        raise ValueError(f"chunk {chunk} < 1")
    smem = smem_bytes("banded_chunk_f32", q.shape[1], band, chunk)
    b, stream, rows = _prepare_rows(q, w, n, m, band, smem)
    scores = torch.empty(b, dtype=torch.float32, device=q.device)
    if b == 0:
        return scores
    lib = library()
    with torch.cuda.device(q.device):
        err = lib.mapper_banded_chunk_f32(
            *rows, band, chunk, *(float(v) for v in params6), scores.data_ptr(), stream
        )
    if err != 0:
        raise RuntimeError(f"banded_chunk_f32 launch failed: CUDA error {err}")
    _count("banded_chunk_f32")
    return scores


def probe_i16(stage: str, body: int, x, reduces: bool):
    """P1-P9: body number `body` of probe stage `stage` (a ... i, bodies in
    the probe's order) on x [rows, lanes] int16, lanes one of `PROBE_LANES`,
    16-byte aligned.  Returns int16 [rows, 1] for a body that reduces each
    row (`reduces`), else [rows, lanes]."""
    device = _cuda_device(x)
    _check("x", x, torch.int16, 2, device)
    if len(stage) != 1 or stage not in PROBE_STAGES:
        raise ValueError(f"probe stage {stage!r} not one of {PROBE_STAGES}")
    rows, lanes = x.shape
    if lanes not in PROBE_LANES:
        raise ValueError(f"{lanes} lanes: the probe kernel takes {PROBE_LANES}")
    if x.data_ptr() % 16:
        raise ValueError("x: not 16-byte aligned")
    if rows >= 2**28:
        raise ValueError(f"{rows} rows exceed one launch")
    out_cols = 1 if reduces else lanes
    out = torch.empty((rows, out_cols), dtype=torch.int16, device=device)
    if rows == 0:
        return out
    lib = library()
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = lib.mapper_probe_i16(
            PROBE_STAGES.index(stage), int(body), x.data_ptr(), out.data_ptr(), rows, lanes,
            out_cols, stream,
        )
    if err != 0:
        raise RuntimeError(f"probe_i16_{stage} body {body} launch failed: CUDA error {err}")
    _count(f"probe_i16_{stage}")
    return out


# the merged index's tensors candidates_kernel reads, by dtype
_INDEX_INT64 = ("capacities", "caps", "bases", "rev_flags", "fwd_index", "seq_lengths", "rc_index",
                "seq_starts", "seq_starts_tail")
_INDEX_INT32 = ("counts", "offsets", "values")


def _check_k(k_out: int) -> None:
    if k_out < 1:
        raise ValueError(f"k_out {k_out} < 1")


def candidates(codes, lengths, index: dict, max_size: int, min_size: int, n_seqs: int, span: int,
               bias: int, k_out: int):
    """KC1: the candidates program on read codes [B, W] uint8 (0-padded, W
    the row width) and lengths [B] int64, against the merged index tensors
    of `device_candidates.device_index_arrays`.  Returns [B, 2K+1] int32:
    per read the top-K vote keys (`_NO_KEY` where a rank is empty), their
    votes and the fallback flag.  A team of threads a read
    (`candidates_team`): two warps, two reads a block, at widths up to
    `_NARROW_WIDTH`, a block of 256 threads above; a row that would leave
    room for fewer than two reads on a multiprocessor
    (`candidates_in_scratch`) lives in a scratch buffer of
    `_SCRATCH_BLOCKS_PER_SM` slices a multiprocessor, the blocks walking the
    reads."""
    device = _cuda_device(codes)
    _check("codes", codes, torch.uint8, 2, device)
    _check("lengths", lengths, torch.int64, 1, device)
    for name in _INDEX_INT64:
        _check(name, index[name], torch.int64, 1, device)
    for name in _INDEX_INT32:
        _check(name, index[name], torch.int32, 1, device)
    _check_k(k_out)
    b, width = codes.shape
    if lengths.shape[0] != b:
        raise ValueError(f"lengths: {lengths.shape[0]} rows, expected {b}")
    if b >= 2**31:
        raise ValueError(f"{b} reads exceed one launch")
    if index["capacities"].shape[0] == 0:
        raise ValueError("empty index")
    out = torch.empty((b, 2 * k_out + 1), dtype=torch.int32, device=device)
    if b == 0:
        return out
    grid, scratch = candidates_grid(width, b, device)
    lib = library()
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = lib.mapper_candidates(*_candidates_args(
            codes, lengths, index, max_size, min_size, n_seqs, span, bias, k_out, out, scratch, grid, stream))
    if err != 0:
        raise RuntimeError(f"candidates launch failed: CUDA error {err}")
    _count("candidates")
    return out


def candidates_grid(width: int, num_reads: int, device):
    """(grid, scratch) of a candidates launch: where the row takes the
    scratch buffer (`candidates_in_scratch`), `_SCRATCH_BLOCKS_PER_SM`
    resident blocks a multiprocessor and a buffer of one row slice each;
    elsewhere the read count and no buffer (the launcher sizes its own
    grid)."""
    if not candidates_in_scratch(width):
        return num_reads, None
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    grid = min(num_reads, _SCRATCH_BLOCKS_PER_SM * sms)
    return grid, torch.empty(grid * candidates_row_bytes(width), dtype=torch.uint8, device=device)


def _candidates_args(codes, lengths, index, max_size, min_size, n_seqs, span, bias, k_out, out, scratch,
                     grid, stream) -> list:
    """mapper_candidates' arguments, in the order of `_SIGNATURES`."""
    return [
        codes.data_ptr(), codes.shape[1], lengths.data_ptr(), codes.shape[0],
        index["capacities"].data_ptr(), index["caps"].data_ptr(), index["bases"].data_ptr(),
        index["capacities"].shape[0], index["counts"].data_ptr(), index["offsets"].data_ptr(),
        index["values"].data_ptr(), index["rev_flags"].data_ptr(), index["fwd_index"].data_ptr(),
        index["seq_lengths"].data_ptr(), index["rc_index"].data_ptr(), index["seq_starts"].data_ptr(),
        index["seq_starts_tail"].data_ptr(), index["seq_starts_tail"].shape[0],
        int(max_size), int(min_size), int(n_seqs), int(span), int(bias), int(k_out),
        out.data_ptr(), _ptr(scratch), grid, stream,
    ]


def fused_rows(table, lengths, shift, seq_lengths, seq_starts, n_seqs: int, span: int, bias: int,
               c_slots: int, band: int, k_out: int):
    """KC2: the scoring rows of the kept entries of KC1's table [B, 2K+1]
    int32, in read-major, rank-minor order, in `c_slots` rows.  Returns
    (table, read_id int64, reversed_ bool, win_start int64, lane int64 in
    [0, band), n int32, m int32): `banded_scores_gathered`'s vectors.  A kept
    entry past the budget sets its read's fallback flag in `table`, in
    place (the table is returned).  One thread a read, `_ROWS_TILE` reads a
    block, each block's base from a look-back over the earlier tiles'
    status words (`fused_rows_status_words`, allocated zeroed here)."""
    device = _cuda_device(table)
    _check("table", table, torch.int32, 2, device)
    for name, t in (("lengths", lengths), ("shift", shift), ("seq_lengths", seq_lengths),
                    ("seq_starts", seq_starts)):
        _check(name, t, torch.int64, 1, device)
    _check_k(k_out)
    _check_band(band)
    b = table.shape[0]
    if table.shape[1] != 2 * k_out + 1:
        raise ValueError(f"table: {table.shape[1]} columns, expected {2 * k_out + 1}")
    for name, t in (("lengths", lengths), ("shift", shift)):
        if t.shape[0] != b:
            raise ValueError(f"{name}: {t.shape[0]} rows, expected {b}")
    if n_seqs < 1 or span < 1:
        raise ValueError(f"n_seqs {n_seqs} and span {span} must be positive")

    def empty(dtype):
        return torch.empty(c_slots, dtype=dtype, device=device)

    rows = (empty(torch.int64), empty(torch.bool), empty(torch.int64), empty(torch.int64),
            empty(torch.int32), empty(torch.int32))
    if c_slots == 0:
        return (table, *rows)
    # the padding rows take read 0's and contig 0's geometry
    if b == 0 or seq_lengths.shape[0] == 0:
        raise ValueError("empty table or reference")
    # the tiles' look-back status words, zeroed on the stream before the launch
    status = torch.zeros(fused_rows_status_words(b), dtype=torch.int64, device=device)
    lib = library()
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = lib.mapper_fused_rows(
            table.data_ptr(), b, int(k_out), lengths.data_ptr(), shift.data_ptr(),
            seq_lengths.data_ptr(), seq_starts.data_ptr(), int(n_seqs), int(span), int(bias),
            int(c_slots), int(band), *(t.data_ptr() for t in rows), status.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"fused_rows launch failed: CUDA error {err}")
    _count("fused_rows")
    return (table, *rows)
