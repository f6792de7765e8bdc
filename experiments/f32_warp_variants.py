"""K2's warp kernel (`banded_f32` at bands 64 and 128, 4,096 candidates of
width 1024) and K4's (`banded_chunk_f32`, band 128, chunk 128, on the same
candidates' host rows) in variants of the float32 min, each held equal to
the plain version, timed with CUDA events in turns (A B B A A B B A); and
each variant's SASS instruction mix in `banded_f32_warp_kernel<4>`, whole
and in its x loop.

    python3 experiments/f32_warp_variants.py

Variants: "fminf", the source as it is (F32x1Ops::min is fminf, one
FMNMX); "select", F32x1Ops::min as `vmin` (b < a ? b : a, a compare and a
select, as the block kernels' F32Ops::min).  The two are equal wherever no
operand is NaN and no tie is between +0 and -0.
Needs a card and nvcc; builds each variant from a patched copy of
`mapper_tpu_torch/align/csrc/` under `mapper_tpu_torch/_build/`.
"""
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import numpy as np
import torch
from mapper_tpu_torch.align import banded, kernels
from mapper_tpu_torch.align.params import AlignmentParameters
from mapper_tpu_torch.simulate import scoring_candidates
import chip_smoke as cs
from experiments import sass_loops

MIN_FMINF = "  __device__ __forceinline__ float min(float a, float b) const { return fminf(a, b); }"
VARIANTS = {
    "fminf": None,
    "select": (MIN_FMINF, "  __device__ __forceinline__ float min(float a, float b) const { return vmin(a, b); }"),
}


def sass_mix(csrc: Path, kernel: str):
    """The SASS instruction mix of `kernel`, whole and in its x loop."""
    nvcc = kernels.find_nvcc()
    cubin = csrc / "banded_dp.cubin"
    flags = [f for f in kernels.NVCC_FLAGS if f not in ("-Xcompiler", "-fPIC")]
    subprocess.run([nvcc, *flags, "-cubin", "-o", str(cubin), str(csrc / "banded_dp.cu")], check=True)
    part = next(text for name, text in sass_loops.functions(cubin).items() if kernel in name)
    return sass_loops.instruction_mix(part), sass_loops.shuffle_loops(part)[0][0]


libs = {}
kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
tmp = Path(tempfile.mkdtemp(dir=kernels.BUILD_DIR))
print(cs.gpu_line())
for name, patch in VARIANTS.items():
    src = tmp / name
    shutil.copytree(kernels.CSRC, src)
    if patch:
        t = (src / "dp_core.cuh").read_text()
        assert patch[0] in t
        (src / "dp_core.cuh").write_text(t.replace(patch[0], patch[1]))
    libs[name] = kernels.library(build_dir=src, csrc=src)
    mix, loop = sass_mix(src, "banded_f32_warp_kernelILi4E")
    for what, counts in (("kernel", mix), ("x loop", loop)):
        print(f"{name}: SASS of banded_f32_warp_kernel<4>, {what}: {sass_loops.mix_line(counts)}", flush=True)

params = AlignmentParameters.defaults()
p6 = banded._params_tuple(params)
for band in (128, 64):
    cands = scoring_candidates(np.random.default_rng(7), 4096, 1024, band, ref_size=4_600_000, num_reads=4096)
    args = banded._normalize(*[torch.as_tensor(cands[k]).cuda() for k in cs._KEYS])
    want = banded._gathered_core(*args, params, band)
    reads, concat, read_id, rev, ws, lane, n, m = args
    q, w = banded._gather_codes(reads, concat, read_id, rev, ws, n, band)
    rows = banded._host_rows(q, w, n, m, band, cs.CHUNK)
    want_rows = banded._pen_core(rows[0].to(torch.int32), rows[1].to(torch.int32), rows[2], rows[3], p6, band)[0]
    out = torch.empty((2, 4096), dtype=torch.float32, device="cuda")
    scores = torch.empty(4096, dtype=torch.float32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    calls = {}
    for name, lib in libs.items():
        calls[(name, "K2")] = (lambda lib=lib: lib.mapper_banded_f32(
            reads.data_ptr(), 1024, concat.data_ptr(), concat.shape[0], read_id.data_ptr(), rev.data_ptr(),
            ws.data_ptr(), lane.data_ptr(), n.data_ptr(), m.data_ptr(), 4096, band, *p6, out.data_ptr(), None,
            stream), out, want)
        calls[(name, "K4")] = (lambda lib=lib: lib.mapper_banded_chunk_f32(
            rows[0].data_ptr(), rows[0].shape[1], rows[1].data_ptr(), rows[1].shape[1], rows[2].data_ptr(),
            rows[3].data_ptr(), 4096, band, cs.CHUNK, *p6, scores.data_ptr(), stream), scores, want_rows)
    for key, (fn, got, ref) in calls.items():
        assert fn() == 0
        torch.cuda.synchronize()
        assert torch.equal(got, ref), key
    for kernel in ("K2", "K4"):
        order = [k for k in calls if k[1] == kernel]
        times = {k: [] for k in order}
        for k in order + order[::-1] + order + order[::-1]:
            times[k].append(cs.cuda_ms(calls[k][0], 20))
        print(f"{kernel} band {band}: " + ", ".join(
            f"{k[0]} {np.mean(v):.4f} ms ({', '.join(f'{x:.4f}' for x in v)})" for k, v in times.items()), flush=True)
