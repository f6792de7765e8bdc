"""K1 (`banded_i16`) at [16384, 192], bands 64 and 128: its query row and
window staged in shared memory by each warp (the source as it is) against
both read through the read-only path inside the x loop, each held equal to
the plain version, timed with CUDA events in turns.

    python3 experiments/k1_staging.py

Needs a card and nvcc; builds both from copies of
`mapper_tpu_torch/align/csrc/` under `mapper_tpu_torch/_build/`.
"""
import shutil
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

OLD = """    const int q16 = s_q[x] << 4;
    const uint8_t* const wx = s_w + x + k0;
    int pen[kLanes];
#pragma unroll
    for (int i = 0; i < kLanes; ++i) {
      pen[i] = pen_tab[q16 | wx[i]];"""
NEW = """    int c = __ldg(row + x);
    if (rev) {
      const int f = __ldg(row + (n - 1 - x));
      c = ((f & 1) << 3) | ((f & 2) << 1) | ((f & 4) >> 1) | ((f & 8) >> 3);
    }
    const int q16 = (c & 15) << 4;
    int pen[kLanes];
#pragma unroll
    for (int i = 0; i < kLanes; ++i) {
      int64_t idx = ws + x + k0 + i;
      idx = idx > concat_len - 1 ? concat_len - 1 : idx;
      pen[i] = pen_tab[q16 | (__ldg(concat + idx) & 15)];"""
kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
tmp = Path(tempfile.mkdtemp(dir=kernels.BUILD_DIR))
fns = {}
for name, patch in (("staged", False), ("read_only", True)):
    src = tmp / name
    shutil.copytree(kernels.CSRC, src)
    t = (src / "banded_dp.cu").read_text()
    if patch:
        assert OLD in t
        t = t.replace(OLD, NEW)
    (src / "banded_dp.cu").write_text(t)
    fns[name] = kernels.library(build_dir=src, csrc=src).mapper_banded_i16
print(cs.gpu_line())
params = AlignmentParameters.defaults()
for band in (64, 128):
    cands = scoring_candidates(np.random.default_rng(band), 16384, 192, band, ref_size=4_600_000, num_reads=4096)
    args = banded._normalize(*[torch.as_tensor(cands[k]).cuda() for k in cs._KEYS])
    scale, ints = banded._quantize_params(params, 192, band)
    want = banded._gathered_core(*args, params, band)
    out = torch.empty((2, 16384), dtype=torch.float32, device="cuda")
    reads, concat, read_id, rev, ws, lane, n, m = args
    def call(fn):
        return lambda: fn(reads.data_ptr(), 192, concat.data_ptr(), concat.shape[0], read_id.data_ptr(), rev.data_ptr(),
                          ws.data_ptr(), lane.data_ptr(), n.data_ptr(), m.data_ptr(), 16384, band,
                          *[int(v) for v in ints], float(banded._inv(scale)), out.data_ptr(), None,
                          torch.cuda.current_stream().cuda_stream)
    times = {k: [] for k in fns}
    for k, fn in fns.items():
        assert call(fn)() == 0
        torch.cuda.synchronize()
        assert torch.equal(out, want), k
    order = list(fns)
    for k in order + order[::-1] + order + order[::-1]:
        times[k].append(cs.cuda_ms(call(fns[k]), 20))
    print(f"band {band}: " + ", ".join(f"{k} {np.mean(v):.4f} ms ({', '.join(f'{x:.4f}' for x in v)})" for k, v in times.items()), flush=True)
