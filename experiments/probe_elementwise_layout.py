"""The probe kernel's elementwise layout (threads a block, 16-byte vectors a
thread, blocks an SM) in variants, against the one PyTorch call of four
one-op bodies, timed by CUDA-graph replay of 50 calls in turns, at
[16384, 128] int16, each variant held equal to the plain version first.

    python3 experiments/probe_elementwise_layout.py

Needs a card and nvcc; builds each variant from a patched copy of
`mapper_tpu_torch/align/csrc/` under `mapper_tpu_torch/_build/`.
"""
import re
import shutil
import sys
import tempfile
from pathlib import Path
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import numpy as np
import torch
from mapper_tpu_torch.align import kernels
import chip_smoke as cs

VARIANTS = [(256, 1, 8), (256, 2, 8), (256, 4, 8), (128, 4, 16), (512, 2, 4), (128, 2, 16)]
BODIES = [("e", "sub"), ("e", "band"), ("a", "copy"), ("b", "min_only_scalar")]
libs = {}
kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
tmp = Path(tempfile.mkdtemp(dir=kernels.BUILD_DIR))
for th, vecs, bps in VARIANTS:
    src = tmp / f"csrc_{th}_{vecs}_{bps}"
    shutil.copytree(kernels.CSRC, src)
    t = (src / "probe_i16.cu").read_text()
    for name, value in (("kEwThreads", th), ("kEwVecs", vecs), ("kEwBlocksPerSm", bps)):
        t, count = re.subn(rf"constexpr int {name} = \d+;", f"constexpr int {name} = {value};", t)
        assert count == 1, name
    (src / "probe_i16.cu").write_text(t)
    libs[(th, vecs, bps)] = kernels.library(build_dir=src, csrc=src).mapper_probe_i16
x = torch.from_numpy(np.random.default_rng(0).integers(-2**15, 2**15, (16384, 128)).astype(np.int16)).cuda()
out = torch.empty_like(x)
from mapper_tpu_torch.probe_i16 import probes
print(cs.gpu_line())
for stage, body in BODIES:
    idx = probes.STAGES[stage].index(body)
    want = probes.plain(stage, body, x)
    lib_call = cs.PROBE_LIBRARY[(stage, body)]
    times = {v: [] for v in VARIANTS}
    times["library"] = []
    def run(fn):
        return lambda: fn(kernels.PROBE_STAGES.index(stage), idx, x.data_ptr(), out.data_ptr(), 16384, 128, 128, torch.cuda.current_stream().cuda_stream)
    for v, fn in libs.items():
        assert run(fn)() == 0
        torch.cuda.synchronize()
        assert torch.equal(out, want), (v, body)
    order = [*VARIANTS, "library"]
    for key in order + order[::-1] + order + order[::-1]:
        f = (lambda: lib_call(x)) if key == "library" else run(libs[key])
        times[key].append(cs.graph_ms(f, 50) * 1e3)
    print(f"{stage}.{body}: " + ", ".join(f"{k}: {np.median(v):.3f} us (min {min(v):.3f})" for k, v in times.items()), flush=True)
