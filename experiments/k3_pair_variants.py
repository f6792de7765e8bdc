"""K3 (`banded_i16_packed`, one warp a pair of band-64 candidates) in design
variants, against K1 (`banded_i16` at band 64, one warp a candidate) on the
same host rows: 16,384 candidates of 96-192 bp over a 4.6 Mb reference,
width 192 padded to 256, default penalties (int16 units).  Each variant's
outputs are held equal to the plain version first; then every variant's K3
and the source's K1 are timed with CUDA events (20 calls a reading), in
turns, forward and back, twice; and each variant's K3 x loops (the loops
whose body holds a SHFL.UP) are printed as SASS instruction mixes.

    python3 experiments/k3_pair_variants.py [SASS_DIR]

With SASS_DIR, each variant's innermost x loop is also written there as
SASS text, `k3_<variant>_loop.sass`.
Variants: "source", the source as it is (a steady loop for the steps where
both rows are active and every lane has its window cell, then the general
step); "one_loop", every step in the general form; "pairs2", "pairs4",
"pairs8" and "pairs16", that many pairs a block (kPairsPerBlock).  Needs a card and nvcc; builds each variant from a
patched copy of `mapper_tpu_torch/align/csrc/` under `mapper_tpu_torch/_build/`.
"""
import re
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
from experiments import sass_loops

PAIRS = re.search(r"constexpr int kPairsPerBlock = \d+;", (kernels.CSRC / "banded_dp.cu").read_text()).group(0)
VARIANTS = {
    "source": None,
    "one_loop": ("const int x_steady = steady0 < steady1 ? steady0 : steady1;", "const int x_steady = 0;"),
    **{f"pairs{k}": (PAIRS, f"constexpr int kPairsPerBlock = {k};") for k in (2, 4, 8, 16)},
}
SASS_DIR = Path(sys.argv[1]) if len(sys.argv) > 1 else None


print(cs.gpu_line())
kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
tmp = Path(tempfile.mkdtemp(dir=kernels.BUILD_DIR))
libs = {}
for name, patch in VARIANTS.items():
    src = tmp / name
    shutil.copytree(kernels.CSRC, src)
    if patch:
        text = (src / "banded_dp.cu").read_text()
        assert text.count(patch[0]) == 1, name
        (src / "banded_dp.cu").write_text(text.replace(patch[0], patch[1]))
    libs[name] = kernels.library(build_dir=src, csrc=src)
    k3 = next(part for fn, part in sass_loops.functions(libs[name]._name).items()
              if "banded_i16_packed_warp_kernel" in fn)
    loops = sass_loops.shuffle_loops(k3)
    for i, (mix, _) in enumerate(loops[:2]):  # the steady and the general step's loops
        print(f"{name}: K3 x loop {i}: {sass_loops.mix_line(mix)}", flush=True)
    if SASS_DIR is not None:
        SASS_DIR.mkdir(parents=True, exist_ok=True)
        (SASS_DIR / f"k3_{name}_loop.sass").write_text(loops[0][1] + "\n")

params = AlignmentParameters.defaults()
cands = scoring_candidates(np.random.default_rng(64), 16384, 192, 64, ref_size=4_600_000, num_reads=4096)
reads, concat, read_id, rev, ws, lane, n, m = banded._normalize(*[torch.as_tensor(cands[k]).cuda() for k in cs._KEYS])
qg, wg = banded._gather_codes(reads, concat, read_id, rev, ws, n, 64)
q, w, n3, m3 = banded._host_rows(qg, wg, n, m, 64, cs.CHUNK)
scale, ints = banded._quantize_params(params, q.shape[1], 64)
inv = banded._inv(scale)
want = banded._from_units(*banded._pen_core_i16(q.to(torch.int32), w.to(torch.int32), n3, m3, ints, 64), scale)
stream = torch.cuda.current_stream().cuda_stream
b = q.shape[0]
calls = {}
for name, lib in libs.items():
    out = (torch.empty(b, device="cuda"), torch.empty((b, 64), device="cuda"))
    calls[f"K3 {name}"] = (lambda lib=lib, out=out: lib.mapper_banded_i16_packed(
        q.data_ptr(), q.shape[1], w.data_ptr(), w.shape[1], n3.data_ptr(), m3.data_ptr(), b, *ints, inv,
        out[0].data_ptr(), out[1].data_ptr(), stream), out)
# K1 on the same rows, as banded_scores sends them: each row its own read,
# the windows laid end to end as the reference
reads1, concat1, read_id1, rev1, ws1, lane1, n1, m1 = banded._rows_as_candidates(q, w, n3, m3)
k1_out, k1_diag = torch.empty((2, b), device="cuda"), torch.empty((b, 64), device="cuda")
calls["K1 source"] = (lambda: libs["source"].mapper_banded_i16(
    reads1.data_ptr(), q.shape[1], concat1.data_ptr(), concat1.shape[0], read_id1.data_ptr(), rev1.data_ptr(),
    ws1.data_ptr(), lane1.data_ptr(), n1.data_ptr(), m1.data_ptr(), b, 64, *ints, inv, k1_out.data_ptr(),
    k1_diag.data_ptr(), stream), (k1_out[0], k1_diag))
for key, (fn, got) in calls.items():
    assert fn() == 0
    torch.cuda.synchronize()
    assert all(torch.equal(g, u) for g, u in zip(got, want)), key
order = list(calls)
times = {key: [] for key in order}
for key in order + order[::-1] + order + order[::-1]:
    times[key].append(cs.cuda_ms(calls[key][0], 20))
for key, ts in times.items():
    print(f"{key}: {np.mean(ts):.4f} ms ({', '.join(f'{t:.4f}' for t in ts)}), "
          f"{np.mean(ts) / np.mean(times['K1 source']):.3f}x K1", flush=True)
