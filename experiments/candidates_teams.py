"""KC1's team sizes against each other: `candidates_kernel` built with its
team constants set to each variant, timed in turns on `chip_smoke.py`'s
phase 7 chunks of 150 bp and 1,000 bp, each held equal to the plain
version first.

    python3 experiments/candidates_teams.py [VARIANT ...]

A VARIANT is NAME=VALUE[,NAME=VALUE...] over candidates.cu's constants
(kNarrowWarps, kNarrowReads, kWideWarps, kNarrowWidth); by default
kNarrowWarps x kNarrowReads over (1, 1) (1, 2) (1, 4) (2, 1) (2, 2) (4, 1)
and kWideWarps 4 and 8.  Each variant is `candidates.cu` and `launch.cuh`
copied with the constants replaced, built into a directory of its own
under `mapper_tpu_torch/_build/`.  Timed by CUDA-graph replay of 20 calls
a reading, the variants in turns, twice (forward, then backward).  Needs a
card and nvcc.
"""
from __future__ import annotations

import concurrent.futures
import ctypes
import json
import re
import shutil
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from experiments import dc_chunks  # noqa: E402

import chip_smoke as cs  # noqa: E402

DEFAULT = ["kNarrowWarps=1,kNarrowReads=1", "kNarrowWarps=1,kNarrowReads=2", "kNarrowWarps=1,kNarrowReads=4",
           "kNarrowWarps=2,kNarrowReads=1", "kNarrowWarps=2,kNarrowReads=2", "kNarrowWarps=4,kNarrowReads=1",
           "kWideWarps=4", "kWideWarps=8"]


def build(variant: str, root: Path):
    from mapper_tpu_torch.align import kernels

    src = root / re.sub(r"\W", "_", variant)
    src.mkdir(parents=True)
    text = (kernels.CSRC / "candidates.cu").read_text()
    for item in variant.split(","):
        name, value = item.split("=")
        text, count = re.subn(rf"(constexpr int {name} = )\d+;", rf"\g<1>{value};", text)
        assert count == 1, name
    (src / "candidates.cu").write_text(text)
    shutil.copy(kernels.CSRC / "launch.cuh", src / "launch.cuh")
    kernels.compile_library(src / "kernels.so", src)
    lib = ctypes.CDLL(str(src / "kernels.so"))
    lib.mapper_candidates.argtypes = kernels._SIGNATURES["mapper_candidates"]
    lib.mapper_candidates.restype = ctypes.c_int
    return lib


def main(argv) -> int:
    import torch

    from mapper_tpu_torch.align import kernels
    from mapper_tpu_torch.batch import device_candidates as dc

    variants = argv or DEFAULT
    print(cs.gpu_line(), flush=True)
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    root = Path(tempfile.mkdtemp(prefix="teams_", dir=kernels.BUILD_DIR))
    with concurrent.futures.ThreadPoolExecutor(len(variants)) as pool:
        libs = dict(zip(variants, pool.map(lambda v: build(v, root), variants)))
    results = {}
    with tempfile.TemporaryDirectory(prefix="teams_data_") as tmp:
        chunks = dc_chunks.phase7_chunks(Path(tmp))
        for tag in ("150bp", "1000bp"):
            inputs, _ = chunks[tag]
            want = dc.candidates_plain(inputs)
            calls = {}
            for v, lib in libs.items():
                launch, out = dc_chunks.kc1_call(lib, inputs)
                if launch() != 0:
                    raise RuntimeError(f"{v}: launch failed on {tag}")
                torch.cuda.synchronize()
                if not torch.equal(out, want):
                    raise AssertionError(f"{v}: KC1 != plain on {tag}")
                calls[v] = launch
            times = {v: [] for v in variants}
            for v in variants + variants[::-1]:
                times[v].append(cs.graph_ms(calls[v], 20))
            for v in variants:
                ms = sum(times[v]) / len(times[v])
                results[f"{tag} {v}"] = {"ms": ms, "readings": times[v]}
                print(f"[teams] {tag} {v}: equal to plain; {ms:.4f} ms ({', '.join(f'{t:.4f}' for t in times[v])})",
                      flush=True)
    print(json.dumps({"candidates_teams": results, "gpu": cs.gpu_line()}))
    shutil.rmtree(root, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
