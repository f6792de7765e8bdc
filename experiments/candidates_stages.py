"""Where KC1's time goes: `candidates_kernel` built with a compile-time cut
after each of its stages, timed on `chip_smoke.py`'s phase 7 chunks.

    python3 experiments/candidates_stages.py [CSRC ...]

Each CSRC (default: the package's `csrc/`) is a source directory laid out
as `mapper_tpu_torch/align/csrc/`.  For each, `candidates.cu` and
`launch.cuh` are copied five times into a build directory of their own
under `mapper_tpu_torch/_build/`, each with `#define KC1_STAGE n` in front:
the kernel stops after stage n of

    1 the gapmer prefix tables and the base row,
    2 the pyramid levels (seeds written),
    3 the lookup (each entry's vote key computed),
    4 the votes (counted),
    5 the top-K (the whole kernel),

and writes one word that depends on what the stage made, so that nothing is
left out as dead code.  A source with `KC1_STAGE` cut points of its own
takes the define alone; the earlier kernel of one block a read (commit
6c3e5e7) takes them as text patches at its stage comments.  The main build never defines
KC1_STAGE.  Each cut is timed by CUDA-graph replay of 20 calls (the host's
pace of issuing calls is not in the time) at the 150 bp and 1,000 bp
chunks, the sources in turns (A B B A, each stage in order);
prints each stage's time and its increment over the one before, and one
JSON line.  Needs a card and nvcc.
"""
from __future__ import annotations

import concurrent.futures
import ctypes
import json
import shutil
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from experiments import dc_chunks  # noqa: E402

import chip_smoke as cs  # noqa: E402

STAGES = ("prefix tables and base row", "levels", "lookup", "votes", "top-K")
REPS = 20
CHUNKS = ("150bp", "1000bp")

# the one-block-a-read kernel's cuts: (the comment a cut goes in front of, the cut)
PARENT_CUTS = {
    1: ("    // the levels: each merges the list's valid blocks",
        "row.pref_fwd[width] ^ row.pref_comp[width] ^ static_cast<uint32_t>(row.len[n0 > 0 ? n0 - 1 : 0])"),
    2: ("    // each kept seed's bin, then its matches' vote keys",
        "seeds + (unconverged ? 1 : 0) + (seeds > 0 ? seed_key[min_of(seeds, kVSlots) - 1] : 0)"),
    3: ("    // the votes: sort the keys (bitonic",
        "entries + (num_entries > 0 ? static_cast<int32_t>(vote_keys[num_entries - 1]) : 0)"),
    4: ("    // top-K rounds: votes descending",
        "num_entries > 0 ? vote_counts[0] : 0"),
}


def staged_source(text: str, stage: int) -> str:
    """candidates.cu cut after `stage` (5: whole)."""
    head = f"#define KC1_STAGE {stage}\n"
    if "KC1_STAGE" in text:
        return head + text
    for n, (anchor, value) in PARENT_CUTS.items():
        assert text.count(anchor) == 1, anchor
        cut = (f"    if (KC1_STAGE == {n}) {{\n      __syncthreads();\n"
               f"      if (tid == 0) out[b * row_width] = static_cast<int32_t>({value});\n"
               f"      __syncthreads();\n      continue;\n    }}\n")
        text = text.replace(anchor, cut + anchor)
    return head + text


def build(csrc: Path, stage: int, root: Path):
    """The cut's library, loaded, with mapper_candidates' argument types."""
    from mapper_tpu_torch.align import kernels

    src = root / f"{csrc.name}_{stage}"
    src.mkdir(parents=True)
    (src / "candidates.cu").write_text(staged_source((csrc / "candidates.cu").read_text(), stage))
    shutil.copy(csrc / "launch.cuh", src / "launch.cuh")
    target = src / "kernels.so"
    kernels.compile_library(target, src)
    lib = ctypes.CDLL(str(target))
    lib.mapper_candidates.argtypes = kernels._SIGNATURES["mapper_candidates"]
    lib.mapper_candidates.restype = ctypes.c_int
    return lib


def main(argv) -> int:
    import torch

    from mapper_tpu_torch.align import kernels

    dirs = [Path(a).resolve() for a in argv] or [kernels.CSRC]
    print(cs.gpu_line(), flush=True)
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    root = Path(tempfile.mkdtemp(prefix="stages_", dir=kernels.BUILD_DIR))
    with concurrent.futures.ThreadPoolExecutor(len(dirs) * len(STAGES)) as pool:
        futures = {(i, s): pool.submit(build, d, s, root / str(i)) for i, d in enumerate(dirs)
                   for s in range(1, len(STAGES) + 1)}
        libs = {key: f.result() for key, f in futures.items()}
    print(f"[stages] {len(libs)} cuts built", flush=True)
    with tempfile.TemporaryDirectory(prefix="stages_data_") as tmp:
        chunks = dc_chunks.phase7_chunks(Path(tmp))
        results = {}
        for tag in CHUNKS:
            inputs, _ = chunks[tag]
            calls = {key: dc_chunks.kc1_call(lib, inputs) for key, lib in libs.items()}
            for key, (launch, _) in calls.items():
                if launch() != 0:
                    raise RuntimeError(f"launch failed: {key}")
            torch.cuda.synchronize()
            order = list(range(len(dirs)))
            times = {key: [] for key in calls}
            for i in order + order[::-1]:
                for s in range(1, len(STAGES) + 1):
                    times[(i, s)].append(cs.graph_ms(calls[(i, s)][0], REPS))
            for i, d in enumerate(dirs):
                ms = [sum(times[(i, s)]) / len(times[(i, s)]) for s in range(1, len(STAGES) + 1)]
                results[f"{tag} {d}"] = {"label": dc_chunks.build_label(d), "stage_ms": ms,
                                         "readings": [times[(i, s)] for s in range(1, len(STAGES) + 1)]}
                print(f"[stages] {tag}, {d} ({dc_chunks.build_label(d)}):", flush=True)
                for s, name in enumerate(STAGES):
                    step = ms[s] - (ms[s - 1] if s else 0.0)
                    print(f"    to {s + 1} {name}: {ms[s]:.4f} ms (+{step:.4f}); readings "
                          f"{', '.join(f'{t:.4f}' for t in times[(i, s + 1)])}", flush=True)
    print(json.dumps({"candidates_stages": results, "gpu": cs.gpu_line()}))
    shutil.rmtree(root, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
