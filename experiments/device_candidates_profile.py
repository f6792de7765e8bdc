"""Where the fused device-candidates path spends its time, on one NVIDIA GPU.

    python3 experiments/device_candidates_profile.py

1. Simulates chip_smoke.py's reference and 150 bp reads (seed 0, 4.6 Mb,
   100,000 reads) and runs the CLI on them four times in turns with
   MAPPER_TPU_TRACE=1: kernel-scored (the default path), on the fused path
   (MAPPER_TPU_DEVICE_CANDIDATES=1) twice, kernel-scored again. Prints the
   engine's stage times summed over chunks and pool threads, per run, and
   each run's align phase.
2. On the first 4,096 reads, with the engine's band and half-windows, traces
   three calls each of the candidates program and the fused program with
   torch.profiler: wall milliseconds a call, device-busy milliseconds a call
   (the kernels' summed self time on the card), kernel launches a call, and
   the ten kernels with the most device time.
3. Contention: host-clock milliseconds (synchronized) alone and with one
   pure-Python busy thread beside them, in turns (alone, busy, alone): 200
   small tensor operations on the card (20 calls a reading), the fused
   program and the host generate_candidates on the same reads (one call a
   reading). The CLI's pool threads and main thread run Python while a
   chunk's program is issued; this shows what that costs the issuing thread.

Prints one JSON line with all of it, after the card's name and power limit.
"""

from __future__ import annotations

import collections
import contextlib
import io
import json
import os
import re
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
# the card's name line and the contention measurement, as chip_smoke.py takes them
from chip_smoke import contention_ms, gpu_line  # noqa: E402

READS = 4096
CALLS = 3


def simulate(root: Path) -> None:
    """chip_smoke.py's reference and 150 bp reads (the same seed and order)."""
    import numpy as np

    from benchmarks.simlib import random_reference, write_reference
    from mapper_tpu_torch.simulate import simulate_reads, write_fastq

    rng = np.random.default_rng(0)
    ref = random_reference(rng, 4_600_000)
    write_reference(str(root / "ref.fasta"), {"chr1": ref})
    write_fastq(root / "short.fastq", simulate_reads(rng, ref, 100_000, 150, 0.01, 0.1, "s"))


def traced_cli(root: Path, tag: str, fused: bool) -> dict:
    """One CLI run with the engine's stage tracer: the seconds of each stage
    summed over chunks and threads, how often each was marked, and the align
    phase."""
    from mapper_tpu_torch import cli

    env = {"MAPPER_TPU_TRACE": "1", "MAPPER_TPU_DEVICE_CANDIDATES": "1" if fused else "0"}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    out, err = io.StringIO(), io.StringIO()
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = cli.main(["--reference", str(root / "ref.fasta"), "--queries", str(root / "short.fastq"),
                           "--out-sam", str(root / f"{tag}.sam"), "--cache-dir", str(root / "index_cache")])
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    if rc != 0:
        raise RuntimeError(f"{tag}: CLI returned {rc}\n{err.getvalue()[-2000:]}")
    stages = collections.Counter()
    counts = collections.Counter()
    for label, seconds in re.findall(r"\[engine\] ([^:(]+?)(?: \([^)]*\))?: ([0-9.]+)s", out.getvalue()):
        stages[label] += float(seconds)
        counts[label] += 1
    align = re.search(r"Align phase: \d+ queries in ([0-9.]+)s", err.getvalue())
    return {"stages_s": dict(stages), "stage_counts": dict(counts), "align_s": float(align.group(1))}


def profile_programs(root: Path, device) -> dict:
    """torch.profiler over CALLS calls of each program on the first READS reads."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from mapper_tpu_torch.align.params import AlignmentParameters
    from mapper_tpu_torch.batch import device_candidates as dc
    from mapper_tpu_torch.batch.candidates import ReadBatch
    from mapper_tpu_torch.batch.engine import upload_reference
    from mapper_tpu_torch.index.database import HashBlockDatabase, choose_max_duplication_length
    from mapper_tpu_torch.index.dircache import DirCache
    from mapper_tpu_torch.io import fastx
    from mapper_tpu_torch.sequence import Sequence, SequenceDatabase, sort_and_complement

    params = AlignmentParameters.defaults()
    provider = fastx.load_from([str(root / "ref.fasta")], keep_quality=False)
    seq_db = SequenceDatabase(sort_and_complement(b.build() for b in provider))
    db = HashBlockDatabase(seq_db, hint_max_interesting_size=choose_max_duplication_length(seq_db),
                           cache_dir=DirCache(str(root / "index_cache")))
    lines = (root / "short.fastq").read_text().splitlines()[: 4 * READS]
    batch = ReadBatch.from_sequences([Sequence.from_text(lines[i][1:], lines[i + 1]) for i in range(0, len(lines), 4)])
    max_indel = np.maximum(0, ((batch.lengths * params.max_error_rate - params.deletion_start_penalty)
                               / params.deletion_extension_penalty).astype(np.int64))
    band = 64 if int(max_indel.max()) <= 31 else 128
    inputs = dc.fused_inputs(batch, db, upload_reference(seq_db.concatenated_codes(), device),
                             np.minimum(max_indel, band // 2), band)
    programs = {"candidates": lambda: dc.candidates_program(inputs),
                "fused": lambda: dc.fused_program(inputs, params, band)}
    result = {}
    for name, fn in programs.items():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(CALLS):
                fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        kernels = collections.Counter()
        launches = 0
        for event in prof.events():
            if event.device_type == torch.autograd.DeviceType.CUDA:
                kernels[event.name] += event.device_time_total
                launches += 1
        busy_us = sum(kernels.values())
        result[name] = {
            "wall_ms_per_call": wall / CALLS * 1e3,
            "device_busy_ms_per_call": busy_us / CALLS / 1e3,
            "device_ops_per_call": launches / CALLS,
            "top_kernels_ms_per_call": {k: v / CALLS / 1e3 for k, v in kernels.most_common(10)},
        }
        print(f"[profile] {name}: {result[name]['wall_ms_per_call']:.3f} ms a call (host clock), device busy "
              f"{result[name]['device_busy_ms_per_call']:.3f} ms, {result[name]['device_ops_per_call']:.0f} "
              "device operations", flush=True)

    from mapper_tpu_torch.batch.candidates import generate_candidates

    small = torch.ones(1024, device=inputs["codes"].device)

    def small_ops():
        for _ in range(200):
            small.add_(1)

    contenders = {"200_small_ops": (small_ops, 20), "fused": (programs["fused"], 1),
                  "host_candidates": (lambda: generate_candidates(batch, db), 1)}
    result["contention_ms_per_call"] = {name: contention_ms(fn, reps) for name, (fn, reps) in contenders.items()}
    for name, ms in result["contention_ms_per_call"].items():
        print(f"[contention] {name}: ms a call alone {ms['alone']}, beside a busy Python thread {ms['busy']}",
              flush=True)
    return result


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("device_candidates_profile: no CUDA device", file=sys.stderr)
        return 1
    gpu = gpu_line()
    print(f"[gpu] {gpu}", flush=True)
    os.environ["MAPPER_TPU_TORCH_DEVICE"] = "cuda"
    with tempfile.TemporaryDirectory(prefix="dc_profile_") as tmp:
        root = Path(tmp)
        simulate(root)
        cli_runs = {}
        for tag, fused in (("kernel_1", False), ("fused_1", True), ("fused_2", True), ("kernel_2", False)):
            cli_runs[tag] = traced_cli(root, tag, fused)
            print(f"[cli] {tag}: align phase {cli_runs[tag]['align_s']:.3f} s; stages (s, summed): "
                  + ", ".join(f"{k} {v:.3f}" for k, v in cli_runs[tag]["stages_s"].items()), flush=True)
        programs = profile_programs(root, torch.device("cuda", 0))
    print(gpu)
    print(json.dumps({"gpu": gpu, "cli": cli_runs, "programs": programs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
