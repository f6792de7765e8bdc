"""What the program's tracing costs on the card: `portbench` runs of a cell
with tracing off and with `MAPPER_TPU_TRACE=1` alone (no torch.profiler, no
benchmark wrappers), in turns on the same seeds, and the recorder's own
cost a span and a counter on this host.

    python3 experiments/trace_cost.py --workload se150_gapped --seeds N [N ...] [--seconds 51]

For each seed, in turns (off, on; then on, off for the next seed), one
`portbench.run.run_cell(..., trace=False)`; the traced side sets
`MAPPER_TPU_TRACE=1` after the harness clears the program's variables.
Prints one JSON line a run (reads/s, set-up, the jobs' walls, and with
tracing on the spans a job) and a last line with the medians and the
microbenchmark.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from portbench import run  # noqa: E402


def one_run(root: Path, workload: str, seed: int, seconds: float, traced: bool, device: str) -> dict:
    original = run.environment

    def environment(root, device):
        original(root, device)
        if traced:
            os.environ["MAPPER_TPU_TRACE"] = "1"

    run.environment = environment
    try:
        result = run.run_cell(root, workload, seed, seconds, False, device)
    finally:
        run.environment = original
        os.environ.pop("MAPPER_TPU_TRACE", None)
    return {"seed": seed, "traced": traced, "correct": result["correct"],
            "reads_per_s": result["metrics"]["reads_per_s"]["value"],
            "setup_s": result["metrics"]["setup_s"]["value"],
            "job_wall_s": [j["wall_s"] for j in result["jobs"]], "device": result["device"]["kind"],
            "power_limit_w": result["device"].get("power_limit_w")}


def microbenchmark(n: int = 200_000) -> dict:
    """Seconds a span (enter and exit, nested one deep) and a counter."""
    from mapper_tpu_torch import trace

    rec = trace.Recorder()
    with rec.span("outer"):
        t0 = time.perf_counter()
        for _ in range(n):
            with rec.span("x"):
                pass
        span_s = (time.perf_counter() - t0) / n
        t0 = time.perf_counter()
        for _ in range(n):
            rec.count("x", 1)
        count_s = (time.perf_counter() - t0) / n
    off = trace.OFF
    t0 = time.perf_counter()
    for _ in range(n):
        with off.span("x"):
            pass
    off_s = (time.perf_counter() - t0) / n
    with open(os.devnull, "w") as sink:
        t0 = time.perf_counter()
        rec.export(sink)
    return {"span_s": span_s, "count_s": count_s, "off_span_s": off_s,
            "export_s_per_span": (time.perf_counter() - t0) / (n + 1)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 experiments/trace_cost.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=51)
    ap.add_argument("--root", type=Path, default=ROOT, help="the checkout whose BENCHMARK.json is run")
    ap.add_argument("--device", default="cuda", help="cpu: a rehearsal at a shrunk size, which measures nothing")
    args = ap.parse_args(argv)
    runs = []
    for k, seed in enumerate(args.seeds):
        for traced in ((False, True) if k % 2 == 0 else (True, False)):
            runs.append(one_run(args.root, args.workload, seed, args.seconds, traced, args.device))
            print(json.dumps(runs[-1]), flush=True)
    summary = {}
    for traced in (False, True):
        side = [r for r in runs if r["traced"] == traced]
        walls = [w for r in side for w in r["job_wall_s"]]
        summary["on" if traced else "off"] = {
            "reads_per_s_median": statistics.median(r["reads_per_s"] for r in side),
            "setup_s_median": statistics.median(r["setup_s"] for r in side),
            "job_wall_s_mean": statistics.fmean(walls), "jobs": len(walls)}
    pairs = [(a["reads_per_s"], b["reads_per_s"]) for a in runs for b in runs
             if a["seed"] == b["seed"] and not a["traced"] and b["traced"]]
    summary["on_over_off_reads_per_s"] = [b / a for a, b in pairs]
    summary["microbenchmark"] = microbenchmark()
    print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
