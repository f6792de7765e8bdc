"""Where a benchmark job's time goes, from the program's own spans: one
traced `portbench` run of a cell on the card, and the split of its jobs.

    python3 experiments/trace_breakdown.py --workload se150_gapped --seed N [--seconds 51]

Runs `portbench.run.run_cell(..., trace=True)` (torch.profiler and the
benchmark's wrappers on, `MAPPER_TPU_TRACE=1`), keeps the context its
metric readers see, and prints one JSON line: the result line's metrics
and checks, and from the jobs' `[trace]` lines

- `leaf_s_a_job`: each leaf span's (a span without a child) seconds a
  job, and `span_s_a_job` the same for every span;
- `cpu_share`: a span's thread CPU seconds over its wall seconds, for the
  waits (`cli.wait`, `cli.dup_wait`, `engine.fetch`) and every other span;
- `idle_by_leaf_s`: the device's idle seconds inside jobs put down to the
  leaf spans open then (`portbench.program_trace.idle_by_leaf`);
- `nonalign_cover`: the main thread's leaf spans outside `cli.align`, the
  mean a job, over `cli.nonalign_s`;
- `decide_over_decisions`: `engine.decide_ms_per_kread` over
  `engine.decisions_ms_per_kread` (single end).
"""

from __future__ import annotations

import argparse
import json
import sys
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from portbench import cells, program_trace, run  # noqa: E402

WAITS = ("cli.wait", "cli.dup_wait", "engine.fetch")


def split(ctx) -> dict:
    found = program_trace.records(ctx)
    jobs = len(found)
    leaf_s, span_s = defaultdict(float), defaultdict(float)
    cpu, wall = defaultdict(float), defaultdict(float)
    outside_align = 0.0
    for record in found:
        spans = record["spans"]
        parents = {s[5] for s in spans if s[5] is not None}
        main = next(s for s in spans if s[0] == "cli.main")
        align = [s for s in spans if s[0] == "cli.align" and s[3] is not None]
        for i, (name, thread, t0, t1, c, parent, _) in enumerate(spans):
            if t1 is None:
                continue
            span_s[name] += (t1 - t0) / jobs
            cpu[name] += c
            wall[name] += t1 - t0
            if i not in parents:
                leaf_s[name] += (t1 - t0) / jobs
                if thread == main[1] and not any(a[2] <= t0 and t1 <= a[3] for a in align):
                    outside_align += (t1 - t0) / jobs
    out = {
        "jobs_with_a_line": jobs,
        "leaf_s_a_job": dict(sorted(leaf_s.items(), key=lambda kv: -kv[1])),
        "span_s_a_job": dict(sorted(span_s.items(), key=lambda kv: -kv[1])),
        "cpu_share": {n: cpu[n] / wall[n] for n in sorted(wall, key=lambda n: (n not in WAITS, n)) if wall[n] > 0},
        "counts_a_job": {k: v / jobs for k, v in sorted(
            {k: sum(r["counts"].get(k, 0) for r in found) for r in found for k in r["counts"]}.items())},
        "main_leaf_outside_align_s_a_job": outside_align,
        "spans_a_job": sum(len(r["spans"]) for r in found) / jobs,
    }
    if ctx.device is not None:
        by_leaf = program_trace.idle_by_leaf(ctx.device, ctx.spans.spans, found)
        out["idle_in_jobs_s"] = sum(by_leaf.values())
        out["idle_by_leaf_s"] = dict(sorted(by_leaf.items(), key=lambda kv: -kv[1]))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 experiments/trace_breakdown.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=51)
    ap.add_argument("--root", type=Path, default=ROOT, help="the checkout whose BENCHMARK.json is run")
    ap.add_argument("--device", default="cuda", help="cpu: a rehearsal at a shrunk size, which measures nothing")
    args = ap.parse_args(argv)
    kept = {}
    original = cells.reader

    def reader(root, metric):
        read = original(root, metric)

        def keep(ctx):
            kept["ctx"] = ctx
            return read(ctx)
        return keep

    cells.reader = reader
    try:
        result = run.run_cell(args.root, args.workload, args.seed, args.seconds, True, args.device)
    finally:
        cells.reader = original
    metrics = {k: v["value"] for k, v in result["metrics"].items()}
    out = {"workload": args.workload, "seed": args.seed, "correct": result["correct"], "device": result["device"],
           "metrics": metrics, "breakdown": result.get("breakdown"), "jobs": result["jobs"],
           "checks": {k: v["value"] for k, v in result["checks"].items()}, **split(kept["ctx"])}
    if metrics.get("cli.nonalign_s"):
        out["nonalign_cover"] = out["main_leaf_outside_align_s_a_job"] / metrics["cli.nonalign_s"]
    if metrics.get("engine.decisions_ms_per_kread"):
        out["decide_over_decisions"] = metrics["engine.decide_ms_per_kread"] / metrics["engine.decisions_ms_per_kread"]
    print(json.dumps(out), flush=True)
    return 0 if result["correct"] else 1


if __name__ == "__main__":
    sys.exit(main())
