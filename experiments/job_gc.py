"""Where a benchmark job's time outside `cli.pileup` goes, with the garbage
collector's pauses: a cell's jobs run as `portbench.run` runs them, traced
by the program (`MAPPER_TPU_TRACE=1`), with `gc.callbacks` timing every
collection.

    python3 experiments/job_gc.py --workload se150_gapped --seed N [--jobs 3]

Makes the cell's sample from `--seed`, runs the warm-up job, then `--jobs`
jobs (a `gc.collect()` before each, as `portbench.run` does), and prints
one JSON line: for each job its wall seconds, the main thread's spans
`cli.main`, `cli.align`, `cli.pileup` and `cli.write`, `cli.main` less
`cli.pileup`, and the collector's pauses (count and seconds by generation,
and seconds inside each of those spans).  Run it from two checkouts in
turns on the same seed to compare them.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from portbench import cells, run  # noqa: E402

SPANS = ("cli.main", "cli.align", "cli.pileup", "cli.write")


class Pauses:
    """Every collection's (generation, start, stop) on perf_counter."""

    def __init__(self):
        self.pauses: list[tuple[int, float, float]] = []
        self._start = None

    def __call__(self, phase, info):
        if phase == "start":
            self._start = time.perf_counter()
        elif self._start is not None:
            self.pauses.append((info["generation"], self._start, time.perf_counter()))
            self._start = None


def main_spans(stderr: str) -> dict[str, list[tuple[float, float]]]:
    """The main thread's closed spans of SPANS in a job's `[trace]` line."""
    line = next(ln for ln in stderr.splitlines() if ln.startswith("[trace] "))
    spans = json.loads(line[len("[trace] "):])["spans"]
    main = next(s[1] for s in spans if s[0] == "cli.main")
    found: dict[str, list] = {name: [] for name in SPANS}
    for name, thread, t0, t1, *_ in spans:
        if name in found and thread == main and t1 is not None:
            found[name].append((t0, t1))
    return found


def job_record(job, pauses) -> dict:
    spans = main_spans(job.stderr)
    seconds = {name: sum(t1 - t0 for t0, t1 in spans[name]) for name in SPANS}
    gc_by_gen = {str(g): [0, 0.0] for g in range(3)}
    gc_in = {name: 0.0 for name in SPANS}
    for gen, t0, t1 in pauses:
        gc_by_gen[str(gen)][0] += 1
        gc_by_gen[str(gen)][1] += t1 - t0
        for name in SPANS:
            gc_in[name] += sum(max(0.0, min(t1, b) - max(t0, a)) for a, b in spans[name])
    return {"wall_s": job.wall, "span_s": seconds, "main_less_pileup_s": seconds["cli.main"] - seconds["cli.pileup"],
            "gc_count_s_by_generation": gc_by_gen, "gc_s_in_span": gc_in}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 experiments/job_gc.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--jobs", type=int, default=3)
    ap.add_argument("--root", type=Path, default=ROOT, help="the checkout whose BENCHMARK.json is run")
    ap.add_argument("--device", default="cuda", help="cpu: a rehearsal at a shrunk size, which measures nothing")
    args = ap.parse_args(argv)
    cell = cells.load(args.root, args.workload)
    run.environment(args.root, args.device)
    from mapper_tpu_torch import cli

    tmp = Path(tempfile.mkdtemp(prefix="job-gc-", dir=os.environ.get("TMPDIR")))
    try:
        sample = run.make_sample(cell, args.seed, tmp)
        (tmp / "warm").mkdir()
        warm = run.run_job(cli.main, run.cli_argv(cell.config, sample.warm_files, tmp / "warm", tmp / "index_cache"))
        if warm.error is not None or warm.rc != 0:
            raise RuntimeError(f"warm-up run failed (rc {warm.rc}):\n{warm.error or ''}{warm.stderr[-3000:]}")
        os.environ["MAPPER_TPU_TRACE"] = "1"
        jobs = []
        for k in range(args.jobs):
            outdir = tmp / f"job{k}"
            outdir.mkdir()
            gc.collect()
            pauses = Pauses()
            gc.callbacks.append(pauses)
            try:
                job = run.run_job(cli.main, run.cli_argv(cell.config, sample.files, outdir, tmp / "index_cache"))
            finally:
                gc.callbacks.remove(pauses)
            if job.error is not None or job.rc != 0:
                raise RuntimeError(f"job {k} failed (rc {job.rc}):\n{job.error or ''}{job.stderr[-3000:]}")
            jobs.append(job_record(job, pauses.pauses))
            shutil.rmtree(outdir)
        print(json.dumps({"workload": args.workload, "seed": args.seed, "checkout": str(ROOT.name),
                          "thresholds": gc.get_threshold(), "jobs": jobs}), flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
