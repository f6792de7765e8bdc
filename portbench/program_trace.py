"""The program's own spans and counters: the `[trace]` line that each traced
job of `mapper_tpu_torch.cli.main` writes to its standard error
(`mapper_tpu_torch/trace.py`; the root README's "Tracing" section),

    [trace] {"clock": "perf_counter", "spans": [[name, thread, t0, t1, cpu, parent, batch], ...], "counts": {...}}

`parent` is the index of the enclosing span on the same thread, `t1` and
`cpu` are null for a span left open.  The clock is the one the device
trace's anchors use (`trace.py`), so program spans and device intervals
compare directly.  A program that writes no such line gives no records, and
every reader built on these returns None there.
"""

from __future__ import annotations

import json
from collections import defaultdict

PREFIX = "[trace] "
# spans in which a thread waits for another thread's work
WAITS = ("cli.wait", "cli.dup_wait")


def records(ctx) -> list[dict]:
    """One record per `[trace]` line in the jobs' standard error."""
    found = []
    for job in ctx.jobs:
        for line in job.stderr.splitlines():
            if line.startswith(PREFIX):
                try:
                    record = json.loads(line[len(PREFIX):])
                except ValueError:
                    continue
                if isinstance(record, dict) and record.get("clock") == "perf_counter":
                    found.append(record)
    return found


def closed(record: dict) -> list[list]:
    """The record's spans that closed."""
    return [s for s in record["spans"] if s[3] is not None]


def seconds(record: dict, names) -> float:
    return sum(s[3] - s[2] for s in closed(record) if s[0] in names)


def mean_seconds_a_job(ctx, names) -> float | None:
    """The spans' seconds summed over each job, the mean over jobs."""
    found = records(ctx)
    if not found:
        return None
    return sum(seconds(r, names) for r in found) / len(found)


def ms_per_kread(ctx, names) -> float | None:
    """The spans' milliseconds per 1,000 reads (a pair is two reads)."""
    found = records(ctx)
    if not found:
        return None
    kreads = ctx.reads_per_job * len(found) / 1000
    return sum(seconds(r, names) for r in found) * 1e3 / kreads


def count(ctx, name: str) -> float | None:
    found = records(ctx)
    if not found:
        return None
    return sum(r["counts"].get(name, 0) for r in found)


def leaves(found: list[dict]) -> list[tuple[str, str, float, float]]:
    """(name, thread, t0, t1) of every closed span without a child."""
    out = []
    for record in found:
        spans = record["spans"]
        parents = {s[5] for s in spans if s[5] is not None}
        out += [(s[0], s[1], s[2], s[3]) for i, s in enumerate(spans) if i not in parents and s[3] is not None]
    return out


def _union(intervals) -> list[list[float]]:
    merged: list[list[float]] = []
    for a, b in sorted((a, b) for a, b in intervals if b > a):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def _subtract(keep, cut) -> list[list[float]]:
    """Merged intervals `keep` less merged intervals `cut`."""
    out, k = [], 0
    for a, b in keep:
        while k < len(cut) and cut[k][1] <= a:
            k += 1
        j = k
        while j < len(cut) and cut[j][0] < b:
            if cut[j][0] > a:
                out.append([a, cut[j][0]])
            a = max(a, cut[j][1])
            j += 1
        if a < b:
            out.append([a, b])
    return out


def _length(intervals) -> float:
    return sum(b - a for a, b in intervals)


def idle_in_jobs(device: dict, job_spans) -> list[list[float]]:
    """The device's idle time inside the benchmark's `job` spans, within the
    traced window, as merged intervals."""
    start, end = device["start"], device["end"]
    jobs = _union((max(t0, start), min(t1, end)) for name, t0, t1 in job_spans if name == "job")
    return _subtract(jobs, _union(tuple(b) for b in device["busy"]))


def idle_unattributed_share(device: dict, job_spans, found: list[dict]) -> float | None:
    """The share of the device's idle time inside jobs during which no
    program leaf span is open on any thread."""
    idle = idle_in_jobs(device, job_spans)
    total = _length(idle)
    if not found or total <= 0:
        return None
    covered = _union((t0, t1) for _, _, t0, t1 in leaves(found))
    return _length(_subtract(idle, covered)) / total


def idle_by_leaf(device: dict, job_spans, found: list[dict]) -> dict[str, float]:
    """The device's idle seconds inside jobs put down to the program's leaf
    spans open then: split evenly among those that are not waits
    (`WAITS`), else among the waits; "none" where no leaf is open."""
    idle = idle_in_jobs(device, job_spans)
    spans = leaves(found)
    cuts = sorted({t for a, b in idle for t in (a, b)} | {t for _, _, t0, t1 in spans for t in (t0, t1)})
    by_name: dict[str, float] = defaultdict(float)
    k = 0
    for a, b in zip(cuts, cuts[1:]):
        mid = 0.5 * (a + b)
        while k < len(idle) and idle[k][1] <= mid:
            k += 1
        if k == len(idle) or idle[k][0] > mid:
            continue
        open_ = [n for n, _, t0, t1 in spans if t0 <= mid < t1]
        work = [n for n in open_ if n not in WAITS] or open_
        for n in work:
            by_name[n] += (b - a) / len(work)
        if not work:
            by_name["none"] += b - a
    return dict(by_name)
