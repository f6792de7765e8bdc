"""What the traced run records, from the benchmark's own code: spans and
counts around calls into the program's layers, and the device's kernels
and copies from torch.profiler.

The spans wrap module attributes the program calls through, so the program
is not edited: `batch/engine.py`'s `generate_candidates` (its module
global, which the single-end and paired paths both call), the scorer
wrappers `align/kernels.py`'s `banded_i16` (K1) and `banded_f32` (K2),
which `banded_scores_gathered` calls as `kernels.<name>`, and the engine's
two finishing stages (host decisions and emission)."""

from __future__ import annotations

import json
import threading
import time
from collections import defaultdict
from contextlib import contextmanager

from portbench import roofline

# span names, innermost first: idle device time is put down to the first of
# them open on any thread at that time
SPAN_ORDER = ("banded_i16", "banded_f32", "generate_candidates", "finish", "job")


class Spans:
    """Spans (name, start, end) on the host clock and per-layer counts,
    shared by the pool threads."""

    def __init__(self):
        self.lock = threading.Lock()
        self.spans: list[tuple[str, float, float]] = []
        self.counts: dict[str, float] = defaultdict(float)
        self.k1_calls: list[tuple[object, int]] = []  # (device cells, bytes)
        self._restore: list = []

    def add(self, name: str, t0: float, t1: float) -> None:
        with self.lock:
            self.spans.append((name, t0, t1))

    def count(self, name: str, value: float) -> None:
        with self.lock:
            self.counts[name] += value

    def total(self, name: str) -> float:
        return sum(t1 - t0 for n, t0, t1 in self.spans if n == name)

    def wrap(self, owner, attr: str, name: str, before=None, after=None) -> None:
        original = getattr(owner, attr)

        def wrapped(*args, **kwargs):
            if before is not None:
                before(args, kwargs)
            t0 = time.perf_counter()
            try:
                result = original(*args, **kwargs)
            finally:
                self.add(name, t0, time.perf_counter())
            if after is not None:
                after(args, kwargs, result)
            return result

        setattr(owner, attr, wrapped)
        self._restore.append((owner, attr, original))

    def restore(self) -> None:
        for owner, attr, original in reversed(self._restore):
            setattr(owner, attr, original)
        self._restore.clear()

    def k1_least_seconds(self) -> float:
        """K1's least time over the recorded calls (`roofline`)."""
        if not self.k1_calls:
            return 0.0
        import torch

        cells = torch.stack([c for c, _ in self.k1_calls]).cpu().tolist()
        return sum(roofline.k1_least_seconds(c, b) for c, (_, b) in zip(cells, self.k1_calls))


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def instrument(spans: Spans) -> None:
    """Wraps the program's layer boundaries (see the module's docstring)."""
    from mapper_tpu_torch.align import kernels
    from mapper_tpu_torch.batch import engine

    def candidates_after(args, kwargs, table):
        spans.count("candidate_rows", len(table))

    def scorer_before(kernel):
        def before(args, kwargs):
            read_id = args[2]
            spans.count("device_rows", read_id.shape[0])
            if kernel == "banded_i16" and read_id.shape[0]:
                reads, n = args[0], args[6]
                band = kwargs.get("band", args[10] if len(args) > 10 else None)
                moved = _nbytes(*args[:8]) + 2 * read_id.shape[0] * 4  # inputs, [2, B] float32 out
                spans.k1_calls.append((roofline.cells_of(n, reads.shape[1], band), moved))
        return before

    spans.wrap(engine, "generate_candidates", "generate_candidates", after=candidates_after)
    for kernel in ("banded_i16", "banded_f32"):
        spans.wrap(kernels, kernel, kernel, before=scorer_before(kernel))
    for method in ("_finish_single_end", "_finish_paired"):
        spans.wrap(engine.BatchAligner, method, "finish")


@contextmanager
def device_trace(path):
    """torch.profiler over the block, CUDA activity only, exported as a
    Chrome trace to `path`.  A spin kernel on the default stream at the
    start and end (`torch.cuda._sleep`) ties the trace's clock to the host's:
    yields a list that receives their host times."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    anchors: list[float] = []
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        anchors.append(time.perf_counter())
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        try:
            yield anchors
        finally:
            torch.cuda.synchronize()
            anchors.append(time.perf_counter())
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(path))


DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def read_device_trace(path, anchors: list[float]) -> dict:
    """Device intervals on the host clock from an exported trace: every
    kernel, copy and fill, merged; the spin anchors mark the window."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    ops = [(e["name"], float(e["ts"]) * 1e-6, float(e["ts"] + e.get("dur", 0)) * 1e-6)
           for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATEGORIES]
    spins = sorted(t0 for name, t0, _ in ops if "spin" in name.lower())
    ops = [o for o in ops if "spin" not in o[0].lower()]
    if not spins:
        raise RuntimeError(f"device trace {path}: no anchor kernel")
    # the profiler may drop one anchor; the start anchor precedes every
    # other operation of the window, the end anchor follows them
    if len(spins) >= 2 or not ops or spins[0] <= min(t0 for _, t0, _ in ops):
        offset = anchors[0] - spins[0]
    else:
        offset = anchors[-1] - spins[-1]
    ops = [(name, t0 + offset, t1 + offset) for name, t0, t1 in ops]
    start, end = anchors[0], anchors[-1]
    ops = [(n, max(t0, start), min(t1, end)) for n, t0, t1 in ops if t1 > start and t0 < end]
    merged: list[list[float]] = []
    for _, t0, t1 in sorted(ops, key=lambda o: o[1]):
        if merged and t0 <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t1)
        else:
            merged.append([t0, t1])
    by_name: dict[str, float] = defaultdict(float)
    for name, t0, t1 in ops:
        by_name[name] += t1 - t0
    return {"ops": ops, "busy": merged, "start": start, "end": end, "by_name": dict(by_name)}


def idle_gaps(device: dict, spans: Spans) -> dict[str, float]:
    """The window's idle device time, each stretch put down to the innermost
    benchmark span open on any thread then ("between jobs" where none is)."""
    import bisect

    start, end = device["start"], device["end"]
    busy = device["busy"]
    busy_starts = [b[0] for b in busy]
    cuts = {start, end}
    cuts.update(t for b in busy for t in b if start < t < end)
    cuts.update(t for _, t0, t1 in spans.spans for t in (t0, t1) if start < t < end)
    cuts = sorted(cuts)
    rank = {n: i for i, n in enumerate(SPAN_ORDER)}
    by_name: dict[str, float] = defaultdict(float)
    for a, b in zip(cuts, cuts[1:]):
        mid = 0.5 * (a + b)
        k = bisect.bisect_right(busy_starts, mid) - 1
        if k >= 0 and busy[k][0] <= mid < busy[k][1]:
            continue
        open_ = [n for n, t0, t1 in spans.spans if t0 <= mid < t1]
        by_name[min(open_, key=lambda n: rank.get(n, len(rank))) if open_ else "between jobs"] += b - a
    return dict(by_name)
