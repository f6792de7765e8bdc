"""Spans and counters inside the port, for one CLI run.

With `MAPPER_TPU_TRACE=1`, read once when `cli.main` starts, the CLI makes
a `Recorder` and hands it to the engine; otherwise both hold `OFF`, whose
`span` returns the shared no-op `NOOP` and whose `count` returns at once.

A span records its name, its thread's name, its start and end on
`time.perf_counter()`, the CPU seconds its thread spent inside it
(`time.thread_time()`, so a span that waits reads low), the index of the
span that encloses it on the same thread, and the batch id it serves (given,
or inherited from that enclosing span).  Spans stay in memory under one
lock; `export` writes them and the counters as one line,

    [trace] {"clock":"perf_counter","spans":[[name,thread,t0,t1,cpu,parent,batch],...],"counts":{...}}

where `parent` and `batch` are null where there is none, and `t1` and `cpu`
are null for a span still open when the line was written (a run that
raised while another thread worked).  Spans mark stage boundaries at chunk
level or coarser, never a single read.
"""

from __future__ import annotations

import json
import os
import threading
import time

CLOCK = "perf_counter"


class _NoSpan:
    """The span of `OFF`: enters and leaves, records nothing."""

    __slots__ = ()
    seconds = 0.0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None


NOOP = _NoSpan()


class _Off:
    """The recorder when tracing is off."""

    on = False

    def span(self, name: str, batch: int | None = None) -> _NoSpan:
        return NOOP

    def count(self, name: str, value: float) -> None:
        return None

    def export(self, stream) -> None:
        return None


OFF = _Off()


class _Span:
    __slots__ = ("_recorder", "_name", "_batch", "_row", "_cpu0")

    def __init__(self, recorder: "Recorder", name: str, batch: int | None):
        self._recorder = recorder
        self._name = name
        self._batch = batch

    def __enter__(self):
        self._recorder._open(self)
        return self

    def __exit__(self, *exc):
        self._recorder._close(self)
        return None

    @property
    def seconds(self) -> float:
        """The span's duration, once it has closed."""
        return self._row[3] - self._row[2]


class Recorder:
    """The spans and counters of one run, shared by its threads."""

    on = True

    def __init__(self):
        self._lock = threading.Lock()
        self._spans: list[list] = []
        self._counts: dict[str, float] = {}
        self._local = threading.local()  # per thread: its open spans

    def span(self, name: str, batch: int | None = None) -> _Span:
        return _Span(self, name, batch)

    def count(self, name: str, value: float) -> None:
        with self._lock:
            self._counts[name] = self._counts.get(name, 0) + value

    def _open(self, span: _Span) -> None:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []  # (index, batch) of each open span
        parent, batch = stack[-1] if stack else (None, None)
        if span._batch is not None:
            batch = span._batch
        row = [span._name, threading.current_thread().name, None, None, None, parent, batch]
        with self._lock:
            self._spans.append(row)
            stack.append((len(self._spans) - 1, batch))
        span._row = row
        span._cpu0 = time.thread_time()
        row[2] = time.perf_counter()

    def _close(self, span: _Span) -> None:
        t1 = time.perf_counter()
        cpu = time.thread_time() - span._cpu0
        self._local.stack.pop()
        with self._lock:
            span._row[3] = t1
            span._row[4] = cpu

    def export(self, stream) -> None:
        """Writes the spans and counters as one `[trace] ` line to `stream`."""
        with self._lock:
            record = {"clock": CLOCK, "spans": self._spans, "counts": self._counts}
            line = "[trace] " + json.dumps(record, separators=(",", ":")) + "\n"
        stream.write(line)
        stream.flush()


def recorder():
    """A `Recorder` when `MAPPER_TPU_TRACE=1`, else `OFF`."""
    return Recorder() if os.environ.get("MAPPER_TPU_TRACE") == "1" else OFF
