"""Logging utilities (reference: QuickVariants Logger/TextWriter hierarchy +
mapper StatusLogger/StringWriter; usage patterns per AlignerWorker.java:36-40,
Mapper.java:1014-1019, StatusLogger.java:17-24).

The hot paths guard every format with `get_enabled()` exactly like the
reference so verbose logging costs nothing when off."""

from __future__ import annotations

import sys
import time


class TextWriter:
    def write(self, message: str) -> None:
        raise NotImplementedError

    def flush(self) -> None:
        pass


class StderrWriter(TextWriter):
    def write(self, message: str) -> None:
        print(message, file=sys.stderr)


class StdoutWriter(TextWriter):
    def write(self, message: str) -> None:
        print(message)


class StringWriter(TextWriter):
    def __init__(self):
        self.lines: list[str] = []

    def write(self, message: str) -> None:
        self.lines.append(message)

    def get_text(self) -> str:
        return "\n".join(self.lines)


class BufferedWriter(TextWriter):
    """Defers output under a header line, with a capacity cap
    (per-worker log replay; Mapper.java:1014-1016)."""

    def __init__(self, target: TextWriter, header: str, capacity: int = 100000):
        self.target = target
        self.header = header
        self.capacity = capacity
        self.buffered: list[str] = []
        self.size = 0
        self.truncated = False

    def write(self, message: str) -> None:
        if self.size + len(message) > self.capacity:
            self.truncated = True
            return
        self.buffered.append(message)
        self.size += len(message)

    def flush(self) -> None:
        if self.buffered:
            self.target.write(self.header)
            for line in self.buffered:
                self.target.write(line)
            if self.truncated:
                self.target.write("...(truncated)")
            self.buffered = []
            self.size = 0
            self.truncated = False


class Logger:
    """Scope-indented logger with a verbosity gate: a logger is enabled while
    its verbosity exceeds its scope depth, so `-v` (verbosity 1) shows
    top-level decisions and `--verbose-alignment` (verbosity INF) also shows
    the incremented-scope detail loggers (AlignerWorker.java:36-40)."""

    def __init__(self, writer: TextWriter, scope_depth: int = 0, verbosity: int = 1):
        self.writer = writer
        self.scope_depth = scope_depth
        self.verbosity = verbosity

    def get_enabled(self) -> bool:
        return self.verbosity > self.scope_depth

    def log(self, message: str) -> None:
        if self.get_enabled():
            self.writer.write(" " * self.scope_depth + message)

    def increment_scope(self) -> "Logger":
        return Logger(self.writer, self.scope_depth + 1, self.verbosity)

    def with_writer(self, writer: TextWriter) -> "Logger":
        return Logger(writer, self.scope_depth, self.verbosity)

    def flush(self) -> None:
        self.writer.flush()


NO_OP_LOGGER = Logger(StderrWriter(), verbosity=0)


class StatusLogger:
    """Rate-limited progress logging: at most one unimportant message per
    second (StatusLogger.java:17-24)."""

    def __init__(self, logger: Logger, start_time: float | None = None):
        self.logger = logger
        self.start_time = start_time if start_time is not None else time.time()
        self._last_emit = 0.0

    def get_logger(self) -> Logger:
        return self.logger

    def log(self, message: str, important: bool = False) -> None:
        now = time.time()
        if not important and now - self._last_emit < 1.0:
            return
        self._last_emit = now
        elapsed = now - self.start_time
        self.logger.log(f"[{elapsed:7.1f}s] {message}")
