"""device.idle_unattributed_share: the share of the device's idle time
inside the benchmark's `job` spans (torch.profiler's intervals, merged)
during which no program leaf span (a span without a child) is open on any
thread.  Both clocks are `time.perf_counter` in one process
(`program_trace.py`)."""

from portbench import program_trace


def read(ctx):
    if ctx.device is None or ctx.spans is None:
        return None
    found = program_trace.records(ctx)
    if not found:
        return None
    return program_trace.idle_unattributed_share(ctx.device, ctx.spans.spans, found)
