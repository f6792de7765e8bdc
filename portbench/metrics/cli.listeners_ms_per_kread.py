"""cli.listeners_ms_per_kread: the listeners on the CLI's main thread (SAM
writer, pileup, summarizers, counters), milliseconds per 1,000 reads: the
program's span `cli.listeners` (`program_trace.py`)."""

from portbench import program_trace


def read(ctx):
    return program_trace.ms_per_kread(ctx, ("cli.listeners",))
