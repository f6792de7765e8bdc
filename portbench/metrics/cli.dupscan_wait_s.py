"""cli.dupscan_wait_s: seconds a job's main thread waits for the
duplication scan before its first batch, the mean over the window's jobs:
the program's span `cli.dup_wait` (`program_trace.py`)."""

from portbench import program_trace


def read(ctx):
    return program_trace.mean_seconds_a_job(ctx, ("cli.dup_wait",))
