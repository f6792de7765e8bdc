"""cli.load_s: seconds of a job loading the reference and its index from
the cache, the mean over the window's jobs: the program's spans
`cli.reference` and `cli.index` (`program_trace.py`)."""

from portbench import program_trace


def read(ctx):
    return program_trace.mean_seconds_a_job(ctx, ("cli.reference", "cli.index"))
