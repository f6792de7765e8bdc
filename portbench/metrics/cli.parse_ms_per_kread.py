"""cli.parse_ms_per_kread: query parsing on the CLI's main thread,
milliseconds per 1,000 reads: the program's span `cli.parse`, the loop's
own time between one batch's submit and the next (`program_trace.py`)."""

from portbench import program_trace


def read(ctx):
    return program_trace.ms_per_kread(ctx, ("cli.parse",))
