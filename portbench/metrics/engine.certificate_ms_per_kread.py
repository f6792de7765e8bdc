"""engine.certificate_ms_per_kread: the host certificate (window geometry
and the float64 ungapped penalties of every candidate row, both paths),
milliseconds per 1,000 reads: the program's span `engine.certificate`,
summed over the pool threads (`program_trace.py`)."""

from portbench import program_trace


def read(ctx):
    return program_trace.ms_per_kread(ctx, ("engine.certificate",))
