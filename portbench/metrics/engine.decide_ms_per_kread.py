"""engine.decide_ms_per_kread: host decisions, gapped finalization and
emission, milliseconds per 1,000 reads: the program's span
`engine.decide` (single end: from the scores in hand to the end of the
chunk's finish, the interval `engine.decisions_ms_per_kread` reads from
stdout; paired: the pair decisions, without the deferred exact pairs),
summed over the pool threads (`program_trace.py`)."""

from portbench import program_trace


def read(ctx):
    return program_trace.ms_per_kread(ctx, ("engine.decide",))
