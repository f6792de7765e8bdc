"""ancestry.index_s: seconds of a job building the two indexes that
`--infer-ancestors` needs, the mean over the window's jobs: the program's
spans `ancestry.source_index` (the reference's index, built or loaded from
the cache) and `ancestry.index` (the inferred ancestor's index, built anew
each run) (`program_trace.py`).  None where no job opened them."""

from portbench import program_trace

SPANS = ("ancestry.source_index", "ancestry.index")


def read(ctx):
    found = program_trace.records(ctx)
    if not any(s[0] in SPANS for r in found for s in program_trace.closed(r)):
        return None
    return sum(program_trace.seconds(r, SPANS) for r in found) / len(found)
