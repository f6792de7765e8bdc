"""engine.fallback_share: the share of queries the exact sequential worker
aligns: the program's counter `reads.fallback` over `reads.single` plus
`reads.paired` (a pair is one query) (`program_trace.py`)."""

from portbench import program_trace


def read(ctx):
    queries = (program_trace.count(ctx, "reads.single") or 0) + (program_trace.count(ctx, "reads.paired") or 0)
    if not queries:
        return None
    return program_trace.count(ctx, "reads.fallback") / queries
