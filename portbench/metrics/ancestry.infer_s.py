"""ancestry.infer_s: seconds of a job inferring the ancestor of the
reference's duplications (`--infer-ancestors`), the mean over the window's
jobs: the program's spans `ancestry.detect` (the three-copy duplication
detection), `ancestry.walk` (the outward walks over them) and
`ancestry.emit` (the overridden sequences built, the ancestor written)
(`program_trace.py`).  None where no job opened them: a program without
these spans, or a run without `--infer-ancestors`."""

from portbench import program_trace

SPANS = ("ancestry.detect", "ancestry.walk", "ancestry.emit")


def read(ctx):
    found = program_trace.records(ctx)
    if not any(s[0] in SPANS for r in found for s in program_trace.closed(r)):
        return None
    return sum(program_trace.seconds(r, SPANS) for r in found) / len(found)
