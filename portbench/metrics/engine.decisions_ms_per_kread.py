"""engine.decisions_ms_per_kread: host decisions, gapped finalization and
emission, milliseconds per 1,000 reads: the program's own
`MAPPER_TPU_TRACE=1` marks labelled `decisions+emit` (stdout of each job),
summed.  The paired path prints no marks: nothing to read there."""

import re

MARK = re.compile(r"^\[engine\] decisions\+emit: ([0-9.]+)s$", re.M)


def read(ctx):
    seconds = [float(s) for j in ctx.jobs for s in MARK.findall(j.stdout)]
    if not seconds:
        return None
    return sum(seconds) * 1e3 / (ctx.reads_per_job * len(ctx.jobs) / 1000)
