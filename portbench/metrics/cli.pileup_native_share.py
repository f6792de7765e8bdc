"""cli.pileup_native_share: the share of a job's component alignments that
`MatchDatabase.group_by_position` accumulated in its one native pass: the
program's counters `pileup.native` over `pileup.alignments`, summed over the
window's jobs (`program_trace.py`)."""

from portbench import program_trace


def read(ctx):
    alignments = program_trace.count(ctx, "pileup.alignments")
    if not alignments:
        return None
    return program_trace.count(ctx, "pileup.native") / alignments
