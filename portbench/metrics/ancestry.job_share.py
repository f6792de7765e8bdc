"""ancestry.job_share: the share of a job spent on the ancestry set-up that
the program repeats on every run, the mean over the window's jobs: the
seconds of its `ancestry.*` spans (both indexes, the detection, the walk,
the ancestor written) and of `cli.dup_wait` (the main thread's wait for the
duplication scan over the ancestor's index), over the seconds of its
`cli.main` span (`program_trace.py`).  None where no job opened an
`ancestry.*` span."""

from portbench import program_trace

ANCESTRY = {"ancestry.source_index", "ancestry.detect", "ancestry.walk", "ancestry.emit", "ancestry.index"}


def read(ctx):
    shares = []
    for record in program_trace.records(ctx):
        names = {s[0] for s in program_trace.closed(record)}
        if "cli.main" in names and names & ANCESTRY:
            repeated = program_trace.seconds(record, ANCESTRY | {"cli.dup_wait"})
            shares.append(repeated / program_trace.seconds(record, ("cli.main",)))
    return sum(shares) / len(shares) if shares else None
