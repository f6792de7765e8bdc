"""cli.outputs_s: seconds of a job after its align phase, the mean over the
window's jobs: the program's spans `cli.pileup` (the device pileup's merge,
`group_by_position`), `cli.write` (refs-count, VCF, mutations writers) and
`cli.report` (the statistics block, the closes) (`program_trace.py`)."""

from portbench import program_trace


def read(ctx):
    return program_trace.mean_seconds_a_job(ctx, ("cli.pileup", "cli.write", "cli.report"))
