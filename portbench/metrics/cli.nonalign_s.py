"""cli.nonalign_s: seconds of a job outside its align phase (reference load,
index from the cache, duplication scan, writers), the mean over the
window's jobs: the benchmark's clock around `cli.main` minus the CLI's own
`Align phase: N queries in T s`."""


def read(ctx):
    parts = [j.wall - j.align_s for j in ctx.jobs if j.align_s is not None]
    return sum(parts) / len(parts) if parts else None
