"""candidates.ms_per_kread: host candidate generation, milliseconds per
1,000 reads: the benchmark's spans around `generate_candidates` as the
engine calls it, summed over both pool threads."""


def read(ctx):
    if ctx.spans is None or not any(n == "generate_candidates" for n, _, _ in ctx.spans.spans):
        return None
    kreads = ctx.reads_per_job * len(ctx.jobs) / 1000
    return ctx.spans.total("generate_candidates") * 1e3 / kreads
