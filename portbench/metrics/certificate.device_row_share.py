"""certificate.device_row_share: the share of candidate rows the host
certificate leaves to device scoring: rows the scorer wrappers
(`kernels.banded_i16`, `kernels.banded_f32`) received over the rows
`generate_candidates` returned, both counted by the benchmark's wrappers."""


def read(ctx):
    if ctx.spans is None or not ctx.spans.counts.get("candidate_rows"):
        return None
    return ctx.spans.counts.get("device_rows", 0.0) / ctx.spans.counts["candidate_rows"]
