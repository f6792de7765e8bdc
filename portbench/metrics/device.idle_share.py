"""device.idle_share: the share of the traced window in which no kernel,
copy or fill ran on the card: 1 - (the union of their intervals in
torch.profiler's trace) / the window."""


def read(ctx):
    if ctx.device is None:
        return None
    window = ctx.device["end"] - ctx.device["start"]
    busy = sum(t1 - t0 for t0, t1 in ctx.device["busy"])
    return 1.0 - busy / window
