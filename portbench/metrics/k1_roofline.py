"""k1_roofline: K1's (`banded_i16`) share of its roofline in the window, in
percent: the least time its calls need (`portbench/roofline.py`: the cells
min(n, LQ) x band read from the wrapper's arguments, 10 int16 operations a
cell at 33.5 T/s, or the call's bytes at 3.35 TB/s where longer) over K1's
device time in the profiler's trace.  Nothing to read without a K1 launch or
without its kernels in the trace."""

from portbench import roofline


def read(ctx):
    if ctx.spans is None or ctx.device is None or not ctx.spans.k1_calls:
        return None
    device_s = sum(s for name, s in ctx.device["by_name"].items() if roofline.is_k1(name))
    if device_s <= 0:
        return None
    return 100.0 * ctx.spans.k1_least_seconds() / device_s
