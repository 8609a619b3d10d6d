"""The whole frame's or step's share of the chip's peak: the least time
(``roofline.py``) of the window's units that ran after the traced ones,
without the profiler, over their wall time, in %."""


def read(ctx):
    if not ctx.get("plain_units"):
        return None
    return 100.0 * ctx["least_s"] * ctx["plain_units"] / ctx["plain_s"]
