"""The traced frames' least time (``roofline.py``) over the device's busy
time in them, in %: how near the kernels together come to the chip's
bound on the work the substeps need."""


def read(ctx):
    if ctx.get("busy_s", 0.0) <= 0:
        return None
    return 100.0 * ctx["least_s"] * ctx["units"] / ctx["busy_s"]
