"""The share of the traced units' wall time in which nothing ran on the
device, in %.  Under the profiler: its per-launch cost lengthens the
host's gaps, so this reads above the untraced run's idle share and
compares only with other traced readings."""


def read(ctx):
    if "busy_s" not in ctx:
        return None
    return 100.0 * (1.0 - ctx["busy_s"] / ctx["window_s"])
