"""Release windows looked at but not live, per traced substep: the
counters ``windows.evaluated`` less ``windows.live`` of
``core/stepping.py::_pre_p2g_velocity``, counted on the host from each
window's interval as registered."""

from benchmark import spans


def read(ctx):
    got = spans.sim(ctx)
    if got is None or "windows.evaluated" not in got[1]:
        return None
    counters = got[1]
    dead = counters["windows.evaluated"] - counters.get("windows.live", 0)
    return dead / ctx["substeps"]
