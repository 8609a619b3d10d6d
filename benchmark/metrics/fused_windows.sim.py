"""Release windows applied by the fused launch per traced substep: the
counter ``windows.fused`` of ``core/stepping.py::_pre_p2g_velocity``,
which adds each launch's windows (``ops/windows.py``, one launch a
substep on the card; 0 where the plain loop ran).  A program without the
counter reads nothing."""

from benchmark import spans


def read(ctx):
    got = spans.sim(ctx)
    if got is None or "windows.fused" not in got[1]:
        return None
    return got[1]["windows.fused"] / ctx["substeps"]
