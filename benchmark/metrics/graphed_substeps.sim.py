"""The share of the traced substeps replayed from a captured CUDA graph:
the counter ``substep.graphed`` of ``sim/solver.py::MPMSolver.frame``
(one a replayed substep, none an eager one) per traced substep.  A
program without the counter reads nothing."""

from benchmark import spans


def read(ctx):
    got = spans.sim(ctx)
    if got is None or "substep.graphed" not in got[1]:
        return None
    return got[1]["substep.graphed"] / ctx["substeps"]
