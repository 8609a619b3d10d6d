"""The frame's glue outside the substeps per traced substep, us: the
self time of the span ``frame`` (``sim/solver.py::MPMSolver.frame``: the
device conversions, each substep's collider mesh, checkpoint wrapping)
plus the span ``frame.inputs`` (``sim/pose_playback.py::
PosePlayback.inputs``, where the cell uses it)."""

from benchmark import spans


def read(ctx):
    glue = spans.per_substep_us(ctx, "frame", "self_ns")
    if glue is None:
        return None
    return glue + (spans.per_substep_us(ctx, "frame.inputs") or 0.0)
