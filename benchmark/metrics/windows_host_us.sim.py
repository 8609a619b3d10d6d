"""Host time in the span ``substep.windows`` (``core/stepping.py::
_pre_p2g_velocity``: the release windows, impulses and velocity
modifiers) per traced substep, us."""

from benchmark import spans


def read(ctx):
    return spans.per_substep_us(ctx, "substep.windows")
