"""Host time in the span ``substep.p2g`` (``core/stepping.py::p2g``: the
RPIC mix, the stress scaling, K2) per traced substep, us."""

from benchmark import spans


def read(ctx):
    return spans.per_substep_us(ctx, "substep.p2g")
