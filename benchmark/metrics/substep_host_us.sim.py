"""Host time in the span ``substep`` (``core/stepping.py::p2g2p``, the
whole substep) per traced substep, us."""

from benchmark import spans


def read(ctx):
    return spans.per_substep_us(ctx, "substep")
