"""Host time in the span ``substep.g2p`` (``core/stepping.py::g2p``: K3
and the advection glue) per traced substep, us."""

from benchmark import spans


def read(ctx):
    return spans.per_substep_us(ctx, "substep.g2p")
