"""Host time in the span ``substep.stress`` (``core/stepping.py::
compute_stress``: K1, K8 and their scatter glue) per traced substep,
us."""

from benchmark import spans


def read(ctx):
    return spans.per_substep_us(ctx, "substep.stress")
