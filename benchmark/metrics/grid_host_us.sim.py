"""Host time in the span ``substep.grid`` (the grid stage: the splat
inputs, K4 twice and K5, or the unfused path) per traced substep, us."""

from benchmark import spans


def read(ctx):
    return spans.per_substep_us(ctx, "substep.grid")
