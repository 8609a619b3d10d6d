"""Host time in the span ``appearance.forward`` (``train/appearance.py::
float_leaf_grads``: the frame's posing, shadow UNet, SH, the rasterizer,
the image losses and the regularisers) per traced step, ms."""

from benchmark import spans_appearance


def read(ctx):
    return spans_appearance.per_step_ms(ctx, "appearance.forward")
