"""Host time in the span ``appearance.backward`` (``torch.autograd.grad``
of the stage-2 loss: K7, the binding gathers' backward, LPIPS's and the
UNet's data gradients) per traced step, ms."""

from benchmark import spans_appearance


def read(ctx):
    return spans_appearance.per_step_ms(ctx, "appearance.backward")
