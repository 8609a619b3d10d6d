"""Host time in the span ``train.backward`` (``torch.autograd.grad`` of
the loss: the checkpoints' recompute and the twins' backward) per traced
step, ms."""

from benchmark import spans


def read(ctx):
    return spans.per_step_ms(ctx, "train.backward")
