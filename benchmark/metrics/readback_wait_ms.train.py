"""Host time in the span ``train.readback`` (the loss and the parameters
read back: the host's wait for the device) per traced step, ms."""

from benchmark import spans


def read(ctx):
    return spans.per_step_ms(ctx, "train.readback")
