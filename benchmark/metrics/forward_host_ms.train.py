"""Host time in the span ``train.forward`` (``MaterialTrainer.
rollout_loss``: the checkpointed rollout and its loss) per traced
step, ms."""

from benchmark import spans


def read(ctx):
    return spans.per_step_ms(ctx, "train.forward")
