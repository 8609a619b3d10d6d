"""Device time per training step of the kernels launched from autograd's
backward (``ops/_autograd.py::KernelWithTwinGrad``'s twins, the
checkpoints' recompute included), ms."""


def read(ctx):
    if "backward_s" not in ctx:
        return None
    return 1e3 * ctx["backward_s"] / ctx["units"]
