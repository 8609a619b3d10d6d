"""Host time in the spans ``twin_backward.<kernel>`` (``ops/_autograd.py::
KernelWithTwinGrad.backward``, on the autograd thread) per traced step,
summed over the kernels, ms."""

from benchmark import spans


def read(ctx):
    return spans.per_step_ms(ctx, "twin_backward.")
