"""Gradients of the hand-written kernels K1, K2, K3, K4, K5 and K8.

The JAX entry points of K1, K2, K3, K5 and K8 are ``jax.custom_vjp``s whose forward is the
Pallas kernel and whose backward re-traces the kernel's jnp math with
``jax.vjp`` (mpmavatar_tpu/ops/pallas_stress.py::_stress_bwd and
::_sand_bwd, ops/pallas_transfer.py::_p2g_fused_bwd and ::_g2p_fused_bwd,
ops/pallas_grid_pipeline.py::make_grid_pipeline's ``bwd``).  None of
those backwards is a Pallas kernel; K4's mover splat is the plain
``stepping.rasterize_to_grid`` in JAX, which XLA differentiates.  ``call`` does the same here: the
forward launches the CUDA kernel, and the backward recomputes the
kernel's plain PyTorch version from the saved inputs and differentiates
it with autograd.  Traced (``utils/profiling.py``), each backward is a
span ``twin_backward.<name>``, the name each call site gives its kernel:
``cloth_stress`` (K1), ``sand_stress`` (K8), ``p2g`` (K2), ``g2p`` (K3),
``splat`` (K4), ``grid_pipeline`` (K5).

The wrappers in ``ops/`` take this route on CUDA tensors only when grad
mode is on and an input requires grad; otherwise they launch the kernel
directly, so forward-only paths add nothing to their launches.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from ..utils import profiling


class KernelWithTwinGrad(torch.autograd.Function):
    """``kernel(*args)`` forward, the VJP of ``twin(*args)`` backward, in
    the span ``twin_backward.<name>``.

    ``kernel`` and ``twin`` take the same arguments and return a tensor
    or a tuple of tensors of the same structure; each output must be a
    tensor of its own, not a view of another output.  The backward
    differentiates the twin with respect to each floating-point tensor
    argument that requires grad, recomputed from detached copies of the
    saved inputs, and returns None for every other argument (integers,
    flags, tensors that need no grad).  Integer outputs are marked
    non-differentiable.
    """

    @staticmethod
    def forward(ctx, name, kernel, twin, *args):
        # autograd runs a Function's forward with grad mode off
        is_tensor = [isinstance(a, torch.Tensor) for a in args]
        ctx.span = "twin_backward." + name
        ctx.twin, ctx.is_tensor = twin, is_tensor
        ctx.consts = [None if t else a for a, t in zip(args, is_tensor)]
        ctx.save_for_backward(*[a for a, t in zip(args, is_tensor) if t])
        ctx.set_materialize_grads(False)
        outs = kernel(*args)
        ctx.single = isinstance(outs, torch.Tensor)
        ctx.mark_non_differentiable(*[
            o for o in ((outs,) if ctx.single else outs)
            if not o.is_floating_point()])
        return outs

    @staticmethod
    @once_differentiable
    def backward(ctx, *grads):
        with profiling.span(ctx.span):
            saved = iter(ctx.saved_tensors)
            args, wrt = [], []
            for i, (is_t, const) in enumerate(zip(ctx.is_tensor,
                                                  ctx.consts)):
                if not is_t:
                    args.append(const)
                    continue
                a = next(saved).detach()
                if a.is_floating_point() and ctx.needs_input_grad[3 + i]:
                    a.requires_grad_(True)
                    wrt.append(i)
                args.append(a)
            result = [None] * len(args)
            with torch.enable_grad():
                outs = ctx.twin(*args)
            outs = (outs,) if ctx.single else tuple(outs)
            pairs = [(o, g) for o, g in zip(outs, grads)
                     if g is not None and o.requires_grad]
            if pairs and wrt:
                got = torch.autograd.grad([o for o, _ in pairs],
                                          [args[i] for i in wrt],
                                          [g for _, g in pairs],
                                          allow_unused=True)
                for i, g in zip(wrt, got):
                    result[i] = g
            return (None, None, None, *result)


def call(name, kernel, twin, *args):
    """``kernel(*args)``; through :class:`KernelWithTwinGrad` when an
    argument needs grad, so that the outputs carry a ``grad_fn``.
    ``name`` is the kernel's, for the backward's span."""
    if torch.is_grad_enabled() and any(
            isinstance(a, torch.Tensor) and a.requires_grad for a in args):
        return KernelWithTwinGrad.apply(name, kernel, twin, *args)
    return kernel(*args)
