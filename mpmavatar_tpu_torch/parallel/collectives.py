"""Differentiable collectives over a ``torch.distributed`` process group:
the counterparts of ``jax.lax.psum``, ``psum_scatter(tiled=True)``,
``all_gather(tiled=True)``, ``pmean``, ``pmax`` and ``axis_index`` as
mpmavatar_tpu/parallel/sharded.py and appearance_dp.py use them.

Each differentiable collective is a ``torch.autograd.Function`` whose
backward is the JAX transpose of its forward:

    all_reduce (sum)      <->  all_reduce (sum)
    reduce_scatter (sum)   ->  all_gather
    all_gather             ->  reduce_scatter (sum)

Under these rules a rank's gradient of a value that every rank holds (a
replicated value) is its share: the true gradient is the sum of the
ranks' gradients.  A caller that differentiates a replicated loss seeds
each rank's copy with 1 / world, so that the seeds sum to one, and sums
the parameters' gradients over the ranks (``all_reduce``).  Every rank
must run the same collectives in the same order, forward and backward.

Each call takes its process group explicitly; the tensors stay on the
device they are on (NCCL on CUDA tensors, gloo on CPU tensors), with no
staging through the host.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def rank(group) -> int:
    """This process's index in ``group`` (``jax.lax.axis_index``)."""
    return dist.get_rank(group)


def world_size(group) -> int:
    """The number of ranks in ``group`` (``jax.lax.axis_size``)."""
    return dist.get_world_size(group)


def _all_reduce(x, group, op=dist.ReduceOp.SUM):
    out = x.contiguous().clone()
    dist.all_reduce(out, op=op, group=group)
    return out


def _reduce_scatter(x, group):
    n = world_size(group)
    if x.shape[0] % n:
        raise ValueError(f"reduce_scatter: {x.shape[0]} rows over {n} ranks")
    out = x.new_empty((x.shape[0] // n, *x.shape[1:]))
    dist.reduce_scatter_tensor(out, x.contiguous(), op=dist.ReduceOp.SUM,
                               group=group)
    return out


def _all_gather(x, group):
    n = world_size(group)
    out = x.new_empty((x.shape[0] * n, *x.shape[1:]))
    dist.all_gather_into_tensor(out, x.contiguous(), group=group)
    return out


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _reduce_scatter(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.group), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_gather(x, group)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.group), None


def all_reduce(x, group):
    """The sum of ``x`` over the ranks, on every rank (``psum``)."""
    return _AllReduce.apply(x, group)


def reduce_scatter(x, group):
    """Sum ``x`` (N * k, ...) over the ranks and keep this rank's block of
    k rows along axis 0 (``psum_scatter(scatter_dimension=0,
    tiled=True)``)."""
    return _ReduceScatter.apply(x, group)


def all_gather(x, group):
    """The ranks' blocks ``x`` (k, ...) concatenated along axis 0 in rank
    order, on every rank (``all_gather(tiled=True)``)."""
    return _AllGather.apply(x, group)


def all_mean(x, group):
    """The mean of ``x`` over the ranks (``pmean``)."""
    return all_reduce(x, group) / world_size(group)


def all_max(x, group):
    """The elementwise maximum of ``x`` over the ranks (``pmax``); not
    differentiable."""
    return _all_reduce(x.detach(), group, op=dist.ReduceOp.MAX)
