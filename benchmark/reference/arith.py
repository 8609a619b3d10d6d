"""The reference's products, in float32 or, for the control, in TF32.

Every sum of products of the reference (matrix products, the stencil's
contractions, the skinning blends) goes through :class:`Arith`.  The
control rounds both operands of each to TF32's 10-bit mantissa before it
multiplies and sums in float32, which is what a tensor core's TF32 mode
does; computed so, the same rounding happens on any device, whatever
cuBLAS would choose for a shape.
"""

from __future__ import annotations

import torch


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """Round float32 ``x`` to the nearest TF32 value (ties to even)."""
    bits = x.contiguous().view(torch.int32)
    bias = ((bits >> 13) & 1) + 0x0FFF
    return ((bits + bias) & ~0x1FFF).view(torch.float32)


class Arith:
    """``tf32=False``: plain float32 products (the reference).
    ``tf32=True``: operands rounded to TF32 first (the control)."""

    def __init__(self, tf32: bool = False):
        self.tf32 = tf32

    def r(self, x):
        """An operand of a product: ``x``, or in the control ``x``
        rounded to TF32 (the rounding is the precision's, not a
        parameter's: its gradient passes straight through)."""
        if self.tf32 and x.dtype == torch.float32:
            return x + (tf32_round(x.detach()) - x.detach())
        return x

    def einsum(self, eq: str, *ops):
        return torch.einsum(eq, *[self.r(o) for o in ops])
