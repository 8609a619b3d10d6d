"""K6: segment compositing of the rasterizer's (tile, chunk) worklist.

``segment_composite`` launches the CUDA kernel of ``csrc/composite.cu``
on CUDA tensors and runs ``segment_composite_plain`` on CPU tensors.  Both
replace mpmavatar_tpu/render/pallas_composite.py::segment_composite (the
forward ``_seg_pallas`` over ``_seg_math``): per work item, C
depth-ordered gaussians against the 256 pixels of a 16x16 tile, giving nc
colour planes and the transmittance of the segment, which the rasterizer
merges per tile.

Gradient: on CPU tensors, autograd over the plain version (re-traced in
the backward, as the JAX custom VJP's XLA path did).  On the card the
backward is K7, the hand-written VJP kernel of the stage-2 training slice,
which is not ported yet: it raises.
"""

from __future__ import annotations

import torch

from . import _build

KERNEL = "composite"
TILE = 16
ALPHA_MIN = 1.0 / 255.0
PIXELS = TILE * TILE
MAX_NC = 8          # colour channels the kernel keeps in registers
MAX_CHUNK = 512     # (6 + nc) x C floats of shared memory per block


def _check(pgT, pix0, nc: int):
    if not 1 <= nc <= MAX_NC:
        raise ValueError(f"segment_composite: nc must be in [1, {MAX_NC}], "
                         f"got {nc}")
    if pgT.dim() != 3 or pgT.shape[1] != 6 + nc \
            or not 1 <= pgT.shape[2] <= MAX_CHUNK:
        raise ValueError(f"segment_composite: pgT must be (W, {6 + nc}, C) "
                         f"with 1 <= C <= {MAX_CHUNK}, got "
                         f"{tuple(pgT.shape)}")
    if pix0.shape != (pgT.shape[0], 2):
        raise ValueError(f"segment_composite: pix0 must be "
                         f"({pgT.shape[0]}, 2), got {tuple(pix0.shape)}")


def segment_power_alpha(pgT, pix0, nc: int):
    """(power, alpha) of every (item, gaussian, pixel), each (W, C, 256),
    alpha = min(0.99, o exp(min(power, 0))) before the two cutoffs."""
    f32 = pgT.dtype
    ip = torch.arange(PIXELS, device=pgT.device)
    px = pix0[:, 0][:, None, None] + (ip % TILE).to(f32)        # (W, 1, P)
    py = pix0[:, 1][:, None, None] + (ip // TILE).to(f32)
    mx, my, ca, cb, cc = (pgT[:, i, :][:, :, None] for i in range(5))
    op = pgT[:, 5 + nc, :][:, :, None]                          # (W, C, 1)
    dx = px - mx                                                 # (W, C, P)
    dy = py - my
    power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
    alpha = torch.clamp_max(op * torch.exp(torch.clamp_max(power, 0.0)),
                            0.99)
    return power, alpha


def segment_composite_plain(pgT, pix0, nc: int):
    """Plain PyTorch version of the kernel: (W, 6+nc, C) packed instances
    + (W, 2) tile origins -> (W, nc+1, 256) [colours, transmittance]."""
    power, alpha = segment_power_alpha(pgT, pix0, nc)
    alpha = torch.where((power > 0.0) | (alpha < ALPHA_MIN), 0.0, alpha)
    prod = torch.cumprod(1.0 - alpha, dim=1)              # inclusive
    excl = torch.cat([torch.ones_like(prod[:, :1]), prod[:, :-1]], 1)
    seg_c = torch.bmm(pgT[:, 5:5 + nc, :], alpha * excl)  # (W, nc, P)
    return torch.cat([seg_c, prod[:, -1:]], 1)


def _launch(pgT, pix0, nc: int):
    pg = _build.check_cuda("pgT", pgT)
    pix = _build.check_cuda("pix0", pix0)
    W, _, C = pg.shape
    out = torch.empty((W, nc + 1, PIXELS), dtype=pg.dtype, device=pg.device)
    if W:
        _build.launch(KERNEL, "launch_composite", pg.data_ptr(),
                      pix.data_ptr(), W, C, nc, out.data_ptr(),
                      _build.stream(pg.device))
    return out


class _SegmentComposite(torch.autograd.Function):

    @staticmethod
    def forward(ctx, pgT, pix0, nc):
        ctx.save_for_backward(pgT, pix0)
        ctx.nc = nc
        if pgT.is_cuda:
            return _launch(pgT, pix0, nc)
        return segment_composite_plain(pgT, pix0, nc)

    @staticmethod
    def backward(ctx, grad):
        pgT, pix0 = ctx.saved_tensors
        if pgT.is_cuda:
            raise NotImplementedError(
                "segment_composite has no backward on the card yet: its "
                "VJP is K7 (render/pallas_composite.py::_seg_bwd_pallas), "
                "ported with the stage-2 training slice")
        with torch.enable_grad():
            x = pgT.detach().requires_grad_(True)
            out = segment_composite_plain(x, pix0, ctx.nc)
            (dpg,) = torch.autograd.grad(out, x, grad)
        return dpg, None, None


def segment_composite(pgT, pix0, nc: int):
    """(W, 6+nc, C) packed worklist + (W, 2) tile origins ->
    (W, nc+1, 256) segments.

    On CUDA tensors this launches the kernel (or raises); it runs the
    plain version only for CPU tensors."""
    _check(pgT, pix0, nc)
    return _SegmentComposite.apply(pgT, pix0, nc)
