"""K6 and K7: segment compositing of the rasterizer's (tile, chunk)
worklist and its VJP.

``segment_composite`` launches K6, the CUDA kernel of
``csrc/composite.cu``, on CUDA tensors and runs ``segment_composite_plain``
on CPU tensors.  Both replace
mpmavatar_tpu/render/pallas_composite.py::segment_composite (the forward
``_seg_pallas`` over ``_seg_math``): per work item, C depth-ordered
gaussians against the 256 pixels of a 16x16 tile, giving nc colour planes
and the transmittance of the segment, which the rasterizer merges per
tile.

Its backward is ``segment_composite_vjp``: K7, the CUDA kernel of
``csrc/composite_bwd.cu``, on CUDA tensors (it launches or raises, never
the plain version), and ``segment_composite_vjp_plain``, autograd over the
plain forward, on CPU tensors.  Both replace the custom VJP's backward
``_seg_bwd_pallas``; the tile origins get no gradient (JAX's returns
zeros).  K6 and K7 count their launches apart (``KERNEL``,
``KERNEL_BWD``).
"""

from __future__ import annotations

import torch

from . import _build

KERNEL = "composite"
KERNEL_BWD = "composite_bwd"
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


def segment_composite_vjp_plain(pgT, pix0, g, nc: int):
    """Plain PyTorch version of K7: the VJP of ``segment_composite_plain``
    with cotangent ``g`` (W, nc+1, 256), by autograd -> (W, 6+nc, C)."""
    with torch.enable_grad():
        x = pgT.detach().requires_grad_(True)
        out = segment_composite_plain(x, pix0, nc)
        (dpg,) = torch.autograd.grad(out, x, g)
    return dpg


def _launch_bwd(pgT, pix0, g, nc: int):
    pg = _build.check_cuda("pgT", pgT)
    pix = _build.check_cuda("pix0", pix0)
    gc = _build.check_cuda("g", g)
    W, _, C = pg.shape
    dpg = torch.empty_like(pg)
    if W:
        _build.launch(KERNEL_BWD, "launch_composite_bwd", pg.data_ptr(),
                      pix.data_ptr(), gc.data_ptr(), W, C, nc,
                      dpg.data_ptr(), _build.stream(pg.device))
    return dpg


def segment_composite_vjp(pgT, pix0, g, nc: int):
    """d(packed worklist) of ``segment_composite`` for the cotangent ``g``
    (W, nc+1, 256) of its segments.

    On CUDA tensors this launches K7 (or raises); it runs the plain
    version only for CPU tensors."""
    _check(pgT, pix0, nc)
    if g.shape != (pgT.shape[0], nc + 1, PIXELS):
        raise ValueError(f"segment_composite_vjp: g must be "
                         f"({pgT.shape[0]}, {nc + 1}, {PIXELS}), got "
                         f"{tuple(g.shape)}")
    if pgT.is_cuda:
        return _launch_bwd(pgT, pix0, g, nc)
    return segment_composite_vjp_plain(pgT, pix0, g, nc)


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
        return segment_composite_vjp(pgT, pix0, grad, ctx.nc), None, None


def segment_composite(pgT, pix0, nc: int):
    """(W, 6+nc, C) packed worklist + (W, 2) tile origins ->
    (W, nc+1, 256) segments.

    On CUDA tensors this launches K6 (or raises), and its backward K7; it
    runs the plain versions only for CPU tensors."""
    _check(pgT, pix0, nc)
    return _SegmentComposite.apply(pgT, pix0, nc)
