"""K6 and K7: segment compositing of the rasterizer's (tile, chunk)
worklist and its VJP.

``segment_composite_gather(packed, ids, pix0, nc)`` is the rasterizer's
entry: per work item (a row of the (W, C) ``ids``), C depth-ordered rows
of the (N+1, 6+nc) parameter table ``packed`` against the 256 pixels of a
16x16 tile, giving nc colour planes and the transmittance of the segment,
which the rasterizer merges per tile.  Id N, the table's last row, is the
sentinel of an empty slot.  On CUDA tensors it launches K6, the CUDA
kernel of ``csrc/composite.cu``, which gathers the item's live rows itself
and skips the sentinels, and its autograd backward launches K7
(``csrc/composite_bwd.cu``), which adds d``packed`` with atomics; both
launch or raise, never the plain version.  On CPU tensors they run the
plain versions, ``segment_composite_gather_plain`` and autograd over it
(``segment_composite_gather_vjp_plain``).  Row N of d``packed`` is exactly
0; ``ids`` and the tile origins get no gradient (JAX's are zeros).

Together they replace mpmavatar_tpu/render/pallas_composite.py::
segment_composite (the forward ``_seg_pallas`` over ``_seg_math`` and the
custom VJP's backward ``_seg_bwd_pallas``) and the ``packed[ids]`` gather
in front of it (mpmavatar_tpu/render/rasterizer.py), which the TPU needed
as one XLA gather into a VMEM block.

``segment_composite(pgT, pix0, nc)`` and ``segment_composite_vjp`` keep
the TPU kernel's per-slot contract ((W, 6+nc, C) instances already
gathered) over the same two kernels: the table is the W C slots, ids count
them and the sentinel is W C, so no slot is skipped.  K6 and K7 count
their launches apart (``KERNEL``, ``KERNEL_BWD``).

K7 adds each (live slot, parameter row) sum into d``packed`` with one
atomic, so a row summed over several items (a gaussian in several tiles)
is rounded in an order that changes from run to run; under the per-slot
contract each entry gets at most one add onto zero and is deterministic.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

KERNEL = "composite"
KERNEL_BWD = "composite_bwd"
TILE = 16
ALPHA_MIN = 1.0 / 255.0
PIXELS = TILE * TILE
MAX_NC = 8          # colour channels the kernel keeps in registers
MAX_CHUNK = 512     # (6 + nc) x C floats of shared memory per block


def _check_nc(name: str, nc: int):
    if not 1 <= nc <= MAX_NC:
        raise ValueError(f"{name}: nc must be in [1, {MAX_NC}], got {nc}")


def _check_items(name: str, w: int, c: int, pix0):
    if not 1 <= c <= MAX_CHUNK:
        raise ValueError(f"{name}: the chunk C must be in [1, {MAX_CHUNK}], "
                         f"got {c}")
    if pix0.shape != (w, 2):
        raise ValueError(f"{name}: pix0 must be ({w}, 2), got "
                         f"{tuple(pix0.shape)}")


def _check(pgT, pix0, nc: int):
    _check_nc("segment_composite", nc)
    if pgT.dim() != 3 or pgT.shape[1] != 6 + nc:
        raise ValueError(f"segment_composite: pgT must be (W, {6 + nc}, C), "
                         f"got {tuple(pgT.shape)}")
    _check_items("segment_composite", pgT.shape[0], pgT.shape[2], pix0)


def _check_gather(packed, ids, pix0, nc: int):
    name = "segment_composite_gather"
    _check_nc(name, nc)
    if packed.dim() != 2 or packed.shape[1] != 6 + nc or not len(packed):
        raise ValueError(f"{name}: packed must be (N+1, {6 + nc}), got "
                         f"{tuple(packed.shape)}")
    if ids.dim() != 2 or ids.dtype != torch.int64:
        raise ValueError(f"{name}: ids must be (W, C) int64, got "
                         f"{tuple(ids.shape)} {ids.dtype}")
    _check_items(name, ids.shape[0], ids.shape[1], pix0)


def _check_g(g, w: int, nc: int):
    if g.shape != (w, nc + 1, PIXELS):
        raise ValueError(f"segment_composite_vjp: g must be "
                         f"({w}, {nc + 1}, {PIXELS}), got {tuple(g.shape)}")


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
    """Plain PyTorch version of the per-slot contract: (W, 6+nc, C) packed
    instances + (W, 2) tile origins -> (W, nc+1, 256) [colours,
    transmittance]."""
    power, alpha = segment_power_alpha(pgT, pix0, nc)
    alpha = torch.where((power > 0.0) | (alpha < ALPHA_MIN), 0.0, alpha)
    prod = torch.cumprod(1.0 - alpha, dim=1)              # inclusive
    excl = torch.cat([torch.ones_like(prod[:, :1]), prod[:, :-1]], 1)
    seg_c = torch.bmm(pgT[:, 5:5 + nc, :], alpha * excl)  # (W, nc, P)
    return torch.cat([seg_c, prod[:, -1:]], 1)


def segment_composite_gather_plain(packed, ids, pix0, nc: int):
    """Plain PyTorch version of K6: the table's rows ``packed[ids]`` as
    (W, 6+nc, C) instances through ``segment_composite_plain``."""
    return segment_composite_plain(packed[ids].transpose(1, 2).contiguous(),
                                   pix0, nc)


def segment_composite_gather_vjp_plain(packed, ids, pix0, g, nc: int):
    """Plain PyTorch version of K7: the VJP of
    ``segment_composite_gather_plain`` with cotangent ``g`` (W, nc+1, 256)
    with respect to the table, by autograd -> (N+1, 6+nc)."""
    with torch.enable_grad():
        x = packed.detach().requires_grad_(True)
        out = segment_composite_gather_plain(x, ids, pix0, nc)
        (dpacked,) = torch.autograd.grad(out, x, g)
    return dpacked


def segment_composite_vjp_plain(pgT, pix0, g, nc: int):
    """The per-slot VJP, autograd over ``segment_composite_plain``
    -> (W, 6+nc, C)."""
    with torch.enable_grad():
        x = pgT.detach().requires_grad_(True)
        out = segment_composite_plain(x, pix0, nc)
        (dpg,) = torch.autograd.grad(out, x, g)
    return dpg


def _launch(packed, ids, pix0, nc: int, sentinel: int):
    pk = _build.check_cuda("packed", packed)
    idc = _build.check_cuda("ids", ids, torch.int64)
    pix = _build.check_cuda("pix0", pix0)
    W, C = idc.shape
    out = torch.empty((W, nc + 1, PIXELS), dtype=pk.dtype, device=pk.device)
    if W:
        _build.launch(KERNEL, "launch_composite", pk.data_ptr(),
                      idc.data_ptr(), pix.data_ptr(), W, C, nc, sentinel,
                      out.data_ptr(), _build.stream(pk.device))
    return out


def _launch_bwd(packed, ids, pix0, g, nc: int, sentinel: int):
    pk = _build.check_cuda("packed", packed)
    idc = _build.check_cuda("ids", ids, torch.int64)
    pix = _build.check_cuda("pix0", pix0)
    gc = _build.check_cuda("g", g)
    W, C = idc.shape
    dpacked = torch.zeros_like(pk)
    if W:
        _build.launch(KERNEL_BWD, "launch_composite_bwd", pk.data_ptr(),
                      idc.data_ptr(), pix.data_ptr(), gc.data_ptr(), W, C,
                      nc, sentinel, dpacked.data_ptr(),
                      _build.stream(pk.device))
    return dpacked


def _vjp(packed, ids, pix0, g, nc: int, sentinel: int):
    _check_g(g, ids.shape[0], nc)
    if packed.is_cuda:
        return _launch_bwd(packed, ids, pix0, g, nc, sentinel)
    return segment_composite_gather_vjp_plain(packed, ids, pix0, g, nc)


class _SegmentComposite(torch.autograd.Function):

    @staticmethod
    def forward(ctx, packed, ids, pix0, nc, sentinel):
        ctx.save_for_backward(packed, ids, pix0)
        ctx.nc, ctx.sentinel = nc, sentinel
        if packed.is_cuda:
            return _launch(packed, ids, pix0, nc, sentinel)
        return segment_composite_gather_plain(packed, ids, pix0, nc)

    @staticmethod
    def backward(ctx, grad):
        packed, ids, pix0 = ctx.saved_tensors
        return (_vjp(packed, ids, pix0, grad, ctx.nc, ctx.sentinel), None,
                None, None, None)


def segment_composite_gather(packed, ids, pix0, nc: int):
    """(N+1, 6+nc) table + (W, C) int64 ids in [0, N] (N: an empty slot)
    + (W, 2) tile origins -> (W, nc+1, 256) segments.

    On CUDA tensors this launches K6 (or raises), and its backward K7,
    which returns d``packed``; it runs the plain versions only for CPU
    tensors."""
    _check_gather(packed, ids, pix0, nc)
    return _SegmentComposite.apply(packed, ids, pix0, nc, len(packed) - 1)


def segment_composite_gather_vjp(packed, ids, pix0, g, nc: int):
    """d``packed`` (N+1, 6+nc) of ``segment_composite_gather`` for the
    cotangent ``g`` (W, nc+1, 256) of its segments.

    On CUDA tensors this launches K7 (or raises); it runs the plain
    version only for CPU tensors."""
    _check_gather(packed, ids, pix0, nc)
    return _vjp(packed, ids, pix0, g, nc, len(packed) - 1)


def _per_slot(pgT):
    """The per-slot contract as a gathered one: the W C slots as the
    table, ids counting them and the sentinel W C (no slot skipped)."""
    W, rows, C = pgT.shape
    table = pgT.transpose(1, 2).reshape(W * C, rows)
    ids = torch.arange(W * C, device=pgT.device).view(W, C)
    return table, ids, W * C


def segment_composite(pgT, pix0, nc: int):
    """(W, 6+nc, C) packed instances + (W, 2) tile origins ->
    (W, nc+1, 256) segments, through K6 (backward K7) on CUDA tensors and
    the plain versions on CPU tensors."""
    _check(pgT, pix0, nc)
    table, ids, sentinel = _per_slot(pgT)
    return _SegmentComposite.apply(table, ids, pix0, nc, sentinel)


def segment_composite_vjp(pgT, pix0, g, nc: int):
    """d(packed instances) (W, 6+nc, C) of ``segment_composite`` for the
    cotangent ``g`` (W, nc+1, 256): K7 on CUDA tensors (or raise), the
    plain version on CPU tensors."""
    _check(pgT, pix0, nc)
    W, rows, C = pgT.shape
    table, ids, sentinel = _per_slot(pgT)
    d = _vjp(table, ids, pix0, g, nc, sentinel)
    return d.view(W, C, rows).transpose(1, 2).contiguous()


def kernel_info(chunk: int, nc: int) -> dict:
    """K6's and K7's registers per thread, spilled bytes per thread and
    resident blocks per SM at this chunk and nc, as built (CUDA only)."""
    lib = _build.library()
    info = {}
    for kernel, symbol in ((KERNEL, "composite_info"),
                           (KERNEL_BWD, "composite_bwd_info")):
        out = (ctypes.c_int * 3)()
        err = getattr(lib, symbol)(chunk, nc, out)
        if err != 0:
            raise RuntimeError(f"{symbol}: "
                               f"{lib.mpm_error_string(err).decode()}")
        info[kernel] = {"registers": out[0], "spill_bytes": out[1],
                        "blocks_per_sm": out[2]}
    return info
