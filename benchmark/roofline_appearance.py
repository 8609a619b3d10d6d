"""The least time the chip needs for a stage-2 appearance step, counted
from the cell's shapes and the first state, never from the program.

Peaks as ``roofline.py``: 3.35 TB/s of HBM and 67 TFLOP/s of FP32
outside the tensor cores (H100 SXM at 700 W).  The step's least time is
the larger of all bytes over the bandwidth and all operations over the
peak, summed over:

- K6 and K7 as ``chip_smoke.py`` counts them, over the live items: the
  16 x 16 tiles' (gaussian, tile) instances of the alive splats (a tile's
  first ``tile_capacity``), in items of ``chunk``; ~20 FP32 per live
  (gaussian, pixel) forward, and ~50 more per pair that passes both
  cut-offs backward;
- the binding gathers over the alive splats only (a compacted gather
  does the same work), forward and the scatter-add backward;
- SH degree 3 over the alive splats, forward and backward;
- the shadow UNet's and LPIPS-VGG16's 3x3 convolutions: the forward on
  both images (the UNet on one AO map), the data gradient of the
  rendering's branch and the UNet's weight gradient;
- SSIM's separable 11-tap filter: five moments forward, three backward;
- Adam: 7 x 4 bytes per held element (p, g, m, v read; p, m, v written).

The projection, the sort, the worklists and the image's glue are work a
fused rasterizer would not need and are not counted.
"""

from __future__ import annotations

import torch

from .reference import splatting
from .reference.appearance import FROZEN, VGG, Appearance
from .reference.arith import Arith
from .roofline import F32, Work

TILE = 16


def conv_work(h: int, w: int, c_in: int, c_out: int, passes: float) -> Work:
    """A 3x3 SAME convolution at h x w, ``passes`` times (a forward, a
    data gradient or a weight gradient is one): its multiply-adds, and
    its input and output read or written once a pass."""
    macs = h * w * c_in * c_out * 9
    return Work(passes * F32 * (h * w * (c_in + c_out) + 9 * c_in * c_out),
                passes * 2.0 * macs)


def lpips_work(h: int, w: int) -> Work:
    """Both images forward, the rendering's data gradient: 3 passes."""
    out, c_in = Work(), 3
    for item in VGG:
        if item == "M":
            h, w = h // 2, w // 2
            continue
        out += conv_work(h, w, c_in, item, 3.0)
        c_in = item
    return out


def unet_work(size: int, dims: int) -> Work:
    """The shadow UNet on one map: forward, data and weight gradients."""
    out = Work()
    sizes = [size // 2 ** i for i in range(4)]
    for i in range(4):
        out += conv_work(sizes[i], sizes[i], 1 if i == 0 else dims, dims, 3)
        out += conv_work(sizes[-i - 1], sizes[-i - 1],
                         dims if i == 0 else 2 * dims, dims, 3)
    return out + conv_work(size, size, dims, 1, 3)


def raster_counts(ref: Appearance, leaves: dict, camera: int, frame: int,
                  tile_capacity: int, chunk: int) -> dict:
    """The live instances, live items and passing pairs of one view of
    the state ``leaves``, under the port's binning (each alive splat in
    every tile of its 3-sigma rect, a tile's first ``tile_capacity``)."""
    with torch.no_grad():
        _, xyz, cov = ref.world(leaves, frame)
        m2d, depth, conic, radius, _ = splatting.project(
            xyz, cov, ref.cams[camera], ref.width, ref.height, ref.ar)
        dev = xyz.device
        lo, hi = splatting.footprint(m2d, radius, ref.width, ref.height)
        lo = lo // TILE
        hi = torch.where(radius[:, None] > 0, (hi + TILE - 1) // TILE, lo)
        w_t = hi[:, 0] - lo[:, 0]
        count = w_t * (hi[:, 1] - lo[:, 1])
        gid = torch.repeat_interleave(torch.arange(len(xyz), device=dev),
                                      count)
        j = torch.arange(len(gid), device=dev) \
            - (torch.cumsum(count, 0) - count)[gid]
        tx = (ref.width + TILE - 1) // TILE
        tid = (lo[gid, 1] + j // w_t[gid]) * tx + lo[gid, 0] + j % w_t[gid]
        per = torch.zeros(tx * ((ref.height + TILE - 1) // TILE),
                          dtype=torch.int64, device=dev)
        per = torch.clamp_max(per.index_add_(0, tid, torch.ones_like(tid)),
                              tile_capacity)
        _, _, alpha = splatting.alphas(
            m2d, conic, torch.sigmoid(leaves["splats.opacity"][ref.alive, 0]),
            radius, depth, ref.width, ref.height)
    return {"live": int(per.sum()),
            "items": int(((per + chunk - 1) // chunk).sum()),
            "passing": int((alpha > 0).sum())}


def composite_work(live: int, items: int, passing: int, chunk: int,
                   alive: int, nc: int = 3) -> Work:
    """K6 and K7 over the live items (``chip_smoke.py``'s terms)."""
    k6 = Work(8.0 * items * chunk + F32 * (live * (6 + nc) + 2 * items
                                           + items * (nc + 1) * 256),
              20.0 * live * 256)
    k7 = Work(8.0 * items * chunk + F32 * (3 * live * (6 + nc) + 2 * items
                                           + items * (nc + 1) * 256
                                           + (alive + 1) * (6 + nc)),
              20.0 * live * 256 + 50.0 * passing)
    return k6 + k7


def step_work(cfg: dict, counts: dict, alive: int, held: int) -> Work:
    """One step's work from the view's raster counts, the alive splats and
    the elements Adam holds."""
    im, sh = cfg["image"], cfg["shadow"]
    h, w = im["height"], im["width"]
    chunk = cfg["raster"]["chunk"]
    out = composite_work(counts["live"], counts["items"], counts["passing"],
                         chunk, alive)
    # the binding gathers: rows of 9 + 1 + 3 + 1 + 4 + 1 floats read and
    # written forward, the gradient rows read and added backward
    out += Work(alive * (F32 * 19 * 2 + 8 * 6) * 2, alive * 19.0)
    # SH 3: 48 coefficients and a direction in, a colour out; backward
    # twice that
    out += Work(3 * alive * F32 * (48 + 3 + 3), 3 * alive * 150.0)
    if cfg["loss_weights"]["lpips"]:
        out += lpips_work(h, w)
    out += unet_work(sh["shadow_size"], sh["n_dims"])
    out += Work(8 * 3 * h * w * F32 * 2, 8 * 3 * h * w * 22 * 2.0)
    out += Work(7 * F32 * held, 10.0 * held)
    return out


def step_seconds(cfg: dict, raw: dict, leaves: dict, alive, binding,
                 views: int, device) -> float:
    """The least time of a step over the first ``views`` cameras at the
    state ``leaves`` and frame 0, averaged."""
    ref = Appearance(cfg, raw, alive, binding, device, Arith(False))
    rc = cfg["raster"]
    held = sum(v.numel() for k, v in leaves.items() if k not in FROZEN)
    total = 0.0
    for cam in range(views):
        counts = raster_counts(ref, leaves, cam, 0, rc["tile_capacity"],
                               rc["chunk"])
        total += step_work(cfg, counts, len(ref.alive), held).seconds()
    return total / views
