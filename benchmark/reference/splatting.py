"""Plain 3D Gaussian splatting: the 3DGS camera, EWA projection and
front-to-back compositing in float32, for the stage-2 reference.

No tile lists and no capacity: each gaussian is evaluated at every pixel
of its footprint, and each pixel composites all of its (gaussian, pixel)
pairs in depth order.  The footprint is diff-gaussian-rasterization's
(``getRect``), which the port keeps: the pixels of the 16 x 16 blocks
that the gaussian's 3-sigma square (half-side ``r = ceil(3
sqrt(lambda_max))`` of the dilated 2D covariance) touches.  Outside the
square an opacity under 0.35 gives alpha < 1/255, which is cut; above
it the blocks' edges decide, so the reference takes them too.

Where the port's contract (the JAX package's rasterizer) and
diff-gaussian-rasterization differ, this takes the port's:

- no transmittance stop (diff-gaussian-rasterization stops a pixel once
  T would fall under 1e-4; what it leaves out adds under 1e-4 to a pixel,
  and taking it would put that difference into every reading);
- depth ties are broken by the gaussians' order (a stable sort), as the
  port's packed sort key does;
- the 2D mean is ((ndc + 1) W - 1) / 2, the 1e-7 in the perspective
  divide and the clamp of the view-space x/z, y/z at 1.3 tan(fov / 2)
  are CUDA 3DGS's, as the port's are.
"""

from __future__ import annotations

import math

import numpy as np
import torch

ALPHA_MIN = 1.0 / 255.0
BLOCK = 16


def camera(k, w2c, width: int, height: int, near: float, far: float,
           device) -> dict:
    """3DGS's camera from intrinsics and world-to-camera: the transposed
    (row-vector) world-view and full projection (principal point as
    given), the centre and tan(fov / 2), as float32 tensors."""
    k = np.asarray(k, np.float64)
    fx, fy, cx, cy = k[0, 0], k[1, 1], k[0, 2], k[1, 2]
    world_view = np.asarray(w2c, np.float64).T.astype(np.float32)
    proj = np.array([
        [2 * fx / width, 0.0, -(width - 2 * cx) / width, 0.0],
        [0.0, 2 * fy / height, -(height - 2 * cy) / height, 0.0],
        [0.0, 0.0, far / (far - near), -(far * near) / (far - near)],
        [0.0, 0.0, 1.0, 0.0]]).T
    full = (world_view.astype(np.float64) @ proj).astype(np.float32)
    center = np.linalg.inv(world_view.astype(np.float64))[3, :3]
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32),
                                    device=device)
    return {"world_view": f32(world_view), "full_proj": f32(full),
            "center": f32(center),
            "tanfovx": math.tan(math.atan(width / (2 * fx))),
            "tanfovy": math.tan(math.atan(height / (2 * fy)))}


def project(means3d, cov3d, cam: dict, width: int, height: int, ar):
    """(means2d (N, 2) px, depth, conic (N, 3), radius, in_frustum)."""
    n = means3d.shape[0]
    hom = torch.cat([means3d, means3d.new_ones((n, 1))], 1)
    p_view = ar.einsum("ni,ij->nj", hom, cam["world_view"])
    depth = p_view[:, 2]
    p_proj = ar.einsum("ni,ij->nj", hom, cam["full_proj"])
    p_w = 1.0 / (p_proj[:, 3] + 1e-7)
    ndc = p_proj[:, :3] * p_w[:, None]
    means2d = torch.stack([((ndc[:, 0] + 1.0) * width - 1.0) * 0.5,
                           ((ndc[:, 1] + 1.0) * height - 1.0) * 0.5], -1)
    fx = width / (2.0 * cam["tanfovx"])
    fy = height / (2.0 * cam["tanfovy"])
    tz = torch.clamp_min(depth, 1e-4)
    limx, limy = 1.3 * cam["tanfovx"], 1.3 * cam["tanfovy"]
    tx = torch.clamp(p_view[:, 0] / tz, -limx, limx) * tz
    ty = torch.clamp(p_view[:, 1] / tz, -limy, limy) * tz
    zero = torch.zeros_like(tz)
    jac = torch.stack([
        torch.stack([fx / tz, zero, -(fx * tx) / (tz * tz)], -1),
        torch.stack([zero, fy / tz, -(fy * ty) / (tz * tz)], -1)], 1)
    # the Jacobian of the projection times the view rotation
    t = ar.einsum("nab,cb->nac", jac, cam["world_view"][:3, :3])
    cov2d = ar.einsum("nab,nbc,ndc->nad", t, cov3d, t)
    c_xx = cov2d[:, 0, 0] + 0.3
    c_yy = cov2d[:, 1, 1] + 0.3
    c_xy = cov2d[:, 0, 1]
    det = c_xx * c_yy - c_xy * c_xy
    det_inv = 1.0 / torch.clamp_min(det, 1e-12)
    conic = torch.stack([c_yy * det_inv, -c_xy * det_inv, c_xx * det_inv],
                        -1)
    mid = 0.5 * (c_xx + c_yy)
    lam = mid + torch.sqrt(torch.clamp_min(mid * mid - det, 0.1))
    in_frustum = (depth > 0.2) & (det > 0)
    radius = torch.where(in_frustum, torch.ceil(3.0 * torch.sqrt(lam)), 0.0)
    return means2d, depth, conic, radius, in_frustum


def footprint(means2d, radius, width: int, height: int):
    """(first pixel (N, 2), last pixel + 1 (N, 2)) of each gaussian's
    footprint inside the image, integer tensors: the 16 x 16 blocks from
    trunc((m - r) / 16) to trunc((m + r + 15) / 16) (exclusive), clamped
    to the image's blocks (``getRect``)."""
    m, r = means2d.detach(), radius.detach()[:, None]
    dev = m.device
    blocks = torch.tensor([(width + BLOCK - 1) // BLOCK,
                           (height + BLOCK - 1) // BLOCK], device=dev)
    # .to(int32) truncates toward zero, negative values included
    block = lambda v: torch.minimum(torch.clamp_min(
        (v / BLOCK).to(torch.int32), 0), blocks).long()
    lo = block(m - r) * BLOCK
    hi = torch.minimum(block(m + r + BLOCK - 1) * BLOCK,
                       torch.tensor([width, height], device=dev))
    return lo, hi


def pairs(means2d, radius, width: int, height: int):
    """The (gaussian, pixel) pairs of the gaussians' footprints: (gaussian
    ids, pixel x, pixel y), integer tensors."""
    lo, hi = footprint(means2d, radius, width, height)
    size = torch.clamp_min(hi - lo, 0)
    size = torch.where((radius.detach() > 0)[:, None], size, 0)
    m = means2d
    count = size[:, 0] * size[:, 1]
    gid = torch.repeat_interleave(torch.arange(len(m), device=m.device),
                                  count)
    first = torch.cumsum(count, 0) - count
    j = torch.arange(len(gid), device=m.device) - first[gid]
    nx = size[gid, 0]
    px = lo[gid, 0] + j % nx
    py = lo[gid, 1] + j // nx
    return gid, px, py


def alphas(means2d, conic, opacity, radius, depth, width: int,
           height: int):
    """(gaussian ids, pixels, alphas) of every (gaussian, pixel) pair,
    sorted by pixel and then depth: alpha = min(0.99, o exp(power)) with
    power <= 0, cut to 0 under 1/255."""
    n = means2d.shape[0]
    gid, px, py = pairs(means2d, radius, width, height)
    rank = torch.empty(n, dtype=torch.int64, device=means2d.device)
    rank[torch.argsort(depth.detach(), stable=True)] = torch.arange(
        n, device=means2d.device)
    pix = py * width + px
    order = torch.argsort(pix * n + rank[gid])
    gid, px, py, pix = gid[order], px[order], py[order], pix[order]
    dx = px.to(means2d.dtype) - means2d[gid, 0]
    dy = py.to(means2d.dtype) - means2d[gid, 1]
    co = conic[gid]
    power = -0.5 * (co[:, 0] * dx * dx + co[:, 2] * dy * dy) \
        - co[:, 1] * dx * dy
    alpha = torch.clamp_max(opacity[gid] * torch.exp(
        torch.clamp_max(power, 0.0)), 0.99)
    alpha = torch.where((power > 0.0) | (alpha < ALPHA_MIN), 0.0, alpha)
    return gid, pix, alpha


def composite(means2d, conic, colors, opacity, radius, depth, width: int,
              height: int, ar):
    """(image (nc, H, W) on a black background, transmittance (H, W)):
    each pixel's pairs in depth order, C = sum alpha_i T_i c_i, T_i the
    product of (1 - alpha) in front."""
    dev = means2d.device
    nc = colors.shape[1]
    gid, pix, alpha = alphas(means2d, conic, opacity, radius, depth, width,
                             height)

    # each pixel's run of pairs; runs of one length bucket (up to a power
    # of two) become the rows of one padded matrix
    new = torch.ones_like(pix, dtype=torch.bool)
    new[1:] = pix[1:] != pix[:-1]
    starts = torch.nonzero(new)[:, 0]
    lengths = torch.diff(torch.cat([starts, starts.new_tensor([len(pix)])]))
    bucket = torch.ceil(torch.log2(lengths.double())).long()
    image = means2d.new_zeros((height * width, nc))
    trans = means2d.new_ones((height * width,))
    for b in torch.unique(bucket).tolist():
        rows = torch.nonzero(bucket == b)[:, 0]
        lane = torch.arange(2 ** b, device=dev)
        idx = starts[rows, None] + lane
        inside = lane < lengths[rows, None]
        idx = torch.where(inside, idx, 0)
        a = torch.where(inside, alpha[idx], 0.0)
        t_incl = torch.cumprod(1.0 - a, 1)
        t_excl = torch.cat([torch.ones_like(t_incl[:, :1]),
                            t_incl[:, :-1]], 1)
        c = ar.einsum("rk,rkc->rc", a * t_excl, colors[gid[idx]])
        where = pix[starts[rows]]
        image = image.index_put((where,), c)
        trans = trans.index_put((where,), t_incl[:, -1])
    img = image.T.reshape(nc, height, width)
    return img, trans.reshape(height, width)
