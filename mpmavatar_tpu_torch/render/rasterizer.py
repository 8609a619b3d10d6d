"""Tile-based 3D Gaussian Splatting rasterizer, port of
mpmavatar_tpu/render/rasterizer.py.

EWA projection of 3D covariances with the 0.3-pixel low-pass dilation,
3-sigma tile binning into (tile, depth)-sorted instances with footprint
tiers, and front-to-back alpha compositing.  Two compositors, chosen by
``work_cap`` as in the JAX package: ``_composite`` (a dense (tile,
capacity) table, plain tensor code, ``work_cap=0``) and
``_composite_worklist`` (``work_cap > 0``), whose per-item work is K6
(``ops/composite.py::segment_composite_gather``), launched twice per
frame on the parameter table and each item's instance ids.

Port of the contract, not the TPU layout: the lane-rotated chunk windows
of the JAX package become a clipped gather of ``start + arange(chunk)``
ids, the (W, 6+nc, C) gather of the items' parameters happens inside K6
(and its scatter-add backward inside K7), and the kernel block padding
(phase 1 padded to a multiple of 8, ``pick_block``) is gone; the outputs
are the same.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from .. import resolve_device
from ..core.types import _Tensors
from ..ops.composite import segment_composite_gather

TILE = 16
ALPHA_MIN = 1.0 / 255.0


@dataclasses.dataclass(frozen=True)
class CameraArrays(_Tensors):
    """Device-side camera tensors (see render.cameras.Camera)."""
    world_view: torch.Tensor   # (4,4) transposed (row-vector)
    full_proj: torch.Tensor    # (4,4) transposed
    cam_center: torch.Tensor   # (3,)
    tanfovx: torch.Tensor      # scalar
    tanfovy: torch.Tensor      # scalar


def camera_arrays(cam, device=None) -> CameraArrays:
    device = resolve_device(device)
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
    return CameraArrays(world_view=f32(cam.world_view_transform),
                        full_proj=f32(cam.full_proj_transform),
                        cam_center=f32(cam.camera_center),
                        tanfovx=f32(cam.tanfovx), tanfovy=f32(cam.tanfovy))


def project_gaussians(means3d, cov3d, cam: CameraArrays, width: int,
                      height: int):
    """World-space gaussians -> screen space.

    Returns (means2d (N,2) px, depth (N,), conic (N,3), radius (N,),
    in_frustum (N,) bool)."""
    n = means3d.shape[0]
    hom = torch.cat([means3d, torch.ones((n, 1), dtype=means3d.dtype,
                                         device=means3d.device)], 1)
    p_view = hom @ cam.world_view                       # (N,4) row-vector
    depth = p_view[:, 2]
    p_proj = hom @ cam.full_proj
    p_w = 1.0 / (p_proj[:, 3] + 1e-7)
    ndc = p_proj[:, :3] * p_w[:, None]
    means2d = torch.stack([((ndc[:, 0] + 1.0) * width - 1.0) * 0.5,
                           ((ndc[:, 1] + 1.0) * height - 1.0) * 0.5], -1)

    focal_x = width / (2.0 * cam.tanfovx)
    focal_y = height / (2.0 * cam.tanfovy)

    # EWA: clamp view-space x/z, y/z like the CUDA reference kernel
    tz = torch.clamp_min(depth, 1e-4)
    limx = 1.3 * cam.tanfovx
    limy = 1.3 * cam.tanfovy
    txtz = torch.clamp(p_view[:, 0] / tz, -limx, limx)
    tytz = torch.clamp(p_view[:, 1] / tz, -limy, limy)
    tx = txtz * tz
    ty = tytz * tz

    zeros = torch.zeros_like(tz)
    j = torch.stack([
        torch.stack([focal_x / tz, zeros, -(focal_x * tx) / (tz * tz)], -1),
        torch.stack([zeros, focal_y / tz, -(focal_y * ty) / (tz * tz)], -1),
        torch.stack([zeros, zeros, zeros], -1),
    ], dim=-2)                                           # (N,3,3)
    w_rot = cam.world_view[:3, :3].T                     # w2c rotation
    t_mat = torch.einsum("ab,nbc->nac", w_rot.T, j.transpose(-1, -2))
    # cov2d = J W cov3d W^T J^T; t_mat = (J W)^T
    cov2d_full = torch.einsum("nba,nbc,ncd->nad", t_mat, cov3d, t_mat)
    c_xx = cov2d_full[:, 0, 0] + 0.3
    c_yy = cov2d_full[:, 1, 1] + 0.3
    c_xy = cov2d_full[:, 0, 1]

    det = c_xx * c_yy - c_xy * c_xy
    det_inv = 1.0 / torch.clamp_min(det, 1e-12)
    conic = torch.stack([c_yy * det_inv, -c_xy * det_inv, c_xx * det_inv],
                        -1)

    mid = 0.5 * (c_xx + c_yy)
    lam1 = mid + torch.sqrt(torch.clamp_min(mid * mid - det, 0.1))
    radius = torch.ceil(3.0 * torch.sqrt(lam1))

    in_frustum = (depth > 0.2) & (det > 0)
    radius = torch.where(in_frustum, radius, 0.0)
    return means2d, depth, conic, radius, in_frustum


def _sorted_instances(means2d, depth, radius, valid, width, height,
                      max_tiles_per_gauss: int,
                      mid_capacity=None, big_capacity=None, tiers=None):
    """(tile, depth)-sorted gaussian instances.

    Returns (tile_sorted (I,), gauss_sorted (I,), edges (T+2,),
    big_overflow) where instances of tile t occupy
    gauss_sorted[edges[t]:edges[t+1]] in front-to-back depth order.  When
    (T+1)(N+1) < 2^31 the sort key packs (tile, depth rank) into one
    integer (the rank from a stable argsort of depth, so the order is
    determined under depth ties); otherwise two stable sorts give the
    lexicographic (tile, depth) order.

    ``tiers``: optional ascending ((side, capacity), ...) footprint tiers
    (``capacity=None`` means all N).  The first tier admits everyone; tier
    i > 0 admits, up to its capacity, the gaussians whose rect exceeds
    tier i-1's side.  Stragglers keep the previous tier's coverage, and
    rects wider than the last side lose their outer tiles; both count into
    big_overflow.
    """
    n = means2d.shape[0]
    dev = means2d.device
    tiles_x = (width + TILE - 1) // TILE
    tiles_y = (height + TILE - 1) // TILE
    num_tiles = tiles_x * tiles_y
    side = int(math.ceil(math.sqrt(max_tiles_per_gauss)))

    # .to(int32) truncates toward zero, negative values included, as the
    # JAX package's astype does (floor would not)
    def tile_of(v, hi):
        return torch.clamp((v / TILE).to(torch.int32), 0, hi)

    rect_min_x = tile_of(means2d[:, 0] - radius, tiles_x)
    rect_min_y = tile_of(means2d[:, 1] - radius, tiles_y)
    rect_max_x = tile_of(means2d[:, 0] + radius + TILE - 1, tiles_x)
    rect_max_y = tile_of(means2d[:, 1] + radius + TILE - 1, tiles_y)

    ok_g = valid & (radius > 0)
    w_t = rect_max_x - rect_min_x
    h_t = rect_max_y - rect_min_y

    packed_key = (num_tiles + 1) * (n + 1) < 2 ** 31
    if packed_key:
        rank = torch.empty((n,), dtype=torch.int64, device=dev)
        rank[torch.argsort(depth, stable=True)] = torch.arange(n, device=dev)

    def pool(idx_g, side_p, emit):
        """One tier's instances: side_p^2 slots per gaussian in idx_g;
        slots outside the rect (or of non-members) are sentinels."""
        off = torch.arange(side_p, device=dev)
        ty = rect_min_y[idx_g][:, None, None] + off[None, :, None]
        tx = rect_min_x[idx_g][:, None, None] + off[None, None, :]
        v = emit[idx_g][:, None, None] \
            & (ty < rect_max_y[idx_g][:, None, None]) \
            & (tx < rect_max_x[idx_g][:, None, None])
        tid = torch.where(v, ty * tiles_x + tx, num_tiles).reshape(
            len(idx_g), -1).to(torch.int64)
        gid = idx_g[:, None].expand(tid.shape)
        if packed_key:
            key = tid * (n + 1) + rank[idx_g][:, None]
            return key.reshape(-1), gid.reshape(-1)
        dep = torch.where(v.reshape(tid.shape), depth[idx_g][:, None],
                          math.inf)
        return (tid.reshape(-1), dep.reshape(-1)), gid.reshape(-1)

    def top_pool(flag, capacity):
        order = torch.argsort(torch.where(flag, 0, 1), stable=True)
        idx = order[:capacity]
        member = torch.zeros((n,), dtype=torch.bool, device=dev)
        member[idx] = flag[idx]
        return idx, member, flag.sum() - member.sum()

    if tiers is None:
        mid_capacity = min(n, max(256, n // 4) if mid_capacity is None
                           else mid_capacity)
        big_capacity = min(n, max(256, n // 16) if big_capacity is None
                           else big_capacity)
        tiers = ((2, None), (4, mid_capacity))
        if side > 8:
            # giant-footprint tail tier: only rects wider than 8 pay side^2
            tiers += ((8, big_capacity), (side, min(n, max(256, n // 32))))
        else:
            tiers += ((side, big_capacity),)
    sides = [int(s) for s, _ in tiers]
    if sides != sorted(sides):
        raise ValueError(f"tiers must be ascending by side, got {tiers}")
    top_side = sides[-1]

    # tier membership, highest first: a gaussian whose rect exceeds tier
    # i-1's side belongs to tier i (capacity permitting); members of a
    # higher tier never emit in a lower one
    members = [None] * len(tiers)
    idxs = [torch.arange(n, device=dev)] + [None] * (len(tiers) - 1)
    in_higher = torch.zeros((n,), dtype=torch.bool, device=dev)
    over_total = torch.zeros((), dtype=torch.int64, device=dev)
    for i in range(len(tiers) - 1, 0, -1):
        cap_i = tiers[i][1]
        cap_i = n if cap_i is None else min(n, max(8, int(cap_i)))
        flag = (ok_g & ~in_higher
                & ((w_t > sides[i - 1]) | (h_t > sides[i - 1])))
        idx_i, in_i, over_i = top_pool(flag, cap_i)
        idxs[i] = idx_i
        members[i] = in_i & ~in_higher
        in_higher = in_higher | in_i
        over_total = over_total + over_i
    members[0] = ok_g & ~in_higher
    clipped = ok_g & ((w_t > top_side) | (h_t > top_side))
    big_overflow = over_total + clipped.sum()

    emitted = [pool(idxs[i], sides[i], members[i]) for i in range(len(tiers))]
    gauss_id = torch.cat([g for _, g in emitted])
    if packed_key:
        # valid keys are unique; equal sentinel keys carry equal ids
        key = torch.cat([k for k, _ in emitted])
        key_sorted, order = torch.sort(key, stable=True)
        tile_sorted = key_sorted // (n + 1)
    else:
        tile_id = torch.cat([k[0] for k, _ in emitted])
        inst_depth = torch.cat([k[1] for k, _ in emitted])
        order = torch.argsort(inst_depth, stable=True)
        order = order[torch.argsort(tile_id[order], stable=True)]
        tile_sorted = tile_id[order]
    gauss_sorted = gauss_id[order]

    # tile_sorted is sorted: per-tile ranges from searchsorted
    edges = torch.searchsorted(
        tile_sorted, torch.arange(num_tiles + 2, device=dev,
                                  dtype=tile_sorted.dtype))
    return tile_sorted, gauss_sorted, edges, big_overflow


def _build_tile_table(tile_sorted, gauss_sorted, edges, n: int,
                      num_tiles: int, tile_capacity: int):
    """Dense fixed-capacity (T, K) table from the sorted instances."""
    starts = edges[:-1]
    pos_in_tile = torch.arange(tile_sorted.shape[0],
                               device=tile_sorted.device) \
        - starts[tile_sorted]
    ok = (tile_sorted < num_tiles) & (pos_in_tile < tile_capacity)
    table = torch.full((num_tiles * tile_capacity,), n, dtype=torch.int64,
                       device=tile_sorted.device)
    table[(tile_sorted * tile_capacity + pos_in_tile)[ok]] = \
        gauss_sorted[ok]
    return table.reshape(num_tiles, tile_capacity)


def _tile_origins(num_tiles: int, tiles_x: int, device, dtype):
    t_idx = torch.arange(num_tiles, device=device)
    return torch.stack([(t_idx % tiles_x) * TILE, (t_idx // tiles_x) * TILE],
                       -1).to(dtype)


def _to_image(accum, trans, bg, tiles_x, width, height):
    """(T, nc, P) colours + (T, P) transmittance -> (image (nc,H,W),
    alpha (1,H,W)), tile padding cropped."""
    num_tiles, nc, _ = accum.shape
    tiles_y = num_tiles // tiles_x
    img = accum + trans[:, None, :] * bg[:nc][None, :, None]
    img = img.reshape(tiles_y, tiles_x, nc, TILE, TILE)
    img = img.permute(2, 0, 3, 1, 4).reshape(nc, tiles_y * TILE,
                                             tiles_x * TILE)
    alpha_map = (1.0 - trans).reshape(tiles_y, tiles_x, TILE, TILE)
    alpha_map = alpha_map.permute(0, 2, 1, 3).reshape(
        1, tiles_y * TILE, tiles_x * TILE)
    return img[:, :height, :width], alpha_map[:, :height, :width]


def _packed_params(means2d, conic, colors, opacities):
    """(N+1, 6+nc) rows [mean(2), conic(3), colour(nc), opacity]; the pad
    row N (the sentinel id) has means -1e6 and opacity 0 -> alpha 0."""
    pad = torch.zeros((1, 6 + colors.shape[-1]), dtype=means2d.dtype,
                      device=means2d.device)
    pad[0, 0:2] = -1e6
    return torch.cat([torch.cat([means2d, conic, colors,
                                 opacities.reshape(-1, 1)], -1), pad], 0)


def _composite(table, means2d, conic, colors, opacities, width, height,
               bg, chunk: int = 32, cap_lo: int = 0, hot_tiles: int = 0):
    """Front-to-back alpha compositing over the tile table (plain tensor
    code, as in the JAX package).

    With ``0 < cap_lo < cap``: every tile composites only its first
    ``cap_lo`` table entries; the ``hot_tiles`` fullest tiles continue,
    carrying transmittance, through the rest.

    Returns (image (nc,H,W), alpha (1,H,W))."""
    num_tiles, cap = table.shape
    tiles_x = (width + TILE - 1) // TILE
    n = means2d.shape[0]
    packed = _packed_params(means2d, conic, colors, opacities)
    nc = colors.shape[-1]
    ip = torch.arange(TILE * TILE, device=table.device)
    pix_all = _tile_origins(num_tiles, tiles_x, table.device,
                            means2d.dtype)[:, None, :] + torch.stack(
        [ip % TILE, ip // TILE], -1).to(means2d.dtype)      # (T, P, 2)

    def run(pix, accum, trans, chunks):
        for ids in chunks:                                  # (T, C)
            pg = packed[ids]                                # (T, C, 6+nc)
            d = pix[:, :, None, :] - pg[:, None, :, 0:2]    # (T, P, C, 2)
            co = pg[:, None, :, 2:5]
            power = -0.5 * (co[..., 0] * d[..., 0] ** 2
                            + co[..., 2] * d[..., 1] ** 2) \
                - co[..., 1] * d[..., 0] * d[..., 1]
            alpha = torch.clamp_max(pg[:, None, :, 5 + nc] * torch.exp(
                torch.clamp_max(power, 0.0)), 0.99)
            alpha = torch.where(power > 0.0, 0.0, alpha)
            alpha = torch.where(alpha < ALPHA_MIN, 0.0, alpha)
            # exclusive prod_{c'<c}(1-alpha) through log1p and a strict
            # upper-triangular product, as the JAX package computes it
            log1m = torch.log1p(-alpha)
            c_n = alpha.shape[-1]
            tri = torch.triu(torch.ones((c_n, c_n), dtype=alpha.dtype,
                                        device=alpha.device), 1)
            excl_log = log1m @ tri
            w = alpha * torch.exp(excl_log) * trans[..., None]
            accum = accum + w @ pg[..., 5:5 + nc]
            trans = trans * torch.exp(excl_log[..., -1] + log1m[..., -1])
        return accum, trans

    p = TILE * TILE
    accum = torch.zeros((num_tiles, p, nc), dtype=means2d.dtype,
                        device=table.device)
    trans = torch.ones((num_tiles, p), dtype=means2d.dtype,
                       device=table.device)
    hot_tiles = min(hot_tiles, num_tiles)
    two_tier = 0 < cap_lo < cap and hot_tiles > 0
    cap1 = cap_lo if two_tier else cap
    accum, trans = run(pix_all, accum, trans,
                       table[:, :cap1].split(chunk, dim=1))
    if two_tier:
        counts_lo = (table[:, :cap] < n).sum(1)
        hot = torch.argsort(-counts_lo, stable=True)[:hot_tiles]  # fullest
        table_h = table[hot, cap_lo:]
        pad = (-table_h.shape[1]) % chunk
        if pad:
            table_h = torch.cat([table_h, torch.full(
                (hot_tiles, pad), n, dtype=table.dtype,
                device=table.device)], 1)
        acc_h, tr_h = run(pix_all[hot], accum[hot], trans[hot],
                          table_h.split(chunk, dim=1))
        accum = accum.index_put((hot,), acc_h)
        trans = trans.index_put((hot,), tr_h)
    return _to_image(accum.transpose(1, 2), trans, bg, tiles_x, width,
                     height)


def _composite_worklist(gauss_sorted, edges, means2d, conic, colors,
                        opacities, width, height, bg, chunk: int = 32,
                        work_cap: int = 16384, tile_capacity: int = 512,
                        stop_eps: float = 0.0):
    """Front-to-back compositing over a compacted (tile, chunk) worklist.

    Phase 1 composites the first ``chunk`` instances of every tile (W =
    number of tiles); phase 2 composites the remaining chunks of the tiles
    that have more, one (tile, chunk) item per row of a ``work_cap``-long
    worklist (items past ``work_cap`` are dropped and counted as
    ``work_overflow``), and merges same-tile segments in depth order with
    (c, t) o (c', t') = (c + t c', t t') through a segmented doubling scan.
    Both phases are K6.  ``stop_eps > 0`` skips a tile's phase-2 chunks
    once all its pixels' transmittance fell below it after phase 1.

    Returns (image, alpha, work_overflow, n_items)."""
    dev = means2d.device
    tiles_x = (width + TILE - 1) // TILE
    tiles_y = (height + TILE - 1) // TILE
    num_tiles = tiles_x * tiles_y
    n = means2d.shape[0]
    nc = colors.shape[-1]
    max_items = max(tile_capacity // chunk, 1)

    starts = edges[:num_tiles]
    counts = torch.clamp_max(edges[1:num_tiles + 1] - starts, tile_capacity)
    packed = _packed_params(means2d, conic, colors, opacities)
    pix0_all = _tile_origins(num_tiles, tiles_x, dev, means2d.dtype)
    lane = torch.arange(chunk, device=dev)
    last_inst = gauss_sorted.shape[0] - 1

    def window(item_start, in_tile):
        """Ids of ``chunk`` consecutive instances from each start; the
        sentinel n outside the tile."""
        pos = torch.clamp(item_start[:, None] + lane, 0, last_inst)
        return torch.where(in_tile, gauss_sorted[pos], n)

    # ---- phase 1: first chunk of every tile ----------------------------
    ids1 = window(starts, lane[None, :] < counts[:, None])
    seg1 = segment_composite_gather(packed, ids1, pix0_all, nc)
    c1 = seg1[:, :nc]                                      # (T, nc, P)
    t1 = seg1[:, nc]                                       # (T, P)

    # ---- phase 2: remaining chunks, compacted worklist -----------------
    rem = torch.clamp_min((counts + chunk - 1) // chunk - 1, 0)
    if stop_eps > 0.0:
        alive = t1.amax(dim=-1) >= stop_eps
        rem = torch.where(alive, rem, 0)
    offs = torch.cat([torch.zeros((1,), dtype=rem.dtype, device=dev),
                      torch.cumsum(rem, 0)])
    n_items = offs[-1]
    overflow = torch.clamp_min(n_items - work_cap, 0)

    w_ids = torch.arange(work_cap, device=dev, dtype=offs.dtype)
    item_tile = torch.clamp(
        torch.searchsorted(offs, w_ids, right=True) - 1, 0, num_tiles - 1)
    valid_item = w_ids < n_items
    ordinal = torch.clamp(w_ids - offs[item_tile], 0,
                          max(max_items - 2, 0)) + 1       # chunks 1..
    pos = ordinal[:, None] * chunk + lane[None, :]
    in_tile = valid_item[:, None] & (pos < counts[item_tile][:, None])
    ids = window(starts[item_tile] + ordinal * chunk, in_tile)
    seg = segment_composite_gather(packed, ids, pix0_all[item_tile], nc)
    seg_c = seg[:, :nc]                                    # (W, nc, P)
    seg_t = seg[:, nc]                                     # (W, P)

    # segmented inclusive scan along W: items of one tile are consecutive
    # and depth-ordered; items past n_items are the identity (0, 1)
    s = 1
    while s < max_items - 1:
        same = torch.cat([torch.zeros((s,), dtype=torch.bool, device=dev),
                          item_tile[s:] == item_tile[:-s]])
        c_l = torch.cat([torch.zeros_like(seg_c[:s]), seg_c[:-s]])
        t_l = torch.cat([torch.ones_like(seg_t[:s]), seg_t[:-s]])
        seg_c = torch.where(same[:, None, None], c_l + t_l[:, None, :] * seg_c,
                            seg_c)
        seg_t = torch.where(same[:, None], t_l * seg_t, seg_t)
        s *= 2

    # per-tile phase-2 result at its last in-cap item; tiles cut by
    # work_cap keep the in-cap prefix (overflow reported above)
    tile_end = torch.clamp_max(offs[1:num_tiles + 1], work_cap)
    has = offs[:num_tiles] < tile_end
    last = torch.clamp(tile_end - 1, 0, work_cap - 1)
    c2 = torch.where(has[:, None, None], seg_c[last], 0.0)  # (T, nc, P)
    t2 = torch.where(has[:, None], seg_t[last], 1.0)        # (T, P)

    # phase 1 (front) o phase 2
    img, alpha = _to_image(c1 + t1[:, None, :] * c2, t1 * t2, bg, tiles_x,
                           width, height)
    return img, alpha, overflow, n_items


def rasterize(means3d, colors, opacities, cov3d, cam: CameraArrays, bg,
              width: int, height: int, means2d_offset=None,
              tile_capacity: int = 512, max_tiles_per_gauss: int = 36,
              chunk: int = 32, tile_capacity_lo: int = 0,
              hot_tiles: int = 0, work_cap: int = 0,
              mid_capacity: int = None, big_capacity: int = None,
              tiers=None, stop_eps: float = 0.0, live=None):
    """Full splatting pass.

    ``means2d_offset`` (N,2), normally zeros, is added to the projected 2D
    means (differentiate a loss w.r.t. it for the view-space gradients of
    densification).  ``tile_capacity_lo``/``hot_tiles`` enable two-tier
    compositing on the ``work_cap=0`` path.  ``live`` (N,) bool, when
    given, leaves the other gaussians out of the tiles: they must have
    opacity 0 (a capacity-padded set's dead slots), so that they add
    nothing to any pixel and take no tile's capacity.

    Returns dict(render (nc,H,W), alpha (1,H,W), radii (N,), depth (N,),
    tile_counts (T,), big_overflow, work_overflow) as the JAX package does,
    plus n_items, the phase-2 worklist length (0 without a worklist), and
    tile_overflow, the instances past ``tile_capacity`` in their tile,
    which no phase composites."""
    means2d, depth, conic, radius, in_frustum = project_gaussians(
        means3d, cov3d, cam, width, height)
    if means2d_offset is not None:
        means2d = means2d + means2d_offset
    tiles_x = (width + TILE - 1) // TILE
    tiles_y = (height + TILE - 1) // TILE
    num_tiles = tiles_x * tiles_y
    binned = in_frustum if live is None else in_frustum & live
    tile_sorted, gauss_sorted, edges, big_overflow = _sorted_instances(
        means2d, depth, radius, binned, width, height,
        max_tiles_per_gauss, mid_capacity=mid_capacity,
        big_capacity=big_capacity, tiers=tiers)
    counts = edges[1:num_tiles + 1] - edges[:num_tiles]
    if work_cap > 0:
        img, alpha, work_overflow, n_items = _composite_worklist(
            gauss_sorted, edges, means2d, conic, colors, opacities,
            width, height, bg, chunk=chunk, work_cap=work_cap,
            tile_capacity=tile_capacity, stop_eps=stop_eps)
    else:
        table = _build_tile_table(tile_sorted, gauss_sorted, edges,
                                  means3d.shape[0], num_tiles,
                                  tile_capacity)
        img, alpha = _composite(table, means2d, conic, colors, opacities,
                                width, height, bg, chunk=chunk,
                                cap_lo=tile_capacity_lo,
                                hot_tiles=hot_tiles)
        work_overflow = n_items = torch.zeros((), dtype=torch.int64,
                                              device=means3d.device)
    return {"render": img, "alpha": alpha, "radii": radius,
            "depth": depth, "tile_counts": counts,
            "big_overflow": big_overflow, "work_overflow": work_overflow,
            "n_items": n_items,
            "tile_overflow": torch.clamp_min(counts - tile_capacity,
                                             0).sum()}
