"""Data-parallel stage-2 appearance training over a ``torch.distributed``
process group (port of mpmavatar_tpu/parallel/appearance_dp.py).

A batch of (camera, frame) samples is split over the ranks; each rank
renders and differentiates its samples with the same stage-2 loss as the
single-device trainer (``train.appearance.frame_loss``), one sample after
another.  The gradients and the loss are averaged over the ranks, the
densification statistics summed (the view-space gradient norms and the
visible counts) or max-reduced (the screen radii), so that one step of B
samples optimizes the mean of their losses and adds B samples' worth of
densification statistics, as B single-device steps' averaged gradients
and accumulated statistics would.  Then every rank applies the same
optimizer step to its replica of the parameters.
"""

from __future__ import annotations

import dataclasses

import torch

from ..render import gaussians as G
from ..render.rasterizer import CameraArrays, camera_arrays
from ..train.appearance import (AppearanceLossWeights, apply_updates_float,
                                float_leaf_grads, frame_loss)
from . import collectives as C


def make_dp_appearance_step(avatar, opt, optimizer, group,
                            active_sh_degree: int, white_bkgd: bool,
                            width: int, height: int,
                            weights: AppearanceLossWeights = None,
                            tile_capacity: int = 256, work_cap: int = 0,
                            chunk: int = 32, lpips_fn=None):
    """Returns step(params, densify_state, cam, camera_idx, timestep,
    verts_base, ao_map, rgb, msk) -> (densify_state, loss, metrics).

    The batch arguments are this rank's samples (``shard_batch``), each
    with a leading axis of the local batch size: cam (CameraArrays
    stacked, ``stack_camera_arrays``), camera_idx and timestep (int),
    verts_base (b, V, 3) the tracked vertices WITHOUT the learnable
    offset (the step adds ``verts_offset[timestep]`` so that its gradient
    flows), ao_map (b, 1, Ha, Wa), rgb (b, 3, H, W), msk (b, 1, H, W).
    ``optimizer`` holds the parameters (``train.appearance
    .make_optimizer``) and updates them in place, the same update on
    every rank; ``loss`` and the float metrics are means over the global
    batch, the overflow counts sums."""
    weights = weights or AppearanceLossWeights(
        dssim=opt.lambda_dssim, lpips=getattr(opt, "lambda_lpips", 0.2),
        threshold_xyz=getattr(opt, "threshold_xyz", 1.0),
        threshold_scale=getattr(opt, "threshold_scale", 0.6))

    def one_sample_grads(params, cam, cidx, t, verts_base, ao, rgb, msk):
        dev = params.verts_offset.device
        bg = torch.full((3,), 1.0 if white_bkgd else 0.0, device=dev)

        def loss_fn(p, m2d):
            verts = verts_base + p.verts_offset[t]
            return frame_loss(
                avatar, weights, p, m2d, verts, p.verts_offset[t], ao, cam,
                width, height, cidx, rgb, msk, active_sh_degree, bg,
                white_bkgd, tile_capacity, work_cap, chunk, lpips_fn)

        cap = params.splats.capacity
        m2d0 = torch.zeros((cap, 2), device=dev)
        (loss, aux), grads, vgrad = float_leaf_grads(params, loss_fn, m2d0)
        ndc = torch.tensor([0.5 * width, 0.5 * height], device=dev)
        gn = torch.linalg.norm(vgrad[:, :2] * ndc, dim=-1)
        visible = aux["visible"][:cap]
        stats = (torch.where(visible, gn[:cap], 0.0), visible.float(),
                 torch.where(visible, aux["radii"][:cap].float(), 0.0))
        metrics = {k: aux[k] for k in ("l1", "dssim", "lpips",
                                       "big_overflow", "work_overflow")}
        return loss, grads, stats, metrics

    def step(params, ds, cam_b, cidx_b, t_b, verts_b, ao_b, rgb_b, msk_b):
        # one sample after another, as JAX unrolls its local batch
        local_b = rgb_b.shape[0]
        loss = grads = stats = metrics = None
        for i in range(local_b):
            cam = CameraArrays(**{f.name: getattr(cam_b, f.name)[i]
                                  for f in dataclasses.fields(cam_b)})
            li, gi, si, mi = one_sample_grads(
                params, cam, int(cidx_b[i]), int(t_b[i]), verts_b[i],
                ao_b[i], rgb_b[i], msk_b[i])
            if loss is None:
                loss, grads, stats, metrics = li, gi, si, mi
            else:
                loss = loss + li
                grads = {k: grads[k] + gi[k] for k in grads}
                stats = (stats[0] + si[0], stats[1] + si[1],
                         torch.maximum(stats[2], si[2]))
                metrics = {k: metrics[k] + mi[k] for k in metrics}
        inv_b = 1.0 / local_b
        with torch.no_grad():
            # the gradients' mean over the ranks (parameters replicated,
            # the batch split)
            loss = C.all_mean(loss * inv_b, group)
            grads = {k: C.all_mean(g * inv_b, group)
                     for k, g in grads.items()}
            # densification statistics: summed over the global batch (each
            # sample counts as one iteration), the screen radii max-reduced
            ds = G.DensifyState(
                xyz_gradient_accum=ds.xyz_gradient_accum
                + C.all_reduce(stats[0], group)[:, None],
                denom=ds.denom + C.all_reduce(stats[1], group)[:, None],
                max_radii2d=torch.maximum(ds.max_radii2d,
                                          C.all_max(stats[2], group)))
            metrics = {k: C.all_mean(v * inv_b, group)
                       if v.is_floating_point() else C.all_reduce(v, group)
                       for k, v in metrics.items()}
        apply_updates_float(optimizer, params, grads)
        return ds, loss, metrics

    return step


def stack_camera_arrays(cams, device=None) -> CameraArrays:
    """Host Cameras stacked into one CameraArrays with a leading batch
    axis."""
    arrays = [camera_arrays(c, device) for c in cams]
    return CameraArrays(**{
        f.name: torch.stack([getattr(a, f.name) for a in arrays])
        for f in dataclasses.fields(CameraArrays)})


def shard_batch(batch, rank: int, world: int):
    """Rank ``rank``'s contiguous block of a batch: a tuple of tensors
    and CameraArrays, each split along its leading axis (JAX places the
    batch with a ``NamedSharding`` over the mesh)."""
    def block(a):
        if dataclasses.is_dataclass(a):
            return dataclasses.replace(a, **{
                f.name: block(getattr(a, f.name))
                for f in dataclasses.fields(a)})
        if a.shape[0] % world:
            raise ValueError(f"a batch of {a.shape[0]} does not split over "
                             f"{world} ranks")
        k = a.shape[0] // world
        return a[rank * k:(rank + 1) * k]
    return tuple(block(a) for a in batch)
