"""Stage-2 appearance training, port of mpmavatar_tpu/train/appearance.py:
the avatar render (``shaded_colors``, ``render_avatar_frame``), the
per-group Adam optimizer, the stage-2 loss, the train step and the
held-out evaluation (``evaluate_appearance``).

One train step poses the mesh, runs the shadow UNet, shades SH colours,
splats (K6 forward, K7 backward on the card), and minimises
L1 + DSSIM (+ lambda_lpips * LPIPS when an ``lpips_fn`` is given) + the
regularizer set with one Adam group per learning rate.  The view-space
gradient that drives densification comes out of the same backward
(``aux["vgrad"]``).

Parameters are updated in place: the optimizer holds the leaf tensors of
``AvatarParams``, where the JAX package returns new parameters and an
optax state.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..render import (camera_arrays, convert_sh_colors, grid_sample_bilinear,
                      rasterize, shadow_unet_apply)
from ..render import gaussians as G
from ..render.avatar_model import AvatarParams, MeshAvatar
from ..utils import profiling
from ..utils.losses import l1_loss, psnr, ssim

SPLAT_FLOATS = ("xyz", "features_dc", "features_rest", "scaling",
                "rotation", "opacity")
# float leaves no optimizer group holds (optax's "frozen" label)
FROZEN_SHADOW = ("ao_mean", "beta")


def float_leaves(params: AvatarParams) -> dict:
    """Name -> tensor of every float leaf, named by the JAX pytree's path
    ("splats.xyz", "verts_offset", "shadow.enc0_v", ...)."""
    leaves = {f"splats.{f}": getattr(params.splats, f) for f in SPLAT_FLOATS}
    leaves.update(verts_offset=params.verts_offset, cam_m=params.cam_m,
                  cam_c=params.cam_c)
    leaves.update({f"shadow.{k}": v for k, v in params.shadow.items()})
    return leaves


def make_optimizer(opt, spatial_lr_scale: float,
                   params: AvatarParams) -> torch.optim.Adam:
    """Adam with one parameter group per learning rate, as the JAX
    package's optax labels (eps 1e-15; lr 0 for the higher SH bands);
    ``binding``, ``alive`` and the shadow UNet's ``ao_mean``/``beta`` are
    in no group."""
    s = params.splats
    shadow = [v for k, v in params.shadow.items() if k not in FROZEN_SHADOW]
    groups = (("xyz", [s.xyz], opt.position_lr_init * spatial_lr_scale),
              ("f_dc", [s.features_dc], opt.feature_lr),
              ("f_rest", [s.features_rest], 0.0),
              ("opacity", [s.opacity], opt.opacity_lr),
              ("scaling", [s.scaling], opt.scaling_lr),
              ("rotation", [s.rotation], opt.rotation_lr),
              ("verts", [params.verts_offset],
               opt.verts_lr_init * spatial_lr_scale),
              ("cams", [params.cam_m, params.cam_c], 1e-4),
              ("shadow", shadow, 1e-4))
    return torch.optim.Adam([{"params": p, "lr": lr, "name": name}
                             for name, p, lr in groups], eps=1e-15)


def shaded_colors(avatar: MeshAvatar, params: AvatarParams, frames,
                  ao_map, cam_center, xyz, active_sh_degree: int):
    """ShadowUNet(AO) -> per-face shadow -> shadow * SH colour."""
    shadow_map = shadow_unet_apply(params.shadow, ao_map[None])["shadow_map"]
    shadow = grid_sample_bilinear(
        shadow_map[0], avatar.tensor("uv_coord", xyz.device))   # (F, 1)
    shadow_per_gauss = G.bound_rows(shadow, params.splats.binding)
    colors = convert_sh_colors(G.get_features(params.splats), xyz,
                               cam_center, active_sh_degree)
    return shadow_per_gauss * colors, shadow_map


def render_avatar_frame(avatar: MeshAvatar, params: AvatarParams,
                        verts, ao_map, cam, camera_idx,
                        active_sh_degree: int, bg, white_bkgd: bool,
                        means2d_offset=None, tile_capacity: int = 512,
                        work_cap: int = 0, chunk: int = 32):
    """Pose + shade + splat + colour-calibrate one frame, on the device of
    ``verts``.

    ``cam`` is a host Camera or a (CameraArrays, width, height) triple.
    Only the alive slots are binned: the capacity's dead slots (opacity
    0) all bind face 0 and would fill that face's tiles, dropping the live
    splats behind them.  The splatting pass runs in the span
    ``appearance.raster``.
    Returns (rendering (3,H,W), the rasterizer's outputs dict)."""
    frames = avatar.frames_for_verts(verts)
    if isinstance(cam, tuple):
        ca, width, height = cam
    else:
        ca, width, height = (camera_arrays(cam, verts.device),
                             cam.image_width, cam.image_height)
    xyz = G.get_xyz(params.splats, frames)
    colors, _ = shaded_colors(avatar, params, frames, ao_map, ca.cam_center,
                              xyz, active_sh_degree)
    opacity = G.get_opacity(params.splats)[:, 0] * params.splats.alive
    cov3d = G.get_covariance(params.splats, frames)
    with profiling.span("appearance.raster"):
        out = rasterize(xyz, colors, opacity, cov3d, ca,
                        torch.as_tensor(bg, dtype=torch.float32,
                                        device=verts.device),
                        width=width, height=height,
                        means2d_offset=means2d_offset,
                        tile_capacity=tile_capacity, work_cap=work_cap,
                        chunk=chunk, live=params.splats.alive)
    rendering = out["render"] * torch.exp(
        params.cam_m[camera_idx])[:, None, None] \
        + params.cam_c[camera_idx][:, None, None]
    rendering = rendering * out["alpha"]
    if white_bkgd:
        rendering = rendering + (1.0 - out["alpha"])
    return rendering, out


@dataclasses.dataclass
class AppearanceLossWeights:
    """Weights of the stage-2 loss (the JAX package's defaults)."""
    dssim: float = 0.2
    lpips: float = 0.2
    normal: float = 0.1
    opacity: float = 0.05
    iso: float = 20.0
    area: float = 1000.0
    xyz: float = 1.0
    scale: float = 1.0
    offset: float = 0.0
    threshold_xyz: float = 1.0
    threshold_scale: float = 0.6


def _masked_mean(values, mask):
    return torch.sum(values * mask) / torch.clamp_min(torch.sum(mask), 1.0)


def _norm(v):
    """||.|| with 1e-12 inside the sqrt: the xyz offsets start at 0,
    where the plain norm's gradient is NaN."""
    return torch.sqrt(torch.sum(v * v, dim=1) + 1e-12)


def frame_loss(avatar: MeshAvatar, weights: AppearanceLossWeights,
               p: AvatarParams, m2d, verts, offset_rows, ao_map, ca,
               width: int, height: int, camera_idx, gt_rgb, gt_msk,
               active_sh_degree: int, bg, white_bkgd: bool,
               tile_capacity: int, work_cap: int, chunk: int,
               lpips_fn=None):
    """The stage-2 loss for one (camera, frame) sample: render + L1/DSSIM
    (+ LPIPS through ``lpips_fn``) + the regularizer set
    (normal/opacity/iso/area/xyz/scale/offset).  ``verts`` carries the
    learnable offset; ``offset_rows`` is the frame's slice of
    ``verts_offset`` for the optional offset term.  ``aux["lpips"]`` is
    NaN when the term is disabled (0 would read as converged)."""
    rendering, out = render_avatar_frame(
        avatar, p, verts, ao_map, (ca, width, height), camera_idx,
        active_sh_degree, bg, white_bkgd, means2d_offset=m2d,
        tile_capacity=tile_capacity, work_cap=work_cap, chunk=chunk)
    rendering = torch.clamp(rendering, 0.0, 1.0)
    gt = gt_rgb * gt_msk + (1.0 - gt_msk if white_bkgd else 0.0)
    ll1 = l1_loss(rendering, gt)
    ds = 1.0 - ssim(rendering, gt)
    loss = (1.0 - weights.dssim) * ll1 + weights.dssim * ds
    lp = torch.full((), float("nan"), device=ll1.device)
    if lpips_fn is not None:
        lp = lpips_fn(rendering[None], gt[None])
        loss = loss + weights.lpips * lp
    loss = loss + weights.normal * avatar.normal_loss(verts)
    loss = loss + weights.opacity * avatar.opacity_loss(p)
    loss = loss + weights.iso * avatar.iso_loss(verts)
    loss = loss + weights.area * avatar.area_loss(verts)
    # xyz / scale threshold regs over the visible gaussians
    visible = (out["radii"] > 0) & p.splats.alive
    xyz_excess = torch.relu(_norm(p.splats.xyz) - weights.threshold_xyz)
    loss = loss + weights.xyz * _masked_mean(xyz_excess, visible)
    scale_excess = _norm(torch.relu(
        torch.exp(p.splats.scaling) - weights.threshold_scale))
    loss = loss + weights.scale * _masked_mean(scale_excess, visible)
    if weights.offset:
        loss = loss + weights.offset * torch.mean(torch.abs(offset_rows))
    aux = {"l1": ll1.detach(), "dssim": ds.detach(), "lpips": lp.detach(),
           "radii": out["radii"].detach(), "alpha": out["alpha"].detach(),
           "visible": visible, "big_overflow": out["big_overflow"],
           "work_overflow": out["work_overflow"], "n_items": out["n_items"],
           "tile_overflow": out["tile_overflow"]}
    return loss, aux


def float_leaf_grads(params: AvatarParams, loss_of_params_and_m2d, m2d0):
    """Loss and gradients over every float leaf of ``params`` (each made
    to require grad) and the view-space offset ``m2d0``, from one
    backward.  Returns ((loss, aux), name -> gradient, vgrad)."""
    leaves = float_leaves(params)
    for t in leaves.values():
        t.requires_grad_(True)
    m2d = m2d0.detach().requires_grad_(True)
    with profiling.span("appearance.forward"):
        loss, aux = loss_of_params_and_m2d(params, m2d)
    with profiling.span("appearance.backward"):
        grads = torch.autograd.grad(loss, [*leaves.values(), m2d],
                                    allow_unused=True)
    grads = [torch.zeros_like(t) if gr is None else gr
             for t, gr in zip([*leaves.values(), m2d], grads)]
    return (loss.detach(), aux), dict(zip(leaves, grads[:-1])), grads[-1]


def apply_updates_float(optimizer: torch.optim.Optimizer,
                        params: AvatarParams, grads: dict) -> None:
    """One optimizer step on the float leaves that its groups hold, from
    ``grads`` (name -> gradient); the frozen leaves stay as they are."""
    name_of = {id(t): name for name, t in float_leaves(params).items()}
    held = [p for group in optimizer.param_groups for p in group["params"]]
    for p in held:
        p.grad = grads[name_of[id(p)]]
    optimizer.step()
    for p in held:
        p.grad = None


def make_loss_and_grads(avatar: MeshAvatar, opt, active_sh_degree: int,
                        white_bkgd: bool, weights=None,
                        tile_capacity: int = 512, work_cap: int = 0,
                        chunk: int = 32, lpips_fn=None):
    """fn(params, timestep, camera_idx, ca, gt_rgb, gt_msk, ao_map, width,
    height) -> (loss, aux, grads): the train step without its update.

    ``aux["vgrad"]`` is d(loss)/d(means2d) from the same backward, scaled
    to NDC units (x 0.5 W, 0.5 H) so the reference's
    ``densify_grad_threshold`` applies unchanged.  ``lpips_fn`` (an
    ``utils.lpips.LPIPS``) adds the lambda_lpips * LPIPS term."""
    weights = weights or AppearanceLossWeights(
        dssim=opt.lambda_dssim, lpips=opt.lambda_lpips,
        threshold_xyz=opt.threshold_xyz,
        threshold_scale=opt.threshold_scale)

    def loss_and_grads(params: AvatarParams, timestep: int, camera_idx, ca,
                       gt_rgb, gt_msk, ao_map, width: int, height: int):
        dev = params.verts_offset.device
        bg = torch.full((3,), 1.0 if white_bkgd else 0.0, device=dev)

        def loss_fn(p, m2d):
            verts = avatar.select_verts(p, timestep)
            return frame_loss(
                avatar, weights, p, m2d, verts, p.verts_offset[timestep],
                ao_map, ca, width, height, camera_idx, gt_rgb, gt_msk,
                active_sh_degree, bg, white_bkgd, tile_capacity, work_cap,
                chunk, lpips_fn)

        m2d0 = torch.zeros((params.splats.capacity, 2), device=dev)
        (loss, aux), grads, vgrad = float_leaf_grads(params, loss_fn, m2d0)
        aux["vgrad"] = vgrad * torch.tensor([0.5 * width, 0.5 * height],
                                            device=dev)
        return loss, aux, grads

    return loss_and_grads


def make_train_step(avatar: MeshAvatar, opt, optimizer: torch.optim.Adam,
                    active_sh_degree: int, white_bkgd: bool, weights=None,
                    tile_capacity: int = 512, work_cap: int = 0,
                    chunk: int = 32, lpips_fn=None):
    """step(params, timestep, camera_idx, ca, gt_rgb, gt_msk, ao_map,
    width, height) -> (loss, aux): one optimization step, updating the
    parameters that ``optimizer`` holds in place (see
    ``make_loss_and_grads`` for ``aux["vgrad"]`` and ``lpips_fn``).  A
    step is the span ``appearance.step`` around ``appearance.forward``,
    ``appearance.backward`` (``float_leaf_grads``) and
    ``appearance.adam``."""
    loss_and_grads = make_loss_and_grads(
        avatar, opt, active_sh_degree, white_bkgd, weights, tile_capacity,
        work_cap, chunk, lpips_fn)

    def train_step(params: AvatarParams, *args):
        with profiling.span("appearance.step"):
            loss, aux, grads = loss_and_grads(params, *args)
            with profiling.span("appearance.adam"):
                apply_updates_float(optimizer, params, grads)
        return loss, aux

    return train_step


@torch.no_grad()
def evaluate_appearance(avatar: MeshAvatar, params: AvatarParams,
                        test_dataset, test_camera_index,
                        active_sh_degree: int, white_bkgd: bool,
                        lpips_fn=None, tile_capacity: int = 512,
                        max_items: Optional[int] = None):
    """Held-out evaluation: every (test camera, frame) pair of
    ``test_dataset`` rendered through the tile path (``work_cap`` 0) on
    the device of ``params``; the mean L1 and PSNR against the masked GT
    (+ LPIPS when ``lpips_fn`` is given), as floats."""
    dev = params.verts_offset.device
    bg = torch.full((3,), 1.0 if white_bkgd else 0.0, device=dev)
    l1s, psnrs, lps = [], [], []
    pairs = [(ci, fi) for ci in range(len(test_dataset.camera_list))
             for fi in range(len(test_dataset.frame_index))]
    if max_items is not None:
        pairs = pairs[:max_items]
    for ci, fi in pairs:
        batch = test_dataset.load_frame(ci, fi)
        cam = batch["cam"]
        t = batch["frame_idx"]
        cam_idx = test_camera_index[batch["camera_idx"]]
        rendering, _ = render_avatar_frame(
            avatar, params, avatar.select_verts(params, t),
            avatar.tensor("ao_maps", dev)[t], cam, cam_idx,
            active_sh_degree, bg, white_bkgd, tile_capacity=tile_capacity)
        rendering = torch.clamp(rendering, 0.0, 1.0)
        gt_rgb = torch.as_tensor(batch["rgb"], device=dev)
        gt_msk = torch.as_tensor(batch["msk"], device=dev)
        gt = gt_rgb * gt_msk + (1.0 - gt_msk if white_bkgd else 0.0)
        l1s.append(float(l1_loss(rendering, gt)))
        psnrs.append(float(psnr(rendering, gt)))
        if lpips_fn is not None:
            lps.append(float(lpips_fn(rendering[None], gt[None])))
    out = {"l1": float(np.mean(l1s)), "psnr": float(np.mean(psnrs))}
    if lps:
        out["lpips"] = float(np.mean(lps))
    return out


def viewspace_gradients(avatar, params, timestep, cam, camera_idx, gt_rgb,
                        gt_msk, ao_map, active_sh_degree, white_bkgd,
                        tile_capacity=512):
    """Standalone view-space gradient probe: d(L1)/d(means2d), in pixels."""
    dev = params.verts_offset.device
    bg = torch.full((3,), 1.0 if white_bkgd else 0.0, device=dev)
    m2d = torch.zeros((params.splats.capacity, 2), device=dev,
                      requires_grad=True)
    verts = avatar.select_verts(params, timestep)
    rendering, _ = render_avatar_frame(
        avatar, params, verts, ao_map, cam, camera_idx, active_sh_degree,
        bg, white_bkgd, means2d_offset=m2d, tile_capacity=tile_capacity)
    gt = gt_rgb * gt_msk + (1.0 - gt_msk if white_bkgd else 0.0)
    (grad,) = torch.autograd.grad(l1_loss(rendering, gt), m2d)
    return grad
