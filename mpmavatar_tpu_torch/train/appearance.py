"""Stage-2 appearance: the avatar render of training and evaluation, port
of mpmavatar_tpu/train/appearance.py (``shaded_colors`` and
``render_avatar_frame``).  The train step, its losses, the optimizer and
densification belong to the stage-2 training slice and are not ported
yet.
"""

from __future__ import annotations

import torch

from ..render import (camera_arrays, convert_sh_colors, grid_sample_bilinear,
                      rasterize, shadow_unet_apply)
from ..render import gaussians as G
from ..render.avatar_model import AvatarParams, MeshAvatar


def shaded_colors(avatar: MeshAvatar, params: AvatarParams, frames,
                  ao_map, cam_center, xyz, active_sh_degree: int):
    """ShadowUNet(AO) -> per-face shadow -> shadow * SH colour."""
    shadow_map = shadow_unet_apply(params.shadow, ao_map[None])["shadow_map"]
    shadow = grid_sample_bilinear(
        shadow_map[0], avatar.tensor("uv_coord", xyz.device))   # (F, 1)
    shadow_per_gauss = shadow[params.splats.binding]
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
    out = rasterize(xyz, colors, opacity, cov3d, ca,
                    torch.as_tensor(bg, dtype=torch.float32,
                                    device=verts.device),
                    width=width, height=height,
                    means2d_offset=means2d_offset,
                    tile_capacity=tile_capacity, work_cap=work_cap,
                    chunk=chunk)
    rendering = out["render"] * torch.exp(
        params.cam_m[camera_idx])[:, None, None] \
        + params.cam_c[camera_idx][:, None, None]
    rendering = rendering * out["alpha"]
    if white_bkgd:
        rendering = rendering + (1.0 - out["alpha"])
    return rendering, out
