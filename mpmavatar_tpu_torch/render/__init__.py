"""Rendering, port of mpmavatar_tpu/render: 3DGS splatting (K6 on the
card) + SH shading + quasi-shadow.

``render()`` mirrors the JAX package's entry point, with the
``override_color`` and ``extra``-gaussians paths the demo uses."""

from __future__ import annotations

from typing import Optional

import torch

from . import gaussians as G
from .cameras import Camera, spherical_camera_path  # noqa: F401
from .geometry import compute_face_orientation  # noqa: F401
from .rasterizer import CameraArrays, camera_arrays, rasterize  # noqa: F401
from .sh import eval_sh, rgb2sh, sh2rgb  # noqa: F401
from .shadow import (grid_sample_bilinear, init_shadow_unet,  # noqa: F401
                     shadow_unet_apply)


def convert_sh_colors(features, positions, cam_center, active_sh_degree):
    """SH -> clamped RGB toward the camera.  features: (N, (deg+1)^2, 3)."""
    dirs = positions - cam_center[None, :]
    dirs = dirs / torch.clamp_min(
        torch.linalg.vector_norm(dirs, dim=-1, keepdim=True), 1e-12)
    shs = features.transpose(1, 2)  # (N, 3, coeffs)
    rgb = eval_sh(active_sh_degree, shs, dirs)
    return torch.clamp_min(rgb + 0.5, 0.0)


def render(cam: Camera, params: G.GaussianParams,
           frames: Optional[G.FaceFrames], bg_color,
           active_sh_degree: int = 0, scaling_modifier: float = 1.0,
           override_color=None, extra=None, means2d_offset=None,
           tile_capacity: int = 512, tile_capacity_lo: int = 0,
           hot_tiles: int = 0):
    """Render ``params`` (bound to ``frames`` when given) from ``cam`` on
    the device of ``params``.

    ``extra`` = (xyz, colors, opacity, cov3d) of world-space gaussians
    appended at render time (demo props, sand).  Returns dict(render,
    alpha, mask, radii, depth, ...)."""
    device = params.xyz.device
    ca = camera_arrays(cam, device)
    xyz = G.get_xyz(params, frames)
    opacity = G.get_opacity(params)[:, 0] * params.alive
    cov3d = G.get_covariance(params, frames, scaling_modifier)

    if override_color is None:
        colors = convert_sh_colors(G.get_features(params), xyz,
                                   ca.cam_center, active_sh_degree)
    else:
        colors = override_color

    if extra is not None:
        extra_xyz, extra_colors, extra_opacity, extra_cov3d = extra
        xyz = torch.cat([xyz, extra_xyz], 0)
        colors = torch.cat([colors, extra_colors], 0)
        opacity = torch.cat([opacity, extra_opacity.reshape(-1)], 0)
        cov3d = torch.cat([cov3d, extra_cov3d], 0)
        if means2d_offset is not None:
            means2d_offset = torch.cat(
                [means2d_offset, torch.zeros((extra_xyz.shape[0], 2),
                                             dtype=xyz.dtype,
                                             device=device)], 0)

    out = rasterize(xyz, colors, opacity, cov3d, ca,
                    torch.as_tensor(bg_color, dtype=torch.float32,
                                    device=device),
                    width=cam.image_width, height=cam.image_height,
                    means2d_offset=means2d_offset,
                    tile_capacity=tile_capacity,
                    tile_capacity_lo=tile_capacity_lo,
                    hot_tiles=hot_tiles)
    out["mask"] = out["alpha"]
    return out
