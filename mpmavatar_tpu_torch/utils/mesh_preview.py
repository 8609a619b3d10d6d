"""Offscreen mesh preview (software z-buffer rasterizer, numpy; the port's
own copy of mpmavatar_tpu/utils/mesh_preview.py).

Replaces the reference's pyrender/EGL preview used for sim videos
(utils/render_utils.py:8-39): flat-shaded triangles with a headlight, no
GPU/GL dependency."""

from __future__ import annotations

import numpy as np

from .io import as_numpy


def render_mesh(verts, faces, cam, color=(0.7, 0.7, 0.9), bg=1.0):
    """Render (V,3)/(F,3) (numpy or tensors) under a
    ``render.cameras.Camera`` -> (H, W, 3) uint8."""
    w, h = cam.image_width, cam.image_height
    verts = as_numpy(verts).astype(np.float64)
    faces = as_numpy(faces).astype(np.int64)

    hom = np.concatenate([verts, np.ones((len(verts), 1))], 1)
    p_view = hom @ cam.world_view_transform.astype(np.float64)
    p_proj = hom @ cam.full_proj_transform.astype(np.float64)
    ndc = p_proj[:, :3] / np.maximum(p_proj[:, 3:4], 1e-7)
    px = ((ndc[:, 0] + 1) * w - 1) * 0.5
    py = ((ndc[:, 1] + 1) * h - 1) * 0.5
    depth = p_view[:, 2]

    # flat shading with a view-direction headlight
    tri = verts[faces]
    n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    n /= np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-12)
    view_dir = tri.mean(1) - cam.camera_center[None].astype(np.float64)
    view_dir /= np.maximum(np.linalg.norm(view_dir, axis=1, keepdims=True),
                           1e-12)
    shade = 0.25 + 0.75 * np.abs(np.einsum("fi,fi->f", n, view_dir))

    img = np.full((h, w, 3), bg, np.float64)
    zbuf = np.full((h, w), np.inf)
    xs = px[faces]
    ys = py[faces]
    zs = depth[faces]
    order = np.argsort(-zs.mean(1))  # far-to-near fallback for ties
    base = np.asarray(color, np.float64)
    for fi in order:
        if np.any(zs[fi] <= 0):
            continue
        x0, x1 = int(max(0, np.floor(xs[fi].min()))), \
            int(min(w - 1, np.ceil(xs[fi].max())))
        y0, y1 = int(max(0, np.floor(ys[fi].min()))), \
            int(min(h - 1, np.ceil(ys[fi].max())))
        if x1 < x0 or y1 < y0:
            continue
        gx, gy = np.meshgrid(np.arange(x0, x1 + 1), np.arange(y0, y1 + 1))
        ax, ay = xs[fi][0], ys[fi][0]
        d1x, d1y = xs[fi][1] - ax, ys[fi][1] - ay
        d2x, d2y = xs[fi][2] - ax, ys[fi][2] - ay
        det = d1x * d2y - d1y * d2x
        if abs(det) < 1e-12:
            continue
        rx, ry = gx - ax, gy - ay
        b1 = (rx * d2y - ry * d2x) / det
        b2 = (-rx * d1y + ry * d1x) / det
        inside = (b1 >= 0) & (b2 >= 0) & (b1 + b2 <= 1)
        if not inside.any():
            continue
        z = zs[fi][0] * (1 - b1 - b2) + zs[fi][1] * b1 + zs[fi][2] * b2
        yy, xx = gy[inside], gx[inside]
        zz = z[inside]
        closer = zz < zbuf[yy, xx]
        yy, xx, zz = yy[closer], xx[closer], zz[closer]
        zbuf[yy, xx] = zz
        img[yy, xx] = base * shade[fi]
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)
