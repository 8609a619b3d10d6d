"""Camera model, the port's own copy of mpmavatar_tpu/render/cameras.py
(numpy only): intrinsics -> FoV, a D3D-style projection with
principal-point offset, and the transposed (row-vector) matrix layout the
3DGS rasterizer expects.  ``rasterizer.camera_arrays`` puts a Camera's
matrices on the device.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np


def fov2focal(fov, pixels):
    return pixels / (2 * math.tan(fov / 2))


def focal2fov(focal, pixels):
    return 2 * math.atan(pixels / (2 * focal))


@dataclasses.dataclass
class Camera:
    """Host-side camera; matrices are numpy.  ``world_view_transform`` /
    ``full_proj_transform`` are stored TRANSPOSED (row-vector
    convention)."""

    camera_id: str
    image_width: int
    image_height: int
    fx: float
    fy: float
    cx: float
    cy: float
    world_view_transform: np.ndarray   # (4,4) = w2c^T
    projection_matrix: np.ndarray      # (4,4) transposed
    full_proj_transform: np.ndarray    # (4,4) transposed
    camera_center: np.ndarray          # (3,)
    FoVx: float
    FoVy: float
    znear: float
    zfar: float

    @classmethod
    def from_kw2c(cls, camera_id, w, h, k, w2c, near=1.0, far=10.0):
        """scene/cameras.py:12-39."""
        k = np.asarray(k, np.float64)
        w2c = np.asarray(w2c, np.float64)
        fx, fy, cx, cy = k[0][0], k[1][1], k[0][2], k[1][2]
        world_view = w2c.T.astype(np.float32)
        proj = np.array([
            [2 * fx / w, 0.0, -(w - 2 * cx) / w, 0.0],
            [0.0, 2 * fy / h, -(h - 2 * cy) / h, 0.0],
            [0.0, 0.0, far / (far - near), -(far * near) / (far - near)],
            [0.0, 0.0, 1.0, 0.0]], np.float64).T
        full = (world_view.astype(np.float64) @ proj).astype(np.float32)
        cam_center = np.linalg.inv(world_view.astype(np.float64))[3, :3]
        return cls(
            camera_id=camera_id, image_width=w, image_height=h,
            fx=fx, fy=fy, cx=cx, cy=cy,
            world_view_transform=world_view,
            projection_matrix=proj.astype(np.float32),
            full_proj_transform=full,
            camera_center=cam_center.astype(np.float32),
            FoVx=focal2fov(fx, w), FoVy=focal2fov(fy, h),
            znear=near, zfar=far)

    @property
    def tanfovx(self):
        return math.tan(self.FoVx * 0.5)

    @property
    def tanfovy(self):
        return math.tan(self.FoVy * 0.5)


def spherical_camera_path(num_cams, center, radius, height, w, h, focal,
                          start_angle=0.0):
    """360-degree orbit path (utils/demo_utils.py:44-57 equivalent):
    cameras on a circle looking at ``center``."""
    cams = []
    center = np.asarray(center, np.float64)
    for i in range(num_cams):
        ang = start_angle + 2 * np.pi * i / num_cams
        eye = center + np.array([radius * np.cos(ang), height,
                                 radius * np.sin(ang)])
        forward = center - eye
        forward = forward / np.linalg.norm(forward)
        up = np.array([0.0, -1.0, 0.0])
        right = np.cross(up, forward)
        right /= np.linalg.norm(right)
        up2 = np.cross(forward, right)
        r_c2w = np.stack([right, up2, forward], 1)
        w2c = np.eye(4)
        w2c[:3, :3] = r_c2w.T
        w2c[:3, 3] = -r_c2w.T @ eye
        k = np.array([[focal, 0, w / 2], [0, focal, h / 2], [0, 0, 1]])
        cams.append(Camera.from_kw2c(f"orbit{i:03d}", w, h, k, w2c))
    return cams
