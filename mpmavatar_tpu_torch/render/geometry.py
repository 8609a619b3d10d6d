"""Quaternion / rotation / face-frame geometry, port of
mpmavatar_tpu/render/geometry.py.

Quaternion convention: wxyz (like 3DGS).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.linalg import cross, safe_norm, safe_normalize


def quat_normalize(q):
    return q / torch.clamp_min(safe_norm(q, dim=-1, keepdim=True), 1e-12)


def quat_to_rotmat(q):
    """(..., 4) wxyz -> (..., 3, 3)."""
    q = quat_normalize(q)
    r, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    row0 = torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - r * z),
                        2 * (x * z + r * y)], -1)
    row1 = torch.stack([2 * (x * y + r * z), 1 - 2 * (x * x + z * z),
                        2 * (y * z - r * x)], -1)
    row2 = torch.stack([2 * (x * z - r * y), 2 * (y * z + r * x),
                        1 - 2 * (x * x + y * y)], -1)
    return torch.stack([row0, row1, row2], -2)


def rotmat_to_quat(m):
    """(..., 3, 3) -> (..., 4) wxyz, branchless Shepperd's method."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22

    def sq(x):
        return torch.sqrt(torch.clamp_min(x, 1e-12))

    qw0 = sq(1.0 + tr) / 2
    c0 = torch.stack([qw0, (m21 - m12) / (4 * qw0), (m02 - m20) / (4 * qw0),
                      (m10 - m01) / (4 * qw0)], -1)
    qx1 = sq(1.0 + m00 - m11 - m22) / 2
    c1 = torch.stack([(m21 - m12) / (4 * qx1), qx1, (m01 + m10) / (4 * qx1),
                      (m02 + m20) / (4 * qx1)], -1)
    qy2 = sq(1.0 - m00 + m11 - m22) / 2
    c2 = torch.stack([(m02 - m20) / (4 * qy2), (m01 + m10) / (4 * qy2), qy2,
                      (m12 + m21) / (4 * qy2)], -1)
    qz3 = sq(1.0 - m00 - m11 + m22) / 2
    c3 = torch.stack([(m10 - m01) / (4 * qz3), (m02 + m20) / (4 * qz3),
                      (m12 + m21) / (4 * qz3), qz3], -1)

    cond0 = (tr > 0)[..., None]
    cond1 = ((m00 >= m11) & (m00 >= m22))[..., None]
    cond2 = (m11 >= m22)[..., None]
    q = torch.where(cond0, c0,
                    torch.where(cond1, c1, torch.where(cond2, c2, c3)))
    return quat_normalize(q)


def quat_multiply(a, b):
    """Hamilton product, wxyz convention."""
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], -1)


def compute_face_orientation(verts, faces, return_scale=True):
    """Face frame + isotropic face scale.

    Columns of the orientation matrix: (edge dir, normal, in-plane)."""
    v0 = verts[faces[:, 0]]
    v1 = verts[faces[:, 1]]
    v2 = verts[faces[:, 2]]

    a0 = safe_normalize(v1 - v0)
    a1 = safe_normalize(cross(a0, v2 - v0))
    a2 = -safe_normalize(cross(a1, a0))
    orientation = torch.stack([a0, a1, a2], dim=-1)
    if not return_scale:
        return orientation
    s0 = safe_norm(v1 - v0, dim=-1, keepdim=True)
    s1 = torch.abs(torch.sum(a2 * (v2 - v0), -1, keepdim=True))
    return orientation, (s0 + s1) / 2


def build_scaling_rotation(s, q):
    """L = R(q) @ diag(s)."""
    return quat_to_rotmat(q) * s[..., None, :]


def covariance_from_scaling_rotation(scaling, scaling_modifier, q):
    """Full 3x3 covariance L L^T (an elementwise product and sum: a
    batched 3x3 matmul runs as GEMM launches on the card)."""
    l = build_scaling_rotation(scaling_modifier * scaling, q)
    return torch.sum(l[..., :, None, :] * l[..., None, :, :], -1)


def vertex_normals(verts, faces):
    """Area-weighted outward vertex normals."""
    faces = faces.long()
    fn = cross(verts[faces[:, 1]] - verts[faces[:, 0]],
               verts[faces[:, 2]] - verts[faces[:, 0]])
    vn = torch.zeros_like(verts)
    for i in range(3):
        vn = vn.index_add(0, faces[:, i], fn)
    return safe_normalize(vn)


def find_adjacent_faces(faces_np):
    """For each face, its 3 edge-adjacent faces (itself where a face has
    fewer); host-side numpy, called once at setup."""
    edges = {}
    faces_np = np.asarray(faces_np)
    for fi, (a, b, c) in enumerate(faces_np):
        for e in ((a, b), (b, c), (c, a)):
            key = (min(e), max(e))
            edges.setdefault(key, []).append(fi)
    neighbors = np.tile(np.arange(len(faces_np))[:, None], (1, 3))
    fill = np.zeros(len(faces_np), int)
    for fl in edges.values():
        if len(fl) == 2:
            f0, f1 = fl
            if fill[f0] < 3:
                neighbors[f0, fill[f0]] = f1
                fill[f0] += 1
            if fill[f1] < 3:
                neighbors[f1, fill[f1]] = f0
                fill[f1] += 1
    return neighbors
