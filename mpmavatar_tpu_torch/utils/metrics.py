"""Geometry evaluation metrics (host-side numpy and scipy), the port's
own copy of mpmavatar_tpu/utils/metrics.py: chamfer distance x1000 and
F-Score@tau over area-weighted surface samples."""

from __future__ import annotations

import numpy as np
from scipy.spatial import cKDTree


def sample_mesh_surface(verts, faces, count=100000, seed=0):
    """Area-weighted uniform surface samples + face normals."""
    verts = np.asarray(verts, np.float64)
    faces = np.asarray(faces, np.int64)
    v0, v1, v2 = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]
    cross = np.cross(v1 - v0, v2 - v0)
    area = 0.5 * np.linalg.norm(cross, axis=1)
    prob = area / area.sum()
    rng = np.random.default_rng(seed)
    fi = rng.choice(len(faces), size=count, p=prob)
    r1 = np.sqrt(rng.random(count))
    r2 = rng.random(count)
    a = 1 - r1
    b = r1 * (1 - r2)
    c = r1 * r2
    pts = a[:, None] * v0[fi] + b[:, None] * v1[fi] + c[:, None] * v2[fi]
    normals = cross[fi] / np.maximum(
        np.linalg.norm(cross[fi], axis=1, keepdims=True), 1e-12)
    return pts, normals


def nn_distances(src, dst):
    return cKDTree(dst).query(src)[0]


def chamfer_distance(points1, points2):
    """1000 * (mean d12^2 + mean d21^2) of the nearest-neighbour distances."""
    d12 = nn_distances(points1, points2)
    d21 = nn_distances(points2, points1)
    return 1000.0 * (np.mean(d12 ** 2) + np.mean(d21 ** 2))


def f_score(points1, points2, tau=1e-3):
    """Harmonic mean of precision/recall (in %) at squared
    threshold tau."""
    d12 = nn_distances(points1, points2)
    d21 = nn_distances(points2, points1)
    precision = np.mean((d12 ** 2 <= tau)) * 100.0
    recall = np.mean((d21 ** 2 <= tau)) * 100.0
    return (2 * precision * recall) / (precision + recall + 1e-9)


def all_mesh_metrics(verts1, faces1, verts2, faces2, sample_count=100000):
    """(F-Score@1e-3, chamfer x1000) from surface samples."""
    p1, _ = sample_mesh_surface(verts1, faces1, sample_count)
    p2, _ = sample_mesh_surface(verts2, faces2, sample_count)
    return f_score(p1, p2, 1e-3), chamfer_distance(p1, p2)
