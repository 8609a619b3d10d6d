"""Tracked-mesh cleaning for the tracking stage.

Copy of mpmavatar_tpu/preprocess/mesh_cleaning.py (numpy only): drop
near-black faces from the reconstruction, reset opacities, and compact
away unused vertices."""

from __future__ import annotations

import numpy as np


def clean_mesh(verts, faces, rgb_colors, color_threshold: float = 0.001):
    """Remove faces whose fitted color is ~black (reconstruction ghosts),
    then drop unreferenced vertices.

    Returns (verts, faces, keep_face_mask, vertex_remap)."""
    verts = np.asarray(verts)
    faces = np.asarray(faces)
    rgb = np.asarray(rgb_colors)
    keep = ~np.all(rgb < color_threshold, axis=-1)
    faces = faces[keep]

    used = np.unique(faces)
    remap = np.full(len(verts), -1, np.int64)
    remap[used] = np.arange(len(used))
    return verts[used], remap[faces], keep, remap
