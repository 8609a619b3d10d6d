"""Mesh subdivision utilities (hand-region refinement), numpy; the
port's own copy of mpmavatar_tpu/avatar/subdivide.py.

Port of the reference's SmplxDeformer.subdivide_mesh
(utils/smplx_deformer.py:459-496) without trimesh: the
faces whose vertices are dominated by selected bones (hands) are
midpoint-subdivided; all attributes (positions, lbs weights) are averaged
onto the new edge-midpoint vertices."""

from __future__ import annotations

import numpy as np


def _unique_edges(faces):
    edges = np.sort(np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]],
                                    faces[:, [2, 0]]], 0), axis=1)
    uniq, inverse = np.unique(edges, axis=0, return_inverse=True)
    return uniq, inverse


def subdivide_faces(verts, faces, attrs=None, iterations=1):
    """Midpoint-subdivide ``faces``; returns (new_verts, new_faces,
    new_attrs) with attrs linearly interpolated on edge midpoints."""
    verts = np.asarray(verts, np.float64)
    faces = np.asarray(faces, np.int64)
    attrs = dict(attrs or {})
    for _ in range(iterations):
        uniq, inverse = _unique_edges(faces)
        num_v = len(verts)
        # edge order within _unique_edges concat: [e01 | e12 | e20]
        inv = inverse.reshape(3, -1).T   # (F, 3): mid01, mid12, mid20
        mid01 = inv[:, 0] + num_v
        mid12 = inv[:, 1] + num_v
        mid20 = inv[:, 2] + num_v
        mids = 0.5 * (verts[uniq[:, 0]] + verts[uniq[:, 1]])
        verts = np.concatenate([verts, mids], 0)
        for k in attrs:
            a = np.asarray(attrs[k])
            attrs[k] = np.concatenate(
                [a, 0.5 * (a[uniq[:, 0]] + a[uniq[:, 1]])], 0)
        faces = np.column_stack([
            faces[:, 0], mid01, mid20,
            mid01, faces[:, 1], mid12,
            mid20, mid12, faces[:, 2],
            mid01, mid12, mid20,
        ]).reshape(-1, 3)
    return verts, faces, attrs


def subdivide_hand_region(verts, faces, lbs_weights, hand_bone_slice,
                          iterations=1, dominance=0.5):
    """Subdivide only the faces dominated by the given bone columns
    (smplx_deformer.py:459-496 selects w[:, :3].sum() > 0.5; pass the
    appropriate slice for the hand bones of your model).

    Returns (verts, faces, lbs_weights)."""
    verts = np.asarray(verts)
    faces = np.asarray(faces, np.int64)
    w = np.asarray(lbs_weights)
    v_sel = np.where(w[:, hand_bone_slice].sum(axis=1) > dominance)[0]
    face_mask = np.isin(faces, v_sel).all(axis=1)
    sub_v, sub_f, attrs = subdivide_faces(verts, faces[face_mask],
                                          {"w": w}, iterations)
    new_faces = np.vstack([faces[~face_mask], sub_f])
    return sub_v, new_faces, attrs["w"]
