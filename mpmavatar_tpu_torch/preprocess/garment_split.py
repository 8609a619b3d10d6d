"""Garment / body mesh split with dilated joint band (host numpy).

Copy of mpmavatar_tpu/preprocess/garment_split.py (numpy only): splits the
tracked mesh into cloth vs human faces, expands a "joint band" by N ring
dilations around the boundary / fixed vertices, and emits the reordered
index maps with joint vertices/faces FIRST — the particle mover pins
exactly this prefix (mpm_solver.py:661-802, train_material_params.py:
243-244)."""

from __future__ import annotations

import numpy as np


def split_cloth_human(vertices: np.ndarray, faces: np.ndarray,
                      is_cloth_faces: np.ndarray,
                      fix_v: np.ndarray = None, iterations: int = 20):
    """Returns the split dict (same keys as split_idx.npz)."""
    faces = np.asarray(faces)
    is_cloth_faces = np.asarray(is_cloth_faces, bool)
    nv = len(vertices)
    nf = len(faces)
    v_idx = np.arange(nv)
    f_idx = np.arange(nf)

    def dilate_faces(seed_f_idx):
        cur = np.asarray(seed_f_idx)
        for _ in range(iterations):
            seed_verts = np.unique(faces[cur])
            shared = np.isin(faces, seed_verts).sum(axis=1)
            cur = np.where(shared > 1)[0]
        mask = np.zeros(nf, bool)
        mask[cur] = True
        return mask

    if fix_v is not None and len(fix_v) > 0:
        is_fix_faces = np.isin(faces, fix_v).any(axis=1)
        is_expanded_fix = dilate_faces(f_idx[is_fix_faces])
        is_human_faces = (~is_cloth_faces) | is_expanded_fix
    else:
        is_human_faces = ~is_cloth_faces
        is_cloth_faces = dilate_faces(f_idx[is_cloth_faces])

    cloth_faces = faces[is_cloth_faces]
    human_faces = faces[is_human_faces]
    is_joint_faces = is_cloth_faces & is_human_faces

    is_cloth_vertices = np.isin(v_idx, cloth_faces)
    is_human_vertices = np.isin(v_idx, human_faces) | ~is_cloth_vertices
    is_joint_vertices = is_cloth_vertices & is_human_vertices

    joint_v = v_idx[is_joint_vertices]
    cloth_only_v = v_idx[~is_human_vertices]
    human_only_v = v_idx[~is_cloth_vertices]
    joint_f = f_idx[is_joint_faces]
    cloth_only_f = f_idx[~is_human_faces]
    human_only_f = f_idx[~is_cloth_faces]

    reordered_cloth_v_idx = np.concatenate([joint_v, cloth_only_v])
    reordered_human_v_idx = np.concatenate([joint_v, human_only_v])
    reordered_cloth_f_idx = np.concatenate([joint_f, cloth_only_f])
    reordered_human_f_idx = np.concatenate([joint_f, human_only_f])

    cloth_map = np.full(nv, -1, np.int64)
    cloth_map[reordered_cloth_v_idx] = np.arange(len(reordered_cloth_v_idx))
    human_map = np.full(nv, -1, np.int64)
    human_map[reordered_human_v_idx] = np.arange(len(reordered_human_v_idx))

    return {
        "num_joint_v": len(joint_v),
        "num_joint_f": len(joint_f),
        "reordered_cloth_v_idx": reordered_cloth_v_idx.astype(np.int32),
        "reordered_cloth_f_idx": reordered_cloth_f_idx.astype(np.int32),
        "reordered_human_v_idx": reordered_human_v_idx.astype(np.int32),
        "reordered_human_f_idx": reordered_human_f_idx.astype(np.int32),
        "new_cloth_faces": cloth_map[faces[reordered_cloth_f_idx]].astype(
            np.int32),
        "new_human_faces": human_map[faces[reordered_human_f_idx]].astype(
            np.int32),
    }


def save_split(filename: str, split: dict):
    np.savez(filename, **split)
