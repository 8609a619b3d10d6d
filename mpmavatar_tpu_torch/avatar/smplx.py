"""SMPL-X body model on tensors (port of mpmavatar_tpu/avatar/smplx.py).

Loads the official SMPLX_*.npz directly and computes vertices, joints and
per-joint rigid transforms.  Full-pose layout (55 joints):
[global_orient, 21 body, jaw, leye, reye, 15 lhand, 15 rhand].
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from .. import resolve_device
from . import lbs

NUM_BODY_JOINTS = 21
NUM_HAND_JOINTS = 15


@dataclasses.dataclass(frozen=True)
class SMPLXModel:
    """Model constants from SMPLX_{gender}.npz, tensors on one device;
    ``parents`` is a static tuple of ints."""
    v_template: torch.Tensor      # (V, 3)
    shapedirs: torch.Tensor       # (V, 3, n_betas)
    expr_dirs: torch.Tensor       # (V, 3, n_expr)
    posedirs: torch.Tensor        # (P, V*3) pose blend basis
    j_regressor: torch.Tensor     # (J, V)
    lbs_weights: torch.Tensor     # (V, J)
    parents: tuple                # (J,) ints, parents[0] = -1
    faces: torch.Tensor           # (F, 3) int32
    hands_componentsl: Optional[torch.Tensor] = None  # (n_pca, 45)
    hands_componentsr: Optional[torch.Tensor] = None
    hands_meanl: Optional[torch.Tensor] = None        # (45,)
    hands_meanr: Optional[torch.Tensor] = None

    def to(self, device) -> "SMPLXModel":
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)})


def _parents(kintree_or_parents) -> tuple:
    """kintree_table[0] (or a parents array) as ints, the root as -1: the
    official archives mark it uint32(-1)."""
    return tuple(-1 if p >= 2 ** 31 else int(p)
                 for p in np.asarray(kintree_or_parents).astype(np.int64))


def load_smplx_npz(path: str, num_betas: int = 300, num_expr: int = 100,
                   use_pca: bool = False, num_pca_comps: int = 12,
                   device=None) -> SMPLXModel:
    """Load the official SMPL-X npz archive onto ``device`` (default: the
    CUDA device)."""
    device = resolve_device(device)
    data = np.load(path, allow_pickle=True)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    shapedirs_full = np.asarray(data["shapedirs"], np.float32)
    n_verts = len(data["v_template"])
    return SMPLXModel(
        v_template=f32(data["v_template"]),
        # SMPL-X packs 300 shape + 100 expression dirs along the last axis
        shapedirs=f32(shapedirs_full[:, :, :num_betas]),
        expr_dirs=f32(shapedirs_full[:, :, 300:300 + num_expr]),
        # the npz stores (V, 3, P); the lbs convention is (P, V*3)
        posedirs=f32(np.asarray(data["posedirs"], np.float32)
                     .reshape(n_verts * 3, -1).T),
        j_regressor=f32(data["J_regressor"]),
        lbs_weights=f32(data["weights"]),
        parents=_parents(data["kintree_table"][0] if "kintree_table" in data
                         else data["parents"]),
        faces=torch.as_tensor(np.asarray(data["f"], np.int64).astype(
            np.int32), device=device),
        hands_componentsl=f32(data["hands_componentsl"][:num_pca_comps])
        if use_pca else None,
        hands_componentsr=f32(data["hands_componentsr"][:num_pca_comps])
        if use_pca else None,
        hands_meanl=f32(data["hands_meanl"]) if "hands_meanl" in data
        else None,
        hands_meanr=f32(data["hands_meanr"]) if "hands_meanr" in data
        else None,
    )


@dataclasses.dataclass(frozen=True)
class SMPLXOutput:
    vertices: torch.Tensor       # (B, V, 3)
    joints: torch.Tensor         # (B, J, 3)
    v_shaped: torch.Tensor       # (B, V, 3)
    transform_mat: torch.Tensor  # (B, J, 4, 4)
    full_pose: torch.Tensor      # (B, J*3)


def smplx_forward(model: SMPLXModel, params: Dict[str, torch.Tensor],
                  use_pose_blendshapes: bool = True) -> SMPLXOutput:
    """SMPL-X forward and per-joint transforms (smplx.lbs.lbs).

    params keys: trans (B,3), orient (B,3), body_pose (B,63),
    beta (B,n_betas), expr (B,n_expr), jaw_pose/left_eye_pose/
    right_eye_pose (B,3), left_hand_pose/right_hand_pose (B,45, or
    (B,n_pca) if the model uses PCA), scale () or (B,).  Tensors on the
    model's device.
    """
    b = params["body_pose"].shape[0]
    dtype, device = model.v_template.dtype, model.v_template.device

    def get(name, dim):
        if params.get(name) is not None:
            return params[name].to(dtype)
        return torch.zeros((b, dim), dtype=dtype, device=device)

    n_joints = len(model.parents)
    segments = [get("orient", 3), params["body_pose"].to(dtype)]
    if n_joints == 1 + NUM_BODY_JOINTS + 3 + 2 * NUM_HAND_JOINTS:
        # full SMPL-X: jaw, eyes, hands (with optional PCA hand coding)
        lh = get("left_hand_pose", 45)
        rh = get("right_hand_pose", 45)
        if model.hands_componentsl is not None and \
                lh.shape[-1] == model.hands_componentsl.shape[0]:
            lh = model.hands_meanl[None] + lh @ model.hands_componentsl
            rh = model.hands_meanr[None] + rh @ model.hands_componentsr
        segments += [get("jaw_pose", 3), get("left_eye_pose", 3),
                     get("right_eye_pose", 3), lh, rh]
    full_pose = torch.cat(segments, dim=-1)

    shape_components = torch.cat(
        [get("beta", model.shapedirs.shape[-1]),
         get("expr", model.expr_dirs.shape[-1])], dim=-1)
    shapedirs = torch.cat([model.shapedirs, model.expr_dirs], dim=-1)
    v_shaped = model.v_template[None] + lbs.blend_shapes(shape_components,
                                                         shapedirs)
    joints = lbs.vertices2joints(model.j_regressor, v_shaped)

    rot_mats = lbs.batch_rodrigues(full_pose.reshape(-1, 3)).reshape(
        b, n_joints, 3, 3)

    if use_pose_blendshapes:
        eye = torch.eye(3, dtype=dtype, device=device)
        pose_feature = (rot_mats[:, 1:] - eye).reshape(b, -1)
        v_posed = v_shaped + (pose_feature @ model.posedirs).reshape(
            b, -1, 3)
    else:
        v_posed = v_shaped

    posed_joints, rel_tf = lbs.batch_rigid_transform(rot_mats, joints,
                                                     model.parents)
    t = torch.einsum("vj,bjxy->bvxy", model.lbs_weights, rel_tf)
    hom = torch.cat([v_posed, torch.ones_like(v_posed[..., :1])], dim=-1)
    verts = torch.einsum("bvac,bvc->bva", t, hom)[..., :3]

    trans = params.get("trans")
    if trans is not None:
        verts = verts + trans[:, None, :]
        posed_joints = posed_joints + trans[:, None, :]
    scale = params.get("scale")
    if scale is not None:
        scale = torch.as_tensor(scale, dtype=dtype,
                                device=device).reshape(-1, 1, 1)
        verts = verts * scale
        posed_joints = posed_joints * scale

    return SMPLXOutput(vertices=verts, joints=posed_joints,
                       v_shaped=v_shaped, transform_mat=rel_tf,
                       full_pose=full_pose)


def make_test_rig(n_joints=4, n_verts=64, seed=0, device=None) -> SMPLXModel:
    """A tiny synthetic articulated rig for tests (no SMPL-X data file is
    needed): the JAX package's rig, the same arrays for the same seed."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    v = rng.uniform(-0.5, 0.5, (n_verts, 3)).astype(np.float32)
    v[:, 1] = np.linspace(0, 1, n_verts)
    joints_y = np.linspace(0.0, 1.0, n_joints)
    jr = np.zeros((n_joints, n_verts), np.float32)
    for j in range(n_joints):
        d = np.abs(v[:, 1] - joints_y[j])
        jr[j] = np.exp(-20 * d)
        jr[j] /= jr[j].sum()
    w = np.zeros((n_verts, n_joints), np.float32)
    for i in range(n_verts):
        d = np.abs(joints_y - v[i, 1]) + 1e-3
        w[i] = d ** -2
        w[i] /= w[i].sum()
    faces = np.stack([np.arange(n_verts - 2), np.arange(1, n_verts - 1),
                      np.arange(2, n_verts)], -1).astype(np.int32)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    return SMPLXModel(
        v_template=t(v),
        shapedirs=t(rng.normal(0, 0.01, (n_verts, 3, 5))),
        expr_dirs=t(np.zeros((n_verts, 3, 2))),
        posedirs=t(rng.normal(0, 0.001,
                              ((n_joints - 1) * 9, n_verts * 3))),
        j_regressor=t(jr),
        lbs_weights=t(w),
        parents=tuple([-1] + list(range(n_joints - 1))),
        faces=torch.as_tensor(faces, device=device))
