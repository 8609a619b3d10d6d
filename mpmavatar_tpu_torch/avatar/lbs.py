"""Linear blend skinning primitives on tensors (port of
mpmavatar_tpu/avatar/lbs.py): Rodrigues, the rigid transform chain, blend
shapes, KNN weight transfer, forward and inverse LBS.

The functions work on tensors of any device.  ``transform_to_pose``,
``skinning_transforms`` and ``apply_transforms`` also take a leading batch
of poses on the transforms, so a pose sequence is posed in one call.
"""

from __future__ import annotations

import torch

from ..core.linalg import safe_norm

# rows of the KNN's squared-distance block are taken in chunks whose
# (rows, V, 3) difference tensor stays under this many bytes
KNN_BLOCK_BYTES = 256 * 2 ** 20


def batch_rodrigues(rot_vecs: torch.Tensor) -> torch.Tensor:
    """Axis-angle (N, 3) -> rotation matrices (N, 3, 3) (smplx.lbs)."""
    angle = safe_norm(rot_vecs + 1e-8, dim=-1, keepdim=True)
    rot_dir = rot_vecs / angle
    cos = torch.cos(angle)[..., None]
    sin = torch.sin(angle)[..., None]
    rx, ry, rz = rot_dir[..., 0], rot_dir[..., 1], rot_dir[..., 2]
    zeros = torch.zeros_like(rx)
    k = torch.stack([zeros, -rz, ry, rz, zeros, -rx, -ry, rx, zeros],
                    dim=-1).reshape(rot_vecs.shape[:-1] + (3, 3))
    eye = torch.eye(3, dtype=rot_vecs.dtype, device=rot_vecs.device)
    return eye + sin * k + (1.0 - cos) * (k @ k)


def blend_shapes(betas: torch.Tensor, shape_dirs: torch.Tensor
                 ) -> torch.Tensor:
    """(B, L) x (V, 3, L) -> (B, V, 3)."""
    return torch.einsum("bl,vcl->bvc", betas, shape_dirs)


def vertices2joints(j_regressor: torch.Tensor, vertices: torch.Tensor
                    ) -> torch.Tensor:
    """(J, V) x (B, V, 3) -> (B, J, 3)."""
    return torch.einsum("jv,bvc->bjc", j_regressor, vertices)


def batch_rigid_transform(rot_mats: torch.Tensor, joints: torch.Tensor,
                          parents) -> tuple[torch.Tensor, torch.Tensor]:
    """Forward-kinematics chain (smplx.lbs.batch_rigid_transform).

    rot_mats (B, J, 3, 3); joints (B, J, 3); parents (J,) with
    parents[0] = -1.  Returns (posed_joints (B, J, 3),
    rel_transforms (B, J, 4, 4)) where rel_transforms maps rest-pose
    points rigidly attached to each joint to their posed position.
    """
    parents = [int(p) for p in parents]
    b, j = joints.shape[:2]
    rel_joints = torch.cat(
        [joints[:, :1],
         joints[:, 1:] - joints[:, [max(p, 0) for p in parents[1:]]]], 1)

    top = torch.cat([rot_mats, rel_joints[..., None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=rot_mats.dtype,
                          device=rot_mats.device).expand(b, j, 1, 4)
    local = torch.cat([top, bottom], dim=-2)          # (B, J, 4, 4)
    chains = [local[:, 0]]
    for i in range(1, j):
        chains.append(chains[parents[i]] @ local[:, i])
    transforms = torch.stack(chains, dim=1)           # (B, J, 4, 4)
    posed_joints = transforms[..., :3, 3]

    # subtract the rest joint's contribution: A = G - pack(G @ [j; 0])
    joints_hom = torch.cat([joints, torch.zeros_like(joints[..., :1])], -1)
    init_bone = torch.einsum("bjac,bjc->bja", transforms, joints_hom)
    rel = torch.cat([transforms[..., :3, :3],
                     (transforms[..., :3, 3] - init_bone[..., :3])[..., None]],
                    dim=-1)
    return posed_joints, torch.cat([rel, transforms[..., 3:, :]], dim=-2)


def knn(points: torch.Tensor, verts: torch.Tensor, k: int,
        points_normals=None, verts_normals=None, normal_weight=0.1):
    """Squared-distance KNN by top-k (replaces pytorch3d's knn_points):
    points (P, 3), verts (V, 3) -> (d2 (P, k), idx (P, k)), nearest first.
    The (P, V) distance block is computed in row chunks of at most
    KNN_BLOCK_BYTES."""
    if points_normals is not None:
        points = torch.cat([points, normal_weight * points_normals], -1)
        verts = torch.cat([verts, normal_weight * verts_normals], -1)
    rows = max(1, KNN_BLOCK_BYTES // (verts.numel() * verts.element_size()))
    dists, idxs = [], []
    for p in torch.split(points, rows):
        d2 = torch.sum((p[:, None, :] - verts[None, :, :]) ** 2, dim=-1)
        neg, idx = torch.topk(-d2, k, dim=-1)
        dists.append(-neg)
        idxs.append(idx)
    return torch.cat(dists), torch.cat(idxs)


def shepard_weights(points, verts, k, p=2, points_normals=None,
                    verts_normals=None, normal_weight=0.1):
    """Inverse-distance-power weights over the KNN set:
    (weights (P, k), idx (P, k))."""
    dists, idx = knn(points, verts, k, points_normals, verts_normals,
                     normal_weight)
    w = torch.clamp_min(dists, 1e-8) ** (-p)
    return w / torch.sum(w, dim=-1, keepdim=True), idx


def skinning_transforms(weights: torch.Tensor, rel_transforms: torch.Tensor
                        ) -> torch.Tensor:
    """(P, J) x (..., J, 4, 4) -> per-point blended transforms
    (..., P, 4, 4)."""
    lead, j = rel_transforms.shape[:-3], rel_transforms.shape[-3]
    flat = rel_transforms.reshape(*lead, j, 16)
    return (weights @ flat).reshape(*lead, -1, 4, 4)


def apply_transforms(t: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """(..., P, 4, 4) x (..., P, 3) -> (..., P, 3)."""
    return torch.einsum("...pab,...pb->...pa", t[..., :3, :3], points) \
        + t[..., :3, 3]


def transform_to_t_pose(vertices, smplx_verts, rel_transforms,
                        lbs_weights_packed=None, lbs_w=None,
                        global_transl=None, scale=None, k=10,
                        v_normals=None, smplx_normals=None,
                        normal_weight=0.1):
    """Inverse LBS of one example: vertices (P, 3) posed points,
    smplx_verts (V, 3) the posed body, rel_transforms (J, 4, 4).
    Returns (t-pose points, T_inv, W)."""
    if lbs_w is None:
        pw, pidx = shepard_weights(vertices, smplx_verts, k=k, p=2,
                                   points_normals=v_normals,
                                   verts_normals=smplx_normals,
                                   normal_weight=normal_weight)
        w = torch.einsum("pkj,pk->pj", lbs_weights_packed[pidx], pw)
    else:
        w = lbs_w
    t_inv = torch.linalg.inv(skinning_transforms(w, rel_transforms))
    pts = vertices
    if scale is not None:
        pts = pts / scale
    if global_transl is not None:
        pts = pts - global_transl
    return apply_transforms(t_inv, pts), t_inv, w


def transform_to_pose(vertices, lbs_w, rel_transforms, global_transl=None,
                      scale=None):
    """Forward LBS of canonical points (P, 3) by rel_transforms
    (..., J, 4, 4); global_transl and scale broadcast against the
    (..., P, 3) result.  Returns (posed points, blended transforms)."""
    t = skinning_transforms(lbs_w, rel_transforms)
    out = apply_transforms(t, vertices)
    if global_transl is not None:
        out = out + global_transl
    if scale is not None:
        out = out * scale
    return out, t
