"""Plain posing: the SMPL-X forward, inverse skinning of the tracked
garment with KNN-transferred weights, and forward skinning through a
pose sequence (SMPL-X's ``lbs``; MPMAvatar's ``SmplxDeformer``)."""

from __future__ import annotations

import torch

from .arith import Arith


def rodrigues(rv: torch.Tensor) -> torch.Tensor:
    """Axis-angle (N, 3) -> (N, 3, 3); the angle of rv + 1e-8, as
    SMPL-X's ``batch_rodrigues``."""
    angle = torch.sqrt(((rv + 1e-8) ** 2).sum(-1, keepdim=True))
    k = rv / angle
    kx, ky, kz = k.unbind(-1)
    zero = torch.zeros_like(kx)
    km = torch.stack([zero, -kz, ky, kz, zero, -kx, -ky, kx, zero],
                     -1).reshape(-1, 3, 3)
    eye = torch.eye(3, dtype=rv.dtype, device=rv.device)
    s, c = torch.sin(angle)[..., None], torch.cos(angle)[..., None]
    return eye + s * km + (1.0 - c) * (km @ km)


def smplx(body: dict, params: dict, ar: Arith):
    """(vertices (B, V, 3), per-joint transforms relative to the rest
    pose (B, J, 4, 4)) for a batch of parameters."""
    b = params["body_pose"].shape[0]
    dev = body["v_template"].device
    nj = len(body["parents"])
    zeros = lambda n: torch.zeros((b, n), device=dev)
    pose = torch.cat([params.get("orient", zeros(3)), params["body_pose"]],
                     -1)
    if pose.shape[1] < 3 * nj:      # jaw, eyes and hands at rest
        pose = torch.cat([pose, zeros(3 * nj - pose.shape[1])], -1)
    n_beta, n_expr = body["shapedirs"].shape[-1], body["expr_dirs"].shape[-1]
    coeffs = torch.cat([params.get("beta", zeros(n_beta)),
                        params.get("expr", zeros(n_expr))], -1)
    dirs = torch.cat([body["shapedirs"], body["expr_dirs"]], -1)
    v_shaped = body["v_template"][None] + ar.einsum("bl,vcl->bvc", coeffs,
                                                    dirs)
    joints = ar.einsum("jv,bvc->bjc", body["j_regressor"], v_shaped)
    rot = rodrigues(pose.reshape(-1, 3)).reshape(b, nj, 3, 3)
    eye = torch.eye(3, device=dev)
    feat = (rot[:, 1:] - eye).reshape(b, -1)
    v_posed = v_shaped + (ar.r(feat) @ ar.r(body["posedirs"])).reshape(
        b, -1, 3)

    parents = body["parents"]
    rel = joints.clone()
    rel[:, 1:] = joints[:, 1:] - joints[:, [max(p, 0) for p in parents[1:]]]
    local = torch.zeros((b, nj, 4, 4), device=dev)
    local[..., :3, :3] = rot
    local[..., :3, 3] = rel
    local[..., 3, 3] = 1.0
    world = [local[:, 0]]
    for j in range(1, nj):
        world.append(ar.r(world[parents[j]]) @ ar.r(local[:, j]))
    world = torch.stack(world, 1)
    # remove the rest joint: A = G - [0 | G[:3,:3] j]
    corr = ar.einsum("bjac,bjc->bja", world[..., :3, :3], joints)
    tf = world.clone()
    tf[..., :3, 3] = world[..., :3, 3] - corr
    blend = ar.einsum("vj,bjxy->bvxy", body["lbs_weights"], tf)
    verts = ar.einsum("bvac,bvc->bva", blend[..., :3, :3], v_posed) \
        + blend[..., :3, 3]
    if params.get("trans") is not None:
        verts = verts + params["trans"][:, None, :]
    return verts, tf


def knn_weights(points, verts, k: int, chunk: int = 4096):
    """Inverse-squared-distance weights over the k nearest ``verts`` of
    each point: (weights (P, k), indices (P, k))."""
    ws, ids = [], []
    for p in torch.split(points, chunk):
        d2 = ((p[:, None, :] - verts[None]) ** 2).sum(-1)
        dk, ik = torch.topk(d2, k, dim=1, largest=False)
        w = torch.clamp_min(dk, 1e-8) ** -2
        ws.append(w / w.sum(1, keepdim=True))
        ids.append(ik)
    return torch.cat(ws), torch.cat(ids)


def repose(body: dict, first: dict, poses: dict, cloth, k: int, ar: Arith):
    """The tracked garment ``cloth`` (V, 3), fitted by ``first``, carried
    through every pose: (cloth per pose (T, V, 3), body per pose
    (T, Vb, 3))."""
    body0, tf0 = smplx(body, first, ar)
    w, idx = knn_weights(cloth, body0[0], k)
    lbs = (body["lbs_weights"][idx] * w[..., None]).sum(1)      # (V, J)
    t0 = ar.einsum("vj,jxy->vxy", lbs, tf0[0])
    canon = cloth
    if first.get("trans") is not None:
        canon = canon - first["trans"][0]
    canon = torch.linalg.solve(t0, torch.cat(
        [canon, torch.ones_like(canon[:, :1])], -1)[..., None])[:, :3, 0]
    bodies, tfs = smplx(body, poses, ar)
    blend = ar.einsum("vj,bjxy->bvxy", lbs, tfs)
    out = ar.einsum("bvac,vc->bva", blend[..., :3, :3], canon) \
        + blend[..., :3, 3]
    if poses.get("trans") is not None:
        out = out + poses["trans"][:, None, :]
    return out, bodies
