"""Every input the benchmark hands to the program and to the reference,
made from ``--seed``.

The generators are frozen copies of the port's own (``core/types.py``
``build_cloth`` / ``build_body_sphere``, ``sim/pose_playback.py``
``write_body_npz`` / ``make_poses``, ``data/make_demo_assets.py``,
``train/demo.py::get_sand``): the program may change its copies, the
yardstick may not move.  The large random arrays are drawn on the device
with a seeded ``torch.Generator`` in a few calls; the deterministic
meshes are built with numpy and moved once.  A scene is a dict of
tensors that both sides read: the program gets them wrapped in its own
types, the reference reads them as they are.
"""

from __future__ import annotations

import numpy as np
import torch

# sub-streams of one seed, so that a part's draws do not depend on another
# part's sizes
_STREAMS = {"body": 1, "poses": 2, "sand": 3, "params": 4, "rig": 5}


def generator(seed: int, part: str, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) * 1_000_003 + _STREAMS[part]) % 2 ** 63)
    return gen


def _normal(gen, shape, std, device):
    return torch.randn(shape, generator=gen, device=device) * std


def flat_cloth(nx: int, y0: float, extent: float):
    """``core/types.py::build_cloth``: an nx x nx vertex cloth at height
    y0 centred over x = z = 1.  (verts (V, 3) f32, faces (E, 3) int32)."""
    xs = np.linspace(1.0 - extent / 2, 1.0 + extent / 2, nx)
    verts = np.stack(np.meshgrid(xs, xs, indexing="ij"), -1).reshape(-1, 2)
    verts = np.stack([verts[:, 0], np.full(len(verts), y0), verts[:, 1]],
                     -1).astype(np.float32)
    idx = np.arange(nx * nx).reshape(nx, nx)
    a, b = idx[:-1, :-1].ravel(), idx[:-1, 1:].ravel()
    c, d = idx[1:, :-1].ravel(), idx[1:, 1:].ravel()
    faces = np.concatenate([np.stack([a, b, c], -1),
                            np.stack([b, d, c], -1)], 0).astype(np.int32)
    return verts, faces


def uv_sphere(n_theta: int, n_phi: int, center=(0.0, 0.0, 0.0),
              r: float = 1.0):
    """``core/types.py::build_body_sphere``."""
    th = np.linspace(0, np.pi, n_theta)
    ph = np.linspace(0, 2 * np.pi, n_phi, endpoint=False)
    tt, pp = np.meshgrid(th, ph, indexing="ij")
    pts = np.stack([np.sin(tt) * np.cos(pp), np.cos(tt),
                    np.sin(tt) * np.sin(pp)], -1) * r + np.asarray(center)
    idx = np.arange(n_theta * n_phi).reshape(n_theta, n_phi)
    a, b = idx[:-1, :].ravel(), idx[1:, :].ravel()
    c = idx[:-1, np.r_[1:n_phi, 0]].ravel()
    d = idx[1:, np.r_[1:n_phi, 0]].ravel()
    faces = np.concatenate([np.stack([a, b, c], -1),
                            np.stack([c, b, d], -1)], 0).astype(np.int32)
    return pts.reshape(-1, 3).astype(np.float32), faces


def _pack_body(v, shapedirs, posedirs, j_regressor, weights, parents,
               faces, num_betas):
    """The body as ``avatar/smplx.py::load_smplx_npz`` lays it out:
    shape and expression directions split, posedirs (P, V*3)."""
    n = v.shape[0]
    return {"v_template": v,
            "shapedirs": shapedirs[:, :, :num_betas].contiguous(),
            "expr_dirs": shapedirs[:, :, num_betas:].contiguous(),
            "posedirs": posedirs.reshape(n * 3, -1).T.contiguous(),
            "j_regressor": j_regressor, "lbs_weights": weights,
            "parents": tuple(int(p) for p in parents), "faces": faces}


def torso_body(spec: dict, seed: int, device) -> dict:
    """``sim/pose_playback.py::write_body_npz`` on the device: the closed
    torso ellipsoid in SMPL-X's layout (55 joints, 400 shape and 486 pose
    directions), wound outward; joint sites inside it, ``J_regressor``
    normalised bumps around them, skinning weights the normalised inverse
    squared distances to the 4 nearest sites."""
    gen = generator(seed, "body", device)
    nj = spec["joints"]
    unit, faces = uv_sphere(spec["n_theta"], spec["n_phi"])
    radii = torch.tensor(spec["radii"], device=device)
    center = torch.tensor(spec["center"], device=device)
    v = torch.as_tensor(unit, device=device) * radii + center
    dirs = torch.randn((nj, 3), generator=gen, device=device)
    dirs = dirs / dirs.norm(dim=1, keepdim=True)
    depth = 0.7 * torch.rand((nj, 1), generator=gen,
                             device=device) ** (1.0 / 3.0)
    sites = center + dirs * depth * radii
    sites[0] = center
    parents = [-1] + [int(p) for p in (
        torch.rand(nj - 1, generator=gen, device=device)
        * torch.arange(1, nj, device=device)).floor().long().tolist()]
    d2 = ((v[None] - sites[:, None]) ** 2).sum(-1)              # (J, V)
    bumps = torch.exp(-d2 / (2.0 * spec["bump"] ** 2))
    j_regressor = bumps / bumps.sum(1, keepdim=True)
    near = torch.topk(d2, 4, dim=0, largest=False).indices      # (4, V)
    cols = torch.arange(v.shape[0], device=device)[None].expand(4, -1)
    weights = torch.zeros((v.shape[0], nj), device=device)
    weights[cols, near] = 1.0 / torch.clamp_min(d2[near, cols], 1e-6)
    weights = weights / weights.sum(1, keepdim=True)
    n_dirs = spec["num_betas"] + spec["num_expr"]
    shapedirs = _normal(gen, (v.shape[0], 3, n_dirs), spec["dir_std"],
                        device)
    posedirs = _normal(gen, (v.shape[0], 3, (nj - 1) * 9), spec["dir_std"],
                       device)
    faces = torch.as_tensor(faces[:, [0, 2, 1]].astype(np.int32),
                            device=device)
    return _pack_body(v, shapedirs, posedirs, j_regressor, weights, parents,
                      faces, spec["num_betas"])


def walk_poses(spec: dict, n_poses: int, seed: int, device):
    """``sim/pose_playback.py::make_poses`` with the walk's length and
    step sizes as parameters: the first fit is the rest pose with small
    seeded shape and expression coefficients; pose k turns the root by k
    ``root_turn`` about the vertical axis, raises trans by k ``rise`` and
    walks the body pose by k seeded offsets of ``pose_sigma`` (all per
    pose).  Returns (first, poses), dicts of tensors."""
    gen = generator(seed, "poses", device)
    beta = _normal(gen, (1, spec["num_betas"]), 0.1, device)
    expr = _normal(gen, (1, spec["num_expr"]), 0.1, device)
    first = {"body_pose": torch.zeros((1, 63), device=device),
             "orient": torch.zeros((1, 3), device=device),
             "trans": torch.zeros((1, 3), device=device),
             "beta": beta, "expr": expr}
    k = torch.arange(n_poses, dtype=torch.float32, device=device)
    offsets = _normal(gen, (n_poses, 63), spec["pose_sigma"], device)
    offsets[0] = 0.0
    zero = torch.zeros_like(k)
    poses = {"body_pose": torch.cumsum(offsets, 0),
             "orient": torch.stack([zero, spec["root_turn"] * k, zero], -1),
             "trans": torch.stack([zero, spec["rise"] * k, zero], -1),
             "beta": beta.expand(n_poses, -1).contiguous(),
             "expr": expr.expand(n_poses, -1).contiguous()}
    return first, poses


def capsule(n_theta: int, n_phi: int, radius=0.22, height=1.3,
            center=(0.0, 0.75, 0.0)):
    """``data/make_demo_assets.py::capsule_body``."""
    th = np.linspace(1e-3, np.pi - 1e-3, n_theta)
    ph = np.linspace(0, 2 * np.pi, n_phi, endpoint=False)
    tt, pp = np.meshgrid(th, ph, indexing="ij")
    v = np.stack([radius * np.sin(tt) * np.cos(pp),
                  0.5 * height * np.cos(tt),
                  radius * np.sin(tt) * np.sin(pp)], -1)
    v = v.reshape(-1, 3) + np.asarray(center)
    idx = np.arange(n_theta * n_phi).reshape(n_theta, n_phi)
    a, b = idx[:-1, :].ravel(), idx[1:, :].ravel()
    c = idx[:-1, np.r_[1:n_phi, 0]].ravel()
    d = idx[1:, np.r_[1:n_phi, 0]].ravel()
    f = np.concatenate([np.stack([a, b, c], -1),
                        np.stack([c, b, d], -1)], 0).astype(np.int32)
    return v.astype(np.float32), f


def skirt(n_u: int, n_v: int, r_top=0.26, r_bot=0.5, y_top=0.9,
          y_bot=0.15):
    """``data/make_demo_assets.py::skirt_cloth``: an open-cylinder skirt,
    top ring first."""
    us = np.linspace(0, 2 * np.pi, n_u, endpoint=False)
    fr = np.linspace(0.0, 1.0, n_v)
    verts = np.zeros((n_v, n_u, 3), np.float32)
    rr = r_top + (r_bot - r_top) * fr[:, None] ** 1.3
    verts[..., 0] = rr * np.cos(us)[None]
    verts[..., 1] = (y_top + (y_bot - y_top) * fr)[:, None]
    verts[..., 2] = rr * np.sin(us)[None]
    verts = verts.reshape(-1, 3)
    idx = np.arange(n_v * n_u).reshape(n_v, n_u)
    a, b = idx[:-1, :].ravel(), idx[1:, :].ravel()
    c = idx[:-1, np.r_[1:n_u, 0]].ravel()
    d = idx[1:, np.r_[1:n_u, 0]].ravel()
    faces = np.concatenate([np.stack([a, b, c], -1),
                            np.stack([c, b, d], -1)], 0).astype(np.int32)
    return verts, faces


def chair_box(center=(0.0, 0.25, -0.55), size=(0.6, 0.5, 0.5)):
    """``data/make_demo_assets.py::chair_box``: 8 corners, 12 faces."""
    c, s = np.asarray(center), np.asarray(size) / 2
    corners = np.array([[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1)
                        for sz in (-1, 1)], np.float32) * s + c
    quads = [(0, 1, 3, 2), (4, 6, 7, 5), (0, 4, 5, 1), (2, 3, 7, 6),
             (0, 2, 6, 4), (1, 5, 7, 3)]
    faces = [f for q in quads for f in ([q[0], q[1], q[2]],
                                        [q[0], q[2], q[3]])]
    return corners.astype(np.float32), np.asarray(faces, np.int32)


def demo_rig(spec: dict, seed: int, device) -> dict:
    """``data/make_demo_assets.py::make_rig_npz`` on the device: the
    capsule's first ``verts`` vertices, joints along the y axis,
    distance-falloff regressor and skinning weights, seeded shape and
    pose directions."""
    gen = generator(seed, "rig", device)
    v_np, f_np = capsule(*spec["capsule"])
    n, nj = min(spec["verts"], len(v_np)), spec["joints"]
    v = torch.as_tensor(v_np[:n], device=device)
    joints_y = torch.linspace(0.1, 1.4, nj, device=device)
    jr = torch.exp(-30.0 * (v[None, :, 1] - joints_y[:, None]).abs())
    jr = jr / jr.sum(1, keepdim=True)
    w = ((joints_y[None] - v[:, 1:2]).abs() + 1e-3) ** -4
    w = w / w.sum(1, keepdim=True)
    shapedirs = _normal(gen, (n, 3, spec["num_betas"] + spec["num_expr"]),
                        spec["shape_std"], device)
    posedirs = _normal(gen, (n, 3, (nj - 1) * 9), spec["pose_std"], device)
    faces = torch.as_tensor(f_np[(f_np < n).all(1)], device=device)
    return _pack_body(v, shapedirs, posedirs, jr, w,
                      [-1] + list(range(nj - 1)), faces, spec["num_betas"])


def sit_poses(n_poses: int, device):
    """``data/make_demo_assets.py``'s sit-down sequence: (first, poses)."""
    first = {"body_pose": torch.zeros((1, 63), device=device),
             "trans": torch.zeros((1, 3), device=device)}
    ramp = torch.linspace(0.0, 1.0, n_poses, device=device)
    pose = torch.zeros((n_poses, 63), device=device)
    pose[:, 0] = 0.35 * ramp
    pose[:, 12] = -0.25 * ramp
    trans = torch.zeros((n_poses, 3), device=device)
    trans[:, 1] = -0.18 * ramp
    trans[:, 2] = -0.20 * ramp
    return first, {"body_pose": pose, "trans": trans}


def sand_block(spec: dict, seed: int, device):
    """``train/demo.py::get_sand``: a jittered lattice, the jitter drawn
    from the seed.  (positions (N, 3), volumes (N,))."""
    gen = generator(seed, "sand", device)
    res, length = spec["res"], spec["length"]
    axes = [torch.arange(res[1]), torch.arange(res[2]), torch.arange(res[0])]
    g = torch.stack(torch.meshgrid(*axes, indexing="ij"),
                    -1).reshape(-1, 3)[:, [2, 0, 1]].float().to(device)
    g = g / torch.tensor([[res[0] - 1, res[1] - 1, res[2] - 1]],
                         device=device, dtype=torch.float32)
    g = g * torch.tensor([length], device=device) \
        + torch.tensor([spec["center"]], device=device)
    g = g + _normal(gen, g.shape, spec["noise"], device)
    n = res[0] * res[1] * res[2]
    vol = torch.full((n,), length[0] * length[1] * length[2] / n,
                     device=device)
    return g, vol


def uniform(seed: int, lo: float, hi: float, index: int) -> float:
    """A number in [lo, hi) drawn from the seed (the ``index``-th draw)."""
    gen = generator(seed, "params", "cpu")
    return float(lo + (hi - lo) * torch.rand(index + 1, generator=gen)[-1])


def tilted_rest(verts, tilt_deg: float, shrink: float):
    """The rest shape a trainer's H scales: ``verts`` turned by
    ``tilt_deg`` about the x axis through their centroid, so that the
    rest has vertical extent, and shrunk by ``shrink`` about it, so that
    ``verts`` are stretched against it."""
    c = verts.mean(0)
    a = torch.tensor(np.deg2rad(tilt_deg), dtype=torch.float64)
    cos, sin = float(torch.cos(a)), float(torch.sin(a))
    rot = torch.tensor([[1.0, 0.0, 0.0], [0.0, cos, -sin], [0.0, sin, cos]],
                       dtype=verts.dtype, device=verts.device)
    return (verts - c) @ rot.T * (1.0 - shrink) + c


def garment_inputs(cfg: dict, seed: int, device, n_poses: int,
                   fps: float) -> dict:
    """The garment: the flat cloth, the torso body and a walk of
    ``n_poses`` poses at ``fps`` (the walk's steps are per second in the
    configuration)."""
    verts, faces = flat_cloth(cfg["cloth"]["nx"], cfg["cloth"]["y0"],
                              cfg["cloth"]["extent"])
    body = torso_body(cfg["body"], seed, device)
    walk = cfg["walk"]
    per_pose = {"root_turn": walk["root_turn_per_s"] / fps,
                "rise": walk["rise_per_s"] / fps,
                "pose_sigma": walk["pose_sigma_per_s"] / fps,
                "num_betas": cfg["body"]["num_betas"],
                "num_expr": cfg["body"]["num_expr"]}
    first, poses = walk_poses(per_pose, n_poses, seed, device)
    return {"verts": torch.as_tensor(verts, device=device),
            "faces": torch.as_tensor(faces, device=device),
            "body": body, "first": first, "poses": poses, "fps": fps}


def demo_inputs(cfg: dict, seed: int, device) -> dict:
    """The sand demo: the skirt, the rig and its sit-down poses, the
    capsule's faces as the body collider, the chair and the sand."""
    verts, faces = skirt(*cfg["skirt"]["n"])
    _, body_faces = capsule(*cfg["collider_capsule"])
    chair_v, chair_f = chair_box()
    first, poses = sit_poses(cfg["poses"], device)
    sand, sand_vol = sand_block(cfg["sand"], seed, device)
    t = lambda a: torch.as_tensor(a, device=device)
    return {"verts": t(verts), "faces": t(faces),
            "body": demo_rig(cfg["rig"], seed, device),
            "body_faces": t(body_faces), "chair_verts": t(chair_v),
            "chair_faces": t(chair_f), "first": first, "poses": poses,
            "sand": sand, "sand_vol": sand_vol, "fps": float(cfg["fps"])}
