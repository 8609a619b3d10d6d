"""Synthesize the zero-shot demo's inputs (the counterpart of
scripts/make_demo_assets.py): a skirt-like garment on a capsule body, a
chair collider and chair gaussians, an SMPL-X-sized rig npz in the
official archive layout (22 joints, 189 pose directions), a sit-down
pose sequence and a tracked cloth avatar, everything
``train/run_demo.py`` needs for its whole chain (pose playback, the
250^3 cloth + sand sim, the AO bake, the orbit render):

    python -m mpmavatar_tpu_torch.data.make_demo_assets --out DIR

The files are the JAX script's, bit for bit, except the rig's faces: the
JAX script trims them with a prefix slice (``body_f[: (body_f <
n_verts).all(1).sum()]``), which keeps faces that index past
``v_template`` and drops valid ones; here every face whose three vertices
lie in the template is kept (a boolean mask).  Host numpy only.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..utils.io import write_obj


def capsule_body(n_theta=48, n_phi=48, radius=0.22, height=1.3,
                 center=(0.0, 0.75, 0.0)):
    """Capsule-ish body collider: sphere stretched along y."""
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


def skirt_cloth(n_u=183, n_v=183, r_top=0.26, r_bot=0.5, y_top=0.9,
                y_bot=0.15):
    """Open-cylinder skirt around the body, top ring FIRST (the joint
    prefix pinned to the body).  ~33.5k verts + ~66k faces = ~100k MPM
    particles with the element centroids — the bench demo shape."""
    us = np.linspace(0, 2 * np.pi, n_u, endpoint=False)
    fr = np.linspace(0.0, 1.0, n_v)
    verts = np.zeros((n_v, n_u, 3), np.float32)
    rr = r_top + (r_bot - r_top) * fr[:, None] ** 1.3
    verts[..., 0] = rr * np.cos(us)[None]
    verts[..., 1] = (y_top + (y_bot - y_top) * fr)[:, None]
    verts[..., 2] = rr * np.sin(us)[None]
    verts = verts.reshape(-1, 3)
    idx = np.arange(n_v * n_u).reshape(n_v, n_u)
    a = idx[:-1, :].ravel()
    b = idx[1:, :].ravel()
    c = idx[:-1, np.r_[1:n_u, 0]].ravel()
    d = idx[1:, np.r_[1:n_u, 0]].ravel()
    faces = np.concatenate([np.stack([a, b, c], -1),
                            np.stack([c, b, d], -1)], 0).astype(np.int32)
    return verts, faces


def chair_box(center=(0.0, 0.25, -0.55), size=(0.6, 0.5, 0.5)):
    c = np.asarray(center)
    s = np.asarray(size) / 2
    corners = np.array([[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1)
                        for sz in (-1, 1)], np.float32) * s + c
    quads = [(0, 1, 3, 2), (4, 6, 7, 5), (0, 4, 5, 1), (2, 3, 7, 6),
             (0, 2, 6, 4), (1, 5, 7, 3)]
    faces = []
    for q in quads:
        faces.append([q[0], q[1], q[2]])
        faces.append([q[0], q[2], q[3]])
    return corners, np.asarray(faces, np.int32)


def make_rig_npz(path, n_verts=10475, n_joints=22, seed=0):
    """SMPL-X-shaped rig in the OFFICIAL npz layout (the keys
    avatar/smplx.py::load_smplx_npz reads), built around the capsule
    body so LBS poses deform it plausibly: joints along the y axis,
    distance-falloff skinning weights."""
    rng = np.random.default_rng(seed)
    body_v, body_f = capsule_body(n_theta=121, n_phi=87)  # 10527-ish
    body_v = body_v[:n_verts] if len(body_v) >= n_verts else body_v
    n_verts = len(body_v)
    joints_y = np.linspace(0.1, 1.4, n_joints)
    jr = np.zeros((n_joints, n_verts), np.float32)
    for j in range(n_joints):
        d = np.abs(body_v[:, 1] - joints_y[j])
        jr[j] = np.exp(-30 * d)
        jr[j] /= jr[j].sum()
    w = np.zeros((n_verts, n_joints), np.float32)
    for i in range(n_verts):
        d = np.abs(joints_y - body_v[i, 1]) + 1e-3
        w[i] = d ** -4
        w[i] /= w[i].sum()
    kintree = np.zeros((2, n_joints), np.uint32)
    kintree[0, 0] = np.iinfo(np.uint32).max  # root marker (official npz)
    kintree[0, 1:] = np.arange(n_joints - 1)
    kintree[1] = np.arange(n_joints)
    np.savez(
        path,
        v_template=body_v.astype(np.float32),
        shapedirs=rng.normal(0, 0.005,
                             (n_verts, 3, 400)).astype(np.float32),
        posedirs=rng.normal(0, 0.0005,
                            (n_verts, 3, (n_joints - 1) * 9)
                            ).astype(np.float32),
        J_regressor=jr,
        weights=w,
        kintree_table=kintree,
        f=body_f[(body_f < n_verts).all(1)].astype(np.int64))
    return body_v, n_verts


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--out", default="output/demo_assets")
    p.add_argument("--n_poses", type=int, default=30)
    args = p.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    from PIL import Image

    cloth_v, cloth_f = skirt_cloth()
    body_v, body_f = capsule_body()
    chair_v, chair_f = chair_box()
    write_obj(os.path.join(args.out, "cloth.obj"), cloth_v, cloth_f)
    write_obj(os.path.join(args.out, "body.obj"), body_v, body_f)
    write_obj(os.path.join(args.out, "chair.obj"), chair_v, chair_f)

    # rig + pose sequence: lean + sink onto the chair (sit-down-ish)
    rig_path = os.path.join(args.out, "smplx_model.npz")
    make_rig_npz(rig_path)
    n_joints = 22
    np.savez(os.path.join(args.out, "first_smplx.npz"),
             body_pose=np.zeros((1, (n_joints - 1) * 3), np.float32),
             trans=np.zeros((1, 3), np.float32))
    T = args.n_poses
    pose = np.zeros((T, (n_joints - 1) * 3), np.float32)
    ramp = np.linspace(0.0, 1.0, T, dtype=np.float32)
    pose[:, 0] = 0.35 * ramp          # hip pitch
    pose[:, 12] = -0.25 * ramp        # mid-spine counter-lean
    trans = np.zeros((T, 3), np.float32)
    trans[:, 1] = -0.18 * ramp        # sink toward the chair
    trans[:, 2] = -0.20 * ramp        # shift over the seat
    np.savez(os.path.join(args.out, "pose_seq.npz"),
             body_pose=pose, trans=trans)

    # chair gaussians: splats on the box surface
    rng = np.random.default_rng(5)
    n_g = 2000
    fidx = rng.integers(0, len(chair_f), n_g)
    b = rng.dirichlet((1, 1, 1), n_g).astype(np.float32)
    gx = np.einsum("nc,ncd->nd", b, chair_v[chair_f[fidx]])
    np.savez(os.path.join(args.out, "chair_gs.npz"),
             xyz=gx.astype(np.float32),
             shs=np.tile(np.asarray([[0.35, 0.22, 0.1]], np.float32)
                         * 2.0 - 0.5, (n_g, 1))[:, None, :],
             opacity=np.full((n_g,), 0.95, np.float32),
             scale=np.full((n_g, 3), 0.02, np.float32),
             rotation=np.tile(np.asarray([[1.0, 0, 0, 0]], np.float32),
                              (n_g, 1)))

    # tracked-avatar assets for the orbit render (cloth avatar)
    tracked = os.path.join(args.out, "tracked")
    os.makedirs(os.path.join(tracked, "aomap"), exist_ok=True)
    centers = cloth_v[cloth_f].mean(1)
    pat = 0.5 + 0.4 * np.stack([
        np.sin(12.0 * centers[:, 1]),
        np.sin(6.0 * np.arctan2(centers[:, 2], centers[:, 0])),
        np.cos(10.0 * centers[:, 1] + 3.0)], -1)
    np.savez(os.path.join(tracked, "params_0.npz"),
             vertices=cloth_v, faces=cloth_f,
             rgb_colors=np.clip(pat, 0, 1).astype(np.float32),
             cam_m=np.zeros((1, 3), np.float32),
             cam_c=np.zeros((1, 3), np.float32))
    Image.fromarray(np.full((256, 256), 230, np.uint8)).save(
        os.path.join(tracked, "aomap", "mesh_cloth_0.png"))
    # cylinder UV chart: u = angle, v = height fraction
    ang = (np.arctan2(cloth_v[:, 2], cloth_v[:, 0]) + np.pi) / (2 * np.pi)
    hv = (cloth_v[:, 1] - cloth_v[:, 1].min()) / np.ptp(cloth_v[:, 1])
    with open(os.path.join(args.out, "uv.obj"), "w") as f:
        for v in cloth_v:
            f.write(f"v {v[0]:.5f} {v[1]:.5f} {v[2]:.5f}\n")
        for a, h in zip(ang, hv):
            f.write(f"vt {a:.5f} {h:.5f}\n")
        for fc in cloth_f:
            f.write(f"f {fc[0]+1}/{fc[0]+1} {fc[1]+1}/{fc[1]+1} "
                    f"{fc[2]+1}/{fc[2]+1}\n")
    print(f"assets -> {args.out}: cloth {len(cloth_v)}v/{len(cloth_f)}f, "
          f"body {len(body_v)}v, chair {len(chair_v)}v, "
          f"poses {T}")


if __name__ == "__main__":
    main()
