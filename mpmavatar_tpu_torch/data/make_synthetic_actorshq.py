"""A synthetic capture in the ActorsHQ layout at production scale, made
with the port's renderer (the counterpart of
scripts/make_synthetic_actorshq.py):

    python -m mpmavatar_tpu_torch.data.make_synthetic_actorshq --out DIR
    python -m mpmavatar_tpu_torch.data.make_synthetic_actorshq --out DIR \\
        --device cpu --width 96 --height 64 --mesh 20x18 --n_cams 3 \\
        --work_cap 64

The body is render/bench_render.py's UV sphere at body scale (160 x 158,
50,244 faces by default) swaying over ``--n_frames`` frames.  A teacher
avatar (a structured colour pattern, seeded SH bands, opacity 0.9) is
rendered from ``--n_cams`` ring cameras (the last is the held-out view;
f = 1400 px at 1500 px wide, scaled with ``--width``) through the
worklist compositor (``--work_cap``, 8192 by default; an overflow
fails).  It writes:

  DIR/tracked/params_{t}.npz, aomap/mesh_cloth_{t}.png, uv.obj
      the tracking stage's outputs, with the student's colours a flat
      gray: the teacher's pattern has to be learned;
  DIR/dataset/a1_s1/cam_info.json
  DIR/dataset/ActorsHQ/Actor01/Sequence1/4x/rgbs/CamNNN/CamNNN_rgb%06d.jpg
      (JPEG quality 95), masks/CamNNN/CamNNN_mask%06d.png (alpha > 0.5),
      and meshes/Frame%06d.obj (each frame's mesh, the geometry that the
      metrics CLI reads as ground truth).

Runs on the CUDA device unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np
import torch

from .. import resolve_device

TILE_CAPACITY = 512
WORK_CAP = 8192


def ring_cameras(n, radius=2.6, width=1500, height=1000, f=1400.0,
                 y=0.0):
    """n cameras on a horizontal ring looking at the origin: a list of
    (id, K, c2w), the fields of an ActorsHQ cam_info.json."""
    cams = []
    for i in range(n):
        ang = 2 * np.pi * i / n
        pos = np.array([radius * np.sin(ang), y, radius * np.cos(ang)])
        fwd = -pos / np.linalg.norm(pos)            # +z looks at origin
        up = np.array([0.0, 1.0, 0.0])
        right = np.cross(up, fwd)
        right /= np.linalg.norm(right)
        true_up = np.cross(fwd, right)
        c2w = np.eye(4)
        c2w[:3, 0], c2w[:3, 1], c2w[:3, 2] = right, -true_up, fwd
        c2w[:3, 3] = pos
        k = np.array([[f, 0, width / 2], [0, f, height / 2], [0, 0, 1.0]])
        cams.append((f"Cam{i:03d}", k, c2w))
    return cams


def smooth_ao(res, seed, n_blobs=24, lo=0.35, hi=0.98):
    """A res^2 AO-like map in [lo, hi]: seeded gaussian blobs."""
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.linspace(0, 1, res), np.linspace(0, 1, res),
                         indexing="ij")
    img = np.zeros((res, res))
    for _ in range(n_blobs):
        cx, cy = rng.random(2)
        s = 0.05 + 0.15 * rng.random()
        img -= rng.random() * np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2)
                                     / (2 * s * s))
    img = (img - img.min()) / max(img.max() - img.min(), 1e-9)
    return (lo + (hi - lo) * img).astype(np.float32)


def frame_verts(verts, n_frames):
    """Each frame's vertices: a lateral sway and a breathing bend of
    about 2 cm."""
    out = []
    for t in range(n_frames):
        ph = 2 * np.pi * t / max(n_frames, 1)
        v = verts.copy()
        v[:, 0] += 0.02 * np.sin(ph) * (v[:, 1] / 0.85)
        v[:, 2] += 0.01 * np.cos(ph) * (v[:, 1] / 0.85) ** 2
        out.append(v.astype(np.float32))
    return out


def teacher_params(params, verts, faces):
    """The avatar's parameters with the teacher's colours: a smooth
    pattern in the DC band, seeded higher bands, opacity 0.9."""
    from ..render.sh import rgb2sh
    dev = params.splats.xyz.device
    centers = verts[faces].mean(1)
    pat = 0.5 + 0.45 * np.stack([
        np.sin(9.0 * centers[:, 1] + 2.0 * centers[:, 0]),
        np.sin(7.0 * centers[:, 0] + 11.0 * centers[:, 2]),
        np.cos(8.0 * centers[:, 2] + 5.0 * centers[:, 1])], -1)
    cap = params.splats.capacity
    n = len(faces)
    dc = torch.zeros((cap, 1, 3), device=dev)
    dc[:n, 0] = rgb2sh(torch.as_tensor(pat.astype(np.float32), device=dev))
    rng = np.random.default_rng(7)
    rest = np.zeros((cap, 15, 3), np.float32)
    rest[:n] = 0.03 * rng.standard_normal((n, 15, 3)).astype(np.float32)
    opa = torch.full((cap, 1), float(np.log(0.9 / 0.1)), device=dev)
    return dataclasses.replace(params, splats=dataclasses.replace(
        params.splats, features_dc=dc,
        features_rest=torch.as_tensor(rest, device=dev), opacity=opa))


@torch.no_grad()
def make_capture(out, n_frames=4, n_cams=9, width=1500, height=1000,
                 mesh=(160, 158), device=None,
                 work_cap: int = WORK_CAP) -> dict:
    """Write the capture under ``out`` (see the module docstring) on
    ``device``; returns a summary (sizes, the most phase-2 items a
    teacher frame needed, seconds)."""
    from PIL import Image
    from ..render.avatar_model import load_mesh_avatar
    from ..render.bench_render import build_body_mesh
    from ..render.cameras import Camera
    from ..train.appearance import render_avatar_frame
    from ..utils.io import write_obj

    device = resolve_device(device)
    t_start = time.perf_counter()
    tracked = os.path.join(out, "tracked")
    ds_root = os.path.join(out, "dataset")
    img_root = os.path.join(ds_root, "ActorsHQ", "Actor01", "Sequence1",
                            "4x")
    os.makedirs(os.path.join(tracked, "aomap"), exist_ok=True)
    os.makedirs(os.path.join(ds_root, "a1_s1"), exist_ok=True)
    os.makedirs(os.path.join(img_root, "meshes"), exist_ok=True)

    verts, faces = build_body_mesh(n_theta=mesh[0], n_phi=mesh[1])
    frames_v = frame_verts(verts, n_frames)
    for t in range(n_frames):
        np.savez(os.path.join(tracked, f"params_{t}.npz"),
                 vertices=frames_v[t], faces=faces,
                 rgb_colors=np.full((len(faces), 3), 0.5, np.float32),
                 cam_m=np.zeros((n_cams, 3), np.float32),
                 cam_c=np.zeros((n_cams, 3), np.float32))
        Image.fromarray((smooth_ao(256, seed=100 + t) * 255).astype(
            np.uint8)).save(os.path.join(tracked, "aomap",
                                         f"mesh_cloth_{t}.png"))
        write_obj(os.path.join(img_root, "meshes", f"Frame{t:06d}.obj"),
                  frames_v[t], faces)
    # UV template: a spherical (theta, phi) chart per vertex
    theta = np.arccos(np.clip(verts[:, 1] / (np.linalg.norm(
        verts, axis=1) + 1e-9), -1, 1))
    phi = np.arctan2(verts[:, 2], verts[:, 0])
    vt = np.stack([(phi + np.pi) / (2 * np.pi), 1.0 - theta / np.pi], -1)
    uv_path = os.path.join(tracked, "uv.obj")
    with open(uv_path, "w") as f:
        for v in verts:
            f.write(f"v {v[0]:.5f} {v[1]:.5f} {v[2]:.5f}\n")
        for t2 in vt:
            f.write(f"vt {t2[0]:.5f} {t2[1]:.5f}\n")
        for fc in faces:
            f.write(f"f {fc[0]+1}/{fc[0]+1} {fc[1]+1}/{fc[1]+1} "
                    f"{fc[2]+1}/{fc[2]+1}\n")

    avatar, params = load_mesh_avatar(tracked, uv_path, sh_degree=3,
                                      device=device)
    teacher = teacher_params(params, verts, faces)

    cams = ring_cameras(n_cams, width=width, height=height,
                        f=1400.0 * width / 1500)
    with open(os.path.join(ds_root, "a1_s1", "cam_info.json"), "w") as f:
        json.dump({cid: {"K": k.tolist(), "W": width, "H": height,
                         "RT": c2w.tolist()} for cid, k, c2w in cams}, f)

    bg = torch.zeros(3, device=device)
    max_items = 0
    for ci, (cid, k, c2w) in enumerate(cams):
        os.makedirs(os.path.join(img_root, "rgbs", cid), exist_ok=True)
        os.makedirs(os.path.join(img_root, "masks", cid), exist_ok=True)
        cam = Camera.from_kw2c(cid, width, height, k, np.linalg.inv(c2w),
                               near=1, far=10)
        for t in range(n_frames):
            img, res = render_avatar_frame(
                avatar, teacher, avatar.select_verts(teacher, t),
                avatar.tensor("ao_maps", device)[t], cam, ci,
                active_sh_degree=3, bg=bg, white_bkgd=False,
                tile_capacity=TILE_CAPACITY, work_cap=work_cap)
            if int(res["work_overflow"]) or int(res["big_overflow"]):
                raise RuntimeError(
                    f"teacher render overflow at {cid} frame {t}: work "
                    f"{int(res['work_overflow'])}, big "
                    f"{int(res['big_overflow'])}")
            max_items = max(max_items, int(res["n_items"]))
            im8 = (torch.clamp(img, 0, 1) * 255).to(torch.uint8)
            Image.fromarray(im8.permute(1, 2, 0).cpu().numpy()).save(
                os.path.join(img_root, "rgbs", cid,
                             f"{cid}_rgb{t:06d}.jpg"), quality=95)
            msk = (res["alpha"][0] > 0.5).to(torch.uint8) * 255
            Image.fromarray(msk.cpu().numpy()).save(
                os.path.join(img_root, "masks", cid,
                             f"{cid}_mask{t:06d}.png"))
    return {"out": out, "n_faces": len(faces), "n_cams": n_cams,
            "n_frames": n_frames, "wh": [width, height],
            "capacity": params.splats.capacity, "max_items": max_items,
            "seconds": time.perf_counter() - t_start}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default="output/synth_a1")
    p.add_argument("--n_frames", type=int, default=4)
    p.add_argument("--n_cams", type=int, default=9,
                   help="the last camera is the held-out view")
    p.add_argument("--width", type=int, default=1500)
    p.add_argument("--height", type=int, default=1000)
    p.add_argument("--mesh", default="160x158",
                   help="body mesh resolution (theta x phi)")
    p.add_argument("--work_cap", type=int, default=WORK_CAP,
                   help="the teacher render's worklist capacity")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA device)")
    args = p.parse_args(argv)
    mesh = tuple(int(v) for v in args.mesh.split("x"))
    print(json.dumps(make_capture(args.out, args.n_frames, args.n_cams,
                                  args.width, args.height, mesh,
                                  args.device, args.work_cap)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
