"""Render benchmark: the JAX package's production render shapes, through the
port's rasterizer (K6 on the card).

Scenes, all made from seeds:
  avatar      the stage-2 render of bench_appearance.py: a 160 x 158
              body-scale UV sphere (50,244 faces, one splat each in a
              capacity of 65,536), SH degree 3, AO and the shadow UNet at
              256^2 (n_dims 4), 1500 x 1000 px, f = 1400, camera at
              z = 2.6, tile_capacity 512, work_cap 8192, chunk 32,
              through train/appearance.py::render_avatar_frame;
  splats      bench_render.py's 1080p scene: 50,000 gaussians of 1-4 mm,
              f = 1500, camera at z = 3, work_cap 8192;
  big_splats  the same at 1-3 cm: tile_capacity 4096, max_tiles_per_gauss
              196, chunk 128, work_cap 4096, stop_eps 1e-3 and explicit
              footprint tiers.

    python -m mpmavatar_tpu_torch.render.bench_render --scene avatar
    python -m mpmavatar_tpu_torch.render.bench_render --scene avatar \\
        --device cpu --width 96 --height 64 --mesh 20x18 --frames 1

Runs on the CUDA device unless ``--device cpu``; ``--width``/``--height``
cut the image (the focal length scales with the width) and ``--mesh`` /
``--splats`` the scene.  Fails when the worklist or the footprint pools
overflow, as the JAX benches assert.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from .. import resolve_device
from . import camera_arrays, rasterize
from . import gaussians as G
from .avatar_model import AvatarParams, MeshAvatar
from .cameras import Camera
from .geometry import covariance_from_scaling_rotation, find_adjacent_faces
from .shadow import init_shadow_unet

AVATAR = dict(width=1500, height=1000, focal=1400.0, cam_z=2.6, near=0.1,
              far=20.0, mesh=(160, 158), capacity=65536, ao_size=256)
AVATAR_RASTER = dict(tile_capacity=512, work_cap=8192, chunk=32)
SPLATS = dict(n=50_000, width=1920, height=1080, focal=1500.0, cam_z=3.0,
              near=0.5, far=20.0)
SPLAT_RASTER = dict(tile_capacity=512, work_cap=8192)
BIG_SPLAT_RASTER = dict(tile_capacity=4096, max_tiles_per_gauss=196,
                        chunk=128, work_cap=4096, stop_eps=1e-3,
                        tiers=((2, None), (4, 9216), (6, 38912),
                               (8, 13312), (14, 768)))
SCENES = ("avatar", "splats", "big_splats")


def build_body_mesh(n_theta=160, n_phi=158, height=1.7, radius=0.25):
    """Closed capsule-ish UV sphere at body scale: ~50k faces at the
    default resolution."""
    th = np.linspace(1e-3, np.pi - 1e-3, n_theta)
    ph = np.linspace(0, 2 * np.pi, n_phi, endpoint=False)
    tt, pp = np.meshgrid(th, ph, indexing="ij")
    verts = np.stack([radius * np.sin(tt) * np.cos(pp),
                      0.5 * height * np.cos(tt),
                      radius * np.sin(tt) * np.sin(pp)], -1)
    idx = np.arange(n_theta * n_phi).reshape(n_theta, n_phi)
    a = idx[:-1, :].ravel()
    b = idx[1:, :].ravel()
    c = idx[:-1, np.r_[1:n_phi, 0]].ravel()
    d = idx[1:, np.r_[1:n_phi, 0]].ravel()
    faces = np.concatenate([np.stack([a, b, c], -1),
                            np.stack([c, b, d], -1)], 0).astype(np.int32)
    return verts.reshape(-1, 3).astype(np.float32), faces


def build_avatar(sh_degree=3, capacity=65536, n_frames=2, ao_size=256,
                 seed=0, n_theta=160, n_phi=158, device=None):
    """(MeshAvatar, AvatarParams, number of faces) of the body mesh with
    seeded AO maps, UVs and colours, as bench_appearance.py builds them
    (the shadow UNet's weights come from a torch.Generator)."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    verts, faces = build_body_mesh(n_theta=n_theta, n_phi=n_phi)
    verts_orig = np.stack([verts + 0.001 * t for t in range(n_frames)])
    ao_maps = (0.4 + 0.5 * rng.random(
        (n_frames, 1, ao_size, ao_size))).astype(np.float32)
    uv = (rng.random((len(faces), 2)).astype(np.float32)) * 2.0 - 1.0

    face_neighbors = find_adjacent_faces(faces)
    centers = verts_orig[0][faces].mean(1)
    nb = centers[face_neighbors]
    sq = np.sum((nb - centers[:, None]) ** 2, -1)
    avatar = MeshAvatar(
        faces=faces, verts_orig=verts_orig, ao_maps=ao_maps,
        uv_coord=uv, face_neighbors=face_neighbors,
        neighbor_weight=np.exp(-2000 * sq).astype(np.float32),
        neighbor_dist=np.sqrt(sq).astype(np.float32),
        num_timesteps=n_frames, sh_degree=sh_degree)

    splats = G.init_from_mesh(
        len(faces), sh_degree,
        rgb=rng.random((len(faces), 3)).astype(np.float32),
        capacity=capacity, device=device)
    shadow = init_shadow_unet(seed, ao_maps.mean(axis=0), uv_size=ao_size,
                              shadow_size=ao_size, n_dims=4, device=device)
    params = AvatarParams(
        splats=splats,
        verts_offset=torch.zeros((n_frames, len(verts), 3), device=device),
        cam_m=torch.zeros((4, 3), device=device),
        cam_c=torch.zeros((4, 3), device=device),
        shadow=shadow)
    return avatar, params, len(faces)


def look_down_z(width, height, focal, cam_z, near, far) -> Camera:
    """A camera at z = -cam_z looking down +z at the origin."""
    k = np.array([[focal, 0, width / 2], [0, focal, height / 2],
                  [0, 0, 1.0]])
    w2c = np.eye(4)
    w2c[2, 3] = cam_z
    return Camera.from_kw2c("bench", width, height, k, w2c, near=near,
                            far=far)


def avatar_scene(device=None, width=AVATAR["width"],
                 height=AVATAR["height"], mesh=AVATAR["mesh"],
                 ao_size=AVATAR["ao_size"], raster=AVATAR_RASTER):
    """(render one frame -> (rendering, outputs), info dict) for the
    stage-2 avatar render.  The splat capacity keeps the full scene's
    ratio to the face count (65,536 for 50,244 faces)."""
    from ..train.appearance import render_avatar_frame
    device = resolve_device(device)
    faces = 2 * (mesh[0] - 1) * mesh[1]
    full = 2 * (AVATAR["mesh"][0] - 1) * AVATAR["mesh"][1]
    capacity = -(-faces * AVATAR["capacity"] // full)
    avatar, params, n_faces = build_avatar(
        capacity=capacity, ao_size=ao_size, n_theta=mesh[0], n_phi=mesh[1],
        device=device)
    cam = look_down_z(width, height, AVATAR["focal"] * width
                      / AVATAR["width"], AVATAR["cam_z"], AVATAR["near"],
                      AVATAR["far"])
    cam_t = (camera_arrays(cam, device), width, height)
    verts = avatar.select_verts(params, 0)
    ao = avatar.tensor("ao_maps", device)[0]
    bg = torch.zeros(3, device=device)

    def frame():
        return render_avatar_frame(avatar, params, verts, ao, cam_t, 0, 3,
                                   bg, False, **raster)

    return frame, {"scene": "avatar", "width": width, "height": height,
                   "gaussians": params.splats.capacity,
                   "alive": n_faces, **raster}


def splat_scene(big: bool, device=None, n=SPLATS["n"],
                width=SPLATS["width"], height=SPLATS["height"]):
    """(render one frame -> (image, outputs), info dict) for one of
    bench_render.py's 1080p scenes (same seeded draws)."""
    device = resolve_device(device)
    rng = np.random.default_rng(0)
    xyz = rng.normal(0, 0.4, (n, 3)).astype(np.float32)
    colors = rng.random((n, 3)).astype(np.float32)
    opac = (0.3 + 0.6 * rng.random(n)).astype(np.float32)
    scales = (0.001 + 0.003 * rng.random((n, 3))).astype(np.float32)
    rots = rng.normal(size=(n, 4)).astype(np.float32)
    if big:
        scales = (0.01 + 0.02 * rng.random((n, 3))).astype(np.float32)
    t = lambda a: torch.as_tensor(a, device=device)
    xyz, colors, opac = t(xyz), t(colors), t(opac)
    cov3d = covariance_from_scaling_rotation(t(scales), 1.0, t(rots))
    cam = look_down_z(width, height, SPLATS["focal"] * width
                      / SPLATS["width"], SPLATS["cam_z"], SPLATS["near"],
                      SPLATS["far"])
    ca = camera_arrays(cam, device)
    bg = torch.zeros(3, device=device)
    raster = BIG_SPLAT_RASTER if big else SPLAT_RASTER

    def frame():
        out = rasterize(xyz, colors, opac, cov3d, ca, bg, width=width,
                        height=height, **raster)
        return out["render"], out

    return frame, {"scene": "big_splats" if big else "splats",
                   "width": width, "height": height, "gaussians": n,
                   **{k: v for k, v in raster.items() if k != "tiers"}}


def make_scene(name: str, device=None, width=None, height=None, mesh=None,
               splats=None):
    """The scene ``name`` (one of SCENES), optionally cut in size."""
    if name == "avatar":
        kw = {k: v for k, v in (("width", width), ("height", height),
                                ("mesh", mesh)) if v is not None}
        return avatar_scene(device, **kw)
    if name in ("splats", "big_splats"):
        kw = {k: v for k, v in (("width", width), ("height", height),
                                ("n", splats)) if v is not None}
        return splat_scene(name == "big_splats", device, **kw)
    raise ValueError(f"unknown scene {name!r}; one of {SCENES}")


def check_overflow(out, name: str) -> None:
    work, big = int(out["work_overflow"]), int(out["big_overflow"])
    if work or big:
        raise RuntimeError(f"{name}: rasterizer caps overflowed (work "
                           f"{work}, big {big}); the image would be wrong")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scene", choices=SCENES, default="avatar")
    ap.add_argument("--frames", type=int, default=5)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the plain PyTorch path)")
    ap.add_argument("--width", type=int, default=None)
    ap.add_argument("--height", type=int, default=None)
    ap.add_argument("--mesh", default=None,
                    help="avatar mesh resolution, e.g. 20x18")
    ap.add_argument("--splats", type=int, default=None,
                    help="gaussian count of the splat scenes")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    mesh = tuple(int(v) for v in args.mesh.split("x")) if args.mesh else None
    frame, info = make_scene(args.scene, device, args.width, args.height,
                             mesh, args.splats)
    times = []
    for _ in range(args.frames):
        t0 = time.perf_counter()
        image, out = frame()
        if device.type == "cuda":
            torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        check_overflow(out, args.scene)
    if not bool(torch.isfinite(image).all()):
        raise RuntimeError(f"{args.scene}: non-finite pixels")
    print(json.dumps({
        **info, "device": str(device), "frames": args.frames,
        "frame_ms": [round(1e3 * s, 3) for s in times],
        "tiles": int(out["tile_counts"].numel()),
        "instances": int(out["tile_counts"].sum()),
        "n_items": int(out["n_items"]),
        "image_mean": float(image.mean()),
        "alpha_mean": float(out["alpha"].mean())}))


if __name__ == "__main__":
    main()
