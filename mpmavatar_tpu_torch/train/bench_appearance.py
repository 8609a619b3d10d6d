"""Stage-2 appearance-training benchmark: the JAX package's
bench_appearance.py train step through the port (K6 forward and K7
backward on the card).

Shape, from bench_appearance.py: the 160 x 158 body-scale UV sphere
(50,244 faces, one splat each in a capacity of 65,536) with seeded AO
maps, UVs and colours (render/bench_render.py::build_avatar), SH degree 3,
the shadow UNet on the 256^2 AO map (differentiated), a 1500 x 1000 frame
at f = 1400 with the camera at z = 2.6, GT a seeded random image with a
full mask, tile_capacity 512, work_cap 8192, chunk 32, the full
regularizer set and the per-group Adam (OptimizationParams defaults,
spatial_lr_scale 1).

    python -m mpmavatar_tpu_torch.train.bench_appearance --steps 10
    python -m mpmavatar_tpu_torch.train.bench_appearance --device cpu \\
        --width 96 --height 64 --mesh 20x18 --work-cap 64 --steps 3

Runs ``--steps`` train steps, then one densification pass as the stage-2
loop runs it: ``add_densification_stats`` from the last step's view-space
gradient, ``densify_and_prune`` (extent 1, the bench's spatial scale) and
``reset_opacity``.  Prints one JSON line (ms and loss per step, alive
splats before and after, overflow) and fails on overflow or a NaN loss.
Runs on the CUDA device unless ``--device cpu``; ``--width``/``--height``
cut the image (the focal length scales with the width), ``--mesh`` the
body mesh and ``--work-cap`` the phase-2 worklist.
"""

from __future__ import annotations

import argparse
import json
import math
import time

import numpy as np
import torch

from .. import resolve_device
from ..data import OptimizationParams
from ..render import camera_arrays
from ..render import gaussians as G
from ..render.bench_render import (AVATAR, AVATAR_RASTER, build_avatar,
                                   check_overflow, look_down_z)
from .appearance import make_optimizer, make_train_step

ACTIVE_SH = 3
EXTENT = 1.0          # the bench's spatial_lr_scale: no dataset radius
MIN_OPACITY = 0.005


def build(device=None, width=AVATAR["width"], height=AVATAR["height"],
          mesh=AVATAR["mesh"]):
    """(avatar, params, number of faces, (CameraArrays, width, height),
    gt_rgb, gt_msk, AO map of frame 0) of the bench's training scene.
    The splat capacity keeps the full scene's ratio to the face count."""
    device = resolve_device(device)
    faces = 2 * (mesh[0] - 1) * mesh[1]
    full = 2 * (AVATAR["mesh"][0] - 1) * AVATAR["mesh"][1]
    capacity = -(-faces * AVATAR["capacity"] // full)
    avatar, params, n_faces = build_avatar(
        capacity=capacity, ao_size=AVATAR["ao_size"], n_theta=mesh[0],
        n_phi=mesh[1], device=device)
    cam = look_down_z(width, height, AVATAR["focal"] * width
                      / AVATAR["width"], AVATAR["cam_z"], AVATAR["near"],
                      AVATAR["far"])
    rng = np.random.default_rng(1)
    gt_rgb = torch.as_tensor(rng.random((3, height, width)).astype(
        np.float32), device=device)
    gt_msk = torch.ones((1, height, width), device=device)
    ao = avatar.tensor("ao_maps", device)[0]
    return (avatar, params, n_faces, (camera_arrays(cam, device), width,
                                      height), gt_rgb, gt_msk, ao)


@torch.no_grad()
def densify_pass(avatar, params, n_faces: int, aux, opt, generator):
    """One densification pass of the stage-2 loop on ``params`` (in
    place): the stats of one step, clone/split/prune, opacity reset.
    Returns the densified splats' (alive count, fewest alive splats on a
    face)."""
    cap = params.splats.capacity
    dev = params.splats.xyz.device
    ds = G.add_densification_stats(G.init_densify_state(cap, dev),
                                   aux["vgrad"], aux["radii"][:cap],
                                   aux["visible"][:cap])
    frames = avatar.frames_for_verts(avatar.select_verts(params, 0))
    splats, _ = G.densify_and_prune(
        params.splats, ds, frames, n_faces, opt.densify_grad_threshold,
        MIN_OPACITY, EXTENT, percent_dense=opt.percent_dense,
        generator=generator)
    G.copy_into(params.splats, G.reset_opacity(splats))
    alive = params.splats.alive
    per_face = torch.bincount(params.splats.binding[alive],
                              minlength=n_faces)
    return int(alive.sum()), int(per_face.min())


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the plain PyTorch path)")
    ap.add_argument("--width", type=int, default=AVATAR["width"])
    ap.add_argument("--height", type=int, default=AVATAR["height"])
    ap.add_argument("--mesh", default=None,
                    help="body mesh resolution, e.g. 20x18")
    ap.add_argument("--work-cap", type=int,
                    default=AVATAR_RASTER["work_cap"])
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    mesh = tuple(int(v) for v in args.mesh.split("x")) if args.mesh \
        else AVATAR["mesh"]
    avatar, params, n_faces, cam, gt_rgb, gt_msk, ao = build(
        device, args.width, args.height, mesh)
    opt = OptimizationParams()
    optimizer = make_optimizer(opt, EXTENT, params)
    raster = dict(AVATAR_RASTER, work_cap=args.work_cap)
    step = make_train_step(avatar, opt, optimizer, ACTIVE_SH, False,
                           **raster)
    times, losses, l1s = [], [], []
    for _ in range(args.steps):
        t0 = time.perf_counter()
        loss, aux = step(params, 0, 0, cam[0], gt_rgb, gt_msk, ao, cam[1],
                         cam[2])
        if device.type == "cuda":
            torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        check_overflow(aux, "train step")
        losses.append(float(loss))
        l1s.append(float(aux["l1"]))
        if not math.isfinite(losses[-1]):
            raise RuntimeError(f"train step {len(losses)}: loss is "
                               f"{losses[-1]}")
    alive_before = int(params.splats.alive.sum())
    gen = torch.Generator(device).manual_seed(0)
    alive_after, min_per_face = densify_pass(avatar, params, n_faces, aux,
                                             opt, gen)
    print(json.dumps({
        "scene": "avatar_train", "device": str(device),
        "width": args.width, "height": args.height,
        "gaussians": params.splats.capacity, "faces": n_faces, **raster,
        "steps": args.steps,
        "step_ms": [round(1e3 * s, 3) for s in times],
        "loss": losses, "l1": l1s, "n_items": int(aux["n_items"]),
        "work_overflow": int(aux["work_overflow"]),
        "big_overflow": int(aux["big_overflow"]),
        "alive_before": alive_before, "alive_after": alive_after,
        "min_splats_per_face": min_per_face}))


if __name__ == "__main__":
    main()
