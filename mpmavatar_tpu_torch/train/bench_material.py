"""Stage-3 material training at the JAX package's production shape (port
of scripts/stage3_production.py's bench): a 183 x 183 hanging cloth
(33,489 vertices, 66,248 faces: 99,737 particles) pinned along its top
row, a 200^3 grid, the 32 x 32 body sphere as the collider, and D, E, H
differentiated through the rollout.

    python -m mpmavatar_tpu_torch.train.bench_material [--nx 183]
        [--grid 200] [--frames 1] [--substep 400] [--fps 25] [--steps 3]
        [--device cpu]

Cut depth with --frames / --substep only, and set --fps so that
dt = 1 / (fps substep) stays 1e-4: the production run is 25 fps x 400
substeps; a shorter dt changes the physics and a longer one is unstable
at this stiffness.  It prints one JSON line: ms per train step (median
and range of --steps steps after one warm-up step), ms per
differentiated substep, the forward rollout's ms and the grad/forward
ratio, with the device they ran on, and on the card the peak allocated
memory of the timed steps.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import numpy as np
import torch

from ..core.types import build_body_sphere
from .material import MaterialTrainer, MaterialTrainerConfig


def hanging_cloth(nx, ny, width=0.8, height=0.8, tilt=0.35):
    """A vertical, tilted nx x ny sheet, top row first (the pinned
    prefix): H, the rest shape's y scale, moves its rest metric.
    Returns (verts (V, 3) float32, faces (E, 3) int32)."""
    xs = np.linspace(1.0 - width / 2, 1.0 + width / 2, ny)
    fr = np.linspace(0.0, 1.0, nx)[:, None]
    verts = np.zeros((nx, ny, 3), np.float32)
    verts[..., 0] = xs[None, :]
    verts[..., 1] = 1.5 - height * fr
    verts[..., 2] = 1.0 + tilt * height * fr
    verts = verts.reshape(-1, 3)
    idx = np.arange(nx * ny).reshape(nx, ny)
    a, b = idx[:-1, :-1].ravel(), idx[:-1, 1:].ravel()
    c, d = idx[1:, :-1].ravel(), idx[1:, 1:].ravel()
    faces = np.concatenate([np.stack([a, b, c], -1),
                            np.stack([b, d, c], -1)], 0).astype(np.int32)
    return verts, faces


def make_trainer(nx, ny, grid, substep, n_frames, iterations,
                 train_verts=None, fps=25.0,
                 first_frame_verts=None, device=None):
    """The trainer on the hanging cloth over a still body sphere:
    (trainer, verts, faces, body_seq, body_faces).  Without
    ``train_verts`` the tracked trajectory is the cloth at rest; without
    ``first_frame_verts`` the rest shape is the cloth's start."""
    verts, faces = hanging_cloth(nx, ny)
    bv, bf = build_body_sphere(n_theta=32, n_phi=32,
                               center=(1.0, 0.75, 1.2), r=0.22)
    body_seq = np.repeat(bv[None], n_frames + 1, 0)
    cfg = MaterialTrainerConfig(
        grid_size=grid, substep=substep, fps=fps, iterations=iterations,
        init_D=1.0, init_E=100.0, lr_D=0.02, lr_E=0.06, lr_H=0.004)
    if train_verts is None:
        train_verts = np.repeat(verts[None], n_frames + 1, 0)
    tr = MaterialTrainer(
        cfg, faces,
        first_frame_verts=verts if first_frame_verts is None
        else first_frame_verts,
        train_verts=train_verts, smplx_verts=body_seq, smplx_faces=bf,
        num_joint_v=ny, num_joint_f=0, device=device)
    return tr, verts, faces, body_seq, bf


def run_bench(args) -> dict:
    tr, *_ = make_trainer(args.nx, args.nx, args.grid, args.substep,
                          args.frames, iterations=10, fps=args.fps,
                          device=args.device)
    dev = tr.device
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" \
        else (lambda: None)

    def timed(fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        return time.perf_counter() - t0, out

    warm_s, _ = timed(tr.train_one_step)       # first builds and launches
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    steps = [timed(tr.train_one_step) for _ in range(args.steps)]
    step_ms = [1e3 * s for s, _ in steps]
    with torch.no_grad():
        fwd_s, _ = timed(lambda: tr.rollout_loss(tr.params))
    n_sub = args.frames * args.substep
    med = statistics.median(step_ms)
    out = {
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "particles": tr.static.n_particles, "grid": args.grid,
        "frames": args.frames, "substeps_per_frame": args.substep,
        "dt": (1.0 / args.fps) / args.substep,
        "ms_per_step": med, "ms_per_step_range": [min(step_ms),
                                                  max(step_ms)],
        "ms_per_differentiated_substep": med / n_sub,
        "forward_rollout_ms": 1e3 * fwd_s,
        "grad_over_forward": med / (1e3 * fwd_s),
        "warm_step_ms": 1e3 * warm_s,
        "peak_allocated_gib": (torch.cuda.max_memory_allocated(dev) / 2 ** 30
                               if dev.type == "cuda" else None),
        "losses": [loss for _, (loss, _) in steps],
        "params": tr._params_now(),
    }
    print(json.dumps(out))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--nx", type=int, default=183)
    p.add_argument("--grid", type=int, default=200)
    p.add_argument("--frames", type=int, default=1)
    p.add_argument("--substep", type=int, default=400)
    p.add_argument("--fps", type=float, default=25.0)
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA device)")
    run_bench(p.parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
