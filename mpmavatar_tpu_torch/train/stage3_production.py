"""Stage 3 (inverse material estimation) at production scale (port of
scripts/stage3_production.py).

Two modes:

  --bench    one material train step through >= 1 frame x 400 substeps
             at 200^3 on a ~100k-particle hanging cloth
             (``train/bench_material.py::run_bench``; --reps counted
             steps after a warm-up), one JSON line.
  --recover  plant TRUTH = (D, E, H), synthesize a tracked trajectory
             with the solver itself on a hanging cloth (--nx 158: 24,964
             vertices, 49,298 faces, 74,262 particles) at the production
             grid and substeps, then recover the parameters from the
             default init: one JSON line per step, then the summary
             line, and the trace to --out.

    python -m mpmavatar_tpu_torch.train.stage3_production --bench
    python -m mpmavatar_tpu_torch.train.stage3_production --recover \\
        --nx 158 [--steps 100] [--out trace.jsonl] [--device cpu]

dt = 1 / (25 substep): keep --substep at 400 (dt = 1e-4) when cutting
depth; cut --frames and --steps instead.  Runs on the CUDA device unless
--device names another.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from ..core.types import build_body_sphere
from .bench_material import hanging_cloth
from .material import MaterialTrainer, MaterialTrainerConfig

TRUTH = {"D": 1.8, "E": 3.0, "H": 1.08}


def make_trainer(nx, ny, grid, substep, n_frames, iterations,
                 train_verts=None, lr_scale=1.0, device=None):
    """The trainer on the vertical hanging cloth (its top row of ``ny``
    vertices pinned) over the still 32 x 32 body sphere: (trainer, verts,
    faces, body_seq, body_faces).  Without ``train_verts`` the tracked
    trajectory is the cloth at rest."""
    verts, faces = hanging_cloth(nx, ny)
    bv, bf = build_body_sphere(n_theta=32, n_phi=32,
                               center=(1.0, 0.75, 1.2), r=0.22)
    body_seq = np.repeat(bv[None], n_frames + 1, 0)
    cfg = MaterialTrainerConfig(
        grid_size=grid, substep=substep, iterations=iterations,
        init_D=1.0, init_E=100.0, lr_D=0.02 * lr_scale,
        lr_E=0.06 * lr_scale, lr_H=0.004 * lr_scale)
    if train_verts is None:
        train_verts = np.repeat(verts[None], n_frames + 1, 0)
    tr = MaterialTrainer(cfg, faces, first_frame_verts=verts,
                         train_verts=train_verts, smplx_verts=body_seq,
                         smplx_faces=bf, num_joint_v=ny, num_joint_f=0,
                         device=device)
    return tr, verts, faces, body_seq, bf


def run_bench(args) -> dict:
    """ms per material train step at the reference's stage-3 shape."""
    from . import bench_material
    return bench_material.run_bench(argparse.Namespace(
        nx=args.nx, grid=args.grid, frames=args.frames,
        substep=args.substep, fps=25.0, steps=args.reps,
        device=args.device))


def synthesize(args):
    """The trajectory at TRUTH from the cloth at rest: (verts, the
    tracked trajectory (frames + 1, V, 3)); raises unless it is finite
    and moves by more than 0.01."""
    gen, verts, faces, body_seq, bf = make_trainer(
        args.nx, args.nx, args.grid, args.substep, args.frames, args.steps,
        device=args.device)
    print(f"particles={gen.static.n_particles} verts={len(verts)} "
          f"grid={args.grid} substep={args.substep} frames={args.frames}",
          file=sys.stderr)
    gen.params = {k: torch.tensor(np.float32(v), device=gen.device)
                  for k, v in TRUTH.items()}
    zeros = np.zeros((len(verts), 3), np.float32)
    zeros_jv = np.zeros((gen.static.num_joint_v, 3), np.float32)
    t0 = time.perf_counter()
    frames = gen.simulate(
        test_verts0=verts, test_verts_velo0=zeros, test_smplx=body_seq,
        test_smplx_velo=np.zeros_like(body_seq), n_frames=args.frames,
        joint_velo_fn=lambda i: zeros_jv)
    traj = np.stack([verts] + list(frames), 0)
    if not np.isfinite(traj).all():
        raise FloatingPointError("the synthetic trajectory is not finite")
    move = float(np.abs(traj[-1] - traj[0]).max())
    if not move > 0.01:
        raise AssertionError(f"synthetic trajectory barely moves ({move})")
    print(f"synthesized {args.frames} frames in "
          f"{time.perf_counter() - t0:.1f}s, max displacement {move:.3f}",
          file=sys.stderr)
    return verts, traj


def run_recover(args) -> dict:
    """Plant TRUTH, synthesize, recover; print and write the trace."""
    _, traj = synthesize(args)
    tr, *_ = make_trainer(args.nx, args.nx, args.grid, args.substep,
                          args.frames, args.steps, train_verts=traj,
                          lr_scale=args.lr_scale, device=args.device)
    trace = []
    t_start = time.perf_counter()
    for it in range(args.steps):
        t0 = time.perf_counter()
        loss, params = tr.train_one_step()
        rec = {"step": it, "loss": loss,
               "sec": round(time.perf_counter() - t0, 2), **params}
        trace.append(rec)
        print(json.dumps(rec), flush=True)
    wall = time.perf_counter() - t_start
    best = {k: float(v) for k, v in tr.best["params"].items()}
    summary = {
        "metric": "inverse_recovery_production",
        "truth": TRUTH, "best": best, "best_loss": float(tr.best["loss"]),
        "init_loss": trace[0]["loss"],
        "steps": args.steps, "wall_sec": round(wall, 1),
        "particles": tr.static.n_particles, "grid": args.grid,
        "frames": args.frames, "substeps_per_frame": args.substep,
        "err": {k: round(abs(best[k] - TRUTH[k]), 4) for k in TRUTH},
    }
    print(json.dumps(summary))
    if args.out:
        with open(args.out, "w") as f:
            for rec in trace:
                f.write(json.dumps(rec) + "\n")
            f.write(json.dumps(summary) + "\n")
        print(f"trace -> {args.out}", file=sys.stderr)
    return summary


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--bench", action="store_true")
    p.add_argument("--recover", action="store_true")
    p.add_argument("--grid", type=int, default=200)
    p.add_argument("--substep", type=int, default=400)
    p.add_argument("--nx", type=int, default=183,
                   help="cloth side (183 -> ~100k particles for --bench; "
                   "use 158 -> 25k verts / 74k particles for --recover)")
    p.add_argument("--frames", type=int, default=1)
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--lr_scale", type=float, default=1.0)
    p.add_argument("--out", default="")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA device)")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.bench:
        run_bench(args)
    if args.recover:
        run_recover(args)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
