"""The bench's garment substep: cloth on a body-mesh collider with joint
pinning and a sticky floor, optionally under a falling sand block.

The scene of the JAX package's ``bench.py::run_sim``: a flat 183 x 183
cloth (33,489 vertex and 66,248 element particles) at y = 1.3, anisotropic
cloth (E = 2000, nu = 0.3), a UV-sphere body (4,512 faces) at (1.0, 0.9,
1.0) with r = 0.25 and friction 0.5 held still, the sticky floor at
y = 0.1, the particle mover pinning the first 256 vertices and 128 faces
with zero joint velocities, dt = 1e-4.  ``--sand N`` adds N sand particles
(material 2, vol 1e-7) in the block [0.6, 1.4] x [1.6, 1.7] x [0.8, 1.2]
drawn from ``np.random.default_rng(0)``, as the bench's 250^3 demo shape
does with N = 100,000.  Runs on the CUDA device through the port's
kernels; ``--device cpu`` runs the plain PyTorch path instead.
``substeps_per_sec`` times the scene as the JAX bench does (the
``mpmavatar_tpu_torch.bench`` driver's rates); the CLI logs each frame.

    python -m mpmavatar_tpu_torch.sim.bench_scene --grid 128
    python -m mpmavatar_tpu_torch.sim.bench_scene --grid 250 --sand 100000
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .. import resolve_device
from ..core.types import (MPMStaticConfig, build_body_sphere, build_cloth,
                          cloth_geometry, make_model, make_state)
from .solver import MPMSolver

NUM_JOINT_V, NUM_JOINT_F = 256, 128
DT = 1e-4
WARM_FRAMES, TIMED_FRAMES = 2, 5
BODY_CENTER, BODY_R = (1.0, 0.9, 1.0), 0.25


def sand_block(n: int) -> np.ndarray:
    """(n, 3) float32 sand positions, placed as the bench places them."""
    rng = np.random.default_rng(0)
    return (rng.random((n, 3)).astype(np.float32)
            * np.asarray([0.8, 0.1, 0.4])
            + np.asarray([0.6, 1.6, 0.8])).astype(np.float32)


def build(grid: int = 128, sand: int = 0, nx: int = 183,
          body_center=BODY_CENTER, body_r: float = BODY_R, device=None):
    """(solver, state, model, scene) of the bench scene; ``scene`` holds
    the frame inputs (mesh_x, mesh_v, joint_verts_v, joint_faces_v) as
    tensors on the device."""
    device = resolve_device(device)
    verts, faces = build_cloth(nx, nx)
    cfg = MPMStaticConfig(n_elements=len(faces), n_traditional=sand,
                          n_vertices=len(verts), n_grid=grid, grid_lim=2.0,
                          material=2 if sand else 7,
                          num_joint_v=min(NUM_JOINT_V, len(verts)),
                          num_joint_f=min(NUM_JOINT_F, len(faces)))
    v = torch.as_tensor(verts, device=device)
    f = torch.as_tensor(faces, device=device)
    dmat, r_inv, evol, vvol = cloth_geometry(v, f)
    x = torch.cat([v[f.long()].mean(1),
                   torch.as_tensor(sand_block(sand), device=device), v], 0)
    vol = torch.cat([evol, torch.full((sand,), 1e-7, device=device), vvol])
    state = make_state(cfg, x, faces=f, d=dmat, R_inv=r_inv, vol=vol,
                       device=device)
    model = make_model(cfg.n_particles, E=2000.0, nu=0.3, device=device)

    body_v, body_f = build_body_sphere(center=body_center, r=body_r)
    solver = MPMSolver(cfg, device=device)
    solver.add_surface_collider([0.0, 0.1, 0.0], [0.0, 1.0, 0.0])
    solver.add_mesh_collider(body_f, friction=0.5)
    solver.add_particle_mover()
    zeros = lambda n: torch.zeros((n, 3), device=device)
    scene = dict(mesh_x=torch.as_tensor(body_v, device=device),
                 mesh_v=zeros(len(body_v)),
                 joint_verts_v=zeros(cfg.num_joint_v),
                 joint_faces_v=zeros(cfg.num_joint_f))
    return solver, state, model, scene


def run(grid=128, sand=0, frames=2, substeps=100, dt=DT, nx=183,
        device=None, log=print):
    """``frames`` x ``substeps`` substeps of the bench scene; returns the
    final state."""
    solver, state, model, scene = build(grid, sand, nx, device=device)
    cfg = solver.cfg
    cloth = slice(cfg.n_no_vertices, None)
    sand_sl = slice(cfg.n_elements, cfg.n_no_vertices)
    t = 0.0
    for f in range(frames):
        t0 = time.perf_counter()
        state, t = solver.frame(state, model, dt, substeps, t, **scene)
        solver.check_finite(state, context=f"frame {f}")
        y = state.x[:, 1].cpu()
        wall = time.perf_counter() - t0
        msg = (f"frame {f}: cloth y range [{float(y[cloth].min()):.4f}, "
               f"{float(y[cloth].max()):.4f}]")
        if sand:
            msg += f", sand mean y {float(y[sand_sl].mean()):.6f}"
        log(f"{msg}, {1e3 * wall / substeps:.3f} ms/substep")
    return state


def substeps_per_sec(grid=128, sand=0, device=None, nx=183,
                     substeps=100) -> float:
    """Substeps per second of the bench scene, timed as the JAX
    ``bench.py::run_sim`` times it: WARM_FRAMES frames, then TIMED_FRAMES
    frames of ``substeps`` substeps at dt = 1e-4 ending in one
    synchronize; raises unless the state is finite."""
    solver, state, model, scene = build(grid, sand, nx, device=device)
    cuda = solver.device.type == "cuda"
    t = 0.0
    for _ in range(WARM_FRAMES):
        state, t = solver.frame(state, model, DT, substeps, t, **scene)
    if cuda:
        torch.cuda.synchronize(solver.device)
    t0 = time.perf_counter()
    for _ in range(TIMED_FRAMES):
        state, t = solver.frame(state, model, DT, substeps, t, **scene)
    if cuda:
        torch.cuda.synchronize(solver.device)
    wall = time.perf_counter() - t0
    solver.check_finite(state, context="timed frames")
    return TIMED_FRAMES * substeps / wall


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--grid", type=int, default=128,
                        help="128 (the bench's headline), 200 (training), "
                        "250 (the demo shape, with --sand 100000)")
    parser.add_argument("--sand", type=int, default=0)
    parser.add_argument("--nx", type=int, default=183,
                        help="cloth vertices per side")
    parser.add_argument("--frames", type=int, default=2)
    parser.add_argument("--substeps", type=int, default=100)
    parser.add_argument("--device", default=None,
                        help="default: the CUDA device")
    args = parser.parse_args(argv)
    run(args.grid, args.sand, args.frames, args.substeps, nx=args.nx,
        device=args.device)
    print("bench scene complete")


if __name__ == "__main__":
    main()
