"""Cloth drop onto a sticky floor under gravity, at the bench's width.

A flat nx x nx garment (default 183 x 183: 33,489 vertex and 66,248
element particles) at y = 1.3 over a 128^3 grid, anisotropic cloth
(E = 2000, nu = 0.3), sticky floor at y = 0.1, dt = 1e-4.  ``--body``
adds the JAX package's cloth-drop body (scripts/sim_cloth_drop.py): a
UV-sphere mesh collider at (1.0, 0.8, 1.0) with r = 0.3 and friction 0.5,
held still, whose top (y = 1.1) the cloth reaches after ~0.2 s and drapes
over.  Its faces wind outward: ``build_body_sphere`` winds them inward,
as the JAX package builds its bench and cloth-drop sphere, and an
inward-wound collider resists only motion out of the body, so a falling
cloth would pass through it.  Runs on the CUDA device through the port's kernels; ``--device
cpu`` runs the plain PyTorch path instead.

    python -m mpmavatar_tpu_torch.sim.cloth_drop --frames 2 --substeps 100
    python -m mpmavatar_tpu_torch.sim.cloth_drop --out_dir out/cloth_drop
    python -m mpmavatar_tpu_torch.sim.cloth_drop --body --frames 30
"""

from __future__ import annotations

import argparse
import os
import time

import torch

from ..core.types import build_body_sphere, build_cloth, cloth_scene
from .solver import MPMSolver

BODY_CENTER, BODY_R = (1.0, 0.8, 1.0), 0.3


def build(nx: int = 183, grid: int = 128, device=None, body: bool = False):
    """(solver, state, model) of the cloth-drop scene, with the body's
    mesh collider registered when ``body`` (its frame inputs come from
    ``body_scene``)."""
    verts, faces = build_cloth(nx, nx)
    cfg, state, model = cloth_scene(verts, faces, grid, device=device)
    solver = MPMSolver(cfg, device=state.x.device)
    solver.add_surface_collider([0.0, 0.1, 0.0], [0.0, 1.0, 0.0])
    if body:
        faces = build_body_sphere(center=BODY_CENTER, r=BODY_R)[1]
        solver.add_mesh_collider(faces[:, [0, 2, 1]], friction=0.5)
    return solver, state, model


def body_scene(device) -> dict:
    """The still body's frame inputs: mesh_x (Vb, 3), mesh_v = 0."""
    body_v = torch.as_tensor(build_body_sphere(center=BODY_CENTER,
                                               r=BODY_R)[0], device=device)
    return dict(mesh_x=body_v, mesh_v=torch.zeros_like(body_v))


def write_obj(path: str, verts, faces) -> None:
    with open(path, "w") as fh:
        for v in verts:
            fh.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        for f in faces:
            fh.write(f"f {f[0] + 1} {f[1] + 1} {f[2] + 1}\n")


def run(nx=183, grid=128, frames=2, substeps=100, dt=1e-4, out_dir=None,
        device=None, log=print, body=False):
    """Drop the cloth for ``frames`` x ``substeps`` substeps, onto the body
    when ``body``; returns the final state.  Writes one OBJ per frame when
    ``out_dir`` is given."""
    solver, state, model = build(nx, grid, device, body)
    scene = body_scene(state.x.device) if body else {}
    cfg = solver.cfg
    faces = state.faces.cpu().numpy()
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    t = 0.0
    for f in range(frames):
        t0 = time.perf_counter()
        state, t = solver.frame(state, model, dt, substeps, t, **scene)
        solver.check_finite(state, context=f"frame {f}")
        cloth = state.x[cfg.n_elements:].cpu().numpy()
        wall = time.perf_counter() - t0
        if out_dir:
            write_obj(os.path.join(out_dir, f"{f:03d}.obj"), cloth, faces)
        log(f"frame {f}: y range [{cloth[:, 1].min():.4f}, "
            f"{cloth[:, 1].max():.4f}], {1e3 * wall / substeps:.3f} "
            f"ms/substep")
    return state


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--nx", type=int, default=183)
    parser.add_argument("--grid", type=int, default=128)
    parser.add_argument("--frames", type=int, default=2)
    parser.add_argument("--substeps", type=int, default=100)
    parser.add_argument("--dt", type=float, default=1e-4)
    parser.add_argument("--out_dir", default=None,
                        help="write one OBJ of the cloth per frame here")
    parser.add_argument("--device", default=None,
                        help="default: the CUDA device")
    parser.add_argument("--body", action="store_true",
                        help="drape the cloth over a still sphere body")
    args = parser.parse_args(argv)
    run(args.nx, args.grid, args.frames, args.substeps, args.dt,
        args.out_dir, args.device, body=args.body)
    print("cloth drop complete")


if __name__ == "__main__":
    main()
