"""Closed-form substep fixtures against the port's ``p2g2p``: the cases of
tests/test_analytic_dynamics.py, whose answers come from first principles
and not from either package.

1. Single-particle ballistic flight: with one particle the grid velocity
   equals the particle's wherever the mass is nonzero, so G2P returns v
   exactly (the weights sum to 1) and the affine and velocity-gradient
   terms vanish (the weight gradients sum to 0): v += g dt, x += v dt to
   float32 rounding, and F_trial stays I.
2. Uniform translation: a cloth translating rigidly in zero gravity is
   stress-free and advects exactly (grid velocity = v everywhere, grad v
   = 0, F_trial stays I, the direction matrices d unchanged), through the
   whole element/vertex pipeline.

Each case takes a device: here they run the plain versions on the CPU,
and tests/test_torch_cuda.py runs them on the card through the kernels.
This file imports neither JAX nor the JAX package.
"""

import numpy as np
import torch

from mpmavatar_tpu_torch.core import stepping
from mpmavatar_tpu_torch.core.colliders import ColliderSet
from mpmavatar_tpu_torch.core.types import (MPMStaticConfig, build_cloth,
                                            cloth_geometry, make_model,
                                            make_state)

torch.set_num_threads(1)


def single_particle_ballistic(device):
    g, dt, n_steps = -9.8, 1e-4, 200
    x0 = np.array([[1.013, 1.507, 0.921]], np.float32)
    v0 = np.array([[0.31, 0.12, -0.24]], np.float32)
    cfg = MPMStaticConfig(n_elements=0, n_traditional=1, n_vertices=0,
                          n_grid=64, grid_lim=2.0, material=0)
    state = make_state(cfg, x0, vol=np.full((1,), 1e-6, np.float32),
                       density=np.ones((1,), np.float32), v=v0,
                       device=device)
    model = make_model(1, E=100.0, nu=0.3, device=device)

    x, v = x0[0].astype(np.float64), v0[0].astype(np.float64)
    for s in range(n_steps):
        state = stepping.p2g2p(cfg, ColliderSet(), state, model, dt,
                               float(np.float32(s * dt)))
        # symplectic Euler in closed form
        v = v + np.array([0.0, g, 0.0]) * dt
        x = x + v * dt

    np.testing.assert_allclose(state.v.cpu().numpy()[0], v, rtol=0,
                               atol=5e-5)
    np.testing.assert_allclose(state.x.cpu().numpy()[0], x, rtol=0,
                               atol=5e-6)
    # F_trial stays the identity (zero velocity gradient)
    np.testing.assert_allclose(state.F_trial.cpu().numpy()[0], np.eye(3),
                               atol=1e-6)


def uniform_translation(device):
    dt, n_steps = 1e-4, 100
    v0 = np.array([0.2, -0.1, 0.15], np.float32)
    verts, faces = build_cloth(6, 6, y0=1.0, extent=0.4)
    cfg = MPMStaticConfig(n_elements=len(faces), n_traditional=0,
                          n_vertices=len(verts), n_grid=48, grid_lim=2.0,
                          material=7)
    vt = torch.as_tensor(verts, device=device)
    ft = torch.as_tensor(faces, device=device).long()
    d0, r_inv, evol, vvol = cloth_geometry(vt, ft)
    x = torch.cat([vt[ft].mean(1), vt], 0)
    state = make_state(cfg, x, faces=faces, d=d0, R_inv=r_inv,
                       vol=torch.cat([evol, vvol]),
                       v=np.broadcast_to(v0, (cfg.n_particles, 3)),
                       device=device)
    model = make_model(cfg.n_particles, E=2000.0, nu=0.3, gamma=500.0,
                       kappa=500.0, gravity=(0.0, 0.0, 0.0), device=device)

    x_start = state.x.cpu().numpy()
    for s in range(n_steps):
        state = stepping.p2g2p(cfg, ColliderSet(), state, model, dt,
                               float(np.float32(s * dt)))

    shift = v0.astype(np.float64) * dt * n_steps
    np.testing.assert_allclose(state.x.cpu().numpy(), x_start + shift,
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(state.v.cpu().numpy(),
                               np.broadcast_to(v0, state.v.shape), rtol=0,
                               atol=1e-5)
    # rigid translation: no elastic response anywhere in the pipeline
    np.testing.assert_allclose(state.F_trial.cpu().numpy(),
                               np.broadcast_to(np.eye(3),
                                               state.F_trial.shape),
                               atol=2e-6)
    np.testing.assert_allclose(state.d.cpu().numpy(), d0.cpu().numpy(),
                               atol=2e-6)


def test_single_particle_ballistic():
    single_particle_ballistic("cpu")


def test_uniform_translation_is_exact():
    uniform_translation("cpu")
