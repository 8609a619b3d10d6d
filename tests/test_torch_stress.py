"""K1 (cloth stress) and compute_stress of the PyTorch port against the
JAX package: the plain version of the kernel against
cloth_stress_fused(interpret=True) and compute_stress(pallas=False)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_substep_golden import build_pair, make_cloth
from test_torch_core import assert_close, port_of, t

from mpmavatar_tpu.core import stepping as jstep
from mpmavatar_tpu.core import types as jtypes
from mpmavatar_tpu.ops.pallas_stress import cloth_stress_fused

from mpmavatar_tpu_torch.core import stepping as tstep
from mpmavatar_tpu_torch.ops import stress as tstress

torch.set_num_threads(1)

# stresses are tiny (vol ~ 1e-8): compare each output against its own
# magnitude, at the JAX package's own fused-vs-unfused tolerance (3e-5
# on O(1) values, tests/test_pallas_stress.py)
RTOL = 3e-5


def _scene(select_half=False):
    """The bent 9x9 cloth of tests/test_pallas_stress.py: noisy d with a
    scaled d3 so the separated / slipping branches and a non-trivial QR
    all get exercised."""
    verts, faces = make_cloth(nx=9, ny=9, y0=1.1, extent=0.5)
    _, cfg, state, model = build_pair(verts, faces, E=500.0)
    rng = np.random.default_rng(0)
    d = np.asarray(state.d)
    d = d + rng.normal(0, 0.02, d.shape).astype(np.float32)
    d[:, :, 2] *= rng.uniform(0.5, 1.6, (len(d), 1)).astype(np.float32)
    state = dataclasses.replace(state, d=jnp.asarray(d))
    if select_half:
        sel = np.zeros(cfg.n_particles, np.int32)
        sel[: cfg.n_elements // 2] = 1
        state = dataclasses.replace(state, selection=jnp.asarray(sel))
    return cfg, state, model


def _close_rel(port, ref, name):
    ref = np.asarray(ref)
    scale = max(float(np.abs(ref).max()), 1e-30)
    assert_close(np.asarray(port) / scale, ref / scale, RTOL, name)


@pytest.mark.parametrize("select_half", [False, True])
def test_cloth_stress_plain_matches_pallas_interpret(select_half):
    cfg, state, model = _scene(select_half)
    E = cfg.n_elements
    sel_e = (state.selection[:E] == 0).astype(jnp.float32)
    args = (state.d, state.R_inv, state.vol[:E], sel_e, model.mu[:E],
            model.lam[:E], model.gamma[:E], model.kappa[:E],
            model.friction_coeff)
    ref = cloth_stress_fused(*args, interpret=True)
    out = tstress.cloth_stress(*[t(a) for a in args])
    for a, b, n in zip(out, ref, ("new_d", "stress", "f1", "f2", "f3")):
        _close_rel(a, b, n)


@pytest.mark.parametrize("select_half", [False, True])
def test_compute_stress_matches_jax(select_half):
    cfg, state, model = _scene(select_half)
    ref = jstep.compute_stress(cfg, state, model, 1e-4, pallas=False)
    tcfg, tst, tm = port_of(cfg, state, model)
    out = tstep.compute_stress(tcfg, tst, tm, 1e-4)
    for a, b, n in zip(out, ref, ("new_d", "new_F", "yield", "stress",
                                  "vertex_force")):
        if np.asarray(b).size:
            _close_rel(a, b, n)


@pytest.mark.parametrize("material", [0, 1, 2, 3, 5, 6])
def test_compute_stress_traditional_matches_jax(material):
    """The traditional block (plain PyTorch in the port, XLA in the JAX
    package) for each material."""
    n = 96
    rng = np.random.default_rng(material)
    cfg = jtypes.MPMStaticConfig(n_elements=0, n_traditional=n,
                                 n_vertices=0, n_grid=32, grid_lim=2.0,
                                 material=material, hardening=1)
    x = jnp.asarray(rng.uniform(0.6, 1.4, (n, 3)), jnp.float32)
    state = jtypes.make_state(cfg, x, vol=jnp.full((n,), 1e-6),
                              yield_stress=20.0)
    f_trial = np.eye(3) + 0.15 * rng.standard_normal((n, 3, 3))
    sel = (rng.random(n) > 0.2).astype(np.int32)
    state = dataclasses.replace(
        state, F_trial=jnp.asarray(f_trial, jnp.float32),
        selection=jnp.asarray(sel))
    model = jtypes.make_model(n, E=2000.0, nu=0.3, xi=0.5,
                              plastic_viscosity=5.0)
    ref = jstep.compute_stress(cfg, state, model, 1e-4)
    tcfg, tst, tm = port_of(cfg, state, model)
    out = tstep.compute_stress(tcfg, tst, tm, 1e-4)
    for a, b, name in zip(out, ref, ("new_d", "new_F", "yield", "stress",
                                     "vertex_force")):
        b = np.asarray(b)
        if b.size:
            # stress is O(mu); near sigma = 1 log(svd) amplifies f32 noise
            assert_close(a, b, 3e-5 * max(1.0, float(np.abs(b).max())),
                         name)


def test_plain_version_runs_on_cpu_only_because_of_the_device():
    """On CPU tensors the wrapper returns the plain version's result."""
    cfg, state, model = _scene()
    tcfg, tst, tm = port_of(cfg, state, model)
    E = tcfg.n_elements
    args = (tst.d, tst.R_inv, tst.vol[:E], torch.ones(E), tm.mu[:E],
            tm.lam[:E], tm.gamma[:E], tm.kappa[:E], tm.friction_coeff)
    for a, b in zip(tstress.cloth_stress(*args),
                    tstress.cloth_stress_plain(*args)):
        assert torch.equal(a, b)
