"""The PyTorch port's full substep (p2g2p) against the JAX package and
against the scalar numpy reference (tests/reference_numpy.py)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__
from test_substep_golden import build_pair, compare, make_cloth
from test_torch_core import assert_close, port_collider, port_of

from mpmavatar_tpu.core import colliders as jcol
from mpmavatar_tpu.core import stepping as jstep
from mpmavatar_tpu.core import types as jtypes

from mpmavatar_tpu_torch.core import colliders as tcol
from mpmavatar_tpu_torch.core import stepping as tstep
from mpmavatar_tpu_torch.ops import splat as tsplat

torch.set_num_threads(1)

F32 = jnp.float32
FLOOR = jcol.SurfaceCollider(
    point=jnp.asarray([0.0, 0.1, 0.0], F32),
    normal=jnp.asarray([0.0, 1.0, 0.0], F32), friction=F32(0.0),
    start_time=F32(0.0), end_time=F32(999.0))
# golden bounds of tests/test_substep_golden.py::compare
ATOL = {"x": 2e-5, "v": 1e-3, "d": 2e-4}


def _run_both(cfg, state, model, colliders, n, dt=1e-4):
    tcfg, tst, tm = port_of(cfg, state, model)
    tcolliders = port_collider(colliders)
    for s in range(n):
        time = np.float32(s * dt)
        state = jstep.p2g2p(cfg, colliders, state, model, F32(dt),
                            F32(time))
        tst = tstep.p2g2p(tcfg, tcolliders, tst, tm, dt, float(time))
    return state, tst


def test_p2g2p_matches_jax_over_10_substeps():
    """The __graft_entry__ cloth scene (24x24 cloth, 48^3 grid, sticky
    floor, gravity) with random initial velocities: K1 -> K2 -> K5 -> K3
    (plain versions on the CPU) against JAX p2g2p."""
    cfg, state, model = __graft_entry__._build_cloth_scene()
    rng = np.random.default_rng(0)
    v0 = rng.normal(0, 0.05, (cfg.n_particles, 3)).astype(np.float32)
    state = dataclasses.replace(state, v=jnp.asarray(v0))
    ref, out = _run_both(cfg, state, model,
                         jcol.ColliderSet(grid_post=(FLOOR,)), 10)
    for name, atol in ATOL.items():
        assert_close(getattr(out, name), getattr(ref, name), atol, name)
    assert float(out.x[:, 1].min()) < 1.2       # it moved


def test_free_fall_matches_reference():
    verts, faces = make_cloth()
    ref, cfg, state, model = build_pair(verts, faces)
    tcfg, tst, tm = port_of(cfg, state, model)
    dt = 1e-4
    for s in range(10):
        ref.substep(dt)
        tst = tstep.p2g2p(tcfg, tcol.ColliderSet(), tst, tm, dt,
                          float(np.float32(s * dt)))
    compare(ref, dataclasses.replace(state, x=tst.x.numpy(),
                                     v=tst.v.numpy(), d=tst.d.numpy()),
            atol=2e-5)
    assert ref.x[:, 1].mean() < 1.0


def test_momentum_conservation_no_forces():
    """P2G + grid + G2P without gravity or stress conserves linear
    momentum (traditional particles, elastic material, zero moduli)."""
    rng = np.random.default_rng(0)
    n = 256
    cfg = jtypes.MPMStaticConfig(n_elements=0, n_traditional=n,
                                 n_vertices=0, n_grid=32, grid_lim=2.0,
                                 material=7)
    x = (0.6 + 0.8 * rng.random((n, 3))).astype(np.float32)
    state = jtypes.make_state(cfg, jnp.asarray(x), vol=jnp.full((n,), 1e-4),
                              density=jnp.ones((n,)))
    model = jtypes.make_model(n, E=0.0, nu=0.3)
    model = dataclasses.replace(model, gravity=jnp.zeros(3))
    v0 = rng.normal(scale=0.1, size=(n, 3)).astype(np.float32)
    state = dataclasses.replace(state, v=jnp.asarray(v0))
    tcfg, tst, tm = port_of(cfg, state, model)
    p_before = (tst.mass[:, None] * tst.v).sum(0)
    tst2 = tstep.p2g2p(tcfg, tcol.ColliderSet(), tst, tm, 1e-4, 0.0)
    p_after = (tst2.mass[:, None] * tst2.v).sum(0)
    assert_close(p_after, p_before, 1e-5)


def test_unfused_path_with_impulses_and_modifiers_matches_jax():
    """BCs the grid kernel does not cover (cuboid, grid mask) take the
    unfused grid_update + apply_grid_bc in both packages; particle
    impulses and velocity modifiers run before P2G."""
    verts, faces = make_cloth(nx=7, ny=7, y0=1.0, extent=0.4)
    _, cfg, state, model = build_pair(verts, faces, E=300.0, n_grid=32)
    P = cfg.n_particles
    rng = np.random.default_rng(1)
    mask = lambda: jnp.asarray((rng.random(P) > 0.7).astype(np.int32))
    grid_mask = np.zeros((32, 32, 32), np.int32)
    grid_mask[:, :3] = 1
    colliders = jcol.ColliderSet(
        grid_post=(
            jcol.CuboidCollider(point=jnp.asarray([1.0, 1.0, 0.85], F32),
                                size=jnp.asarray([0.1, 0.1, 0.1], F32),
                                velocity=jnp.asarray([0.0, 0.0, 0.2], F32),
                                start_time=F32(0.0), end_time=F32(1.0)),
            jcol.GridMaskCollider(mask=jnp.asarray(grid_mask))),
        impulses=(jcol.ParticleImpulse(
            mask=mask(), force=jnp.asarray([0.0, 0.0, 1e-4], F32),
            start_time=F32(0.0), end_time=F32(1.0)),
            jcol.ParticleImpulse(
            mask=mask(), force=jnp.asarray([0.1, 0.0, 0.0], F32),
            start_time=F32(0.0), end_time=F32(1.0), scale_by_mass=False)),
        velocity_modifiers=(jcol.ParticleVelocityModifier(
            mask=mask(), velocity=jnp.asarray([0.05, 0.0, 0.0], F32),
            start_time=F32(0.0), end_time=F32(1.0)),))
    ref, out = _run_both(cfg, state, model, colliders, 5)
    for name, atol in ATOL.items():
        assert_close(getattr(out, name), getattr(ref, name), atol, name)


def test_mesh_collider_and_mover_need_k4(monkeypatch):
    """With a mesh collider and the mover registered, a substep splats
    twice through K4's wrapper (collider faces with 6 channels, joint
    points with 3), and a missing collider mesh raises."""
    cfg, state, model = __graft_entry__._build_cloth_scene(nx=4, ny=4,
                                                           n_grid=16)
    cfg = dataclasses.replace(cfg, num_joint_v=3, num_joint_f=2)
    tcfg, tst, tm = port_of(cfg, state, model)
    mesh_x = torch.tensor([[0.9, 0.9, 0.9], [1.1, 0.9, 0.9],
                           [1.0, 0.9, 1.1]])
    mesh = tcol.MeshCollider(faces=torch.tensor([[0, 1, 2]]),
                             friction=torch.tensor(0.5))
    colliders = tcol.ColliderSet(mesh_colliders=(mesh,),
                                 use_particle_mover=True)
    calls = []
    real = tsplat.splat
    monkeypatch.setattr(tsplat, "splat", lambda p, v, *a, **k: (
        calls.append((p.shape[0], v.shape[1])) or real(p, v, *a, **k)))
    tstep.p2g2p(tcfg, colliders, tst, tm, 1e-4, 0.0, mesh_x=mesh_x,
                mesh_v=torch.zeros_like(mesh_x),
                joint_verts_v=torch.zeros((3, 3)),
                joint_faces_v=torch.zeros((2, 3)))
    assert calls == [(1, 6), (5, 3)]
    with pytest.raises(ValueError, match="mesh_x"):
        tstep.p2g2p(tcfg, colliders, tst, tm, 1e-4, 0.0)
