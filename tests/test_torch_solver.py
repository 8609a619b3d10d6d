"""The PyTorch port's MPMSolver and cloth-drop driver against the JAX
solver (CPU)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_substep_golden import build_pair, make_cloth
from test_torch_core import assert_close, port_collider, port_of

from mpmavatar_tpu.core import types as jtypes
from mpmavatar_tpu.sim import MPMSolver as JSolver

from mpmavatar_tpu_torch import convert
from mpmavatar_tpu_torch.core import stepping
from mpmavatar_tpu_torch.core.types import MPMStaticConfig
from mpmavatar_tpu_torch.sim import MPMSolver, cloth_drop

torch.set_num_threads(1)


def _register(solver, state):
    solver.add_surface_collider([0.0, 0.1, 0.0], [0.0, 1.0, 0.0])
    solver.add_bounding_box()
    solver.add_impulse_on_particles(
        (np.arange(state.x.shape[0]) % 5 == 0).astype(np.int32),
        [0.0, 0.0, 1e-4], end_time=0.0007)


def test_frame_matches_jax_solver():
    """2 frames x 5 substeps with a sticky floor, a bounding box and an
    impulse: MPMSolver.frame against the JAX MPMSolver.frame
    (column_k=0)."""
    verts, faces = make_cloth(nx=7, ny=7, y0=1.05, extent=0.4)
    _, cfg, state, model = build_pair(verts, faces, E=300.0, n_grid=32)
    rng = np.random.default_rng(2)
    state = dataclasses.replace(state, v=jnp.asarray(
        rng.normal(0, 0.05, (cfg.n_particles, 3)), jnp.float32))
    tcfg, tst, tm = port_of(cfg, state, model)
    js = JSolver(cfg, column_k=0)
    ts = MPMSolver(tcfg, device="cpu")
    _register(js, state)
    _register(ts, tst)
    t_j = t_t = 0.0
    for _ in range(2):
        state, t_j = js.frame(state, model, 1e-4, 5, t_j)
        tst, t_t = ts.frame(tst, tm, 1e-4, 5, t_t)
    assert t_t == float(t_j)
    for name, atol in (("x", 2e-5), ("v", 1e-3), ("d", 2e-4)):
        assert_close(getattr(tst, name), getattr(state, name), atol, name)


def test_registration_matches_jax_solver():
    """Every registration call builds the same colliders as the JAX
    solver's (same types, same values, same order)."""
    verts, faces = make_cloth(nx=5, ny=5)
    _, cfg, state, model = build_pair(verts, faces)
    tcfg, tst, _ = port_of(cfg, state, model)

    def register(s, st):
        _register(s, st)
        s.add_surface_collider([0, 0.5, 0], [0, 1, 1], surface="slip")
        s.add_surface_collider([0, 0.5, 0], [1, 1, 0], surface="friction",
                               friction=0.3)
        s.set_velocity_on_cuboid([1, 1, 1], [0.1, 0.1, 0.1], [0, 0, 1],
                                 reset=1)
        s.enforce_grid_velocity_by_mask(np.zeros((32, 32, 32), np.int32))
        s.enforce_particle_velocity_translation(st, [1.0, 1.0, 1.0],
                                                [0.1, 0.5, 0.1], [0, 0.1, 0])
        s.enforce_particle_velocity_rotation(st, [1.0, 1.0, 1.0],
                                             [0, 1, 0], (0.5, 0.1), 2.0,
                                             0.1)
        s.release_particles_sequentially(st, [0, 1, 0], 0.9, 1.1, 0.0,
                                         0.5, num_layers=3)

    js, ts = JSolver(cfg), MPMSolver(tcfg, device="cpu")
    register(js, state)
    register(ts, tst)
    ref = port_collider(js.colliders)
    assert len(ts.colliders.velocity_modifiers) == 5
    for group in ("grid_post", "impulses", "velocity_modifiers"):
        for a, b in zip(getattr(ts.colliders, group), getattr(ref, group)):
            assert type(a) is type(b)
            for f in dataclasses.fields(a):
                va, vb = getattr(a, f.name), getattr(b, f.name)
                if isinstance(va, torch.Tensor):
                    assert_close(va, vb, 1e-6, f.name)
                else:
                    assert va == vb, f.name


def test_mesh_collider_and_mover_registration_need_k4():
    """Registering a body-mesh collider and the mover (both run through
    K4, the splat) builds what the JAX solver's registration builds."""
    cfg = jtypes.MPMStaticConfig(n_elements=0, n_traditional=4,
                                 n_vertices=0, n_grid=8)
    faces = np.arange(12, dtype=np.int32).reshape(4, 3)
    js = JSolver(cfg)
    ts = MPMSolver(MPMStaticConfig(**dataclasses.asdict(cfg)), device="cpu")
    for s in (js, ts):
        s.add_mesh_collider(faces, friction=0.5)
        s.add_particle_mover()
    assert ts.colliders.use_particle_mover
    jmc = js.colliders.mesh_colliders[0]
    ref = convert.mesh_collider_from_numpy(np.asarray(jmc.faces),
                                           np.asarray(jmc.friction), "cpu")
    (out,) = ts.colliders.mesh_colliders
    assert out.faces.dtype == torch.int64
    assert torch.equal(out.faces, ref.faces)
    assert float(out.friction) == float(ref.friction) == 0.5


def test_grid_stage_is_bound_once_per_collider_set():
    """The solver packs K5's surface parameters once per collider set and
    rebinds after every registration; the bound stage runs what an
    unbound p2g2p builds for itself."""
    solver, state, model = cloth_drop.build(nx=6, grid=16, device="cpu")
    stage = solver.grid_stage()
    assert solver.grid_stage() is stage
    ref = stepping.p2g2p(solver.cfg, solver.colliders, state, model, 1e-4,
                         0.0)
    out = solver.substep(state, model, 1e-4, 0.0)
    assert torch.equal(out.x, ref.x) and torch.equal(out.v, ref.v)
    solver.add_surface_collider([0.0, 1.5, 0.0], [0.0, -1.0, 0.0],
                                surface="slip")
    rebound = solver.grid_stage()
    assert rebound is not stage
    solver.colliders = solver.colliders
    assert solver.grid_stage() is not rebound


def test_check_finite_raises_on_nan():
    solver, state, _ = cloth_drop.build(nx=4, grid=16, device="cpu")
    solver.check_finite(state)
    bad = dataclasses.replace(state, v=state.v.clone())
    bad.v[3, 1] = float("nan")
    with pytest.raises(FloatingPointError, match="v"):
        solver.check_finite(bad)


def test_cloth_drop_driver_writes_frames(tmp_path):
    logs = []
    state = cloth_drop.run(nx=8, grid=32, frames=2, substeps=10,
                           out_dir=str(tmp_path), device="cpu",
                           log=logs.append)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["000.obj",
                                                          "001.obj"]
    text = (tmp_path / "001.obj").read_text().splitlines()
    assert sum(line.startswith("v ") for line in text) == 64
    assert sum(line.startswith("f ") for line in text) == 2 * 7 * 7
    assert len(logs) == 2 and torch.isfinite(state.x).all()
    fall = 1.3 - float(state.x[:, 1].mean())
    expect = 9.8 * 1e-8 * 20 * 21 / 2                # g dt^2 n(n+1)/2
    assert abs(fall / expect - 1.0) < 0.02
