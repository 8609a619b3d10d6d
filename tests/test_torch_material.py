"""Stage-3 material training in the port against the JAX package, on the
CPU: the solver remainder (SimTransform, the parameter setters, the
covariance helpers, cfl_dt), ``MPMSolver.frame(remat=True)``, the
material trainer (its rollout loss and gradient, autodiff and
finite-difference steps, best and saved parameters, simulate) and its
command line.

The trainer's scene is ``test_inverse_recovery._hanging_cloth(5, 5)``
(57 particles) pinned along its top row, on a 16^3 grid, 2 frames x 50
substeps at 200 fps (dt = 1e-4), the rest shape 10% shorter in y than
the start (so D, E and H each move the loss well above rounding), and a
tracked trajectory that turns about the vertical axis: the pinned row
moves with a non-uniform velocity, so the mover's splat has a nonzero
gradient w.r.t. its points.  The JAX trainer runs its dense reference
path (column_k = 0, column_c_cap = 0, mesh_column_k = 0).  Tolerances
are relative to the JAX value, stated beside each check.
"""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_inverse_recovery import _hanging_cloth
from test_torch_core import port_of

from mpmavatar_tpu.core import types as jtypes
from mpmavatar_tpu.sim import solver as jsolver
from mpmavatar_tpu.train.material import MaterialTrainer as JTrainer
from mpmavatar_tpu.train.material import \
    MaterialTrainerConfig as JTrainerConfig

from mpmavatar_tpu_torch import convert
from mpmavatar_tpu_torch.core import stepping as tstep
from mpmavatar_tpu_torch.core.types import build_body_sphere
from mpmavatar_tpu_torch.ops import grid_pipeline as tgp
from mpmavatar_tpu_torch.ops import splat as tsplat
from mpmavatar_tpu_torch.ops import stress as tstress
from mpmavatar_tpu_torch.ops import transfer as ttr
from mpmavatar_tpu_torch.sim import solver as tsolver
from mpmavatar_tpu_torch.train import bench_material, train_material
from mpmavatar_tpu_torch.train.material import (MaterialTrainer,
                                                MaterialTrainerConfig)
from mpmavatar_tpu_torch.utils.schedules import cosine_lr

torch.set_num_threads(1)

NX = NY = 5
GRID, FRAMES, SUBSTEPS, FPS = 16, 2, 50, 200.0
OMEGA = 2.0          # rad/s about the vertical axis through x = z = 1
KNOBS = dict(grid_size=GRID, substep=SUBSTEPS, fps=FPS, iterations=10,
             lr_D=0.04, lr_E=0.08, lr_H=0.008)
# the solver remainder: the same float32 formulas
FN_TOL = 1e-6
# the rollout: 100 substeps of float32 sums in other orders
LOSS_TOL = 1e-5
GRAD_TOL = 1e-3
# the parameters after Adam steps on those gradients
PARAM_TOL = 1e-4
# simulate's vertices (world units), as the solver's golden bound
SIM_ATOL = 2e-5


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max()) / max(float(np.abs(b).max()), 1e-30)


def _turned(verts, angle):
    """``verts`` turned by ``angle`` about the vertical axis through
    x = z = 1."""
    c, s = np.cos(angle), np.sin(angle)
    x, z = verts[:, 0] - 1.0, verts[:, 2] - 1.0
    return np.stack([1.0 + c * x + s * z, verts[:, 1],
                     1.0 - s * x + c * z], -1).astype(np.float32)


def scene(frames=FRAMES, seed=0):
    """(faces, first_frame_verts, train_verts, body_seq, body_faces,
    num_joint_v): the cloth turning at OMEGA, seeded noise of 1e-3 on the
    tracked free vertices, the rest shape 10% shorter in y."""
    verts, faces = _hanging_cloth(nx=NX, ny=NY)
    rng = np.random.default_rng(seed)
    train = np.stack([_turned(verts, OMEGA * i / FPS)
                      for i in range(frames + 1)])
    train[1:, NY:] += rng.normal(0, 1e-3, train[1:, NY:].shape).astype(
        np.float32)
    first = verts * np.float32([1.0, 0.9, 1.0])
    bv, bf = build_body_sphere(n_theta=8, n_phi=8, center=(1.0, 0.85, 1.12),
                               r=0.12)
    body = np.repeat(bv[None], frames + 1, 0)
    return faces, first, train, body, bf, NY


def _trainers(frames=FRAMES):
    faces, first, train, body, bf, nj = scene(frames)
    jt = JTrainer(JTrainerConfig(**KNOBS, column_k=0, column_c_cap=0,
                                 mesh_column_k=0),
                  faces, first, train, body, bf, nj, 0)
    tt = MaterialTrainer(MaterialTrainerConfig(**KNOBS), faces, first,
                         train, body, bf, nj, 0, device="cpu")
    return jt, tt


# ----------------------------------------------------------------------
# (a) the solver remainder
# ----------------------------------------------------------------------
def _mixed_state():
    """A JAX cloth + traditional state with random F_trial, cov, v."""
    verts, faces = _hanging_cloth(nx=4, ny=4)
    E, T, V = len(faces), 6, len(verts)
    cfg = jtypes.MPMStaticConfig(n_elements=E, n_traditional=T,
                                 n_vertices=V, n_grid=16, material=0)
    rng = np.random.default_rng(3)
    x = np.concatenate([verts[faces].mean(1),
                        rng.uniform(0.8, 1.2, (T, 3)), verts]).astype(
        np.float32)
    state = jtypes.make_state(cfg, jnp.asarray(x), faces=faces,
                              vol=jnp.asarray(rng.uniform(1e-4, 2e-4,
                                                          len(x)),
                                              jnp.float32))
    f = np.eye(3) + 0.1 * rng.normal(size=(T, 3, 3))
    state = dataclasses.replace(
        state, F_trial=jnp.asarray(f, jnp.float32),
        cov=jnp.asarray(rng.normal(size=(E + T, 6)), jnp.float32),
        v=jnp.asarray(rng.normal(size=x.shape), jnp.float32))
    model = jtypes.make_model(cfg.n_particles)
    return cfg, state, model


def test_sim_transform_matches_jax():
    verts = np.random.default_rng(0).normal(size=(50, 3)).astype(np.float32)
    jt, tt = jsolver.SimTransform.from_verts(verts), \
        tsolver.SimTransform.from_verts(verts)
    assert tt.scale == jt.scale and np.array_equal(tt.shift, jt.shift)
    assert tt.shift.dtype == np.float32
    p = np.random.default_rng(1).normal(size=(30, 3)).astype(np.float32)
    for name in ("wld2sim", "sim2wld", "vel2sim"):
        a = getattr(tt, name)(torch.as_tensor(p)).numpy()
        assert _rel(a, getattr(jt, name)(jnp.asarray(p))) <= FN_TOL, name


def test_parameter_setters_match_jax():
    cfg, state, model = _mixed_state()
    tcfg, tst, tm = port_of(cfg, state, model)
    params = {"material": "sand", "g": [0.0, -3.0, 0.5],
              "friction_angle": 32.0, "rpic_damping": 0.1, "xi": 0.2,
              "yield_stress": 0.7, "density": 2.5, "hardening": 1}
    jc, jm, js = jsolver.set_parameters_dict(cfg, model, state, params)
    tc, tmm, tss = tsolver.set_parameters_dict(tcfg, tm, tst, params)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    for obj_t, obj_j in ((tmm, jm), (tss, js)):
        for f in dataclasses.fields(obj_t):
            a, b = getattr(obj_t, f.name), getattr(obj_j, f.name)
            assert tuple(a.shape) == tuple(np.shape(b)), f.name
            assert _rel(a, b) <= FN_TOL, f.name

    per = np.random.default_rng(4).uniform(100, 200, cfg.n_particles)
    for kw in ({"E": 300.0, "nu": 0.25}, {"E": per, "gamma": 10.0},
               {"kappa": 3.0}):
        for finalize in (True, False):
            a = tsolver.set_E_nu(tm, finalize=finalize, **kw)
            b = jsolver.set_E_nu(model, finalize=finalize, **kw)
            for f in ("E", "nu", "gamma", "kappa", "mu", "lam"):
                assert _rel(getattr(a, f), getattr(b, f)) <= FN_TOL, f

    box = ([1.0, 1.0, 1.0], [0.15, 0.3, 0.2])
    a_m, a_s = tsolver.set_parameters_in_box(tm, tst, *box, E=50.0, nu=0.2,
                                             density=3.0)
    b_m, b_s = jsolver.set_parameters_in_box(model, state, *box, E=50.0,
                                             nu=0.2, density=3.0)
    inside = int((np.asarray(b_s.density) == 3.0).sum())
    assert 0 < inside < cfg.n_particles
    for f in ("E", "nu", "mu", "lam"):
        assert _rel(getattr(a_m, f), getattr(b_m, f)) <= FN_TOL, f
    for f in ("density", "mass"):
        assert _rel(getattr(a_s, f), getattr(b_s, f)) <= FN_TOL, f

    for dens in (1.7, np.random.default_rng(5).uniform(1, 2,
                                                       cfg.n_particles)):
        for update in (True, False):
            a = tsolver.reset_density(tst, dens, update_mass=update)
            b = jsolver.reset_density(state, dens, update_mass=update)
            for f in ("density", "mass"):
                assert _rel(getattr(a, f), getattr(b, f)) <= FN_TOL, f


def test_reset_density_keeps_mass_in_the_graph():
    cfg, state, model = _mixed_state()
    _, tst, _ = port_of(cfg, state, model)
    d = torch.tensor(1.5, requires_grad=True)
    mass = tsolver.reset_density(tst, d).mass
    (g,) = torch.autograd.grad(mass.sum(), d)
    assert torch.allclose(g, tst.vol.sum())


def test_covariance_and_cfl_match_jax():
    cfg, state, model = _mixed_state()
    tcfg, tst, _ = port_of(cfg, state, model)
    assert _rel(tsolver.export_particle_cov(tst, tcfg),
                jsolver.export_particle_cov(state, cfg)) <= FN_TOL
    grad_v = np.random.default_rng(6).normal(
        size=(cfg.n_particles, 3, 3)).astype(np.float32)
    assert _rel(tsolver.update_cov(tst, tcfg, torch.as_tensor(grad_v), 1e-3),
                jsolver.update_cov(state, cfg, jnp.asarray(grad_v), 1e-3)
                ) <= FN_TOL
    assert tsolver.cfl_dt(tst, tcfg) == pytest.approx(
        jsolver.cfl_dt(state, cfg), rel=FN_TOL)
    still = dataclasses.replace(tst, v=torch.zeros_like(tst.v))
    assert tsolver.cfl_dt(still, tcfg) == jsolver.cfl_dt(
        dataclasses.replace(state, v=jnp.zeros_like(state.v)), cfg)


def test_cosine_lr_matches_jax():
    from mpmavatar_tpu.utils.schedules import cosine_lr as jcos
    for total, eta in ((10, 0.0), (200, 0.1), (0, 0.0)):
        for step in (0, 1, 5, 10, 250):
            assert cosine_lr(1.0, total, eta)(step) == \
                jcos(1.0, total, eta)(step)


# ----------------------------------------------------------------------
# (b) frame(remat=True)
# ----------------------------------------------------------------------
def test_frame_remat_is_the_same_forward_and_gradient():
    """A checkpointed substep recomputes the same operations: the forward
    is bit for bit that of remat=False, and d(loss)/d(mu, mass) equal to
    rounding (the backward sums the same terms)."""
    _, tt = _trainers(frames=1)
    data = tt._rollout_data
    outs = {}
    for remat in (False, True):
        mu = tt.model0.mu.clone().requires_grad_(True)
        mass = tt.base_state.mass.clone().requires_grad_(True)
        model = dataclasses.replace(tt.model0, mu=mu)
        state = dataclasses.replace(tt.base_state, mass=mass,
                                    R_inv=tt._rest_dir_inv(1.0))
        jv = data["joint_velo_sim"][0]
        out, t = tt.solver.frame(state, model, 1e-4, 8, 0.0,
                                 mesh_x=data["smplx_sim"][0],
                                 mesh_v=data["smplx_velo_sim"][0],
                                 joint_verts_v=jv, remat=remat)
        loss = ((out.x[tt.static.n_elements:] - data["target_sim"][0]) ** 2
                ).sum()
        outs[remat] = (out, t, torch.autograd.grad(loss, (mu, mass)))
    (a, ta, ga), (b, tb, gb) = outs[False], outs[True]
    assert ta == tb
    for f in ("x", "v", "C", "d"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    for x, y in zip(ga, gb):
        assert float(y.abs().max()) > 0
        assert _rel(y, x) <= 1e-6


# ----------------------------------------------------------------------
# (c)-(e) the trainer
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def pair():
    return _trainers()


def _jax_grads(jt):
    (loss, _), grads = jt._rollout_loss(jt.params)
    return float(loss), {k: float(v) for k, v in grads.items()}


def _count_wrapper_calls(monkeypatch):
    """Count the calls of each kernel wrapper (on the card: its
    launches) by kernel name."""
    counts = {}

    def counted(module, attr, name):
        real = getattr(module, attr)

        def wrapper(*a, **k):
            counts[name] = counts.get(name, 0) + 1
            return real(*a, **k)
        monkeypatch.setattr(module, attr, wrapper)

    counted(tstress, "cloth_stress", tstress.KERNEL)
    counted(ttr, "p2g", ttr.P2G_KERNEL)
    counted(ttr, "g2p", ttr.G2P_KERNEL)
    counted(tsplat, "splat", tsplat.KERNEL)
    counted(tgp, "grid_pipeline_plain", tgp.KERNEL)
    return counts


def test_rollout_loss_and_gradient_match_jax(pair, monkeypatch):
    """The trainer's loss and d/d(D, E, H) against the JAX trainer's
    ``_rollout_loss``; each gradient is nonzero.  Each substep runs its
    kernels three times: in the forward, in its frame's recompute and in
    its own recompute (two-level checkpointing)."""
    jt, tt = pair
    j_loss, j_grads = _jax_grads(jt)
    counts = _count_wrapper_calls(monkeypatch)
    loss = tt.rollout_loss(tt.params)
    grads = torch.autograd.grad(loss, [tt.params[k] for k in "DEH"])
    n_sub = FRAMES * SUBSTEPS
    assert counts == {"cloth_stress": 3 * n_sub, "p2g": 3 * n_sub,
                      "grid_pipeline": 3 * n_sub, "g2p": 3 * n_sub,
                      "splat": 6 * n_sub}
    assert _rel(float(loss.detach()), j_loss) <= LOSS_TOL
    for k, g in zip("DEH", grads):
        assert j_grads[k] != 0.0, k
        assert _rel(float(g), j_grads[k]) <= GRAD_TOL, (k, float(g),
                                                        j_grads[k])


def test_pinned_faces_past_the_pinned_vertices_match_jax():
    """Pinned faces that name vertices past the pinned prefix (the
    hanging cloth's first faces reach its second row): JAX's gather
    clamps those indices to the last pinned vertex, and the port's
    rollout loss and simulate agree with it (the port raised an
    IndexError before)."""
    faces, first, train, body, bf, nj = scene(frames=1)
    nf = 2
    assert int(faces[:nf].max()) >= nj
    jt = JTrainer(JTrainerConfig(**KNOBS, column_k=0, column_c_cap=0,
                                 mesh_column_k=0),
                  faces, first, train, body, bf, nj, nf)
    tt = MaterialTrainer(MaterialTrainerConfig(**KNOBS), faces, first,
                         train, body, bf, nj, nf, device="cpu")
    j_loss, _ = _jax_grads(jt)
    with torch.no_grad():
        loss = float(tt.rollout_loss(tt.params))
    assert _rel(loss, j_loss) <= LOSS_TOL
    jv = np.linspace(0.0, 0.1, 3 * nj, dtype=np.float32).reshape(nj, 3)
    args = (train[0], np.zeros_like(train[0]), body[:1],
            np.zeros_like(body[:1]), 1)
    ref = jt.simulate(*args, joint_velo_fn=lambda i: jnp.asarray(jv))
    out = tt.simulate(*args, joint_velo_fn=lambda i: jv)
    np.testing.assert_allclose(out[0], np.asarray(ref[0]), atol=SIM_ATOL)


def test_mover_splat_is_on_the_gradient_path(monkeypatch):
    """From the second substep on the mover splats pinned positions that
    require grad, and its backward gives them a nonzero gradient.  Those
    positions do not depend on D, E or H (every node of a pinned
    vertex's stencil takes the mover's velocity), so that gradient adds
    nothing to d/d(D, E, H): with the points detached it is the same, bit
    for bit."""
    _, tt = _trainers(frames=1)
    seen = []
    real_splat = tsplat.splat

    def splat(points, values, *a):
        if points.requires_grad:
            points.register_hook(lambda g: seen.append(float(g.abs().max())))
        return real_splat(points, values, *a)

    monkeypatch.setattr(tsplat, "splat", splat)
    leaves = [tt.params[k] for k in "DEH"]
    full = torch.autograd.grad(tt.rollout_loss(tt.params), leaves)
    assert len(seen) == SUBSTEPS - 1 and max(seen) > 0
    real = tstep.mover_points
    monkeypatch.setattr(tstep, "mover_points", lambda *a, **k: tuple(
        p.detach() for p in real(*a, **k)))
    cut = torch.autograd.grad(tt.rollout_loss(tt.params), leaves)
    assert all(torch.equal(a, b) for a, b in zip(full, cut))


def test_bench_material_runs_a_cut_production_scene(capsys):
    """bench_material's scene cut to 5 x 5 on 16^3: its JSON line holds
    the step and substep times, the particle count and dt."""
    out = bench_material.main(["--nx", "5", "--grid", "16", "--frames", "1",
                               "--substep", "5", "--fps", "2000",
                               "--steps", "1", "--device", "cpu"])
    assert out == 0
    line = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert line["particles"] == 5 * 5 + 2 * 4 * 4 and line["device"] == "cpu"
    assert line["dt"] == pytest.approx(1e-4)
    assert line["ms_per_differentiated_substep"] == pytest.approx(
        line["ms_per_step"] / 5)
    assert line["peak_allocated_gib"] is None
    assert all(np.isfinite(line["losses"]))


def _optax_adam(jt):
    """name -> (mu, nu, count) of the JAX trainer's per-parameter Adam."""
    out = {}
    inner = jt.opt_state[0].inner_states
    for k in "DEH":
        adam = inner[k].inner_state[0]
        out[k] = (float(adam.mu[k]), float(adam.nu[k]), int(adam.count))
    return out


def test_simulate_matches_jax(pair):
    jt, tt = pair
    faces, first, train, body, bf, nj = scene()
    velo0 = (train[1] - train[0]) * FPS
    body_v = np.zeros_like(body)
    jv = lambda i: (train[i + 1, :nj] - train[i, :nj]) * FPS
    a = tt.simulate(train[0], velo0, body, body_v, FRAMES,
                    joint_velo_fn=jv)
    b = jt.simulate(train[0], velo0, body, body_v, FRAMES,
                    joint_velo_fn=lambda i: jnp.asarray(jv(i)))
    assert len(a) == len(b) == FRAMES
    for x, y in zip(a, b):
        assert np.isfinite(x).all()
        np.testing.assert_allclose(x, np.asarray(y), atol=SIM_ATOL)
    assert np.abs(a[-1] - train[0]).max() > 1e-4


# ----------------------------------------------------------------------
# (f) the command line
# ----------------------------------------------------------------------
def test_cli_trains_and_writes_the_parameters(tmp_path, capsys):
    faces, first, train, body, bf, nj = scene(frames=1)
    npz = tmp_path / "train.npz"
    np.savez(npz, train_verts=train, smplx_verts=body, smplx_faces=bf,
             cloth_faces=faces, first_frame_verts=first, num_joint_v=nj,
             num_joint_f=0)
    cfg = tmp_path / "cfg.json"
    cfg.write_text('{"grid_size": 16, "substep": 5, "iterations": 2}')
    out = tmp_path / "out"
    assert train_material.main([
        "--tracked_verts_npz", str(npz), "--config", str(cfg),
        "--output_dir", str(out), "--log_iters", "2", "--device",
        "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split()[:2] for ln in lines] == [["step", "0"], ["step", "1"]]
    saved = np.load(out / "last_param_00002.npz")
    assert int(saved["step"]) == 2 and np.isfinite(saved["D"])
    assert (out / "best_param_00002.npz").exists()
    bad = tmp_path / "bad.json"
    bad.write_text('{"no_such_knob": 1}')
    with pytest.raises(SystemExit):
        train_material.main(["--tracked_verts_npz", str(npz), "--config",
                             str(bad), "--device", "cpu"])


def test_train_steps_match_jax(pair, tmp_path):
    """Three autodiff steps and a finite-difference step: parameters,
    losses and ``best`` against the JAX trainer's, and the saved npz.
    The finite-difference step starts both from the JAX trainer's state,
    carried into the port by ``convert.material_params_from_numpy``.
    (Last in the file: it steps the module's trainers.)"""
    jt, tt = pair
    for step in range(3):
        j_loss, j_p = jt.train_one_step()
        t_loss, t_p = tt.train_one_step()
        assert _rel(t_loss, j_loss) <= LOSS_TOL, step
        for k in "DEH":
            assert _rel(t_p[k], j_p[k]) <= PARAM_TOL, (step, k)
            assert t_p[k] != KNOBS.get(f"init_{k}", 1.0), k
    assert _rel(tt.best["loss"], jt.best["loss"]) <= LOSS_TOL
    for k in "DEH":
        assert _rel(tt.best["params"][k], jt.best["params"][k]) <= PARAM_TOL

    jt.save(str(tmp_path / "jax"))
    tt.save(str(tmp_path / "port"))
    for name in ("best_param_00003.npz", "last_param_00003.npz"):
        a = np.load(tmp_path / "port" / name)
        b = np.load(tmp_path / "jax" / name)
        assert sorted(a.files) == sorted(b.files)
        for f in b.files:
            assert a[f].dtype == b[f].dtype, (name, f)
            assert _rel(a[f], b[f]) <= PARAM_TOL, (name, f)

    adam = _optax_adam(jt)
    convert.material_params_from_numpy(
        tt, {k: float(v) for k, v in jt.params.items()},
        mu={k: v[0] for k, v in adam.items()},
        nu={k: v[1] for k, v in adam.items()},
        count={k: v[2] for k, v in adam.items()})
    j_loss, j_p = jt.train_one_step_finite_diff()
    t_loss, t_p = tt.train_one_step_finite_diff()
    assert _rel(t_loss, j_loss) <= LOSS_TOL
    for k in "DEH":
        assert _rel(t_p[k], j_p[k]) <= PARAM_TOL, k
    assert tt.step == jt.step == 4
