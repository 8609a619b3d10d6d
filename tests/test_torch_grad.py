"""Gradients through the port's substep kernels (K1, K2, K3, K4, K5,
K8) against the JAX package, on the CPU.

- Per kernel: autograd over the plain version (what the card's backward
  computes, ops/_autograd.py) against ``jax.vjp`` of the JAX entry point,
  on seeded inputs with random cotangents, off the return maps' branch
  points (a gradient there is the branch's, and two packages may pick
  different branches by rounding).
- The substep: the gradient of a vertex loss after a few substeps of a
  toy cloth scene with respect to E (through ``finalize_mu_lam``), mass
  and R_inv, against ``jax.grad`` of the JAX ``p2g2p``.
- The autograd Function itself with a stand-in forward, and each CUDA
  wrapper's route through it, on CPU tensors that report themselves as
  CUDA tensors (the launch is recorded, not run): its outputs carry a
  ``grad_fn`` and its gradient is exactly the plain version's.
- K4: the mover splat's VJP against ``jax.vjp`` of ``rasterize_to_grid``,
  its card route through the Function, and the collider splat's inputs
  detached.

Every comparison is max |port - jax| over max |jax| per input, with the
tolerance stated beside it.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__
from test_pallas_stress import _sand_inputs
from test_torch_core import port_collider, port_of, t
from test_torch_grid_pipeline import CFG, TCFG, _SCENES, _fields

from mpmavatar_tpu.core import colliders as jcol
from mpmavatar_tpu.core import stepping as jstep
from mpmavatar_tpu.core import types as jtypes
from mpmavatar_tpu.ops import pallas_grid_pipeline as jgp
from mpmavatar_tpu.ops import pallas_stress as jps

from mpmavatar_tpu_torch.core import colliders as tcol
from mpmavatar_tpu_torch.core import linalg as tla
from mpmavatar_tpu_torch.core import stepping as tstep
from mpmavatar_tpu_torch.core import types as ttypes
from mpmavatar_tpu_torch.ops import _autograd, _build
from mpmavatar_tpu_torch.ops import grid_pipeline as tgp
from mpmavatar_tpu_torch.ops import splat as tsplat
from mpmavatar_tpu_torch.ops import stress as tstress
from mpmavatar_tpu_torch.ops import transfer as ttr

torch.set_num_threads(1)

F32 = jnp.float32
DT = 1e-4
# per kernel: float32 VJPs of the same formulas in two frameworks (sums in
# other orders, fused multiply-adds), relative to each input's largest
# gradient
KERNEL_GRAD_TOL = 1e-4
# K8's VJP runs back through 8 Jacobi sweeps on F^T F, whose rotation
# angles come from near-converged off-diagonals: more rounding to carry
SAND_GRAD_TOL = 1e-3
# the substep: 3 substeps, each gradient through K1, K2, K5 and K3 and back
SUBSTEPS = 3
SUBSTEP_GRAD_TOL = 1e-3


def _rel(port, ref):
    ref = np.asarray(ref, np.float64)
    port = np.asarray(port.detach() if isinstance(port, torch.Tensor)
                      else port, np.float64)
    return float(np.abs(port - ref).max()) / max(float(np.abs(ref).max()),
                                                  1e-30)


def _cotangents(outs, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=np.shape(o)).astype(np.float32) for o in outs]


def _port_vjp(fn, args, wrt, cots):
    """Autograd over the port's ``fn`` on the CPU: the gradients of
    sum(cot * out) with respect to ``args[i]`` for i in ``wrt``."""
    leaves = [t(a).requires_grad_(i in wrt) if a is not None
              and not isinstance(a, (int, float)) else a
              for i, a in enumerate(args)]
    outs = fn(*leaves)
    outs = [outs] if isinstance(outs, torch.Tensor) else list(outs)
    return torch.autograd.grad(outs, [leaves[i] for i in wrt],
                               [t(c) for c in cots], allow_unused=True)


def _jax_vjp(fn, args, wrt, cots):
    def f(*diff):
        full = list(args)
        for i, a in zip(wrt, diff):
            full[i] = a
        return fn(*full)
    outs, vjp = jax.vjp(f, *[args[i] for i in wrt])
    return vjp(tuple(jnp.asarray(c) for c in cots) if isinstance(outs, tuple)
               else jnp.asarray(cots[0]))


# ----------------------------------------------------------------------
# per kernel, against jax.vjp
# ----------------------------------------------------------------------
def _cloth_inputs(seed=0):
    """The bent cloth of test_torch_stress.py at 9 x 9: noisy d with d3
    scaled in [0.5, 0.95] or [1.05, 1.6] (separated and contact), and
    sel = 0 on the elements within 0.02 of R33 = 1 or within 5% of the
    friction cone's surface."""
    cfg, state, model = __graft_entry__._build_cloth_scene(nx=9, ny=9,
                                                           n_grid=32)
    E = cfg.n_elements
    rng = np.random.default_rng(seed)
    d = np.asarray(state.d) + rng.normal(0, 0.02, (E, 3, 3)).astype(
        np.float32)
    scale = np.where(rng.random(E) < 0.5, rng.uniform(0.5, 0.95, E),
                     rng.uniform(1.05, 1.6, E)).astype(np.float32)
    d[:, :, 2] *= scale[:, None]
    r = tla.qr3_pos(torch.as_tensor(d))[1]
    r13, r23, r33 = r[:, 0, 2], r[:, 1, 2], r[:, 2, 2]
    gamma, kappa = float(model.gamma[0]), float(model.kappa[0])
    fric = float(model.friction_coeff)
    cone = (gamma * torch.sqrt(r13 ** 2 + r23 ** 2)
            / (fric * kappa * (1.0 - r33) ** 2)).numpy()
    sel = ((np.abs(cone - 1.0) > 0.05)
           & ((r33 - 1.0).abs() > 0.02).numpy()).astype(np.float32)
    assert sel.mean() > 0.8
    return (jnp.asarray(d), state.R_inv, state.vol[:E], jnp.asarray(sel),
            model.mu[:E], model.lam[:E], model.gamma[:E], model.kappa[:E],
            model.friction_coeff)


def test_cloth_stress_vjp_matches_jax():
    """K1: d, r_inv, vol, mu, lam, gamma, kappa, friction_coeff."""
    args = _cloth_inputs()
    wrt = (0, 1, 2, 4, 5, 6, 7, 8)
    fwd = lambda *a: jps.cloth_stress_fused(*a, interpret=True)
    cots = _cotangents(fwd(*args), 1)
    ref = _jax_vjp(fwd, args, wrt, cots)
    out = _port_vjp(tstress.cloth_stress, [np.asarray(a) for a in args],
                    wrt, cots)
    errs = [_rel(a, b) for a, b in zip(out, ref)]
    assert max(errs) < KERNEL_GRAD_TOL, errs


def _sand_off_ties(seed):
    """tests/test_pallas_stress.py::_sand_inputs without the reflected
    particle, and sel = 0 wherever the return map's tests (delta_gamma >
    0, tr > 0) are within 1e-3 of their branch point."""
    f_trial, f_prev, sel, mu, lam, alpha = (np.array(a) for a in
                                            _sand_inputs(t=256, seed=seed))
    n = len(f_trial)
    f_trial[n // 4] = np.abs(f_trial[n // 4])
    sig = np.linalg.svd(f_trial.astype(np.float64), compute_uv=False)
    eps = np.log(sig)
    tr = eps.sum(1)
    eh = eps - tr[:, None] / 3.0
    dg = np.linalg.norm(eh, axis=1) + (3 * lam + 2 * mu) / (2 * mu) * tr \
        * float(alpha)
    far = (np.abs(dg) > 1e-3) & (np.abs(tr) > 1e-3) \
        & (np.linalg.det(f_trial) > 0)
    sel = sel * far
    assert far.mean() > 0.8
    return [jnp.asarray(a) for a in (f_trial, f_prev, sel, mu, lam)] \
        + [jnp.float32(alpha)]


@pytest.mark.parametrize("seed", [0, 1])
def test_sand_stress_vjp_matches_jax(seed):
    """K8: f_trial, f_prev, mu, lam, alpha, on the elastic, cone and tip
    branches."""
    args = _sand_off_ties(seed)
    wrt = (0, 1, 3, 4, 5)
    fwd = lambda *a: jps.sand_stress_fused(*a, interpret=True)
    cots = _cotangents(fwd(*args), seed + 2)
    ref = _jax_vjp(fwd, args, wrt, cots)
    out = _port_vjp(tstress.sand_stress, [np.asarray(a) for a in args],
                    wrt, cots)
    errs = [_rel(a, b) for a, b in zip(out, ref)]
    assert max(errs) < SAND_GRAD_TOL, errs


def _p2g_scene(seed=0):
    cfg, state, model = __graft_entry__._build_cloth_scene(nx=9, ny=9,
                                                           n_grid=32)
    rng = np.random.default_rng(seed)
    P = cfg.n_particles
    state = dataclasses.replace(
        state, v=jnp.asarray(rng.normal(0, 0.1, (P, 3)), F32),
        C=jnp.asarray(rng.normal(0, 0.5, (P, 3, 3)), F32))
    _, _, _, stress, vforce = jstep.compute_stress(cfg, state, model, DT)
    return cfg, state, model, stress, vforce


def test_p2g_vjp_matches_jax():
    """K2 through stepping.p2g (the RPIC mix and dt scaling in front of
    the kernel): x, v, C, mass, stress, vforce."""
    cfg, state, model, stress, vforce = _p2g_scene()
    tcfg, tst, tm = port_of(cfg, state, model)

    def jfn(x, v, c, mass, st, vf):
        s = dataclasses.replace(state, x=x, v=v, C=c, mass=mass)
        return jstep.p2g(cfg, s, model, st, vf, DT)

    def tfn(x, v, c, mass, st, vf):
        s = dataclasses.replace(tst, x=x, v=v, C=c, mass=mass)
        return tstep.p2g(tcfg, s, tm, st, vf, DT)

    args = [state.x, state.v, state.C, state.mass, stress, vforce]
    wrt = tuple(range(6))
    cots = _cotangents(jfn(*args), 3)
    ref = _jax_vjp(jfn, args, wrt, cots)
    out = _port_vjp(tfn, [np.asarray(a) for a in args], wrt, cots)
    errs = [_rel(a, b) for a, b in zip(out, ref)]
    assert max(errs) < KERNEL_GRAD_TOL, errs


def test_g2p_vjp_matches_jax():
    """K3 through stepping.gather_quantities: x and the grid velocity."""
    cfg, state, model, _, _ = _p2g_scene(1)
    tcfg, tst, _ = port_of(cfg, state, model)
    grid_v = np.random.default_rng(4).normal(
        size=(cfg.n_grid ** 3, 3)).astype(np.float32)
    jfn = lambda x, g: jstep.gather_quantities(
        cfg, dataclasses.replace(state, x=x), g)
    tfn = lambda x, g: tstep.gather_quantities(
        tcfg, dataclasses.replace(tst, x=x), g)
    args = [state.x, jnp.asarray(grid_v)]
    cots = _cotangents(jfn(*args), 5)
    ref = _jax_vjp(jfn, args, (0, 1), cots)
    out = _port_vjp(tfn, [np.asarray(a) for a in args], (0, 1), cots)
    errs = [_rel(a, b) for a, b in zip(out, ref)]
    assert max(errs) < KERNEL_GRAD_TOL, errs


def _vjp_post(friction_type):
    """The bounding box, one slip or frictional surface, then the two
    sticky ones: a velocity that reaches a slip or frictional surface at
    exactly 0 (an empty cell, a sticky one, a cell that another surface's
    friction stopped) has the tangential speed sqrt(0 + 1e-40), which XLA
    flushes to sqrt(0), and JAX's VJP is NaN there."""
    bbox, low, slip, fric, timed = _SCENES["all"]
    return (bbox, slip if friction_type == jcol.SLIP else fric, low, timed)


@pytest.mark.parametrize("mesh_mover", [False, True])
def test_grid_pipeline_vjp_matches_jax(mesh_mover):
    """K5 on random fields with every surface type and the bounding box
    (slip without the mesh and mover, frictional with them): the grid,
    the mesh and mover fields, gravity, damping and the mesh friction.
    Every cell has mass, and the sticky surfaces come last
    (``_vjp_post``)."""
    post = _vjp_post(jcol.FRICTIONAL if mesh_mover else jcol.SLIP)
    f = _fields(seed=2)
    f["gm"] = np.maximum(f["gm"], 0.5)
    jfn_ = jgp.make_grid_pipeline(CFG, post, has_mesh=mesh_mover,
                                  has_mover=mesh_mover, interpret=True)
    tpost = tuple(port_collider(c) for c in post)
    tfn_ = tgp.make_grid_pipeline(TCFG, tpost, has_mesh=mesh_mover,
                                  has_mover=mesh_mover)
    jsurf = jgp.pack_surface_params(post)
    tsurf = tgp.pack_surface_params(tpost)
    keys = ("gv", "gm", "macc", "mw", "mv", "mvw") if mesh_mover \
        else ("gv", "gm")
    scal = [np.asarray([0.0, -9.8, 0.0], np.float32), np.float32(0.9)]
    if mesh_mover:
        scal.append(np.float32(0.5))

    def split(fields):
        fields = list(fields)
        grid = fields[:len(keys)]
        if not mesh_mover:
            grid += [None] * 4
        return grid, fields[len(keys):] + ([] if mesh_mover else [None])

    def jfn(*a):
        grid, (g, damp, fric) = split(a)
        return jfn_(*grid, g, damp, F32(0.5) if fric is None else fric,
                    F32(0.7), F32(DT), jsurf)

    def tfn(*a):
        grid, (g, damp, fric) = split(a)
        return tfn_(*grid, g, damp, fric, 0.7, DT, tsurf)

    args = [jnp.asarray(f[k]) for k in keys] + [jnp.asarray(s) for s in scal]
    wrt = tuple(range(len(args)))
    cots = _cotangents([jfn(*args)], 6)
    ref = _jax_vjp(jfn, args, wrt, cots)
    out = _port_vjp(tfn, [np.asarray(a) for a in args], wrt, cots)
    errs = [_rel(a, b) for a, b in zip(out, ref)]
    assert max(errs) < KERNEL_GRAD_TOL, errs


# ----------------------------------------------------------------------
# the substep
# ----------------------------------------------------------------------
def _grad_scene():
    """The __graft_entry__ cloth at 12 x 12 on 32^3 with the sticky floor,
    random velocities, and d3 scaled to 0.9: every element on the return
    map's contact branch, inside the friction cone (R33 = 1 is a branch
    point, and a flat cloth sits on it)."""
    cfg, state, model = __graft_entry__._build_cloth_scene(nx=12, ny=12,
                                                           n_grid=32)
    rng = np.random.default_rng(7)
    d = np.asarray(state.d).copy()
    d[:, :, 2] *= 0.9
    state = dataclasses.replace(
        state, d=jnp.asarray(d),
        v=jnp.asarray(rng.normal(0, 0.05, (cfg.n_particles, 3)), F32))
    floor = jcol.SurfaceCollider(
        point=jnp.asarray([0.0, 0.1, 0.0], F32),
        normal=jnp.asarray([0.0, 1.0, 0.0], F32), friction=F32(0.0),
        start_time=F32(0.0), end_time=F32(999.0))
    weights = rng.normal(size=(cfg.n_vertices, 3)).astype(np.float32)
    return cfg, state, model, jcol.ColliderSet(grid_post=(floor,)), weights


def _jax_rollout_grads(cfg, state, model, colliders, weights):
    E = cfg.n_elements

    def loss(e_mod, mass, r_inv):
        m = jtypes.finalize_mu_lam(dataclasses.replace(model, E=e_mod))
        s = dataclasses.replace(state, mass=mass, R_inv=r_inv)
        for k in range(SUBSTEPS):
            s = jstep.p2g2p(cfg, colliders, s, m, F32(DT), F32(k * DT))
        return jnp.sum(s.x[E:] * weights)

    return jax.grad(loss, argnums=(0, 1, 2))(model.E, state.mass,
                                              state.R_inv)


def _port_rollout_grads(cfg, state, model, colliders, weights):
    """The same gradient through the port (on the CPU: autograd over the
    kernels' plain versions, which is the card's backward)."""
    tcfg, tst, tm = port_of(cfg, state, model)
    cols = port_collider(colliders)
    leaves = [a.clone().requires_grad_(True) for a in (tm.E, tst.mass,
                                                       tst.R_inv)]
    m = ttypes.finalize_mu_lam(dataclasses.replace(tm, E=leaves[0]))
    s = dataclasses.replace(tst, mass=leaves[1], R_inv=leaves[2])
    for k in range(SUBSTEPS):
        s = tstep.p2g2p(tcfg, cols, s, m, DT, float(np.float32(k * DT)))
    loss = torch.sum(s.x[cfg.n_elements:] * torch.as_tensor(weights))
    return torch.autograd.grad(loss, leaves)


def test_substep_gradient_matches_jax_grad():
    """d(vertex loss after 3 substeps) / d(E, mass, R_inv) through the
    port's p2g2p (K1 -> K2 -> K5 -> K3, autograd over their plain
    versions) against jax.grad of the JAX p2g2p."""
    scene = _grad_scene()
    ref = _jax_rollout_grads(*scene)
    out = _port_rollout_grads(*scene)
    errs = {name: _rel(a, b) for name, a, b in zip(("E", "mass", "R_inv"),
                                                   out, ref)}
    assert all(float(np.abs(np.asarray(r)).max()) > 0 for r in ref)
    assert max(errs.values()) < SUBSTEP_GRAD_TOL, errs


# ----------------------------------------------------------------------
# the autograd Function and the wrappers' route through it
# ----------------------------------------------------------------------
class _OnCard(torch.Tensor):
    """A CPU tensor that reports itself as a CUDA tensor, so that a
    wrapper takes its card route; the tests record the launch instead of
    running it."""

    @property
    def is_cuda(self):
        return True


def _on_card(a, requires_grad=False):
    return torch.Tensor._make_subclass(_OnCard, t(a), requires_grad)


def test_function_plumbing_with_a_stand_in_forward():
    """The forward's outputs carry a grad_fn and are the stand-in's (not
    the twin's); the gradient is autograd of the twin on the saved inputs;
    None for the int tensor, the Python number and the tensor that needs
    no grad; the int output is non-differentiable."""
    calls = []

    def twin(a, idx, b, k):
        return (a * b[idx] * k, torch.sin(a) + b.sum(), idx * 2)

    def kernel(a, idx, b, k):
        calls.append(torch.is_grad_enabled())
        y0, y1, y2 = twin(a, idx, b, k)
        return y0 + 1e-3, y1, y2

    rng = np.random.default_rng(0)
    a = torch.tensor(rng.normal(size=5), dtype=torch.float32,
                     requires_grad=True)
    b = torch.tensor(rng.normal(size=4), dtype=torch.float32)
    idx = torch.tensor([0, 3, 1, 1, 2])
    y0, y1, y2 = _autograd.call("stand_in", kernel, twin, a, idx, b, 2.5)
    assert calls == [False]
    assert y0.grad_fn is not None and y1.grad_fn is not None
    assert not y2.requires_grad
    ref0, ref1, _ = twin(a, idx, b, 2.5)
    assert torch.equal(y0, ref0.detach() + 1e-3)
    g0, g1 = torch.randn(5), torch.randn(5)
    (ga,) = torch.autograd.grad([y0, y1], [a], [g0, g1], retain_graph=True)
    (ra,) = torch.autograd.grad([ref0, ref1], [a], [g0, g1],
                                retain_graph=True)
    assert torch.equal(ga, ra)
    # one output used: the other's cotangent stays None
    (ga0,) = torch.autograd.grad(y0, [a], g0)
    assert torch.equal(ga0, torch.autograd.grad(ref0, [a], g0)[0])
    # b needs grad too: its gradient, None for idx and k
    b.requires_grad_(True)
    y0, y1, _ = _autograd.call("stand_in", kernel, twin, a, idx, b, 2.5)
    fn = y0.grad_fn
    grads = fn.apply(g0, g1, None)
    assert grads[4] is None and grads[6] is None
    ref = torch.autograd.grad(list(twin(a, idx, b, 2.5)[:2]), [a, b],
                              [g0, g1])
    assert torch.equal(grads[3], ref[0]) and torch.equal(grads[5], ref[1])
    # no grad needed: the kernel alone, no Function
    with torch.no_grad():
        out = _autograd.call("stand_in", kernel, twin, a, idx, b, 2.5)
    assert out[0].grad_fn is None and len(calls) == 3


def _routes():
    """(kernel name, wrapper fn, plain fn, inputs, differentiable input
    indices) of the five kernels with a backward, at toy shapes."""
    cloth = [np.asarray(a) for a in _cloth_inputs(1)]
    sand = [np.asarray(a) for a in _sand_off_ties(2)]
    cfg, state, model, stress, vforce = _p2g_scene(2)
    tcfg, tst, _ = port_of(cfg, state, model)
    sel = (tst.selection == 0).float()
    p2g_in = [tst.x, tst.v, tst.C, tst.mass, sel, DT * t(stress),
              DT * t(vforce)]
    grid = (cfg.n_grid, cfg.inv_dx, cfg.dx)
    f = _fields(seed=3)
    tpost = tuple(port_collider(c) for c in _SCENES["all"])
    pipe = tgp.make_grid_pipeline(TCFG, tpost, has_mesh=True, has_mover=True)
    surf = tgp.pack_surface_params(tpost)
    k5_in = [f[k] for k in ("gv", "gm", "macc", "mw", "mv", "mvw")] + [
        np.asarray([0.0, -9.8, 0.0], np.float32), np.float32(0.9),
        np.float32(0.5)]
    return {
        "cloth_stress": (tstress.cloth_stress, tstress.cloth_stress_plain,
                         cloth, (0, 1, 2, 4, 5, 6, 7, 8)),
        "sand_stress": (tstress.sand_stress, tstress.sand_stress_plain,
                        sand, (0, 1, 3, 4, 5)),
        "p2g": (lambda *a: ttr.p2g(*a, *grid),
                lambda *a: ttr.p2g_plain(*a, *grid), p2g_in, tuple(range(7))),
        "g2p": (lambda *a: ttr.g2p(*a, cfg.n_grid, cfg.inv_dx),
                lambda *a: ttr.g2p_plain(*a, cfg.n_grid, cfg.inv_dx),
                [tst.x, np.random.default_rng(5).normal(
                    size=(cfg.n_grid ** 3, 3)).astype(np.float32)], (0, 1)),
        "grid_pipeline": (lambda *a: pipe(*a, 0.7, DT, _on_card(surf)),
                          lambda *a: tgp.grid_pipeline_plain(
                              *a, surf, 0.7, DT, TCFG.n_grid, TCFG.dx,
                              (0, 1, 2, 0), True, 3),
                          k5_in, tuple(range(9))),
    }


@pytest.mark.parametrize("kernel", ["cloth_stress", "sand_stress", "p2g",
                                    "g2p", "grid_pipeline"])
def test_card_route_differentiates_through_the_plain_version(kernel,
                                                             monkeypatch):
    """On (stand-in) CUDA tensors under grad the wrapper launches its
    kernel once through the autograd Function: every float output carries
    a grad_fn, and the gradient equals autograd over the plain version on
    the same inputs, exactly.  Without grad it launches directly and its
    outputs carry none."""
    wrapper, plain, args, wrt = _routes()[kernel]
    launched = []
    monkeypatch.setattr(_build, "launch",
                        lambda name, *a: launched.append(name))
    monkeypatch.setattr(_build, "stream", lambda device: 0)
    card = [_on_card(a, i in wrt) for i, a in enumerate(args)]
    outs = wrapper(*card)
    outs = [outs] if isinstance(outs, torch.Tensor) else list(outs)
    assert launched == [kernel]
    assert all(o.grad_fn is not None for o in outs)
    cots = [torch.randn(o.shape, generator=torch.Generator().manual_seed(i))
            for i, o in enumerate(outs)]
    got = torch.autograd.grad(outs, [card[i] for i in wrt], cots,
                              allow_unused=True)
    leaves = [t(a).requires_grad_(i in wrt) for i, a in enumerate(args)]
    ref_outs = plain(*leaves)
    ref_outs = [ref_outs] if isinstance(ref_outs, torch.Tensor) \
        else list(ref_outs)
    ref = torch.autograd.grad(ref_outs, [leaves[i] for i in wrt], cots,
                              allow_unused=True)
    for a, b in zip(got, ref):
        assert (a is None and b is None) or torch.equal(a, b)
    with torch.no_grad():
        outs = wrapper(*card)
    outs = [outs] if isinstance(outs, torch.Tensor) else list(outs)
    assert launched == [kernel, kernel]
    assert all(o.grad_fn is None for o in outs)


def test_mover_splat_differentiates_on_the_card(monkeypatch):
    """The mover splats the joint particles' positions state.x: on the
    card under grad, with x requiring grad, K4 launches once inside the
    autograd Function, and the gradient w.r.t. x is exactly autograd over
    the plain version's; with x detached it launches directly."""
    cfg, state, model = __graft_entry__._build_cloth_scene(nx=4, ny=4,
                                                           n_grid=16)
    cfg = dataclasses.replace(cfg, num_joint_v=3, num_joint_f=2)
    tcfg, tst, _ = port_of(cfg, state, model)
    launched = []
    monkeypatch.setattr(_build, "launch",
                        lambda name, *a: launched.append(name))
    monkeypatch.setattr(_build, "stream", lambda device: 0)
    x = _on_card(tst.x, requires_grad=True)
    rng = np.random.default_rng(8)
    jv, jf = (rng.normal(size=(n, 3)).astype(np.float32) for n in (3, 2))
    outs = tstep.mover_fields(tcfg, dataclasses.replace(tst, x=x),
                              _on_card(jv), _on_card(jf))
    assert launched == [tsplat.KERNEL]
    assert all(o.grad_fn is not None for o in outs)
    cots = [torch.randn(o.shape, generator=torch.Generator().manual_seed(i))
            for i, o in enumerate(outs)]
    (got,) = torch.autograd.grad(outs, [x], cots)
    x_ref = t(tst.x).requires_grad_(True)
    ref_outs = tstep.mover_fields(tcfg, dataclasses.replace(tst, x=x_ref),
                                  t(jv), t(jf))
    (ref,) = torch.autograd.grad(ref_outs, [x_ref], cots)
    assert torch.equal(got, ref) and float(ref.abs().max()) > 0
    tstep.mover_fields(tcfg, dataclasses.replace(tst, x=x.detach()),
                       _on_card(jv), _on_card(jf))
    assert launched == [tsplat.KERNEL, tsplat.KERNEL]


def test_splat_vjp_matches_jax():
    """The plain splat's VJP w.r.t. points and values (the card's K4
    backward) against ``jax.vjp`` of the JAX package's
    ``rasterize_to_grid``, which is what the JAX mover differentiates;
    points off the bounds check's edges."""
    cfg = jtypes.MPMStaticConfig(n_elements=0, n_traditional=40,
                                 n_vertices=0, n_grid=16)
    rng = np.random.default_rng(11)
    pts = rng.uniform(0.3, 1.6, (40, 3)).astype(np.float32)
    vals = rng.normal(size=(40, 3)).astype(np.float32)
    g3 = cfg.n_grid ** 3
    args = [pts, vals]
    cots = _cotangents([np.zeros((g3, 3)), np.zeros((g3,))], 12)
    got = _port_vjp(lambda p, v: tsplat.splat_plain(p, v, cfg.n_grid,
                                                    cfg.inv_dx),
                    args, (0, 1), cots)
    ref = _jax_vjp(lambda p, v: jstep.rasterize_to_grid(cfg, p, v, g3),
                   [jnp.asarray(a) for a in args], (0, 1), cots)
    for name, a, b in zip(("points", "values"), got, ref):
        assert float(np.abs(np.asarray(b)).max()) > 0, name
        assert _rel(a, b) <= KERNEL_GRAD_TOL, name


def test_collider_splat_inputs_are_detached(monkeypatch):
    """The collider splat's inputs are detached (JAX's stop_gradient): a
    collider mesh that requires grad reaches K4 without a graph, and the
    fields carry none."""
    mesh_x = torch.tensor([[0.9, 0.9, 0.9], [1.1, 0.9, 0.9],
                           [1.0, 0.9, 1.1]], requires_grad=True)
    mesh_v = torch.zeros((3, 3), requires_grad=True)
    col = tcol.MeshCollider(faces=torch.tensor([[0, 1, 2]]),
                            friction=torch.tensor(0.5))
    cfg = ttypes.MPMStaticConfig(n_elements=0, n_traditional=1,
                                 n_vertices=0, n_grid=16)
    seen = []
    real = tsplat.splat
    monkeypatch.setattr(tsplat, "splat", lambda p, v, *a: (
        seen.append((p.requires_grad, v.requires_grad)) or real(p, v, *a)))
    acc, grid_w = tstep.mesh_collider_fields(cfg, col, mesh_x, mesh_v)
    assert seen == [(False, False)]
    assert not acc.requires_grad and not grid_w.requires_grad
    assert float(grid_w.sum()) > 0
