"""The release windows (``ops/windows.py``): the plain loop against the
JAX package's pre-P2G step, the membership words and the window table,
the card route on stand-in CUDA tensors, and the CUDA kernel against the
plain loop on the card.

The card tests skip without a CUDA device.  This file imports JAX only
inside the tests that compare with it, so on a machine with PyTorch
alone the card tests run as

    python -m pytest tests/test_torch_windows.py --noconftest -m cuda
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

from mpmavatar_tpu_torch.core import colliders as tcol
from mpmavatar_tpu_torch.core import stepping
from mpmavatar_tpu_torch.ops import _build
from mpmavatar_tpu_torch.ops import windows as kwin
from mpmavatar_tpu_torch.sim import MPMSolver
from mpmavatar_tpu_torch.utils import profiling

DT = 1e-4
# the scene's windows, in registration order (seconds):
#   impulse by mass [0, 2e-3); 6 nested release layers from 1e-3, ending
#   at 1e-3 (never live), 2e-3, ..., 6e-3; impulse not by mass [1.5e-3,
#   4e-3); rotation [5e-4, 3e-3); constant velocity [2e-3, 5e-3)
TIMES = {"dead": 7e-3, "live": 2.5e-3, "start": 1.5e-3, "end": 3e-3}
LIVE = {"dead": 0, "live": 7, "start": 8, "end": 5}


def _f32(t):
    return float(np.float32(t))


def _register(solver, state, rng):
    """The windows of the module docstring on ``solver``; masks of 0, 1
    and 2 (an impulse takes 2, a modifier does not)."""
    n = state.x.shape[0]
    mask = lambda: rng.integers(0, 3, n).astype(np.int32)
    solver.add_impulse_on_particles(mask(), [0.0, 0.3, 0.1], 0.0, 2e-3)
    solver.release_particles_sequentially(state, [0, 0, 1], 1.2, 0.8,
                                          1e-3, 6e-3, num_layers=6)
    solver.add_impulse_on_particles(mask(), [0.1, 0.0, -0.2], 1.5e-3, 4e-3,
                                    scale_by_mass=False)
    solver.enforce_particle_velocity_rotation(
        state, [1.0, 1.0, 1.0], [0.2, 1.0, 0.1], (0.1, 0.15), 2.0, 0.3,
        5e-4, 3e-3)
    solver.enforce_particle_velocity_by_mask(mask(), [0.05, -0.02, 0.0],
                                             2e-3, 5e-3)
    return solver.colliders


def _cloth_state(device="cpu", nx=6, seed=0):
    """A small flat cloth's particles (x, v, mass) near (1, 1, 1), with
    random velocities."""
    xs = np.linspace(0.8, 1.2, nx)
    x = np.stack(np.meshgrid(xs, [1.0], xs, indexing="ij"), -1).reshape(-1, 3)
    rng = np.random.default_rng(seed)
    x = x + rng.normal(scale=0.01, size=x.shape)
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    return types.SimpleNamespace(
        x=f(x), v=f(rng.normal(scale=0.1, size=x.shape)),
        mass=f(rng.uniform(0.5, 2.0, len(x))))


# ----------------------------------------------------------------------
# the plain loop against the JAX package
# ----------------------------------------------------------------------
class _PreP2G(Exception):
    """Carries the velocity the JAX step hands to its stress phase."""


def _jax_pre_p2g(cfg, state, model, colliders, time, monkeypatch):
    """v after the JAX package's pre-P2G step: its p2g2p run eagerly up
    to its stress phase."""
    import jax
    import jax.numpy as jnp
    from mpmavatar_tpu.core import stepping as jstep

    def stop(cfg, state, *args, **kwargs):
        raise _PreP2G(np.asarray(state.v))

    monkeypatch.setattr(jstep, "compute_stress", stop)
    with jax.disable_jit(), pytest.raises(_PreP2G) as got:
        jstep.p2g2p(cfg, colliders, state, model, jnp.float32(DT),
                    jnp.float32(time))
    return got.value.args[0]


def _to_jax(colliders):
    """The JAX package's collider set of the same windows."""
    import jax.numpy as jnp
    from mpmavatar_tpu.core import colliders as jcol

    def one(w):
        cls = getattr(jcol, type(w).__name__)
        return cls(**{f.name: (jnp.asarray(getattr(w, f.name).numpy())
                               if f.name not in ("scale_by_mass",)
                               else getattr(w, f.name))
                      for f in dataclasses.fields(cls)})
    return jcol.ColliderSet(
        impulses=tuple(one(w) for w in colliders.impulses),
        velocity_modifiers=tuple(one(w) for w in colliders.velocity_modifiers))


@pytest.mark.parametrize("when", list(TIMES))
def test_plain_loop_matches_the_jax_pre_p2g_step(when, monkeypatch):
    """At a dead time, a live time and the boundaries (t == an impulse's
    start, t == the rotation's end), with overlapping masks, both kinds of
    impulse, a constant and a rotation modifier registered in mixed
    order: the port's step (the plain loop on the CPU) gives the JAX
    step's velocities, and changes them exactly where a window is live."""
    import jax.numpy as jnp
    from test_substep_golden import build_pair, make_cloth
    from test_torch_core import port_of

    verts, faces = make_cloth(nx=6, ny=6, y0=1.0, extent=0.4)
    _, cfg, jstate, jmodel = build_pair(verts, faces, n_grid=32)
    rng = np.random.default_rng(7)
    v0 = rng.normal(scale=0.1, size=(cfg.n_particles, 3)).astype(np.float32)
    jstate = dataclasses.replace(jstate, v=jnp.asarray(v0))
    tcfg, state, _ = port_of(cfg, jstate, jmodel)
    solver = MPMSolver(tcfg, device="cpu")
    cols = _register(solver, state, rng)
    time = _f32(TIMES[when])
    assert sum(w.live_at(time) for w in cols.impulses
               + cols.velocity_modifiers) == LIVE[when]

    got = stepping._pre_p2g_velocity(cols, state, DT, time)
    ref = _jax_pre_p2g(cfg, jstate, jmodel, _to_jax(cols), time,
                       monkeypatch)
    # XLA's and torch's CPU arccos, sin and cos round apart by an ulp or
    # two of the rotation field (|v| < 0.5)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6)
    changed = (got != state.v).any(1)
    if when == "dead":
        assert not bool(changed.any())
    else:
        assert bool(changed.any()) and not bool(changed.all())


# ----------------------------------------------------------------------
# the pack: membership words and the table
# ----------------------------------------------------------------------
def _random_set(n_windows, n=300, seed=0):
    """A collider set of ``n_windows`` windows, two in five impulses, with
    masks of 0, 1 and 2."""
    rng = np.random.default_rng(seed)
    solver = MPMSolver(None, device="cpu")
    for w in range(n_windows):
        mask = rng.integers(0, 3, n).astype(np.int32)
        start = float(rng.uniform(0, 1))
        if w % 5 in (1, 3):
            solver.add_impulse_on_particles(mask, rng.normal(size=3), start,
                                            start + 0.5,
                                            scale_by_mass=bool(w % 2))
        else:
            solver.enforce_particle_velocity_by_mask(
                mask, rng.normal(size=3), start, start + 0.5)
    return solver.colliders


@pytest.mark.parametrize("n_windows", [1, 32, 33, 50])
def test_membership_bits_are_the_loops_own_tests(n_windows):
    """Bit w of a particle's words is set exactly where window w's test
    holds (an impulse's mask >= 1, a modifier's mask == 1), windows in the
    order they apply; the table holds each window's kind and interval."""
    cols = _random_set(n_windows)
    windows = cols.impulses + cols.velocity_modifiers
    pack = kwin.window_pack(cols)
    assert pack.words.dtype == torch.int32
    assert pack.words.shape == ((n_windows + 31) // 32, 300)
    words = pack.words.to(torch.int64) & 0xFFFFFFFF
    for w, win in enumerate(windows):
        bit = ((words[w // 32] >> (w % 32)) & 1).bool()
        if isinstance(win, tcol.ParticleImpulse):
            want = win.mask >= 1
            kind = kwin.IMPULSE_BY_MASS if win.scale_by_mass \
                else kwin.IMPULSE
        else:
            want = win.mask == 1
            kind = kwin.VELOCITY
        assert torch.equal(bit, want), w
        row = pack.table[w]
        assert row[0] == kind
        assert row[1] == win.start_time and row[2] == win.end_time
    # the last word's unused bits stay clear
    spare = 32 * pack.words.shape[0] - n_windows
    if spare:
        assert not bool((words[-1] >> (32 - spare)).any())
    assert pack.table.shape == (n_windows, kwin.ROW)
    assert pack.reads_mass == any(w.scale_by_mass for w in cols.impulses)
    assert not pack.reads_x


def test_pack_is_built_once_per_collider_set():
    """The pack stays on its set; the set a new registration makes gets
    its own, and a set without windows never gets one."""
    solver = MPMSolver(None, device="cpu")
    state = _cloth_state()
    cols = _register(solver, state, np.random.default_rng(1))
    pack = kwin.window_pack(cols)
    assert kwin.window_pack(cols) is pack
    assert pack.reads_x and pack.reads_mass
    rot = cols.velocity_modifiers[6]
    assert isinstance(rot, tcol.RotationVelocityModifier)
    assert torch.equal(pack.table[2 + 6, 6:], torch.cat([
        rot.point, rot.normal, rot.horizontal_axis_1,
        rot.horizontal_axis_2, rot.rotation_scale.reshape(1),
        rot.translation_scale.reshape(1)]))
    solver.enforce_particle_velocity_by_mask(np.ones(36, np.int32),
                                             [0.0, 0.0, 0.0], 0.0, 1.0)
    assert kwin.window_pack(solver.colliders) is not pack
    assert kwin.window_pack(solver.colliders).table.shape[0] == 11
    empty = tcol.ColliderSet()
    v = stepping._pre_p2g_velocity(empty, state, DT, 0.0)
    assert v is state.v and kwin._PACK not in empty.__dict__


# ----------------------------------------------------------------------
# the card route on CPU tensors that report is_cuda
# ----------------------------------------------------------------------
class _OnCard(torch.Tensor):
    """A CPU tensor that reports itself as a CUDA tensor, so that the
    wrapper takes its card route; the tests record the launch instead of
    running it."""

    @property
    def is_cuda(self):
        return True


def _on_card(a, requires_grad=False):
    return torch.Tensor._make_subclass(_OnCard, a.detach(), requires_grad)


@pytest.fixture
def launched(monkeypatch):
    calls = []
    monkeypatch.setattr(_build, "launch", lambda kernel, symbol, *args:
                        calls.append((kernel, symbol, args)))
    monkeypatch.setattr(_build, "stream", lambda device: 0)
    return calls


def test_card_route_launches_once_and_counts_the_windows(launched):
    """On CUDA tensors the step launches the kernel once with the C entry
    point's arguments, counts the windows it fused while tracing, and with
    no window launches nothing."""
    state = _cloth_state()
    solver = MPMSolver(None, device="cpu")
    cols = _register(solver, state, np.random.default_rng(2))
    card = types.SimpleNamespace(**{k: _on_card(getattr(state, k))
                                    for k in ("x", "v", "mass")})
    time = _f32(TIMES["live"])
    with profiling.enable():
        stepping._pre_p2g_velocity(cols, card, DT, time)
        stepping._pre_p2g_velocity(tcol.ColliderSet(), card, DT, time)
    counters = profiling.snapshot()["counters"]
    assert counters["windows.fused"] == 10
    assert counters["windows.evaluated"] == 10
    assert counters["windows.live"] == LIVE["live"]
    assert len(launched) == 1
    kernel, symbol, args = launched[0]
    assert (kernel, symbol) == (kwin.KERNEL, "launch_windows")
    assert len(args) == len(_build._SIGNATURES[symbol])
    pack = kwin.window_pack(cols)
    assert args[1:8] == (state.x.data_ptr(), state.mass.data_ptr(),
                         pack.words.data_ptr(), pack.table.data_ptr(), 10, 1,
                         36)
    assert args[8:10] == (time, DT)
    # a set without rotation or impulses by mass: x and mass not passed
    plain = tcol.ColliderSet(velocity_modifiers=cols.velocity_modifiers[:6])
    kwin.apply_windows(plain, card.v, card.x, card.mass, DT, time)
    assert launched[1][2][1:3] == (None, None)


def test_card_route_differentiates_through_the_plain_loop(launched):
    """Under grad the launch goes through the autograd Function: the
    gradient w.r.t. v, x and mass is autograd over the plain loop's on
    the same inputs, exactly; without grad no Function."""
    state = _cloth_state()
    cols = _register(MPMSolver(None, device="cpu"), state,
                     np.random.default_rng(3))
    # both impulses and the rotation are live
    time = _f32(TIMES["start"])
    card = [_on_card(getattr(state, k), True) for k in ("v", "x", "mass")]
    out = kwin.apply_windows(cols, *card, DT, time)
    assert len(launched) == 1 and out.grad_fn is not None
    cot = torch.randn(out.shape, generator=torch.Generator().manual_seed(0))
    got = torch.autograd.grad(out, card, cot, allow_unused=True)
    leaves = [getattr(state, k).clone().requires_grad_(True)
              for k in ("v", "x", "mass")]
    ref = torch.autograd.grad(kwin.windows_plain(cols, *leaves, DT, time),
                              leaves, cot, allow_unused=True)
    for a, b in zip(got, ref):
        assert b is not None and torch.equal(a, b)
    with torch.no_grad():
        out = kwin.apply_windows(cols, *card, DT, time)
    assert len(launched) == 2 and out.grad_fn is None


# ----------------------------------------------------------------------
# the kernel on the card
# ----------------------------------------------------------------------
DEMO_PARTICLES = 200_101


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the windows kernel runs only on "
                    "the card")
    return torch.device("cuda")


def _demo_windows(dev, rotation=False, seed=0):
    """The demo's 50 windows at its particle count: 48 nested release
    layers from t = 4 s, layer i ending at (i + 1) / 6 s (the first 24
    never open, as most of the demo's do not), an impulse by mass and one
    not, or a rotation modifier in place of the second impulse, both from
    4 s to 4.5 s.  Returns (state, colliders)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    n = DEMO_PARTICLES
    state = types.SimpleNamespace(
        x=0.5 + torch.rand((n, 3), generator=g, device=dev),
        v=0.1 * torch.randn((n, 3), generator=g, device=dev),
        mass=0.5 + torch.rand((n,), generator=g, device=dev))
    solver = MPMSolver(None, device=dev)
    rng = np.random.default_rng(seed)
    solver.add_impulse_on_particles(rng.integers(0, 3, n).astype(np.int32),
                                    [0.0, -2.0, 0.5], 4.0, 4.5)
    solver.release_particles_sequentially(state, [0, 0, 1], 1.5, 0.5, 4.0,
                                          8.0, num_layers=48)
    if rotation:
        solver.enforce_particle_velocity_rotation(
            state, [1.0, 1.0, 1.0], [0.3, 1.0, -0.2], (0.4, 0.3), 3.0, 0.2,
            4.0, 4.5)
    else:
        solver.add_impulse_on_particles(
            rng.integers(0, 3, n).astype(np.int32), [0.4, 0.0, -1.0], 4.0,
            4.5, scale_by_mass=False)
    return state, solver.colliders


@pytest.mark.cuda
@pytest.mark.parametrize("time", [1.0, 4.3])
def test_kernel_is_the_plain_loop_bit_for_bit(dev, time):
    """At the demo's 50 windows and 200,101 particles, at a dead time and
    a live one: impulses and constant modifiers bit for bit, one launch a
    call, and none without windows."""
    state, cols = _demo_windows(dev)
    before = _build.launch_counts().get(kwin.KERNEL, 0)
    got = kwin.apply_windows(cols, state.v, state.x, state.mass, DT, time)
    ref = kwin.windows_plain(cols, state.v, state.x, state.mass, DT, time)
    torch.cuda.synchronize()
    assert _build.launch_counts()[kwin.KERNEL] == before + 1
    assert torch.equal(got, ref)
    live = sum(w.live_at(time) for w in cols.impulses
               + cols.velocity_modifiers)
    assert (live > 10) == (time > 4.0)
    assert torch.equal(got, state.v) == (live == 0)
    empty = tcol.ColliderSet()
    assert kwin.apply_windows(empty, state.v, state.x, state.mass, DT,
                              time) is state.v
    assert _build.launch_counts()[kwin.KERNEL] == before + 1


@pytest.mark.cuda
def test_rotation_kernel_is_within_1e_6_of_the_plain_loop(dev):
    """A live rotation modifier among the layers: the field within 1e-6 of
    its largest |v_rot| (acosf, sinf, cosf may round otherwise than
    torch's calls), everything else bit for bit."""
    state, cols = _demo_windows(dev, rotation=True, seed=1)
    rot = cols.velocity_modifiers[-1]
    got = kwin.apply_windows(cols, state.v, state.x, state.mass, DT, 4.3)
    ref = kwin.windows_plain(cols, state.v, state.x, state.mass, DT, 4.3)
    sel = rot.mask == 1
    assert int(sel.sum()) > 1000
    scale = float(ref[sel].norm(dim=1).max())
    assert float((got - ref)[sel].abs().max()) <= 1e-6 * scale
    assert torch.equal(got[~sel], ref[~sel])


@pytest.mark.cuda
def test_kernel_gradient_is_the_plain_loops(dev):
    """Under grad on the card: the kernel's forward, the plain loop's
    gradient (NaN in the same places: a particle on the rotation's
    horizontal axis 1 has its cosine clamped at 1, where arccos has no
    derivative)."""
    state, cols = _demo_windows(dev, rotation=True, seed=2)
    ins = [getattr(state, k).clone().requires_grad_(True)
           for k in ("v", "x", "mass")]
    out = kwin.apply_windows(cols, *ins, DT, 4.3)
    ref_in = [a.detach().clone().requires_grad_(True) for a in ins]
    ref = kwin.windows_plain(cols, *ref_in, DT, 4.3)
    cot = torch.randn(out.shape, device=dev)
    got = torch.autograd.grad(out, ins, cot)
    want = torch.autograd.grad(ref, ref_in, cot)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)
