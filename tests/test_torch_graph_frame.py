"""``MPMSolver.frame``'s captured substep (``sim/substep_graph.py``).

On the CPU (tier 1): the graph's device clock against the eager frame's
float32 sequence, ``p2g2p`` with its time as a device scalar against the
same substep with a host float, which frames take the graph and which
the eager loop, what the graph's key holds, the launch counts of a
capture and its replays, the spans of a frame that captures (under a
stand-in graph), ``chip_fixtures.py``'s reading of a device trace's
launches, and the CPU frame as the eager loop of ``p2g2p``.

On the card (marked ``cuda``, skipped without one): the graph frame
against an eager loop of ``p2g2p`` from the same state, in a garment-like
scene (the mesh collider moving, the mover) and a demo-like one (sand,
release windows and a slip surface that open or close inside the frame),
to the gap between two eager runs (K2's and K4's float atomics); the
returned state not aliasing the graph's buffers; captures again on a new
collider set or dt; the launches per replayed frame.  This file imports
neither JAX nor the JAX package:

    python -m pytest tests/test_torch_graph_frame.py --noconftest -m cuda
"""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from mpmavatar_tpu_torch.core import stepping
from mpmavatar_tpu_torch.core.types import build_cloth, cloth_scene
from mpmavatar_tpu_torch.ops import _build
from mpmavatar_tpu_torch.sim import bench_scene
from mpmavatar_tpu_torch.sim import substep_graph as sg
from mpmavatar_tpu_torch.sim.solver import MPMSolver
from mpmavatar_tpu_torch.utils import profiling

DT = 1e-4
DEMO_DT = (1.0 / 25.0) / 400       # run_demo's 25 fps at 400 substeps
FIELDS = ("x", "v", "C", "F", "F_trial", "d")


def _cloth(n_grid=16, nx=5, device="cpu"):
    verts, faces = build_cloth(nx, nx, y0=1.0)
    cfg, state, model = cloth_scene(verts, faces, n_grid, device=device)
    return MPMSolver(cfg, device=device), state, model


def _bits(value) -> int:
    return int(np.float32(value).view(np.int32))


def _scene(device, kind, grid=24, nx=8, sand=300):
    """The bench scene cut small: ``garment`` (the sphere collider moving
    up, the pinned vertices and faces moving), ``demo`` (the same with
    sand, a release window and an impulse that open mid-frame, a velocity
    window that closes mid-frame, and a slip surface that opens
    mid-frame), or ``jelly`` (the garment with the sand's particles as
    jelly, whose stress is plain PyTorch, not K8).  Returns (solver,
    state, model, frame inputs)."""
    solver, state, model, scene = bench_scene.build(
        grid=grid, sand=0 if kind == "garment" else sand, nx=nx,
        device=device)
    if kind == "jelly":
        solver.cfg = dataclasses.replace(solver.cfg, material=0)
    gen = torch.Generator().manual_seed(7)
    # the flat cloth's d sits on the return map's R33 = 1 branch point,
    # where rounding decides the branch: move it off
    d = state.d.cpu() + 0.02 * torch.randn(state.d.shape, generator=gen)
    d[:, :, 2] *= 0.5 + 1.1 * torch.rand((len(d), 1), generator=gen)
    state = dataclasses.replace(state, d=d.to(device))
    scene["mesh_v"] = torch.zeros_like(scene["mesh_v"]) + torch.tensor(
        [0.0, 0.4, 0.1], device=device)
    for key in ("joint_verts_v", "joint_faces_v"):
        scene[key] = 0.2 * torch.randn(scene[key].shape,
                                       generator=gen).to(device)
    if kind == "demo":
        cfg = solver.cfg
        sel = np.zeros(cfg.n_particles, np.int32)
        sel[cfg.n_elements:cfg.n_no_vertices] = 1
        z = state.x[cfg.n_elements:cfg.n_no_vertices, 2]
        solver.release_particles_sequentially(
            state, [0.0, 0.0, 1.0], float(z.max()), float(z.min()),
            start_time=6.5 * DT, end_time=400 * DT, num_layers=5)
        solver.add_impulse_on_particles(sel, [0.0, 500.0, 0.0],
                                        start_time=3.5 * DT,
                                        scale_by_mass=False)
        solver.enforce_particle_velocity_by_mask(
            sel, [0.05, 0.0, 0.0], start_time=0.0, end_time=4.5 * DT)
        solver.add_surface_collider([0.0, 1.55, 0.0], [0.0, 1.0, 0.0],
                                    surface="slip", start_time=5.5 * DT)
    return solver, state, model, scene


def _eager_frame(solver, state, model, n, time0, scene, dt=DT):
    """``frame``'s eager loop written out: ``p2g2p`` n times."""
    t, dt32 = np.float32(time0), np.float32(dt)
    for s in range(n):
        mx = scene["mesh_x"] + float(np.float32(s) * dt32) * scene["mesh_v"]
        state = stepping.p2g2p(
            solver.cfg, solver.colliders, state, model, float(dt32),
            float(t), mesh_x=mx, mesh_v=scene["mesh_v"],
            joint_verts_v=scene["joint_verts_v"],
            joint_faces_v=scene["joint_faces_v"],
            grid_stage=solver.grid_stage())
        t = np.float32(t + dt32)
    return state, float(t)


class _OnCard(torch.Tensor):
    """A CPU tensor that reports itself as a CUDA tensor."""

    @property
    def is_cuda(self):
        return True


# ----------------------------------------------------------------------
# CPU: the clock, the route, the key, the counts
# ----------------------------------------------------------------------
@pytest.mark.parametrize("time0", [0.0, 3.96, 3.9999, 4.0, 4.04])
def test_device_clock_matches_the_eager_frames_float32_sequence(
        time0, monkeypatch):
    """Over 400 substeps at the demo's dt, from frame starts on each side
    of its release at 4.0 s (3.9999 crosses it inside the frame), the
    clock's float32 ``t.add_(dt)`` and ``mesh_x + (s dt) mesh_v`` equal
    the times and collider meshes the eager frame hands ``p2g2p``, bit
    for bit, and its last time the frame's."""
    seen = []

    def record(cfg, colliders, state, model, dt, time, mesh_x=None, **kw):
        seen.append((time, mesh_x))
        return state

    monkeypatch.setattr(stepping, "p2g2p", record)
    solver, state, model = _cloth()
    gen = torch.Generator().manual_seed(3)
    mesh_x = 2.0 * torch.rand((64, 3), generator=gen)
    mesh_v = torch.randn((64, 3), generator=gen)
    _, t_end = solver.frame(state, model, DEMO_DT, 400, time0,
                            mesh_x=mesh_x, mesh_v=mesh_v)
    assert len(seen) == 400
    dt = float(np.float32(DEMO_DT))
    clock = sg.Clock("cpu")
    clock.set(np.float32(time0), 0)
    for s, (time, mx) in enumerate(seen):
        assert _bits(clock.t.item()) == _bits(time), s
        assert _bits((clock.s * dt).item()) == _bits(
            np.float32(s) * np.float32(DEMO_DT)), s
        assert torch.equal(clock.mesh_x(mesh_x, mesh_v, dt), mx), s
        clock.advance(dt)
    assert clock.t.item() == t_end


@pytest.mark.parametrize("kind", ["garment", "demo"])
def test_p2g2p_with_its_time_as_a_device_scalar_is_the_same_substep(kind):
    """K5's surfaces and the release windows read the time from a float32
    0-d tensor as from the host float: at times around each window's and
    the slip surface's opening and closing, the substep is bit for bit
    the same, and its windows are counted only from a host time."""
    solver, state, model, scene = _scene("cpu", kind, grid=16, nx=5,
                                         sand=40)
    args = dict(mesh_x=scene["mesh_x"], mesh_v=scene["mesh_v"],
                joint_verts_v=scene["joint_verts_v"],
                joint_faces_v=scene["joint_faces_v"],
                grid_stage=solver.grid_stage())
    t = np.float32(0.0)
    for s in range(8):
        host = stepping.p2g2p(solver.cfg, solver.colliders, state, model,
                              DT, float(t), **args)
        with profiling.enable():
            dev = stepping.p2g2p(solver.cfg, solver.colliders, state, model,
                                 DT, torch.tensor(t), **args)
            assert "windows.evaluated" not in \
                profiling.snapshot()["counters"]
        for f in FIELDS:
            assert torch.equal(getattr(host, f), getattr(dev, f)), (s, f)
        state, t = host, np.float32(t + np.float32(DT))


def test_unfused_grid_stage_takes_a_device_time():
    """The unfused grid stage (a cuboid, which K5 does not support) reads
    a device time as it reads the host's."""
    solver, state, model = _cloth()
    solver.set_velocity_on_cuboid([1.0, 1.0, 1.0], [0.3, 0.3, 0.3],
                                  [0.0, 0.5, 0.0], start_time=2.5 * DT,
                                  end_time=4.5 * DT, reset=1)
    t = np.float32(0.0)
    for s in range(6):
        host = stepping.p2g2p(solver.cfg, solver.colliders, state, model,
                              DT, float(t))
        dev = stepping.p2g2p(solver.cfg, solver.colliders, state, model,
                             DT, torch.tensor(t))
        for f in FIELDS:
            assert torch.equal(getattr(host, f), getattr(dev, f)), (s, f)
        state, t = host, np.float32(t + np.float32(DT))


def _on_card(state):
    return dataclasses.replace(state, x=torch.Tensor._make_subclass(
        _OnCard, state.x))


@pytest.mark.parametrize("case, want", [
    ("cpu", False),
    ("card", True),
    ("card, remat", False),
    ("card, a model tensor requires grad", False),
    ("card, a model tensor requires grad, no_grad", True),
    ("card, the state requires grad", False),
    ("card, an input requires grad", False),
])
def test_graph_route_needs_cuda_no_remat_and_nothing_to_differentiate(
        case, want):
    _, state, model = _cloth()
    mesh_v = torch.zeros((4, 3))
    if "card" in case:
        state = _on_card(state)
    if "model tensor" in case:
        model = dataclasses.replace(model, E=model.E.clone()
                                    .requires_grad_(True))
    if "state requires" in case:
        state = dataclasses.replace(state, d=state.d.clone()
                                    .requires_grad_(True))
    if "input" in case:
        mesh_v.requires_grad_(True)
    inputs = (torch.zeros((4, 3)), mesh_v, None, None)
    with torch.set_grad_enabled("no_grad" not in case):
        assert sg.graphable(state, model, inputs, "remat" in case) == want


def test_cpu_frames_stay_eager(monkeypatch):
    """A CPU frame, a remat frame and a differentiated frame never build
    a graph, and count no graphed substep."""
    monkeypatch.setattr(sg, "SubstepGraph", None)     # would raise
    solver, state, model = _cloth()
    with profiling.enable():
        solver.frame(state, model, DT, 2, 0.0)
        solver.frame(state, model, DT, 2, 0.0, remat=True)
        leaf = dataclasses.replace(model, mu=model.mu.clone()
                                   .requires_grad_(True))
        out, _ = solver.frame(state, leaf, DT, 2, 0.0)
        assert out.x.grad_fn is not None
    assert solver._graph is None
    assert profiling.snapshot()["counters"]["substep.graphed"] == 0


def test_cpu_frame_is_the_eager_loop_of_p2g2p():
    """The CPU frame runs ``p2g2p`` on its own float32 times and collider
    meshes, bit for bit: the mesh collider moving, the mover, sand and
    windows that open and close inside the frame."""
    solver, state, model, scene = _scene("cpu", "demo", grid=16, nx=5,
                                         sand=40)
    want, t_want = _eager_frame(solver, state, model, 8, 0.0, scene)
    got, t_got = solver.frame(state, model, DT, 8, 0.0, **scene)
    assert t_got == t_want
    for f in FIELDS:
        assert torch.equal(getattr(got, f), getattr(want, f)), f


@pytest.mark.parametrize("change, same", [
    ("the collider set", False), ("the particle count", False),
    ("dt", False), ("an input given", False), ("an input's shape", False),
    ("a model tensor", False), ("new values", True)])
def test_graph_key_holds_what_a_capture_bakes_in(change, same):
    """The key changes with the collider set, the state's and the inputs'
    shapes, dt and the model's tensors; new values in tensors of the same
    shapes keep it (they are copied into the graph's buffers)."""
    solver, state, model = _cloth()
    parts = dict(cfg=solver.cfg, colliders=solver.colliders, state=state,
                 model=model, dt=DT,
                 inputs=[torch.zeros((4, 3)), torch.ones((4, 3)), None,
                         None])
    base = sg.graph_key(**parts)
    inputs = list(parts["inputs"])
    if change == "the collider set":
        solver.add_bounding_box()
        parts["colliders"] = solver.colliders
    elif change == "the particle count":
        parts["state"] = _cloth(nx=6)[1]
    elif change == "dt":
        parts["dt"] = 2 * DT
    elif change == "an input given":
        inputs[2] = torch.zeros((3, 3))
    elif change == "an input's shape":
        inputs[0] = torch.zeros((5, 3))
    elif change == "a model tensor":
        parts["model"] = dataclasses.replace(model, mu=model.mu.clone())
    else:
        parts["state"] = dataclasses.replace(state, x=state.x + 0.01)
        inputs[0] = inputs[0] + 1.0
    parts["inputs"] = inputs
    assert (sg.graph_key(**parts) == base) == same


def test_capture_counts_its_launches_apart_and_replays_add_them(
        monkeypatch):
    """A capture's calls go into the dict ``counted_apart`` yields, not
    the running counts; each replay adds them."""
    class _Lib:
        def __getattr__(self, name):
            return lambda *args: 0

    monkeypatch.setattr(_build, "library", _Lib)
    monkeypatch.setattr(_build, "_counts", {"p2g": 1})
    with _build.counted_apart() as body:
        _build.launch("g2p", "launch_g2p")
        _build.launch("splat", "launch_splat")
        _build.launch("splat", "launch_splat")
    assert body == {"g2p": 1, "splat": 2}
    assert _build.launch_counts() == {"p2g": 1}
    _build.add_launch_counts(body, 399)
    assert _build.launch_counts() == {"p2g": 1, "g2p": 399, "splat": 798}


def test_a_capturing_frame_spans_one_substep_per_substep(monkeypatch):
    """A frame that captures (its first substep eager, the capture, the
    replays) opens one ``substep`` span per substep, the phases' spans of
    the eager one alone, and counts the windows once per substep: the
    capture, run once on the CPU by a stand-in graph, records nothing."""
    replays = []

    class _Graph:
        def replay(self):
            replays.append(1)

    monkeypatch.setattr(torch.cuda, "CUDAGraph", _Graph)
    monkeypatch.setattr(torch.cuda, "graph",
                        lambda graph: contextlib.nullcontext())
    monkeypatch.setattr(sg, "graphable", lambda *args: True)
    # the stand-in's capture runs: give it buffers that hold values
    monkeypatch.setattr(sg, "_buffer",
                        lambda t: None if t is None else t.clone())
    solver, state, model, scene = _scene("cpu", "demo", grid=16, nx=5,
                                         sand=40)
    n_windows = len(solver.colliders.impulses
                    + solver.colliders.velocity_modifiers)
    with profiling.enable():
        solver.frame(state, model, DT, 6, 0.0, **scene)
        snap = profiling.snapshot()
    assert isinstance(solver._graph, sg.SubstepGraph) and len(replays) == 5
    spans = snap["spans"]
    assert spans["substep"]["count"] == 6
    assert {spans[f"substep.{phase}"]["count"] for phase in
            ("windows", "stress", "p2g", "grid", "g2p")} == {1}
    assert snap["counters"]["substep.graphed"] == 5
    assert snap["counters"]["windows.evaluated"] == 6 * n_windows


@pytest.mark.parametrize("drop", [None, "windows", "one splat"])
def test_chip_smoke_counts_the_kernels_a_device_trace_ran(drop):
    """``chip_fixtures.check_traced`` reads the port's kernels from a
    profile's rows (the templated splats under one name, PyTorch's own
    kernels and copies left out) and raises when the trace lacks a
    launch that the per-substep counts expect."""
    import chip_fixtures
    n = 20
    rows = [("(anonymous namespace)::p2g_kernel(float const*, int)", 9.0, n),
            ("void (anonymous namespace)::splat_direct_kernel<6>(float "
             "const*)", 3.0, n),
            ("void (anonymous namespace)::splat_kernel<3>(float const*)",
             2.0, n - (drop == "one splat")),
            ("(anonymous namespace)::sand_kernel(float const*)", 1.0, n),
            ("void at::native::(anonymous namespace)::CatArrayBatchedCopy"
             "<float>(int)", 1.0, 2 * n),
            ("Memcpy DtoD (Device -> Device)", 1.0, 5 * n)]
    if drop != "windows":
        rows.append(("(anonymous namespace)::windows_kernel(float const*)",
                     1.0, n))
    per_sub = {"p2g": 1, "splat": 2, "sand_stress": 1, "windows": 1}
    if drop is None:
        assert chip_fixtures.check_traced("demo", rows, per_sub, n) == {
            "p2g": n, "splat": 2 * n, "sand_stress": n, "windows": n}
    else:
        with pytest.raises(AssertionError):
            chip_fixtures.check_traced("demo", rows, per_sub, n)


def test_time_goes_by_value_or_by_pointer():
    """A kernel gets a host time by value with a NULL pointer, and a
    float32 0-d device scalar by pointer (any other dtype raises)."""
    assert _build.time_arg(np.float32(0.25)) == (0.25, None)
    t = torch.Tensor._make_subclass(_OnCard, torch.tensor(0.25))
    assert _build.time_arg(t) == (0.0, t.data_ptr())
    with pytest.raises(TypeError):
        _build.time_arg(torch.Tensor._make_subclass(
            _OnCard, torch.tensor(0.25, dtype=torch.float64)))


# ----------------------------------------------------------------------
# the card
# ----------------------------------------------------------------------
@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a CUDA graph and the port's "
                    "kernels run only on the card")
    return torch.device("cuda")


def _gaps(a, b) -> dict:
    """Field -> the largest absolute difference (the fields a scene has)."""
    return {f: float((getattr(a, f) - getattr(b, f)).abs().max())
            for f in FIELDS if getattr(a, f).numel()}


N_SUB = 20


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["garment", "demo", "jelly"])
def test_graph_frame_matches_the_eager_loop(dev, kind):
    """From one state, a replayed frame (and the frame that captures:
    its first substep eager) against the eager loop of ``p2g2p``, field
    by field within four times the gap between two eager runs of the same
    frame: the same start, and the start an ulp apart in v (K2's and K4's
    atomics add in an order the launches' timing decides, so two runs may
    agree exactly where a replay, timed otherwise, rounds apart), or a
    millionth of the field's largest value where both agree exactly."""
    solver, state, model, scene = _scene(dev, kind)
    torch.manual_seed(0)
    start = dataclasses.replace(state, v=0.3 * torch.randn_like(state.v))
    nudged = dataclasses.replace(start, v=torch.nextafter(
        start.v, torch.full_like(start.v, float("inf"))))
    eager1, t1 = _eager_frame(solver, start, model, N_SUB, 0.0, scene)
    eager2, _ = _eager_frame(solver, start, model, N_SUB, 0.0, scene)
    eager3, _ = _eager_frame(solver, nudged, model, N_SUB, 0.0, scene)
    captured, t_c = solver.frame(start, model, DT, N_SUB, 0.0, **scene)
    assert solver._graph is not None
    replayed, t_r = solver.frame(start, model, DT, N_SUB, 0.0, **scene)
    torch.cuda.synchronize()
    repeat, ulp = _gaps(eager1, eager2), _gaps(eager1, eager3)
    tol = {f: max(4.0 * max(repeat[f], ulp[f]),
                  1e-6 * float(getattr(eager1, f).abs().max()))
           for f in repeat}
    errs = {"captured": _gaps(captured, eager1),
            "replayed": _gaps(replayed, eager1)}
    print(f"{kind}: eager gaps {repeat}, {ulp}; graph {errs}; tol {tol}")
    assert t_c == t_r == t1
    for run, err in errs.items():
        assert all(err[f] <= tol[f] for f in tol), (run, err, tol)


@pytest.mark.cuda
def test_returned_state_does_not_alias_the_graph(dev):
    solver, state, model, scene = _scene(dev, "garment")
    out, t = solver.frame(state, model, DT, N_SUB, 0.0, **scene)
    kept = {f: getattr(out, f).clone() for f in FIELDS}
    written = [f for f in FIELDS if getattr(out, f).numel()]
    buffers = {getattr(solver._graph.state, f).data_ptr() for f in written}
    assert not {getattr(out, f).data_ptr() for f in written} & buffers
    nxt, _ = solver.frame(out, model, DT, N_SUB, t, **scene)
    nxt, _ = solver.frame(nxt, model, DT, N_SUB, t, **scene)
    torch.cuda.synchronize()
    for f in FIELDS:
        assert torch.equal(getattr(out, f), kept[f]), f


@pytest.mark.cuda
def test_new_colliders_or_dt_capture_again(dev):
    solver, state, model, scene = _scene(dev, "garment")
    solver.frame(state, model, DT, 2, 0.0, **scene)
    first = solver._graph
    solver.frame(state, model, DT, 2, 0.0, **scene)
    assert solver._graph is first
    solver.frame(state, model, 2 * DT, 2, 0.0, **scene)
    assert solver._graph is not first
    second = solver._graph
    solver.add_surface_collider([0.0, 0.2, 0.0], [0.0, 1.0, 0.0],
                                surface="slip")
    solver.frame(state, model, 2 * DT, 2, 0.0, **scene)
    assert solver._graph is not second and solver._graph is not None
    # remat and grad leave it alone
    third = solver._graph
    solver.frame(state, model, DT, 2, 0.0, remat=True, **scene)
    leaf = dataclasses.replace(model,
                               mu=model.mu.clone().requires_grad_(True))
    out, _ = solver.frame(state, leaf, DT, 2, 0.0, **scene)
    assert solver._graph is third and out.x.grad_fn is not None


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["garment", "demo"])
def test_launches_per_replayed_frame_equal_the_eager_loops(dev, kind):
    solver, state, model, scene = _scene(dev, kind)
    _build.reset_launch_counts()
    _eager_frame(solver, state, model, N_SUB, 0.0, scene)
    eager = _build.launch_counts()
    for _ in range(2):    # the capture, then a replayed frame
        _build.reset_launch_counts()
        solver.frame(state, model, DT, N_SUB, 0.0, **scene)
        assert _build.launch_counts() == eager
    assert eager and all(n % N_SUB == 0 for n in eager.values())
