"""The port's tracing (``utils/profiling.py``) and its call sites, on the
CPU: off it records nothing and hands back one shared no-op; on it
records names, parents per thread, total and self times and counters;
under ``torch.profiler`` each span is a ``record_function`` range on the
profiler's clock; sessions keep one trace's spans from the next; and the
spans and window counters of ``p2g2p``, ``MPMSolver.frame``,
``KernelWithTwinGrad`` and ``MaterialTrainer.train_one_step``."""

import sys
import threading
import time

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from mpmavatar_tpu_torch.core.types import (build_body_sphere, build_cloth,
                                            cloth_scene)
from mpmavatar_tpu_torch.ops import _autograd, _build
from mpmavatar_tpu_torch.sim.solver import MPMSolver
from mpmavatar_tpu_torch.train.material import (MaterialTrainer,
                                                MaterialTrainerConfig)
from mpmavatar_tpu_torch.utils import profiling

torch.set_num_threads(1)

PHASES = ("substep.windows", "substep.stress", "substep.p2g",
          "substep.grid", "substep.g2p")
DT = 1e-4


def _by_name(spans):
    out = {}
    for s in spans:
        out.setdefault(s.name, []).append(s)
    return out


def _sleep_span(name, seconds):
    with profiling.span(name):
        time.sleep(seconds)


# ----------------------------------------------------------------------
# the module
# ----------------------------------------------------------------------
def test_off_records_nothing_and_hands_back_the_shared_noop(monkeypatch):
    with profiling.enable():
        profiling.count("before")
    before = profiling.snapshot()

    def forbidden(*a, **k):
        raise AssertionError("tracing off touched the clock or the "
                             "profiler")

    monkeypatch.setattr(profiling, "_clock", forbidden)
    monkeypatch.setattr(profiling, "_range", forbidden)
    assert not profiling.on()
    a, b = profiling.span("a"), profiling.span("b")
    assert a is b
    with a:
        with profiling.span("inner"):
            profiling.count("c", 5)
    assert profiling.snapshot() == before
    assert before["counters"] == {"before": 1} and before["spans"] == {}


def test_on_records_names_parents_and_total_and_self_times():
    with profiling.enable():
        assert profiling.on()
        with profiling.span("outer"):
            time.sleep(0.004)
            _sleep_span("inner", 0.002)
            _sleep_span("inner", 0.002)
        _sleep_span("after", 0.001)
    spans = list(profiling.spans().values())
    assert [s.name for s in spans] == ["outer", "inner", "inner", "after"]
    assert [s.parent for s in spans] == [None, 0, 0, None]
    for s in spans:
        assert s.end_ns - s.start_ns >= 1_000_000
    outer, inner = spans[0], spans[1:3]
    assert all(outer.start_ns <= s.start_ns and s.end_ns <= outer.end_ns
               for s in inner)
    agg = profiling.snapshot()["spans"]
    assert agg["inner"]["count"] == 2 and agg["outer"]["count"] == 1
    assert agg["inner"]["total_ns"] == sum(s.end_ns - s.start_ns
                                           for s in inner)
    assert agg["outer"]["total_ns"] == outer.end_ns - outer.start_ns
    assert agg["outer"]["self_ns"] == agg["outer"]["total_ns"] \
        - agg["inner"]["total_ns"]
    assert agg["inner"]["self_ns"] == agg["inner"]["total_ns"]


def test_parents_are_per_thread():
    seen = []

    def worker():
        with profiling.span("worker"):
            _sleep_span("worker.child", 0.001)
        seen.append(threading.get_ident())

    with profiling.enable():
        with profiling.span("main"):
            t = threading.Thread(target=worker)
            t.start()
            t.join()
    spans = _by_name(profiling.spans().values())
    (main,), (w,), (child,) = (spans["main"], spans["worker"],
                               spans["worker.child"])
    assert w.parent is None and w.thread == seen[0] != main.thread
    assert profiling.spans()[child.parent] == w
    agg = profiling.snapshot()["spans"]
    # the worker ran inside main's interval but is not main's child
    assert agg["main"]["self_ns"] == agg["main"]["total_ns"]


def test_counters_and_reset_clear_spans_counters_and_launches(monkeypatch):
    monkeypatch.setattr(_build, "_counts", {})
    with profiling.enable():
        profiling.count("windows.evaluated", 50)
        profiling.count("windows.evaluated", 50)
        profiling.count("windows.live")
        with profiling.span("x"):
            pass
        _build._counts["p2g"] = 3
        snap = profiling.snapshot()
        assert snap["counters"] == {"windows.evaluated": 100,
                                    "windows.live": 1}
        assert snap["launches"] == {"p2g": 3} and snap["spans"]["x"]
        profiling.reset()
        assert profiling.snapshot() == {"spans": {}, "counters": {},
                                        "launches": {}}
        assert profiling.spans() == {}
        with profiling.span("y"):
            pass
    assert set(profiling.snapshot()["spans"]) == {"y"}


def test_threads_lose_no_count_or_span():
    """More threads than cores, switching often: every count and span of
    every thread lands."""
    threads, rounds = 16, 300
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with profiling.enable():
            def work():
                for _ in range(rounds):
                    with profiling.span("stress"):
                        profiling.count("stress.count")
                        profiling.count("stress.count", 2)
            pool = [threading.Thread(target=work) for _ in range(threads)]
            for t in pool:
                t.start()
            for t in pool:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in pool)
    finally:
        sys.setswitchinterval(old)
    snap = profiling.snapshot()
    assert snap["counters"]["stress.count"] == 3 * threads * rounds
    assert snap["spans"]["stress"]["count"] == threads * rounds
    assert len(profiling.spans()) == threads * rounds
    assert all(s.parent is None for s in profiling.spans().values())


def test_past_the_cap_only_the_aggregates_grow(monkeypatch):
    monkeypatch.setattr(profiling, "MAX_SPANS", 3)
    with profiling.enable():
        with profiling.span("outer"):
            for _ in range(4):
                with profiling.span("inner"):
                    pass
    assert [s.name for s in profiling.spans().values()] == ["outer", "inner",
                                                   "inner"]
    snap = profiling.snapshot()
    assert snap["counters"] == {"spans.dropped": 2}
    assert snap["spans"]["inner"]["count"] == 4
    # the self time still takes every child out
    outer, inner = snap["spans"]["outer"], snap["spans"]["inner"]
    assert outer["self_ns"] == outer["total_ns"] - inner["total_ns"]


def test_spans_are_record_function_ranges_on_the_profilers_clock():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert profiling.on()
        with profiling.span("tracing.outer"):
            for _ in range(3):
                _sleep_span("tracing.sleep", 0.02)
    spans = _by_name(profiling.spans().values())
    events = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CPU:
            events.setdefault(e.name(), []).append(e)
    assert len(events.get("tracing.outer", [])) == 1
    assert len(events.get("tracing.sleep", [])) == 3
    evs = sorted(events["tracing.sleep"], key=lambda e: e.start_ns())
    for s, e in zip(spans["tracing.sleep"], evs):
        e0, e1 = e.start_ns(), e.start_ns() + e.duration_ns()
        overlap = min(s.end_ns, e1) - max(s.start_ns, e0)
        # the span is stamped around its range: on one clock the range
        # lies within it (a preempted host only lengthens the span)
        assert overlap >= 0.9 * (e1 - e0)
        assert overlap >= 0.5 * (s.end_ns - s.start_ns)


def test_each_trace_is_a_session_of_its_own():
    with profile(activities=[ProfilerActivity.CPU]):
        _sleep_span("first", 0.0)
        profiling.count("first.count")
    _sleep_span("between", 0.0)       # off: the profiler has stopped
    with profile(activities=[ProfilerActivity.CPU]):
        _sleep_span("second", 0.0)
    snap = profiling.snapshot()
    assert set(snap["spans"]) == {"second"} and snap["counters"] == {}
    with profiling.enable():
        _sleep_span("third", 0.0)
    with profiling.enable():
        _sleep_span("fourth", 0.0)
    assert set(profiling.snapshot()["spans"]) == {"fourth"}


# ----------------------------------------------------------------------
# the call sites
# ----------------------------------------------------------------------
def _cloth(n_grid=16, nx=5):
    verts, faces = build_cloth(nx, nx, y0=1.0)
    cfg, state, model = cloth_scene(verts, faces, n_grid, device="cpu")
    return MPMSolver(cfg, device="cpu"), state, model


def test_p2g2p_spans_its_phases_and_counts_the_live_windows():
    solver, state, model = _cloth()
    mask = np.ones(state.x.shape[0], np.int32)
    # over 5 substeps: live at t = 0, 1e-4, 2e-4; at 3e-4, 4e-4; never
    solver.add_impulse_on_particles(mask, [0.0, 0.1, 0.0], 0.0, 2.5e-4)
    solver.enforce_particle_velocity_by_mask(mask, [0.0, 0.0, 0.0],
                                             2.5e-4, 999.0)
    solver.enforce_particle_velocity_by_mask(mask, [0.0, 0.0, 0.0],
                                             1.0, 2.0)
    n = 5
    with profiling.enable():
        solver.frame(state, model, DT, n, 0.0)
    spans = profiling.spans()
    subs = [i for i, s in spans.items() if s.name == "substep"]
    assert len(subs) == n
    for i in subs:
        children = [s.name for s in spans.values() if s.parent == i]
        assert children == list(PHASES)
    counters = profiling.snapshot()["counters"]
    # the CPU runs the plain loop: the fused launch applies none
    assert counters == {"windows.evaluated": 3 * n, "windows.live": 3 + 2,
                        "windows.fused": 0}
    # the host's intervals say what the step's device scalars say, at the
    # frame's float32 times
    cols = solver.colliders
    windows = cols.impulses + cols.velocity_modifiers
    t, dt = np.float32(0.0), np.float32(DT)
    for _ in range(n):
        for w in windows:
            device = bool((float(t) >= w.start_time)
                          & (float(t) < w.end_time))
            assert w.live_at(float(t)) == device
        t = np.float32(t + dt)


def test_frame_self_time_leaves_out_its_substeps():
    solver, state, model = _cloth()
    with profiling.enable():
        t = 0.0
        for _ in range(2):
            state, t = solver.frame(state, model, DT, 3, t)
    spans = profiling.spans()
    frames = [i for i, s in spans.items() if s.name == "frame"]
    assert len(frames) == 2
    agg = profiling.snapshot()["spans"]
    assert agg["substep"]["count"] == 6
    assert all(s.parent in frames for s in spans.values()
               if s.name == "substep")
    assert agg["frame"]["self_ns"] == agg["frame"]["total_ns"] \
        - agg["substep"]["total_ns"]


def test_a_twin_backward_is_a_span_named_for_its_kernel():
    def twin(a, k):
        return torch.sin(a) * k

    def kernel(a, k):
        return twin(a, k) + 0.0

    a = torch.linspace(0.0, 1.0, 8, requires_grad=True)
    with profiling.enable():
        out = _autograd.call("p2g", kernel, twin, a, 2.0)
        (g,) = torch.autograd.grad(out.sum(), [a])
    assert torch.allclose(g, 2.0 * torch.cos(a.detach()))
    agg = profiling.snapshot()["spans"]
    assert agg["twin_backward.p2g"]["count"] == 1


def test_a_material_step_spans_forward_backward_and_readback():
    verts, faces = build_cloth(5, 5, y0=1.0)
    train = np.repeat(verts[None], 2, 0)
    bv, bf = build_body_sphere(n_theta=6, n_phi=6, center=(1.0, 0.6, 1.0),
                               r=0.1)
    trainer = MaterialTrainer(
        MaterialTrainerConfig(grid_size=16, substep=4, fps=2500.0,
                              iterations=10),
        faces, verts * np.float32([1.0, 0.9, 1.0]), train,
        np.repeat(bv[None], 2, 0), bf, 5, 0, device="cpu")
    with profiling.enable():
        trainer.train_one_step()
    spans = profiling.spans()
    steps = [i for i, s in spans.items() if s.name == "train.step"]
    assert len(steps) == 1
    assert [s.name for s in spans.values() if s.parent == steps[0]] == [
        "train.forward", "train.backward", "train.readback"]
    agg = profiling.snapshot()["spans"]
    # the CPU runs the plain versions: no twin, so no twin's backward
    assert not any(k.startswith("twin_backward.") for k in agg)
    assert agg["frame"]["count"] >= 1 and agg["substep"]["count"] >= 4


@pytest.mark.parametrize("traced", [False, True])
def test_tracing_leaves_the_substep_unchanged(traced):
    """The same frame with tracing off and on."""
    solver, state, model = _cloth()
    ref, _ = solver.frame(state, model, DT, 3, 0.0)
    with profiling.enable() if traced else profiling.span("off"):
        out, _ = solver.frame(state, model, DT, 3, 0.0)
    assert torch.equal(out.x, ref.x) and torch.equal(out.v, ref.v)


# ----------------------------------------------------------------------
# the stage-2 step
# ----------------------------------------------------------------------
def _appearance_step():
    """One stage-2 step at bench_appearance's cut size, LPIPS off: the
    step function and its arguments."""
    from mpmavatar_tpu_torch.data import OptimizationParams
    from mpmavatar_tpu_torch.train import appearance, bench_appearance
    avatar, params, _, cam, gt_rgb, gt_msk, ao = bench_appearance.build(
        "cpu", 48, 32, (10, 9))
    opt = OptimizationParams()
    step = appearance.make_train_step(
        avatar, opt, appearance.make_optimizer(opt, 1.0, params), 3, False,
        tile_capacity=512, work_cap=32, chunk=32)
    return step, (params, 0, 0, cam[0], gt_rgb, gt_msk, ao, cam[1], cam[2])


def test_an_appearance_step_spans_its_phases_and_counts_the_gathers():
    step, args = _appearance_step()
    with profiling.enable():
        step(*args)
        step(*args)
    spans = profiling.spans()
    by = _by_name(spans.values())
    steps = [i for i, s in spans.items() if s.name == "appearance.step"]
    assert len(steps) == 2
    for i in steps:
        # one a step, its children in order; the rasterizer inside the
        # forward
        assert [s.name for s in spans.values() if s.parent == i] == [
            "appearance.forward", "appearance.backward", "appearance.adam"]
    forwards = {i for i, s in spans.items() if s.name == "appearance.forward"}
    assert len(by["appearance.raster"]) == 2
    assert all(s.parent in forwards for s in by["appearance.raster"])
    snap = profiling.snapshot()
    assert snap["spans"]["appearance.step"]["count"] == 2
    # six per-face tables gathered a step (orientation, scale twice,
    # centre, quaternion, shadow), each over every slot
    slots = args[0].splats.capacity
    assert snap["counters"]["binding.gathered_slots"] == 2 * 6 * slots


def test_appearance_spans_cost_nothing_with_tracing_off(monkeypatch):
    step, args = _appearance_step()
    with profiling.enable():
        profiling.count("before")
    before = profiling.snapshot()

    def forbidden(*a, **k):
        raise AssertionError("tracing off touched the clock or the "
                             "profiler")

    monkeypatch.setattr(profiling, "_clock", forbidden)
    monkeypatch.setattr(profiling, "_range", forbidden)
    step(*args)
    assert profiling.span("appearance.step") is profiling._OFF
    assert profiling.snapshot()["spans"] == before["spans"]
    assert profiling.snapshot()["counters"] == before["counters"]
