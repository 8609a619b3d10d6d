"""The port's benchmark drivers on the CPU at cut shapes.

``train/bench_tracking.py``'s problem against the JAX package's
``bench_tracking.build_tracking_problem`` at the same cut shape (16 x 14
mesh, 96 x 64 view), the JAX rig and VPoser carried across by
``convert``: the first joint iteration's gradient w.r.t. every mesh
parameter, the VPoser latent, beta and the SMPL-X translation against
``jax.grad`` of the same loss, each leaf within 1e-4 of its largest
entry, then the loss and the parameters after the step within 1e-4.  At this shape the mesh's splats overflow JAX's default
footprint tiers (the port's tracking admits every splat to each tier), so
JAX's rasterizer is given the same capacities, as
``test_torch_tracking.py`` does.  ``bench.main`` at cut shapes (a
test-only argument): one JSON line with every key of the JAX line but
``vs_baseline``, each value finite; a part that raises stops the run and
no ``*_error`` key is printed.  ``bench_scene.substeps_per_sec`` steps
the same states as ``bench_scene.run``."""

import dataclasses
import json
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import bench_tracking as jbench_tracking  # noqa: E402
import jax  # noqa: E402
from mpmavatar_tpu.train import tracking as jt  # noqa: E402

from mpmavatar_tpu_torch import bench, convert  # noqa: E402
from mpmavatar_tpu_torch.render import bench_render  # noqa: E402
from mpmavatar_tpu_torch.sim import bench_scene  # noqa: E402
from mpmavatar_tpu_torch.sim.solver import MPMSolver  # noqa: E402
from mpmavatar_tpu_torch.train import bench_tracking  # noqa: E402
from mpmavatar_tpu_torch.train import tracking as tt  # noqa: E402

torch.set_num_threads(1)

TOL = 1e-4
CUT_TRACK = dict(n_theta=16, n_phi=14, width=96, height=64)
# every part of bench.main cut to seconds on the CPU; the splat scenes'
# worklists are cut in the test (bench_render's raster dicts)
CUT = {
    "sim": dict(nx=8, substeps=2),
    "grids": (16, 20, 24),
    "sand": 200,
    "render": dict(width=96, height=64, splats=500, frames=1),
    "appearance": dict(width=64, height=48, mesh="12x10", work_cap=32,
                       steps=1),
    "tracking": dict(iters=1, n_theta=10, n_phi=8, width=64, height=48),
    "material": dict(nx=5, grid=16, substep=4, frames=1, reps=1),
}
KEYS = {"metric", "value", "unit", "grid200_substeps_per_sec",
        "grid250_100k_sand_substeps_per_sec", "render_fps_1080p_50k",
        "appearance_train_steps_per_sec_1500x1000_50k",
        "projected_stage2_hours_30k_iters", "tracking_steps_per_sec",
        "tracking_min_per_frame_3k_iters", "material_grad_step_sec",
        "material_grad_over_forward"}


def test_tracking_problem_matches_jax(monkeypatch):
    jtr, jbatches, n_faces = jbench_tracking.build_tracking_problem(
        **CUT_TRACK)
    jrasterize = jt.rasterize
    monkeypatch.setattr(jt, "rasterize", lambda *a, **k: jrasterize(
        *a, mid_capacity=a[0].shape[0], big_capacity=a[0].shape[0], **k))
    jb = jbatches[0]
    jca, w, h = jt.camera_arrays(jb["cam"]), jb["cam"].image_width, \
        jb["cam"].image_height

    def jloss(params, train, fixed):
        v, vn = jtr._smplx_geometry(train, fixed, jtr.smplx_model,
                                    jtr.vposer)
        return jt.tracking_loss(params, jtr.variables, jca, w, h, 0,
                                jb["rgb"], jb["msk"], v, vn, jtr.prev_col,
                                True, jtr.cfg)[0]

    jgrads = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(
        jtr.params, jtr.smplx_train, jtr.smplx_fixed)
    ref = jtr.fit_frame(jbatches, is_initial=True, iters=1)

    rig = jtr.smplx_model
    rig_t = convert.smplx_model_from_numpy(
        {f.name: (None if getattr(rig, f.name) is None
                  else np.asarray(getattr(rig, f.name)))
         for f in dataclasses.fields(rig) if f.name != "parents"},
        rig.parents, "cpu")
    vposer_t = convert.vposer_from_numpy(
        {k: jtr.vposer[k] for k in ("fc1", "fc2", "out")}, "cpu")
    tr, batches, n = bench_tracking.build_tracking_problem(
        device="cpu", rig=rig_t, vposer=vposer_t, **CUT_TRACK)
    assert n == n_faces == 2 * 15 * 14
    assert set(tr.smplx_train) == {"latent", "beta"}
    assert set(tr.smplx_fixed) == {"trans"}

    # the joint gradient, leaf by leaf, through the rig, VPoser and
    # matrix_to_axis_angle
    trans = tr.smplx_fixed["trans"].clone().requires_grad_(True)
    v, vn = tr._smplx_geometry(tr.smplx_train, {"trans": trans})
    b = tr._device_batches(batches)[0]
    loss, _ = tt.tracking_loss(tr.params, tr.variables, b["ca"], b["w"],
                               b["h"], b["cam_id"], b["rgb"], b["msk"], v,
                               vn, tr.prev_col, True, tr.cfg)
    leaves = {**tr.params, **tr.smplx_train, "trans": trans}
    grads = dict(zip(leaves, torch.autograd.grad(
        loss, list(leaves.values()), allow_unused=True)))
    refs = {**jgrads[0], **jgrads[1], **jgrads[2]}
    assert set(refs) == set(grads)
    for k in ("latent", "trans", "vertices", "rgb_colors"):
        assert float(np.abs(np.asarray(refs[k])).max()) > 0, k
    for k, r in refs.items():
        r = np.asarray(r)
        g = np.zeros_like(r) if grads[k] is None else grads[k].numpy()
        err = float(np.abs(g - r).max()) / max(float(np.abs(r).max()),
                                               1e-30)
        assert err <= TOL, (k, err)

    out = tr.fit_frame(batches, is_initial=True, iters=1)
    assert int(tr.stats["big_overflow"]) == 0
    np.testing.assert_allclose(out, ref, atol=TOL)
    for k in tt.PARAM_KEYS:
        np.testing.assert_allclose(tr.params[k].detach().numpy(),
                                   np.asarray(jtr.params[k]), atol=TOL,
                                   err_msg=k)
    for k in ("latent", "beta"):
        np.testing.assert_allclose(tr.smplx_train[k].detach().numpy(),
                                   np.asarray(jtr.smplx_train[k]),
                                   atol=TOL, err_msg=k)
    # the step moved the vertices past the tolerance (Adam's first step
    # is lr * sign(g): 1.6e-4)
    moved = (tr.params["vertices"].detach() - tr.prev_verts[0]).abs().max()
    assert float(moved) > TOL


@pytest.fixture
def cut_worklists(monkeypatch):
    """The splat scenes' worklists cut to the cut frames."""
    monkeypatch.setitem(bench_render.SPLAT_RASTER, "work_cap", 64)
    monkeypatch.setitem(bench_render.BIG_SPLAT_RASTER, "work_cap", 64)


def _last_line(capsys):
    lines = capsys.readouterr().out.strip().splitlines()
    return lines, json.loads(lines[-1])


def test_bench_main_prints_the_jax_keys(capsys, cut_worklists):
    returned = bench.main(["--device", "cpu"], shapes=CUT)
    lines, line = _last_line(capsys)
    assert line == returned
    assert KEYS <= set(line) and "vs_baseline" not in line
    assert line["metric"] == bench.METRIC and line["device"] == "cpu"
    # the peak is the card's allocator's: no key on the CPU
    assert "peak_bytes" not in line
    for k in KEYS - {"metric", "unit"}:
        assert math.isfinite(line[k]) and line[k] > 0, (k, line[k])
    # the parts' own lines come first: 2 render scenes, appearance,
    # tracking, material
    assert len(lines) == 6


def test_bench_main_one_off_lines(capsys, cut_worklists):
    line = bench.main(["--device", "cpu", "--grid", "20", "--sand", "100"],
                      shapes=CUT)
    assert line["metric"] == \
        "mpm_substeps_per_sec_100k_particles_20grid_100sand"
    assert math.isfinite(line["value"]) and line["value"] > 0
    line = bench.main(["--device", "cpu", "--render"], shapes=CUT)
    assert line["metric"] == "splat_render_fps_1080p_50k"
    assert line["value"] > 0 and line["big_splat_fps"] > 0
    assert _last_line(capsys)[1] == line


def test_bench_main_stops_on_a_failing_part(capsys, monkeypatch):
    def broken(argv):
        raise RuntimeError("render part failed")

    monkeypatch.setattr(bench_render, "main", broken)
    with pytest.raises(RuntimeError, match="render part failed"):
        bench.main(["--device", "cpu", "--headline_only"], shapes=CUT)
    out = capsys.readouterr().out
    assert "_error" not in out and bench.METRIC not in out


def test_bench_main_resolves_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main([], shapes=CUT)


def test_substeps_per_sec_steps_the_run_states(monkeypatch):
    seen = []
    real = MPMSolver.check_finite

    def record(state, *args, **kw):
        seen.append(state)
        return real(state, *args, **kw)

    monkeypatch.setattr(MPMSolver, "check_finite", staticmethod(record))
    kw = dict(grid=16, sand=100, nx=8, substeps=3)
    rate = bench_scene.substeps_per_sec(device="cpu", **kw)
    assert math.isfinite(rate) and rate > 0
    (timed,) = seen
    frames = bench_scene.WARM_FRAMES + bench_scene.TIMED_FRAMES
    ran = bench_scene.run(frames=frames, device="cpu", log=lambda s: None,
                          **kw)
    for f in ("x", "v", "C", "F", "F_trial", "d"):
        assert torch.equal(getattr(timed, f), getattr(ran, f)), f
    # 21 substeps of fall: v = g t ~ 0.02
    assert float(timed.v.abs().max()) > 0.01
