"""The frozen reference against the port's plain path (the kernels'
plain versions on CPU tensors) at a tiny size: the first state, the
posing, one substep from the same state, and the material rollout's
loss and gradient."""

from __future__ import annotations

import pytest
import torch
from conftest import tiny

from benchmark import harness
from benchmark.drivers import material_step, sim_frames
from benchmark.drivers.sim_frames import fields
from benchmark.reference import material as ref_material
from benchmark.reference import mpm, posing
from benchmark.reference import scenes as ref_scenes
from benchmark.reference.arith import Arith

CPU = torch.device("cpu")
SIM_CELLS = ("garment200.playback", "demo_sand250.release")


def _cell(workload, **traffic):
    spec = harness.load_json(harness.ROOT / "BENCHMARK.json")
    _, cfg, tr = harness.cell_files(spec, workload)
    tiny(cfg, tr)
    tr.update(traffic)
    return cfg, tr


def _rel(a, b):
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


@pytest.fixture(scope="module", params=SIM_CELLS)
def sim(request):
    cfg, tr = _cell(request.param, warmup_frames=0)
    drv = sim_frames.Driver(cfg, tr, 31, CPU)
    build = {"garment": ref_scenes.garment, "demo": ref_scenes.demo}[
        cfg["scene"]]
    return drv, build(drv.raw, cfg, Arith(False))


def test_first_state_matches(sim):
    drv, (sc, first, _) = sim
    st = drv.state
    for k in ("x", "v", "C", "d"):
        assert _rel(getattr(st, k), first[k]) <= 1e-6 if k in ("x", "d") \
            else float(getattr(st, k).abs().max()) == 0.0
    assert _rel(st.R_inv, sc.r_inv) <= 1e-5
    assert _rel(st.vol, sc.vol) <= 1e-6 and _rel(st.mass, sc.mass) <= 1e-6
    assert _rel(drv.model.mu, sc.mu) <= 1e-6
    assert _rel(drv.model.lam, sc.lam) <= 1e-6


def test_frame_inputs_match(sim):
    drv, (_, _, inputs) = sim
    for i in (0, 1, 10):
        got, ref = drv.inputs(i), inputs(i)
        assert _rel(got["mesh_x"], ref[0]) <= 1e-6
        assert float((got["mesh_v"] - ref[1]).abs().max()) <= 1e-6 * max(
            float(ref[1].abs().max()), 1.0) * drv.fps
        if ref[2] is not None:
            assert float((got["joint_verts_v"] - ref[2]).abs().max()) <= \
                2e-6 * drv.fps


def test_one_substep_matches(sim):
    drv, (sc, _, _) = sim
    inp = drv.inputs(0)
    got = drv.solver.substep(drv.state, drv.model, drv.dt, 0.0, **inp)
    ref = mpm.substep(sc, fields(drv.state), 0.0, drv.dt, inp["mesh_x"],
                      inp["mesh_v"], inp["joint_verts_v"],
                      inp["joint_faces_v"], Arith(False))
    for k in ("x", "v", "C", "F", "F_trial", "d"):
        if ref[k].numel():
            assert _rel(getattr(got, k), ref[k]) <= 1e-5, k


def test_frames_agree_and_the_control_does_not(sim):
    drv, (sc, first, inputs) = sim
    with torch.no_grad():
        ref, _ = mpm.frame(sc, first, 0.0, drv.dt, drv.substeps, *inputs(0),
                           Arith(False))
        ctl, _ = mpm.frame(sc, first, 0.0, drv.dt, drv.substeps, *inputs(0),
                           Arith(True))
    state, _ = drv.solver.frame(drv.state, drv.model, drv.dt, drv.substeps,
                                0.0, **drv.inputs(0))
    err = float((state.x - ref["x"]).abs().max())
    assert err < 0.1 * float((ctl["x"] - ref["x"]).abs().max())


def test_posing_matches_the_port():
    cfg, tr = _cell("garment200.playback")
    drv = sim_frames.Driver(cfg, dict(tr, warmup_frames=0), 5, CPU)
    raw = drv.raw
    cloth, bodies = posing.repose(raw["body"], raw["first"], raw["poses"],
                                  raw["verts"], cfg["knn_k"], Arith(False))
    from mpmavatar_tpu_torch.sim.pose_playback import prepare_pose_playback
    pb = prepare_pose_playback(sim_frames.smplx_model(raw["body"]),
                               raw["first"], raw["poses"], raw["verts"],
                               fps=drv.fps, k=cfg["knn_k"])
    assert _rel(pb["verts"], cloth) <= 1e-6
    assert _rel(pb["smplx"], bodies) <= 1e-6


def test_material_loss_and_gradient_match_the_port():
    cfg, tr = _cell("garment200.material_step", setup_steps=1)
    drv = material_step.Driver(cfg, tr, 9, CPU)
    raw = drv.raw
    cloth, bodies = posing.repose(raw["body"], raw["first"], raw["poses"],
                                  raw["verts"], cfg["knn_k"], Arith(False))
    roll = ref_material.Rollout(cfg, drv.train, raw["faces"], drv.rest,
                                cloth, bodies, raw["body"]["faces"],
                                Arith(False))
    init = {k: torch.tensor(v, requires_grad=True)
            for k, v in drv.init.items()}
    ref = roll.loss(init["D"], init["E"], init["H"])
    g_ref = torch.autograd.grad(ref, list(init.values()))
    params = {k: torch.tensor(v, requires_grad=True)
              for k, v in drv.init.items()}
    got = drv.trainer.rollout_loss(params)
    g_got = torch.autograd.grad(got, list(params.values()))
    got, ref = float(got.detach()), float(ref.detach())
    assert abs(got - ref) <= 1e-4 * abs(ref)
    scale = max(abs(float(g)) for g in g_ref)
    for a, b in zip(g_got, g_ref):
        assert abs(float(a) - float(b)) <= 1e-2 * scale
