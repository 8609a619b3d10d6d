"""The port's production stage-3 command (train/stage3_production.py)
against scripts/stage3_production.py, on the CPU.

``--recover`` runs in both at a cut size: the hanging cloth at NX x NX
on GRID^3, one frame of 400 substeps (dt = 1 / (25 x 400) = 1e-4, the
production step; a shorter one changes the physics), one train step.
The synthetic trajectory at TRUTH must move by more than 0.01 in both
(it moves 0.020 at this size; at 7 x 7 on 16^3 it moved 0.013, where
contact with the coarse sphere splat left the packages' losses 9e-5
apart).  The JAX script runs in a subprocess on its dense path
(``column_k=0, mesh_column_k=0, column_c_cap=0``, through a wrapper that
also saves the frames ``simulate`` returns), concurrently with the
port's ``main`` in this process.  Tolerances: the trajectory 2e-5 (400
float32 substeps), the loss 1e-4 relative, the parameters after the
step 1e-5 (one Adam step of lr x ~sign(g)).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from mpmavatar_tpu_torch.train import bench_material
from mpmavatar_tpu_torch.train import stage3_production as S

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
NX, GRID, SUBSTEP, STEPS = 7, 24, 400, 1
CUT = ["--nx", str(NX), "--grid", str(GRID), "--substep", str(SUBSTEP),
       "--frames", "1", "--steps", str(STEPS)]
TRAJ_TOL, LOSS_REL, PARAM_TOL = 2e-5, 1e-4, 1e-5

_JAX_RUNNER = """
import functools, runpy, sys
import numpy as np
import mpmavatar_tpu.train.material as M
frames_path = sys.argv[1]
M.MaterialTrainerConfig = functools.partial(
    M.MaterialTrainerConfig, column_k=0, mesh_column_k=0, column_c_cap=0)
simulate = M.MaterialTrainer.simulate
def recorded(self, *a, **k):
    frames = simulate(self, *a, **k)
    np.save(frames_path, np.stack([np.asarray(f) for f in frames]))
    return frames
M.MaterialTrainer.simulate = recorded
sys.argv = ["stage3_production.py"] + sys.argv[2:]
runpy.run_path("scripts/stage3_production.py", run_name="__main__")
"""


def _records(path):
    return [json.loads(line) for line in Path(path).read_text().splitlines()]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("stage3")
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", _JAX_RUNNER, str(tmp / "jax_frames.npy"),
         "--recover", "--cpu", *CUT, "--out", str(tmp / "jax.jsonl")],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, JAX_PLATFORMS="cpu",
                 PYTHONPATH=str(REPO)))
    try:
        traj = {}
        synthesize = S.synthesize

        def recorded(args):
            traj["port"] = synthesize(args)[1]
            return None, traj["port"]

        S.synthesize = recorded
        try:
            S.main(["--recover", "--device", "cpu", *CUT, "--out",
                    str(tmp / "port.jsonl")])
        finally:
            S.synthesize = synthesize
        out, err = jax_proc.communicate(timeout=300)
    finally:
        if jax_proc.poll() is None:
            jax_proc.kill()
            jax_proc.wait()
    assert jax_proc.returncode == 0, err[-3000:]
    return dict(port=_records(tmp / "port.jsonl"),
                jax=_records(tmp / "jax.jsonl"), traj=traj["port"],
                jax_frames=np.load(tmp / "jax_frames.npy"), jax_err=err)


def test_recover_synthesizes_the_jax_trajectory(runs):
    traj, frames = runs["traj"], runs["jax_frames"]
    verts, _ = bench_material.hanging_cloth(NX, NX)
    np.testing.assert_array_equal(traj[0], verts)
    np.testing.assert_allclose(traj[1:], frames, atol=TRAJ_TOL)
    move = float(np.abs(traj[-1] - traj[0]).max())
    assert move > 0.01
    line = [s for s in runs["jax_err"].splitlines()
            if "max displacement" in s]
    assert abs(float(line[0].split()[-1]) - move) <= 5e-4, (line, move)


def test_recover_steps_match_the_jax_script(runs):
    port, ref = runs["port"], runs["jax"]
    assert len(port) == len(ref) == STEPS + 1
    for p, r in zip(port[:-1], ref[:-1]):
        assert p.keys() == r.keys()
        assert p["step"] == r["step"]
        assert abs(p["loss"] - r["loss"]) <= LOSS_REL * r["loss"], (p, r)
        for k in S.TRUTH:
            assert abs(p[k] - r[k]) <= PARAM_TOL, (k, p[k], r[k])
            # the step moved the parameter off its init
            assert abs(p[k] - {"D": 1.0, "E": 1.0, "H": 1.0}[k]) > 1e-3


def test_recover_summary_matches_the_jax_script(runs):
    p, r = runs["port"][-1], runs["jax"][-1]
    assert p.keys() == r.keys()
    for k in ("metric", "truth", "steps", "particles", "grid", "frames",
              "substeps_per_frame"):
        assert p[k] == r[k], k
    assert p["particles"] == NX * NX + 2 * (NX - 1) ** 2
    assert abs(p["best_loss"] - r["best_loss"]) <= LOSS_REL * r["best_loss"]
    assert abs(p["init_loss"] - r["init_loss"]) <= LOSS_REL * r["init_loss"]
    for k in S.TRUTH:
        assert abs(p["best"][k] - r["best"][k]) <= PARAM_TOL, k
        # err is rounded to 4 decimals
        assert abs(p["err"][k] - r["err"][k]) <= 1e-4 + PARAM_TOL, k


def test_make_trainer_scales_the_learning_rates_and_pins_the_top_row():
    tr, verts, faces, body, bf = S.make_trainer(5, 5, 16, 40, 1, 10,
                                                lr_scale=2.0, device="cpu")
    assert (tr.cfg.lr_D, tr.cfg.lr_E, tr.cfg.lr_H) == (0.04, 0.12, 0.008)
    assert tr.static.num_joint_v == 5 and tr.static.num_joint_f == 0
    assert tr.static.n_particles == len(verts) + len(faces) == 25 + 32
    assert body.shape == (2, *body.shape[1:]) and tr.cfg.fps == 25.0


def test_bench_runs_the_material_bench(monkeypatch):
    seen = {}
    monkeypatch.setattr(bench_material, "run_bench",
                        lambda args: seen.update(vars(args)) or {})
    S.main(["--bench", "--nx", "9", "--grid", "24", "--frames", "2",
            "--substep", "50", "--reps", "2", "--device", "cpu"])
    assert seen == dict(nx=9, grid=24, frames=2, substep=50, fps=25.0,
                        steps=2, device="cpu")
