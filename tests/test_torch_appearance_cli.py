"""The port's stage-2 and stage-4 tools on the CPU: the appearance
training CLI (train/train_appearance.py) against the JAX package's
scripts/train_appearance.py run in a subprocess on the same toy capture,
the loop's densification, logs and device cache, the synthetic capture
generator at a cut size, the material CLI's ``--run_eval`` and the
metrics CLI (train/eval_metrics.py) against scripts/eval.py.

The toy capture is tests/test_torch_data.py's (the 5 x 5 tracked cloth of
tests/test_train.py under three 32 x 24 cameras aimed at it).  Both CLIs
run with a tile capacity that holds every instance: the capacity's 96
dead slots bind face 0, which the JAX package bins and the port does not,
so at a capacity that face 0's tile overflows the JAX package drops the
live splats behind them.

Tolerances, as tests/test_torch_train_appearance.py holds a train step:
the iteration-0 loss within 1e-5 and its L1 within 1e-6 (before any
update); after the Adam steps (eps 1e-15: a step moves a parameter by
about its lr whatever the gradient's size) the saved parameters, where
every step's gradient was at least CERTAIN = 1e-2 of its leaf's largest,
within 1e-6 + lr 4 ITERS GRAD_TOL / CERTAIN (the first update,
lr sign(g), is exact there; a later one's direction m / sqrt(v) moves
with the gradients' relative error, at most GRAD_TOL = 2e-5 of the
largest over CERTAIN; a leaf's largest is floored at 1e-6 of the step's
largest, so the isotropic splats' noise-level rotation gradients count
as uncertain), and elsewhere within the 2 lr per step that a noise-level
gradient of another sign can make.  A splat with an alpha within 1e-4 of
the 1/255 cutoff at some pixel in some step is a rounding tie between the
packages: such splats are counted (at most 2) and left out of the tight
comparison.  The later losses and the test metrics of the three-step
avatars within 1e-4 relative.  The metrics CLI
reads the same PNGs as the JAX script: the geometry exactly, PSNR and
SSIM within 1e-5 relative, LPIPS within 2e-4."""

import json
import os
import runpy
import subprocess
import sys
from unittest import mock

import numpy as np
import pytest
import torch
from PIL import Image

from test_lpips import _make_random_weights
from test_torch_data import toy_capture

from mpmavatar_tpu.render import avatar_model as javatar_model

from mpmavatar_tpu_torch.core.types import build_body_sphere
from mpmavatar_tpu_torch.render import avatar_model as tavatar_model
from mpmavatar_tpu_torch.train import appearance as tapp
from mpmavatar_tpu_torch.train import eval_metrics
from mpmavatar_tpu_torch.train import train_appearance as tcli
from mpmavatar_tpu_torch.train import train_material
from mpmavatar_tpu_torch.train.material import (MaterialTrainer,
                                                MaterialTrainerConfig)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_TOL = 1e-5
VALUE_TOL = 1e-6
METRIC_TOL = 1e-4
GRAD_TOL = 2e-5
CERTAIN = 1e-2
ITERS = 3

# scripts/train_appearance.py with make_train_step and evaluate_appearance
# wrapped to record each step's draw and loss and each evaluation at full
# precision (the script prints five decimals)
_JAX_RUNNER = """
import json, runpy, sys
import mpmavatar_tpu.train.appearance as A
rec = {"steps": [], "tests": []}
make = A.make_train_step
def make_train_step(*a, **k):
    step = make(*a, **k)
    def recorded(params, opt_state, t, camera_idx, *rest):
        out = step(params, opt_state, t, camera_idx, *rest)
        rec["steps"].append([int(camera_idx), int(t), float(out[2]),
                             float(out[3]["l1"])])
        return out
    return recorded
A.make_train_step = make_train_step
evaluate = A.evaluate_appearance
def evaluate_appearance(*a, **k):
    m = evaluate(*a, **k)
    rec["tests"].append(m)
    return m
A.evaluate_appearance = evaluate_appearance
out, sys.argv = sys.argv[1], ["train_appearance.py"] + sys.argv[2:]
try:
    runpy.run_path("scripts/train_appearance.py", run_name="__main__")
finally:
    with open(out, "w") as f:
        json.dump(rec, f)
"""


def _flags(root, model_path, iterations=ITERS, extra=()):
    return ["--dataset_dir", str(root), "--trained_model_path", str(root),
            "--uv_path", str(root / "uv.obj"), "--model_path",
            str(model_path), "--test_camera_index", "2",
            "--train_frame_start_num", "0", "2", "--test_frame_start_num",
            "0", "2", "--iterations", str(iterations), "--tile_capacity",
            "256", *extra]


def _run_port(argv):
    return tcli.train(tcli.parse_args(argv), device="cpu")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("capture")
    toy_capture(root)
    flags = _flags(root, root / "jax", extra=["--test_iterations", "1",
                                               str(ITERS)])
    rec_path = root / "jax_rec.json"
    proc = subprocess.run(
        [sys.executable, "-c", _JAX_RUNNER, str(rec_path), *flags],
        cwd=REPO, capture_output=True, text=True, timeout=600,
        env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(rec_path) as f:
        jrec = json.load(f)
    # the port's steps as make_train_step runs them, each gradient and
    # the splats tied at the alpha cutoff kept
    grads, tied = [], set()

    def make_train_step(avatar, opt, optimizer, *a, **k):
        loss_and_grads = tapp.make_loss_and_grads(avatar, opt, *a, **k)

        def step(params, *args):
            tied.update(_tied_splats(avatar, params, *args))
            loss, aux, g = loss_and_grads(params, *args)
            grads.append({n: v.abs() for n, v in g.items()})
            tapp.apply_updates_float(optimizer, params, g)
            return loss, aux
        return step

    with mock.patch.object(tcli, "make_train_step", make_train_step):
        port = _run_port(_flags(root, root / "port",
                                extra=["--test_iterations", "1",
                                       str(ITERS)]))
    return dict(root=root, jax=jrec, jax_stdout=proc.stdout, port=port,
                grads=grads, tied=sorted(tied))


@torch.no_grad()
def _tied_splats(avatar, params, t, camera_idx, ca, gt_rgb, gt_msk, ao,
                 width, height, rel=1e-4):
    """The splats whose alpha at some pixel of this view lies within
    ``rel`` of the 1/255 cutoff."""
    from mpmavatar_tpu_torch.render import gaussians as G
    from mpmavatar_tpu_torch.render.rasterizer import (ALPHA_MIN,
                                                       project_gaussians)
    s = params.splats
    frames = avatar.frames_for_verts(avatar.select_verts(params, t))
    m2d, _, conic, _, vis = project_gaussians(
        G.get_xyz(s, frames), G.get_covariance(s, frames), ca, width,
        height)
    op = G.get_opacity(s)[:, 0] * s.alive * vis
    py, px = torch.meshgrid(torch.arange(height), torch.arange(width),
                            indexing="ij")
    dx = px.reshape(-1, 1) - m2d[None, :, 0]
    dy = py.reshape(-1, 1) - m2d[None, :, 1]
    power = -0.5 * (conic[:, 0] * dx * dx + conic[:, 2] * dy * dy) \
        - conic[:, 1] * dx * dy
    alpha = op * torch.exp(torch.clamp_max(power, 0.0))
    near = ((alpha - ALPHA_MIN).abs() < rel * ALPHA_MIN).any(dim=0)
    return torch.nonzero(near)[:, 0].tolist()


def test_cli_draws_the_jax_scripts_sequence(runs):
    rng = np.random.default_rng(0)
    want = [(int(rng.integers(3)), int(rng.integers(2)))
            for _ in range(ITERS)]
    assert runs["port"]["draws"] == want
    assert [tuple(s[:2]) for s in runs["jax"]["steps"]] == want


def test_cli_iteration0_loss_and_log_match_jax(runs):
    port, jax_steps = runs["port"], runs["jax"]["steps"]
    assert len(port["loss"]) == len(jax_steps) == ITERS
    assert abs(port["loss"][0] - jax_steps[0][2]) <= LOSS_TOL
    assert abs(port["l1"][0] - jax_steps[0][3]) <= VALUE_TOL
    # later steps start from parameters that noise-level gradients moved
    # by up to 2 lr: the losses stay close, not equal
    for (_, _, jl, _), tl in zip(jax_steps, port["loss"]):
        assert abs(tl - jl) <= 1e-4 * abs(jl)
    line = port["logs"][0]
    assert line["iter"] == 0 and np.isnan(line["lpips"])
    # the JAX script's own line, five decimals
    jline = next(ln.split() for ln in runs["jax_stdout"].splitlines()
                 if ln.startswith("iter 0 "))
    assert jline[::2] == ["iter", "loss", "l1", "lpips", "alive"]
    assert jline[7] == "nan" and int(jline[9]) == line["alive"]
    assert abs(float(jline[3]) - line["loss"]) <= 5e-6 + LOSS_TOL
    assert abs(float(jline[5]) - line["l1"]) <= 5e-6 + VALUE_TOL
    assert port["big_overflow"] == port["work_overflow"] == 0


def test_cli_test_metrics_match_jax(runs):
    tests_p, tests_j = runs["port"]["tests"], runs["jax"]["tests"]
    assert [t["iter"] for t in tests_p] == [1, ITERS]
    assert len(tests_j) == 2
    for tp, tj in zip(tests_p, tests_j):
        assert tp.keys() - {"iter"} == tj.keys() == {"l1", "psnr"}
        for k in ("l1", "psnr"):
            assert abs(tp[k] - tj[k]) <= METRIC_TOL * abs(tj[k]), (tp, tj)


def _leaf(params, name):
    """The array of AvatarParams leaf ``name`` ("splats.xyz", "cam_m")."""
    node = params
    for key in name.split("."):
        node = getattr(node, key)
    return np.asarray(node)


def test_cli_checkpoint_matches_jax(runs):
    """The saved avatars after three steps, each loaded by the other
    package: equal where every step's gradient was certain, within Adam's
    2 lr per step elsewhere."""
    root = runs["root"]
    name = f"timestep_{ITERS - 1:06d}"
    pj = root / "jax" / "point_cloud" / name
    pt = root / "port" / "point_cloud" / name
    assert runs["port"]["checkpoints"] == [str(pt)]
    assert sorted(os.listdir(pt)) == sorted(os.listdir(pj))
    _, jparams = javatar_model.load_mesh_avatar(str(root),
                                                str(root / "uv.obj"))
    from_port = javatar_model.load_avatar_checkpoint(str(pt), jparams)
    from_jax = javatar_model.load_avatar_checkpoint(str(pj), jparams)
    _, params = tavatar_model.load_mesh_avatar(
        str(root), str(root / "uv.obj"), device="cpu")
    port_reads_jax = tavatar_model.load_avatar_checkpoint(str(pj), params)
    np.testing.assert_array_equal(port_reads_jax.splats.xyz.numpy(),
                                  np.asarray(from_jax.splats.xyz))
    # every splat stayed alive, so the checkpoints keep the slot order
    assert int(np.asarray(from_jax.splats.alive).sum()) == \
        runs["port"]["alive"] == len(runs["port"]["avatar"].faces)
    radius = tcli.Scene(tcli.extract_dataclass(
        tcli.parse_args(_flags(root, root / "x")),
        tcli.ModelParams)).train_dataset.scene_radius
    lrs = {"splats.xyz": 4e-5 * radius, "splats.features_dc": 0.0025,
           "splats.features_rest": 0.0, "splats.opacity": 0.05,
           "splats.scaling": 0.005, "splats.rotation": 0.001,
           "verts_offset": 0.0, "cam_m": 1e-4, "cam_c": 1e-4}
    assert len(runs["tied"]) <= 2, runs["tied"]
    certain_total = 0
    for leaf, lr in lrs.items():
        a, b, start = (_leaf(p, leaf) for p in (from_port, from_jax,
                                                 jparams))
        certain = np.ones(b.shape, bool)
        if leaf.startswith("splats."):
            certain[runs["tied"]] = False
        for grads in runs["grads"]:
            g = grads[leaf].numpy()
            top = max(float(v.max()) for v in grads.values())
            certain &= g >= CERTAIN * max(g.max(), 1e-6 * top)
        diff = np.abs(a - b)
        tol = VALUE_TOL + lr * 4 * ITERS * GRAD_TOL / CERTAIN
        assert (diff <= 2 * ITERS * lr + VALUE_TOL).all(), leaf
        assert (diff[certain] <= tol).all(), (leaf, diff[certain].max())
        if ITERS * lr > 20 * tol:
            # the steps moved these entries far beyond the tolerance
            assert (np.abs(b - start)[certain] > 10 * tol).all(), leaf
        certain_total += int(certain.sum())
    assert certain_total > 100


def test_cli_loop_densifies_logs_and_preloads(tmp_path):
    """The port's loop at 12 iterations with one densification pass (at
    iteration 5), evaluations after the first and the last step, the
    config written for both packages, and --preload_device drawing and
    training the same."""
    from mpmavatar_tpu.data.config import ModelParams as JModelParams
    from mpmavatar_tpu.data.config import load_config
    toy_capture(tmp_path)
    extra = ["--test_iterations", "1", "12", "--densify_from_iter", "0",
             "--densification_interval", "5", "--densify_until_iter", "6",
             "--densify_grad_threshold", "1e-6"]
    a = _run_port(_flags(tmp_path, tmp_path / "a", 12, extra))
    b = _run_port(_flags(tmp_path, tmp_path / "b", 12,
                         extra + ["--preload_device"]))
    assert [d["iter"] for d in a["densify"]] == [5]
    assert a["densify"][0]["alive"] > 32
    assert a["alive"] == a["densify"][0]["alive"]
    assert [t["iter"] for t in a["tests"]] == [1, 12]
    assert [line["iter"] for line in a["logs"]] == [0]
    assert a["draws"] == b["draws"] and a["loss"] == b["loss"]
    assert a["tests"][-1]["l1"] < a["tests"][0]["l1"]
    cfg = load_config(str(tmp_path / "a" / "cfg_args.json"), JModelParams)
    assert cfg.test_camera_index == [2] and cfg.train_frame_start_num == [0,
                                                                          2]
    assert os.path.isdir(tmp_path / "a" / "point_cloud" / "timestep_000011")


def test_make_synthetic_actorshq_at_a_cut_size(tmp_path):
    """The generator's capture at 96 x 64 (a 20 x 18 body, 3 cameras, 2
    frames) loads in the JAX package's loaders, with the avatar in view
    in every mask."""
    from mpmavatar_tpu.data.datasets import ActorsHQDataset
    from mpmavatar_tpu_torch.data import make_synthetic_actorshq as synth
    out = synth.make_capture(str(tmp_path), n_frames=2, n_cams=3, width=96,
                             height=64, mesh=(20, 18), device="cpu",
                             work_cap=64)
    assert 0 < out["max_items"] <= 64
    assert out["n_faces"] == 684 and out["capacity"] == 4 * 684
    ds = ActorsHQDataset(str(tmp_path / "dataset"), 1, 1, frame_index=[0, 1])
    assert [c.camera_id for c in ds.camera_list] == ["Cam000", "Cam001",
                                                     "Cam002"]
    for ci in range(3):
        b = ds.load_frame(ci, 1)
        assert b["rgb"].shape == (3, 64, 96)
        assert 0.05 < b["msk"].mean() < 0.9
    javatar, _ = javatar_model.load_mesh_avatar(
        str(tmp_path / "tracked"), str(tmp_path / "tracked" / "uv.obj"))
    assert javatar.verts_orig.shape[0] == 2 and len(javatar.faces) == 684
    assert (javatar.ao_maps > 0.3).all()
    assert os.path.isfile(tmp_path / "dataset" / "ActorsHQ" / "Actor01"
                          / "Sequence1" / "4x" / "meshes" / "Frame000001.obj")


def _material_npz(root, verts, faces):
    """train.npz / test.npz for the material CLI: the tracked cloth still
    for three frames, its first row pinned, a small body sphere below."""
    body_v, body_f = build_body_sphere(n_theta=8, n_phi=8,
                                       center=(1.0, 0.8, 1.0), r=0.1)
    for name in ("train", "test"):
        np.savez(root / f"{name}.npz",
                 train_verts=np.repeat(verts[None], 3, 0).astype(np.float32),
                 smplx_verts=np.repeat(body_v[None], 3 if name == "train"
                                       else 2, 0),
                 smplx_faces=body_f, cloth_faces=faces,
                 first_frame_verts=verts.astype(np.float32), num_joint_v=5,
                 num_joint_f=0)
    return root / "train.npz"


def train_material_eval_render(monkeypatch):
    """render_eval_sequence at the toy's AO resolution, its calls kept."""
    from mpmavatar_tpu_torch.train import evaluate as teval
    calls = []
    real = teval.render_eval_sequence

    def render(*a, **k):
        calls.append(a)
        return real(*a, **dict(k, ao_resolution=64, tile_capacity=64))
    monkeypatch.setattr(teval, "render_eval_sequence", render)
    return calls


def test_material_cli_run_eval_writes_the_eval_tree(tmp_path, capsys,
                                                    monkeypatch):
    """--run_eval: the test sequence simulated at the initial parameters
    (the meshes the trainer's own simulate gives), then the AO bake and
    the held-out renders with the newest checkpoint."""
    verts, faces = toy_capture(tmp_path)
    npz = _material_npz(tmp_path, verts, faces)
    avatar, params = tavatar_model.load_mesh_avatar(
        str(tmp_path), str(tmp_path / "uv.obj"), device="cpu")
    tavatar_model.save_avatar_checkpoint(
        str(tmp_path / "avatar" / "point_cloud" / "timestep_000002"),
        params, avatar)
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({"grid_size": 16, "substep": 100}))
    out = tmp_path / "eval"
    # the toy's AO maps are 64^2 (the stage-4 loop's default is 256^2)
    render = train_material_eval_render(monkeypatch)
    assert train_material.main([
        "--tracked_verts_npz", str(npz), "--config", str(cfg),
        "--run_eval", "--skip_video", "--output_dir", str(out),
        "--dataset_dir", str(tmp_path), "--trained_model_path",
        str(tmp_path), "--uv_path", str(tmp_path / "uv.obj"),
        "--model_path", str(tmp_path / "avatar"), "--test_camera_index",
        "0", "2", "--test_frame_start_num", "0", "2", "--device",
        "cpu"]) == 0
    text = capsys.readouterr().out
    assert "wrote 2 simulated meshes" in text and "eval renders" in text
    assert sorted(os.listdir(out)) == ["Cam000", "Cam002", "aomap",
                                       "uvmesh"]
    from mpmavatar_tpu_torch.utils.io import read_obj
    with np.load(str(npz).replace("train", "test")) as f:
        test = {k: f[k] for k in f.files}
    trainer = MaterialTrainer(
        MaterialTrainerConfig(grid_size=16, substep=100), faces, verts,
        test["train_verts"], test["smplx_verts"], test["smplx_faces"], 5, 0,
        device="cpu")
    sim = trainer.simulate(test["train_verts"][0], np.zeros_like(verts),
                           test["smplx_verts"][:-1],
                           np.zeros_like(test["smplx_verts"][1:]),
                           n_frames=1)
    m0, f0 = read_obj(str(out / "uvmesh" / "000.obj"))
    m1, _ = read_obj(str(out / "uvmesh" / "001.obj"))
    np.testing.assert_allclose(m0, verts, atol=1e-6)
    np.testing.assert_array_equal(f0, faces)
    np.testing.assert_allclose(m1, sim[0], atol=1e-6)
    assert np.isfinite(m1).all() and np.abs(m1 - verts).max() > 1e-4
    for cam in ("Cam000", "Cam002"):
        for kind in ("pred", "gt"):
            assert sorted(os.listdir(out / cam / kind)) == ["0000.png",
                                                            "0001.png"]
    # --skip_sim keeps the meshes, --skip_render writes no images
    mtime = os.path.getmtime(out / "uvmesh" / "001.obj")
    os.remove(out / "Cam000" / "pred" / "0001.png")
    assert train_material.main([
        "--tracked_verts_npz", str(npz), "--config", str(cfg),
        "--run_eval", "--skip_sim", "--skip_render", "--output_dir",
        str(out), "--dataset_dir", str(tmp_path), "--trained_model_path",
        str(tmp_path), "--uv_path", str(tmp_path / "uv.obj"),
        "--model_path", str(tmp_path / "avatar"), "--test_camera_index",
        "0", "2", "--test_frame_start_num", "0", "2", "--device",
        "cpu"]) == 0
    assert os.path.getmtime(out / "uvmesh" / "001.obj") == mtime
    assert not os.path.exists(out / "Cam000" / "pred" / "0001.png")
    assert len(render) == 1
    # the newest checkpoint's splats were rendered
    loaded = render[0][1]
    np.testing.assert_array_equal(loaded.splats.features_dc.numpy(),
                                  params.splats.features_dc.numpy())


def _eval_tree(root):
    """An evaluation tree as the stage-4 loop writes it (frames 5 and 6,
    Cam007 and Cam127) and the capture's meshes and masks."""
    from mpmavatar_tpu_torch.utils.io import write_obj
    from test_preprocess_ao import _make_sphere
    v, f = _make_sphere(0.3, (0.0, 0.0, 0.0), nt=10, nph=10)
    rng = np.random.default_rng(3)
    out, data = root / "out", root / "data"
    os.makedirs(out / "uvmesh")
    os.makedirs(data / "meshes")
    for i, frame in enumerate((5, 6)):
        write_obj(str(out / "uvmesh" / f"{i:03d}.obj"), v * (1 + 0.01 * i),
                  f)
        write_obj(str(data / "meshes" / f"Frame{frame:06d}.obj"),
                  v + 0.002 * i, f)
        for cam in ("Cam007", "Cam127"):
            gt = (rng.random((24, 32, 3)) * 255).astype(np.uint8)
            pred = np.clip(gt + rng.normal(0, 12, gt.shape), 0,
                           255).astype(np.uint8)
            for kind, img in (("pred", pred), ("gt", gt)):
                os.makedirs(out / cam / kind, exist_ok=True)
                Image.fromarray(img).save(out / cam / kind
                                          / f"{frame:04d}.png")
            os.makedirs(data / "masks" / cam, exist_ok=True)
            msk = np.zeros((24, 32), np.uint8)
            msk[3:21, 4:28] = 255
            Image.fromarray(msk).save(data / "masks" / cam
                                      / f"{cam}_mask{frame:06d}.png")
    mesh = root / "template.obj"
    write_obj(str(mesh), v, f)
    return out, data, mesh


def test_eval_metrics_cli_matches_the_jax_script(tmp_path, monkeypatch,
                                                 capsys):
    out, data, mesh = _eval_tree(tmp_path)
    weights = tmp_path / "lpips.npz"
    np.savez(weights, **_make_random_weights(seed=7))
    argv = ["--output_path", str(out), "--mesh_path", str(mesh),
            "--data_path", str(data), "--start_idx", "5",
            "--num_timesteps", "2", "--lpips_weights", str(weights)]
    assert eval_metrics.main(argv + ["--device", "cpu"]) == 0
    port = {k: dict(np.load(out / k)) for k in ("geo_metric.npz",
                                                "app_metric.npz")}
    monkeypatch.setattr(sys, "argv", ["eval.py"] + argv)
    runpy.run_path(os.path.join(REPO, "scripts", "eval.py"),
                   run_name="__main__")
    ref = {k: dict(np.load(out / k)) for k in ("geo_metric.npz",
                                               "app_metric.npz")}
    assert port["geo_metric.npz"].keys() == {"CD", "F-Score"}
    for k in ("CD", "F-Score"):
        np.testing.assert_array_equal(port["geo_metric.npz"][k],
                                      ref["geo_metric.npz"][k])
    app, app_ref = port["app_metric.npz"], ref["app_metric.npz"]
    assert app.keys() == app_ref.keys() == {"PSNR", "SSIM", "LPIPS"}
    assert app["PSNR"].shape == (4,)
    for k, tol in (("PSNR", 1e-5), ("SSIM", 1e-5), ("LPIPS", 2e-4)):
        np.testing.assert_allclose(app[k], app_ref[k], rtol=tol, err_msg=k)
    # without weights: a loud line, no LPIPS key; --cameras picks views
    capsys.readouterr()
    with pytest.warns(UserWarning, match="DISABLED"):
        assert eval_metrics.main(argv[:-2] + ["--cameras", "Cam127",
                                              "--device", "cpu"]) == 0
    assert "LPIPS UNAVAILABLE" in capsys.readouterr().out
    app = dict(np.load(out / "app_metric.npz"))
    assert app.keys() == {"PSNR", "SSIM"} and app["PSNR"].shape == (2,)
