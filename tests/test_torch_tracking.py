"""Stage-1 tracking in the port against the JAX package on the CPU.

``collision_loss`` and ``tracking_loss`` with their gradients, the port
on the tile path (work_cap 0) and on the worklist compositor (work_cap >
0, K6/K7's plain versions here) against JAX's tile path (loss <= 1e-5,
gradients <= 1e-4 of each leaf's largest entry); where the
rasterizer's default footprint tiers overflow, JAX's loss apart from the
port's (which admits every splat) and equal to it given the same
capacities (<= 1e-5); the tracker's set-up
arrays; 3 ``fit_frame`` iterations against JAX's (optax's Adam against
the port's per-group torch Adam, <= 1e-4); the SMPL-X branch (the JAX
test rig, a seeded VPoser latent fitted jointly through the collision
penalty) and ``repose_human``; ``save_frame``/``resume`` files read by
both packages; ``train/run_tracking`` cut against
scripts/run_tracking.py run in a JAX subprocess on a tiny capture; and
the tracking and demo CLIs resolving the card unless asked for the
CPU.

The scenes sit off the loss terms' kinks: the cloth is jittered out of
its plane (``abs(ndot - 1)`` at a flat cloth, ``abs(area - mean)`` at
equal areas), and no two splats share a depth."""

import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_rasterizer import simple_camera
from test_substep_golden import make_cloth
from test_torch_data import toy_capture

from mpmavatar_tpu.avatar import smplx as jsmplx
from mpmavatar_tpu.avatar import vposer as jvp
from mpmavatar_tpu.render.geometry import vertex_normals as j_vertex_normals
from mpmavatar_tpu.render.rasterizer import camera_arrays as j_camera_arrays
from mpmavatar_tpu.train import tracking as jt
from mpmavatar_tpu.utils import losses as jlosses

from mpmavatar_tpu_torch import convert
from mpmavatar_tpu_torch.avatar import smplx as tsmplx
from mpmavatar_tpu_torch.render.avatar_model import load_mesh_avatar
from mpmavatar_tpu_torch.render.rasterizer import camera_arrays
from mpmavatar_tpu_torch.train import run_tracking
from mpmavatar_tpu_torch.train import tracking as tt
from mpmavatar_tpu_torch.utils import losses as tlosses

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
FIT_TOL = 1e-4
WORK_CAP = 256
W = H = 32


def _scene(seed=0, n=6, w=W, h=H):
    """An n x n cloth in the camera's x-y plane, jittered out of it, with
    seeded colours and opacities; a w x h GT image and mask; body points
    a few mm around the first 20 vertices, normals toward the camera."""
    rng = np.random.default_rng(seed)
    verts, faces = make_cloth(nx=n, ny=n, y0=0.0, extent=0.8)
    verts = (verts - np.array([1.0, 0.0, 1.0]))[:, [0, 2, 1]]
    verts[:, 2] = 0.03 * rng.normal(size=len(verts))
    verts = verts.astype(np.float32)
    faces = np.asarray(faces, np.int32)
    gt = (0.3 + 0.4 * rng.random((3, h, w))).astype(np.float32)
    msk = (rng.random((1, h, w)) > 0.2).astype(np.float32)
    body = verts[:20] + rng.uniform(-0.002, 0.004, (20, 3)) * [0, 0, 1]
    normals = np.tile([0.0, 0.0, -1.0], (20, 1)) + 0.1 * rng.normal(
        size=(20, 3))
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    return verts, faces, gt, msk, body.astype(np.float32), \
        normals.astype(np.float32)


def _jax_params(verts, faces, seed=1, max_cams=2):
    rng = np.random.default_rng(seed)
    p = jt.init_tracking_params(verts, faces, max_cams)
    p["rgb_colors"] = jnp.asarray(rng.uniform(0.2, 0.8, (len(faces), 3)),
                                  jnp.float32)
    p["logit_opacities"] = jnp.asarray(rng.normal(0, 0.5, (len(faces), 1)),
                                       jnp.float32)
    p["cam_m"] = jnp.asarray(rng.normal(0, 0.05, (max_cams, 3)), jnp.float32)
    p["cam_c"] = jnp.asarray(rng.normal(0, 0.05, (max_cams, 3)), jnp.float32)
    return p


def _np_tree(p):
    return {k: np.asarray(v) for k, v in p.items()}


def _grad_close(got: dict, ref: dict, tol=GRAD_TOL):
    largest = max(float(np.abs(v).max()) for v in ref.values())
    for k, r in ref.items():
        r = np.asarray(r)
        g = np.zeros_like(r) if got[k] is None else got[k].detach().numpy()
        scale = max(float(np.abs(r).max()), 1e-6 * largest)
        err = float(np.abs(g - r).max()) / scale
        assert err <= tol, (k, err)


def test_collision_loss_and_gradient_match_jax():
    rng = np.random.default_rng(4)
    cloth = rng.normal(size=(50, 3)).astype(np.float32)
    body = (cloth[rng.permutation(50)[:30]]
            + rng.normal(0, 0.01, (30, 3))).astype(np.float32)
    nrm = rng.normal(size=(30, 3))
    nrm = (nrm / np.linalg.norm(nrm, axis=1, keepdims=True)).astype(
        np.float32)
    ref, jg = jax.value_and_grad(jlosses.collision_loss, argnums=(0, 1, 2))(
        jnp.asarray(cloth), jnp.asarray(body), jnp.asarray(nrm), 0.02)
    ts = [torch.tensor(a, requires_grad=True) for a in (cloth, body, nrm)]
    out = tlosses.collision_loss(*ts, eps=0.02)
    out.backward()
    assert float(ref) > 0
    assert abs(float(out) - float(ref)) <= LOSS_TOL
    _grad_close({i: t.grad for i, t in enumerate(ts)},
                {i: np.asarray(g) for i, g in enumerate(jg)})


def test_tracking_variables_match_jax():
    verts, faces, *_ = _scene()
    ref = jt.init_tracking_variables(verts, faces, np.arange(20))
    out = tt.init_tracking_variables(verts, faces, np.arange(20), "cpu")
    for k in ref:
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                   rtol=1e-6, atol=0, err_msg=k)
    ref_p = jt.init_tracking_params(verts, faces, 3)
    out_p = tt.init_tracking_params(verts, faces, 3, "cpu")
    for k in ref_p:
        np.testing.assert_array_equal(out_p[k].numpy(), np.asarray(ref_p[k]))


@pytest.mark.parametrize("work_cap", [0, WORK_CAP])
@pytest.mark.parametrize("initial", [True, False], ids=["initial", "later"])
def test_tracking_loss_and_gradient_match_jax(work_cap, initial):
    verts, faces, gt, msk, body, normals = _scene()
    jp = _jax_params(verts, faces)
    cam = simple_camera(w=W, h=H, f=20.0, cam_z=-2.0)
    cfg = jt.TrackingConfig(tile_capacity=64)
    prev = np.random.default_rng(5).random((len(faces), 3)).astype(
        np.float32)
    jv = jt.init_tracking_variables(verts, faces, np.arange(20))
    (ref, jparts), jg = jax.value_and_grad(
        lambda p: jt.tracking_loss(
            p, jv, j_camera_arrays(cam), W, H, 1, jnp.asarray(gt),
            jnp.asarray(msk), jnp.asarray(body), jnp.asarray(normals),
            jnp.asarray(prev), initial, cfg), has_aux=True)(jp)

    params = convert.tracking_params_from_numpy(_np_tree(jp), "cpu")
    for v in params.values():
        v.requires_grad_(True)
    tv = tt.init_tracking_variables(verts, faces, np.arange(20), "cpu")
    stats = {}
    out, parts = tt.tracking_loss(
        params, tv, camera_arrays(cam, "cpu"), W, H, 1, torch.tensor(gt),
        torch.tensor(msk), torch.tensor(body), torch.tensor(normals),
        torch.tensor(prev), initial,
        tt.TrackingConfig(tile_capacity=64, work_cap=work_cap), stats=stats)
    out.backward()
    assert int(stats["work_overflow"]) == 0 and int(stats["big_overflow"]) \
        == 0
    if work_cap:
        assert 0 < int(stats["n_items"]) <= work_cap
    assert set(parts) == set(jparts)
    assert float(jparts["collision"]) > 0
    for k in jparts:
        assert abs(float(parts[k]) - float(jparts[k])) <= LOSS_TOL, k
    assert abs(float(out) - float(ref)) <= LOSS_TOL
    _grad_close({k: v.grad for k, v in params.items()}, _np_tree(jg))


def test_tracking_loss_admits_every_splat_where_jax_overflows(monkeypatch):
    """A 16 x 16 cloth (450 faces) across a 160^2 view: most splats span
    more than 2 tiles, past the rasterizer's default mid tier (256
    splats).  JAX's call drops their coverage and its loss differs from
    the port's, which admits every splat to each tier; JAX given the same
    capacities matches the port (loss <= 1e-5)."""
    w = h = 160
    verts, faces, gt, msk, body, normals = _scene(n=16, w=w, h=h)
    jp = _jax_params(verts, faces)
    cam = simple_camera(w=w, h=h, f=300.0, cam_z=-2.0)
    cfg = jt.TrackingConfig(tile_capacity=64)
    prev = np.random.default_rng(5).random((len(faces), 3)).astype(
        np.float32)
    jv = jt.init_tracking_variables(verts, faces, np.arange(20))
    args = (jv, j_camera_arrays(cam), w, h, 1, jnp.asarray(gt),
            jnp.asarray(msk), jnp.asarray(body), jnp.asarray(normals),
            jnp.asarray(prev), False, cfg)
    jrasterize, overflow = jt.rasterize, []

    def counted(*a, **k):
        out = jrasterize(*a, **k)
        overflow.append(int(out["big_overflow"]))
        return out

    monkeypatch.setattr(jt, "rasterize", counted)
    default, _ = jt.tracking_loss(jp, *args)
    n = len(faces)
    monkeypatch.setattr(jt, "rasterize", lambda *a, **k: jrasterize(
        *a, mid_capacity=n, big_capacity=n, **k))
    ref, _ = jt.tracking_loss(jp, *args)
    params = convert.tracking_params_from_numpy(_np_tree(jp), "cpu")
    stats = {}
    out, _ = tt.tracking_loss(
        params, tt.init_tracking_variables(verts, faces, np.arange(20),
                                           "cpu"),
        camera_arrays(cam, "cpu"), w, h, 1, torch.tensor(gt),
        torch.tensor(msk), torch.tensor(body), torch.tensor(normals),
        torch.tensor(prev), False, tt.TrackingConfig(tile_capacity=64),
        stats=stats)
    assert overflow[0] > 0 and int(stats["big_overflow"]) == 0
    assert abs(float(out) - float(default)) > 100 * LOSS_TOL
    assert abs(float(out) - float(ref)) <= LOSS_TOL

def _batches(cam, gt, msk):
    return [{"cam": cam, "camera_idx": 1, "rgb": gt, "msk": msk}]


@pytest.mark.parametrize("work_cap", [0, WORK_CAP])
def test_fit_frame_matches_jax(work_cap):
    """3 iterations of frame 0, then the warm start and 2 of frame 1."""
    verts, faces, gt, msk, body, normals = _scene()
    jp = _jax_params(verts, faces)
    cam = simple_camera(w=W, h=H, f=20.0, cam_z=-2.0)
    jtr = jt.MeshTracker(verts, faces, jt.TrackingConfig(tile_capacity=64),
                         cloth_v_idx=np.arange(20), max_cams=2,
                         scene_radius=2.0)
    jtr.params = jp
    jtr.opt_state = jtr.tx.init(jp)
    ttr = tt.MeshTracker(verts, faces,
                         tt.TrackingConfig(tile_capacity=64,
                                           work_cap=work_cap),
                         cloth_v_idx=np.arange(20), max_cams=2,
                         scene_radius=2.0, device="cpu")
    with torch.no_grad():
        for k, v in convert.tracking_params_from_numpy(_np_tree(jp),
                                                       "cpu").items():
            ttr.params[k].copy_(v)
    ttr.prev_verts = [ttr.params["vertices"].detach().clone()]
    for initial, iters in ((True, 3), (False, 2)):
        if not initial:
            jtr.initialize_per_timestep()
            ttr.initialize_per_timestep()
        ref = jtr.fit_frame(_batches(cam, gt, msk), body, normals,
                            is_initial=initial, iters=iters)
        out = ttr.fit_frame(_batches(cam, gt, msk), body, normals,
                            is_initial=initial, iters=iters)
        np.testing.assert_allclose(out, ref, atol=LOSS_TOL)
        for k in tt.PARAM_KEYS:
            np.testing.assert_allclose(ttr.params[k].detach().numpy(),
                                       np.asarray(jtr.params[k]),
                                       atol=FIT_TOL, err_msg=k)
    # every step moved the vertices by about an lr
    moved = float(np.abs(np.asarray(jtr.params["vertices"])
                         - np.asarray(jp["vertices"])).max())
    assert moved > 3 * 0.00016


def _rig_scene():
    """The JAX test's rig (4 joints, 64 vertices) with the tracked mesh
    its surface pushed 0.02 inside; a seeded VPoser for its 3 joints."""
    rig = jsmplx.make_test_rig(n_joints=4, n_verts=64)
    faces = np.asarray(rig.faces)
    pose = {"body_pose": jnp.zeros((1, 9)), "trans": jnp.zeros((1, 3)),
            "beta": jnp.zeros((1, 5))}
    body_v = np.asarray(jsmplx.smplx_forward(rig, pose).vertices[0])
    vn = np.asarray(j_vertex_normals(jnp.asarray(body_v),
                                     jnp.asarray(faces)))
    return rig, faces, pose, (body_v - 0.02 * vn).astype(np.float32)


def test_joint_smplx_fit_matches_jax():
    rig, faces, pose, cloth_v = _rig_scene()
    jvposer = jvp.init_vposer(jax.random.PRNGKey(3), num_neurons=16,
                              latent_dim=8, n_joints=3)
    latent = np.random.default_rng(6).normal(0, 0.1, (1, 8)).astype(
        np.float32)
    fit = {**pose, "latent": jnp.asarray(latent)}
    cam = simple_camera(w=W, h=H, f=20.0, cam_z=-3.0)
    gt = np.random.default_rng(0).random((3, H, W)).astype(np.float32)
    msk = np.ones((1, H, W), np.float32)
    cfg = dict(collision_weight=100.0, tile_capacity=64)
    jtr = jt.MeshTracker(cloth_v, faces, jt.TrackingConfig(**cfg),
                         cloth_v_idx=np.arange(64), smplx_model=rig,
                         vposer=jvposer, smplx_faces=faces, lr_smplx=5e-3,
                         max_cams=2)
    jtr.set_smplx_frame(fit, is_initial=True)
    ref = jtr.fit_frame(_batches(cam, gt, msk), is_initial=True, iters=3)
    jfit = jtr.finish_smplx_frame(True)

    trig = tsmplx.make_test_rig(n_joints=4, n_verts=64, device="cpu")
    tvposer = convert.vposer_from_numpy(
        {k: jvposer[k] for k in ("fc1", "fc2", "out")}, "cpu")
    ttr = tt.MeshTracker(cloth_v, faces, tt.TrackingConfig(**cfg),
                         cloth_v_idx=np.arange(64), smplx_model=trig,
                         vposer=tvposer, smplx_faces=faces, lr_smplx=5e-3,
                         max_cams=2, device="cpu")
    ttr.set_smplx_frame(_np_tree(fit), is_initial=True)
    assert set(ttr.smplx_train) == {"latent", "beta"}
    out = ttr.fit_frame(_batches(cam, gt, msk), is_initial=True, iters=3)
    tfit = ttr.finish_smplx_frame(True)
    np.testing.assert_allclose(out, ref, atol=LOSS_TOL)
    for k in jfit:
        np.testing.assert_allclose(tfit[k].detach().numpy(),
                                   np.asarray(jfit[k]), atol=FIT_TOL,
                                   err_msg=k)
    assert float(np.abs(np.asarray(jfit["latent"]) - latent).max()) > 1e-4
    for k in tt.PARAM_KEYS:
        np.testing.assert_allclose(ttr.params[k].detach().numpy(),
                                   np.asarray(jtr.params[k]), atol=FIT_TOL,
                                   err_msg=k)


def test_repose_human_matches_jax():
    rig, faces, pose0, cloth_v = _rig_scene()
    p1 = {**pose0, "body_pose": jnp.asarray(
        np.array([[0.4, 0.0, 0.1, 0.0, 0.2, 0.0, 0.0, 0.0, 0.3]],
                 np.float32)), "trans": jnp.asarray([[0.0, 0.05, 0.0]])}
    jtr = jt.MeshTracker(cloth_v, faces, cloth_v_idx=np.arange(10),
                         smplx_model=rig, smplx_faces=faces)
    jtr.repose_human(pose0, p1)
    ttr = tt.MeshTracker(cloth_v, faces, cloth_v_idx=np.arange(10),
                         smplx_model=tsmplx.make_test_rig(4, 64,
                                                          device="cpu"),
                         smplx_faces=faces, device="cpu")
    ttr.repose_human(_np_tree(pose0), _np_tree(p1))
    out, ref = ttr.params["vertices"].detach().numpy(), np.asarray(
        jtr.params["vertices"])
    assert float(np.abs(ref[10:] - cloth_v[10:]).max()) > 0.01
    np.testing.assert_allclose(out, ref, atol=1e-5)
    np.testing.assert_array_equal(out[:10], cloth_v[:10])


def test_save_frame_and_resume_across_packages(tmp_path):
    verts, faces, *_ = _scene()
    jp = _jax_params(verts, faces)
    port = tt.MeshTracker(verts, faces, max_cams=2, device="cpu")
    with torch.no_grad():
        for k, v in convert.tracking_params_from_numpy(_np_tree(jp),
                                                       "cpu").items():
            port.params[k].copy_(v)
    port.save_frame(str(tmp_path / "params_0.npz"), 0)
    with torch.no_grad():
        port.params["vertices"].add_(0.05)
    port.save_frame(str(tmp_path / "params_3.npz"), 3)
    jtr = jt.MeshTracker(verts, faces, max_cams=2)
    jtr.save_frame(str(tmp_path / "jax_params.npz"), 0)
    a, b = np.load(tmp_path / "params_0.npz"), np.load(tmp_path /
                                                       "jax_params.npz")
    assert {k: (a[k].shape, a[k].dtype) for k in a.files} == \
        {k: (b[k].shape, b[k].dtype) for k in b.files}

    jtr.resume(str(tmp_path), 0, 3)      # the JAX tracker reads the port's
    back = tt.MeshTracker(verts, faces, max_cams=2, device="cpu")
    back.resume(str(tmp_path), 0, 3)
    for k in tt.PARAM_KEYS:
        np.testing.assert_array_equal(back.params[k].detach().numpy(),
                                      np.asarray(jtr.params[k]))
    assert len(back.prev_verts) == 1
    np.testing.assert_allclose(back.params["vertices"].detach().numpy(),
                               np.asarray(jp["vertices"]) + 0.05, atol=1e-6)
    # and the avatar loader reads the port's files
    (tmp_path / "aomap").mkdir()
    from PIL import Image
    for t in (0, 3):
        Image.fromarray(np.full((8, 8), 200, np.uint8)).save(
            tmp_path / "aomap" / f"mesh_cloth_{t}.png")
    uv = tmp_path / "uv.obj"
    with open(uv, "w") as f:
        for v in verts:
            f.write(f"vt {0.5 + v[0] / 2:.5f} {0.5 + v[1] / 2:.5f}\n")
        for fc in faces:
            f.write("f " + " ".join(f"{i + 1}/{i + 1}" for i in fc) + "\n")
    avatar, params = load_mesh_avatar(str(tmp_path), str(uv), device="cpu")
    assert params.verts_offset.shape[0] == 2


_JAX_RUNNER = """
import runpy, sys
sys.argv = ["run_tracking.py"] + sys.argv[1:]
runpy.run_path("scripts/run_tracking.py", run_name="__main__")
"""


def test_run_tracking_cli_matches_the_jax_script(tmp_path):
    """The toy capture (3 cameras, 32 x 24, 2 frames, a 32-face cloth),
    3 iterations on frame 0 and 2 on frame 1: the same printed losses and
    params_{t}.npz files."""
    verts, faces = toy_capture(tmp_path)
    template = tmp_path / "template.obj"
    with open(template, "w") as f:
        for v in verts:
            f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        for fc in faces:
            f.write(f"f {fc[0] + 1} {fc[1] + 1} {fc[2] + 1}\n")
    flags = ["--dataset_dir", str(tmp_path), "--template_obj",
             str(template), "--train_frame_start_num", "0", "2",
             "--iters_first", "3", "--iters_rest", "2"]
    proc = subprocess.run(
        [sys.executable, "-c", _JAX_RUNNER, *flags, "--out_dir",
         str(tmp_path / "jax")], cwd=REPO, capture_output=True, text=True,
        timeout=600, env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    jloss = [float(m) for m in re.findall(r"loss ([-0-9.]+)", proc.stdout)]
    lines = []
    res = run_tracking.main(flags + ["--out_dir", str(tmp_path / "port"),
                                     "--device", "cpu"], log=lines.append)
    assert len(jloss) == 2 and len(res[0]) == 3 and len(res[1]) == 2
    np.testing.assert_allclose([res[0][-1], res[1][-1]], jloss, atol=1e-5)
    for t in (0, 1):
        a = np.load(tmp_path / "port" / f"params_{t}.npz")
        b = np.load(tmp_path / "jax" / f"params_{t}.npz")
        assert sorted(a.files) == sorted(b.files)
        for k in b.files:
            np.testing.assert_allclose(a[k], b[k], atol=FIT_TOL, err_msg=k)


@pytest.mark.parametrize("cli", ["run_tracking", "run_demo"])
def test_clis_need_a_card_unless_asked_for_the_cpu(cli, monkeypatch):
    """Without ``--device`` the tracking and demo CLIs resolve the CUDA
    device, and raise where there is none."""
    from mpmavatar_tpu_torch.train import run_demo
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = {"run_tracking": ["--template_obj", "t.obj", "--out_dir", "o"],
            "run_demo": ["--cloth_obj", "c.obj", "--body_obj", "b.obj"]}
    main = run_tracking.main if cli == "run_tracking" else run_demo.main
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(argv[cli])
