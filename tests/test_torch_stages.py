"""The JAX suite's stage-level checks, on the port (CPU).

Each ``slow`` test holds the port to a JAX test's own scene, built by
that test file's helpers, and to its unchanged bounds: what each stage
exists to produce, not agreement with JAX step by step.
- tracking recovers a target mesh (tests/test_convergence.py:69-124);
- stage 2 raises held-out PSNR by > 3 dB in 120 steps (:126-205);
- stage 3 recovers (D, E, H), finite differences drive toward the same
  optimum and agree with autodiff (tests/test_inverse_recovery.py:103-149;
  MaterialTrainerConfig without the TPU layout's column knobs, which the
  port does not have);
- the miniature pipeline, tracking assets to metrics
  (tests/test_end_to_end.py:15-68);
- the cloth drop settles on the floor (tests/test_solver.py:37-48);
- the animated collider drives the cloth
  (tests/test_demo_playback.py:70-101).
The first two run ``chip_fixtures.converge_tracking`` and
``chip_fixtures.heldout_psnr``, which ``chip_smoke.py`` phase 17 runs on the
card through K6/K7 with JAX-free copies of the scene builders; the
non-slow tests here hold those copies to the JAX suite's builders.

    python -m pytest -m slow tests/test_torch_stages.py
"""

import dataclasses

import numpy as np
import pytest
import torch

import chip_fixtures
from bench import build_body_sphere
from test_convergence import _lookat_cams
from test_inverse_recovery import N_FRAMES, TRUTH, _make_problem
from test_rasterizer import simple_camera
from test_substep_golden import build_pair, make_cloth
from test_torch_core import port_of
from test_train import make_fake_tracking_assets

from mpmavatar_tpu_torch.render.avatar_model import load_mesh_avatar
from mpmavatar_tpu_torch.sim.solver import MPMSolver
from mpmavatar_tpu_torch.train.appearance import render_avatar_frame
from mpmavatar_tpu_torch.train.evaluate import appearance_metrics
from mpmavatar_tpu_torch.train.material import (MaterialTrainer,
                                                MaterialTrainerConfig)
from mpmavatar_tpu_torch.utils.metrics import all_mesh_metrics

torch.set_num_threads(1)


def test_scene_copies_match_the_jax_builders(tmp_path):
    for kw in ({}, dict(nx=9, ny=9, y0=0.0, extent=0.7),
               dict(nx=6, ny=4, y0=1.2, extent=0.5)):
        v, f = chip_fixtures.stage_cloth(**kw)
        jv, jf = make_cloth(**kw)
        assert v.dtype == jv.dtype and f.dtype == jf.dtype
        np.testing.assert_array_equal(v, jv)
        np.testing.assert_array_equal(f, jf)
    eyes = [(1.2, 1.5, 0.3), (-0.9, 1.6, 0.9), (0.2, 1.8, -1.1)]
    for kw in ({}, dict(w=80, h=80, f=150.0)):
        for c, j in zip(chip_fixtures.lookat_cams(eyes, **kw),
                        _lookat_cams(eyes, **kw)):
            assert (c.image_width, c.image_height) == \
                (j.image_width, j.image_height)
            for name in ("world_view_transform", "full_proj_transform",
                         "camera_center", "tanfovx", "tanfovy"):
                np.testing.assert_array_equal(
                    np.asarray(getattr(c, name)),
                    np.asarray(getattr(j, name)), err_msg=name)


def test_fake_tracking_assets_copy_matches_jax(tmp_path):
    ours, ref = tmp_path / "ours", tmp_path / "ref"
    ref.mkdir()
    chip_fixtures.fake_tracking_assets(ours, n_frames=3)
    make_fake_tracking_assets(ref, n_frames=3)
    names = sorted(p.relative_to(ref) for p in ref.rglob("*") if p.is_file())
    assert names == sorted(p.relative_to(ours) for p in ours.rglob("*")
                           if p.is_file())
    for name in names:
        if name.suffix == ".npz":
            a, b = np.load(ours / name), np.load(ref / name)
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                np.testing.assert_array_equal(a[k], b[k], err_msg=str(name))
        else:
            assert (ours / name).read_bytes() == (ref / name).read_bytes(), \
                name


@pytest.mark.slow
def test_tracking_converges_to_target_mesh():
    losses, err0, err1, _ = chip_fixtures.converge_tracking(
        make_cloth, _lookat_cams, "cpu")
    assert np.isfinite(losses).all()
    assert losses[-1] < 0.5 * losses[0], (losses[0], losses[-1])
    assert err1 < 0.4 * err0, (err0, err1)


@pytest.mark.slow
def test_appearance_psnr_rises_on_heldout_view(tmp_path):
    make_fake_tracking_assets(tmp_path)
    psnr0, psnr1, loss, _ = chip_fixtures.heldout_psnr(
        tmp_path, _lookat_cams, "cpu")
    assert np.isfinite(loss)
    assert psnr1 > psnr0 + 3.0, (psnr0, psnr1)


def _port_config(jcfg):
    """The JAX test's MaterialTrainerConfig without the TPU layout's
    column knobs."""
    return MaterialTrainerConfig(**{
        f.name: getattr(jcfg, f.name)
        for f in dataclasses.fields(MaterialTrainerConfig)})


def _trainer(cfg, verts, faces, train_verts, body_seq, bf, n_joint_v):
    return MaterialTrainer(cfg, faces, first_frame_verts=verts,
                           train_verts=train_verts, smplx_verts=body_seq,
                           smplx_faces=bf, num_joint_v=n_joint_v,
                           num_joint_f=0, device="cpu")


@pytest.mark.slow
def test_inverse_recovery_autodiff_and_fd():
    jcfg, verts, faces, body_seq, bf, n_joint_v = _make_problem()
    cfg = _port_config(jcfg)
    problem = (cfg, verts, faces)
    scene = (body_seq, bf, n_joint_v)

    # the trajectory at TRUTH, from the port's own solver
    gen = _trainer(*problem, np.repeat(verts[None], N_FRAMES + 1, 0),
                   *scene)
    gen.params = {k: torch.tensor(np.float32(v)) for k, v in TRUTH.items()}
    zeros_jv = np.zeros((gen.static.num_joint_v, 3), np.float32)
    frames = gen.simulate(
        test_verts0=verts, test_verts_velo0=np.zeros_like(verts),
        test_smplx=body_seq, test_smplx_velo=np.zeros_like(body_seq),
        n_frames=N_FRAMES, joint_velo_fn=lambda i: zeros_jv)
    traj = np.stack([verts] + list(frames), 0)
    assert np.isfinite(traj).all()
    assert np.abs(traj[-1] - traj[0]).max() > 0.01

    # autodiff recovery from the reference's default init
    tr = _trainer(*problem, traj, *scene)
    losses = [tr.train_one_step()[0] for _ in range(cfg.iterations)]
    best = tr.best["params"]
    assert tr.best["loss"] < losses[0] * 0.05, (losses[0], tr.best["loss"])
    assert abs(best["D"] - TRUTH["D"]) < 0.35, best
    assert abs(best["E"] - TRUTH["E"]) < 0.35, best
    assert abs(best["H"] - TRUTH["H"]) < 0.03, best

    # finite differences drive toward the same optimum
    tr_fd = _trainer(*problem, traj, *scene)
    fd_losses = []
    for _ in range(10):
        loss, fd_params = tr_fd.train_one_step_finite_diff()
        fd_losses.append(loss)
    assert fd_losses[-1] < fd_losses[0] * 0.5
    inits = {"D": cfg.init_D, "E": cfg.init_E / 100.0, "H": 1.0}
    for k in ("D", "E", "H"):
        assert (TRUTH[k] - inits[k]) * (fd_params[k] - inits[k]) > 0, (
            k, fd_params)

    # the autodiff gradient matches the finite-difference probe
    tr2 = _trainer(*problem, traj, *scene)
    p0 = {k: v.detach().clone().requires_grad_(True)
          for k, v in tr2.params.items()}
    l0 = tr2.rollout_loss(p0)
    grads = dict(zip(p0, torch.autograd.grad(l0, list(p0.values()))))
    l0 = float(l0.detach())
    for k, dp in (("D", 0.05), ("E", 0.05), ("H", 0.005)):
        p = {kk: v.detach() for kk, v in p0.items()}
        p[k] = p[k] + dp
        with torch.no_grad():
            l1 = tr2.rollout_loss(p)
        fd = (float(l1) - l0) / dp
        ad = float(grads[k])
        denom = max(abs(fd), abs(ad), 1e-12)
        assert abs(fd - ad) / denom < 0.25, (k, fd, ad)


@pytest.mark.slow
def test_full_pipeline(tmp_path):
    # stage 1's artifact: tracking assets on disk
    verts, faces = make_fake_tracking_assets(tmp_path, n_frames=3)
    avatar, params = load_mesh_avatar(str(tmp_path), str(tmp_path / "uv.obj"),
                                      sh_degree=1, capacity_factor=1.0,
                                      device="cpu")

    # stage 3: one autodiff material step against the tracked trajectory
    train_verts = avatar.verts_orig
    body = np.array([[0.6, 0.9, 0.6], [1.4, 0.9, 0.6], [1.4, 0.9, 1.4],
                     [0.6, 0.9, 1.4]], np.float32)
    body_f = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    smplx_seq = np.stack([body] * len(train_verts))
    cfg = MaterialTrainerConfig(grid_size=32, substep=4, iterations=1)
    trainer = MaterialTrainer(cfg, faces, train_verts[0], train_verts,
                              smplx_seq, body_f, num_joint_v=2,
                              num_joint_f=1, device="cpu")
    loss, _ = trainer.train_one_step()
    assert np.isfinite(loss)

    # stage 4: simulate test poses with the optimized parameters
    sim_frames = trainer.simulate(
        train_verts[0], np.zeros_like(train_verts[0]), smplx_seq[:-1],
        (smplx_seq[1:] - smplx_seq[:-1]) * 25.0, n_frames=2)
    assert all(np.isfinite(f).all() for f in sim_frames)

    # geometry metrics against the "tracked" ground truth
    m = all_mesh_metrics(sim_frames[-1], faces, train_verts[-1], faces,
                         sample_count=2000)
    assert np.isfinite(m[0]) and np.isfinite(m[1])

    # the stage-4 render: the avatar posed on the simulated mesh, shadowed
    cam = simple_camera(w=64, h=64, f=40.0, cam_z=-2.0)
    sim_v = torch.as_tensor(sim_frames[-1]) - torch.tensor([1.0, 1.0, 1.0])
    with torch.no_grad():
        img, _ = render_avatar_frame(
            avatar, params, sim_v, avatar.tensor("ao_maps", "cpu")[0], cam,
            0, 0, torch.zeros(3), False, tile_capacity=128)
    assert torch.isfinite(img).all()

    # stage 5: appearance metrics of the render against itself
    gt = torch.clamp(img, 0, 1).numpy()
    m2 = appearance_metrics(gt, gt, np.ones((64, 64), np.float32),
                            device="cpu")
    assert m2["PSNR"] > 50
    assert m2["SSIM"] > 0.99


def _port_pair(verts, faces, **kw):
    """The port's (cfg, state, model) of test_substep_golden.build_pair."""
    _, cfg, state, model = build_pair(verts, faces, **kw)
    return port_of(cfg, state, model)


@pytest.mark.slow
def test_cloth_drop_settles_on_floor():
    verts, faces = make_cloth(nx=6, ny=6, y0=1.2, extent=0.5)
    cfg, state, model = _port_pair(verts, faces, E=200.0)
    solver = MPMSolver(cfg, device="cpu")
    solver.add_surface_collider([0.0, 0.4, 0.0], [0.0, 1.0, 0.0],
                                surface="sticky")
    for _ in range(10):   # 10 frames x 50 substeps = 0.25 s of fall
        state, _ = solver.frame(state, model, 5e-4, 50, 0.0)
    y = state.x[:, 1].numpy()
    # free fall: 0.5 g 0.25^2 = 0.30 from 1.2; the floor at 0.4 is not
    # reached, and nothing tunnels or blows up
    assert 0.8 < y.mean() < 1.0
    assert y.min() > 0.39
    assert torch.isfinite(state.x).all()


@pytest.mark.slow
def test_animated_collider_drives_cloth():
    verts, faces = make_cloth(nx=9, ny=9, y0=1.05, extent=0.4)
    cfg, state, model = _port_pair(verts, faces, E=300.0, n_grid=48)
    bv, bf = build_body_sphere(n_theta=10, n_phi=10, center=(1.0, 0.85, 1.0),
                               r=0.18)
    bv = torch.as_tensor(bv)

    def run(moving):
        solver = MPMSolver(cfg, device="cpu")
        solver.add_mesh_collider(bf, friction=0.5)
        st, t = state, 0.0
        vel = torch.tensor([0.5, 0.0, 0.0]) if moving else torch.zeros(3)
        mesh_x = bv
        for _ in range(3):
            mesh_v = vel.expand(bv.shape)
            st, t = solver.frame(st, model, 2e-4, 10, t, mesh_x=mesh_x,
                                 mesh_v=mesh_v)
            mesh_x = mesh_x + mesh_v * (10 * 2e-4)
        return st.x.numpy()

    x_static = run(False)
    x_moving = run(True)
    assert np.isfinite(x_moving).all()
    assert np.abs(x_moving - x_static).max() > 1e-5
