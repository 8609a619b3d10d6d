"""The port's data-parallel stage-2 step (parallel/appearance_dp.py)
against the JAX package's ``make_dp_appearance_step`` on a 2-device
mesh, on the CPU.

The scene is tests/test_parallel.py's ``_dp_appearance_setup`` at B = 4
(its fake tracking assets, SH degree 1, 64 x 64 cameras at four
distances, varied timesteps and camera indices, perturbed tracked
vertices, random GT).  The port runs 2 gloo ranks in spawned processes
(tests/torch_ranks.py), 2 samples each; JAX runs its jitted shard_map
step.  With SGD (as the JAX test uses: Adam's eps of 1e-15 turns
noise-level gradients into lr-sized steps) the updated parameters
measure the cross-rank gradient mean.  Tolerances are the JAX test's:
loss 1e-5, parameters 2e-5, xyz_gradient_accum 1e-5, denom 1e-6,
max_radii2d 1e-4.

JAX is imported inside the fixture only: the spawned ranks import
tests/torch_ranks.py and the port, never JAX.
"""

import dataclasses
import pathlib
import tempfile

import numpy as np
import pytest
import torch

from torch_ranks import dp_appearance_steps, run_ranks

B, N, RES = 4, 2, 64
RASTER = dict(width=RES, height=RES, tile_capacity=64)
SGD_LR = 1e-3
LOSS_TOL, PARAM_TOL = 1e-5, 2e-5
ACCUM_TOL, DENOM_TOL, RADII_TOL = 1e-5, 1e-6, 1e-4


def _setup():
    """The JAX avatar, params and batch of ``_dp_appearance_setup`` at B
    samples."""
    import jax.numpy as jnp
    from test_rasterizer import simple_camera
    from test_train import make_fake_tracking_assets

    from mpmavatar_tpu.parallel.appearance_dp import stack_camera_arrays
    from mpmavatar_tpu.render.avatar_model import load_mesh_avatar

    with tempfile.TemporaryDirectory() as d:
        tmp = pathlib.Path(d)
        make_fake_tracking_assets(tmp)
        avatar, params = load_mesh_avatar(str(tmp), str(tmp / "uv.obj"),
                                          sh_degree=1, capacity_factor=1.0)
        avatar.verts_orig = avatar.verts_orig - np.array([1.0, 1.0, 1.0])
    rng = np.random.default_rng(3)
    cams = [simple_camera(w=RES, h=RES, f=40.0, cam_z=-2.0 - 0.1 * i)
            for i in range(B)]
    t_b = np.asarray([i % avatar.num_timesteps for i in range(B)], np.int32)
    cidx = np.asarray([i % 4 for i in range(B)], np.int32)
    # off verts_orig[0], where iso_loss's sqrt has a degenerate gradient
    verts_b = np.stack([avatar.verts_orig[int(t)] + 0.002 * rng.standard_normal(
        avatar.verts_orig[0].shape).astype(np.float32) for t in t_b])
    verts_b = verts_b.astype(np.float32)
    ao_b = np.stack([avatar.ao_maps[int(t)] for t in t_b])
    rgb_b = rng.random((B, 3, RES, RES)).astype(np.float32)
    msk_b = np.ones((B, 1, RES, RES), np.float32)
    cam_b = stack_camera_arrays(cams)
    batch = (cam_b, jnp.asarray(cidx), jnp.asarray(t_b), jnp.asarray(verts_b),
             jnp.asarray(ao_b), jnp.asarray(rgb_b), jnp.asarray(msk_b))
    np_batch = ({f.name: np.asarray(getattr(cam_b, f.name))
                 for f in dataclasses.fields(cam_b)},
                cidx.astype(np.int64), t_b.astype(np.int64), verts_b, ao_b,
                rgb_b, msk_b)
    return avatar, params, batch, np_batch


def _arrays(avatar, params):
    """The avatar's and the params' arrays for the port."""
    av = {k: getattr(avatar, k) for k in avatar.__dataclass_fields__}
    p = dict(splats={f.name: np.asarray(getattr(params.splats, f.name))
                     for f in dataclasses.fields(params.splats)},
             verts_offset=np.asarray(params.verts_offset),
             cam_m=np.asarray(params.cam_m), cam_c=np.asarray(params.cam_c),
             shadow={k: np.asarray(v) for k, v in params.shadow.items()})
    return av, p


def _leaf(tree, name):
    node = tree
    for key in name.split("."):
        node = node[key] if isinstance(node, dict) else getattr(node, key)
    return np.asarray(node)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import jax
    import optax
    from jax.sharding import Mesh

    from mpmavatar_tpu.data.config import OptimizationParams
    from mpmavatar_tpu.parallel.appearance_dp import (make_dp_appearance_step,
                                                      shard_batch)
    from mpmavatar_tpu.render import gaussians as G

    avatar, params, batch, np_batch = _setup()
    tx = optax.sgd(SGD_LR)
    mesh = Mesh(np.array(jax.devices()[:N]), ("dp",))
    step = make_dp_appearance_step(avatar, OptimizationParams(), tx, mesh, 0,
                                   False, RES, RES, tile_capacity=64)
    p_j, _, ds_j, loss_j, metrics_j = step(
        params, tx.init(params), G.init_densify_state(params.splats.capacity),
        *shard_batch(mesh, batch))
    av, p = _arrays(avatar, params)
    tmp = tmp_path_factory.mktemp("dp")
    sgd = run_ranks(dp_appearance_steps, N, tmp, av, p, np_batch, SGD_LR, 1,
                    RASTER, timeout=120)
    adam = run_ranks(dp_appearance_steps, N, tmp, av, p, np_batch, None, 3,
                     RASTER, timeout=120)
    return dict(jax=(p_j, ds_j, float(loss_j), metrics_j), sgd=sgd, adam=adam)


def test_dp_step_matches_jax(runs):
    """One SGD step at N = 2: the loss, every float leaf after the update
    and the densification statistics against JAX's 2-device step."""
    p_j, ds_j, loss_j, metrics_j = runs["jax"]
    losses, leaves, ds, metrics = runs["sgd"][0]
    assert abs(losses[0] - loss_j) < LOSS_TOL, (losses[0], loss_j)
    for name, a in leaves.items():
        np.testing.assert_allclose(a, _leaf(p_j, name), atol=PARAM_TOL,
                                   err_msg=name)
    np.testing.assert_allclose(ds["xyz_gradient_accum"],
                               np.asarray(ds_j.xyz_gradient_accum),
                               atol=ACCUM_TOL)
    np.testing.assert_allclose(ds["denom"], np.asarray(ds_j.denom),
                               atol=DENOM_TOL)
    np.testing.assert_allclose(ds["max_radii2d"],
                               np.asarray(ds_j.max_radii2d), atol=RADII_TOL)
    # B samples' worth of statistics: every visible splat counted per
    # sample, and the overflow counts summed over the ranks
    assert float(ds["denom"].max()) == B
    assert int(metrics["work_overflow"]) == int(metrics_j["work_overflow"])
    for k in ("l1", "dssim"):
        assert abs(float(metrics[k]) - float(metrics_j[k])) < LOSS_TOL, k


def test_dp_step_ranks_hold_the_same_replica(runs):
    """Both ranks apply the same update: their parameters, statistics and
    losses are identical."""
    for a, b in zip(runs["sgd"][0][:3], runs["sgd"][1][:3]):
        if isinstance(a, dict):
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a == b


def test_stack_camera_arrays_matches_jax():
    """The port's stacked CameraArrays of host cameras equal JAX's."""
    from test_rasterizer import simple_camera
    from mpmavatar_tpu.parallel.appearance_dp import stack_camera_arrays
    from mpmavatar_tpu_torch.parallel import appearance_dp as tdp
    cams = [simple_camera(w=RES, h=RES, f=40.0, cam_z=-2.0 - 0.1 * i)
            for i in range(B)]
    ref = stack_camera_arrays(cams)
    got = tdp.stack_camera_arrays(cams, "cpu")
    for f in dataclasses.fields(got):
        np.testing.assert_array_equal(getattr(got, f.name).numpy(),
                                      np.asarray(getattr(ref, f.name)))
    blocks = [tdp.shard_batch((got, torch.arange(B)), r, N) for r in range(N)]
    assert torch.equal(torch.cat([b[0].full_proj for b in blocks]),
                       got.full_proj)
    assert [b[1].tolist() for b in blocks] == [[0, 1], [2, 3]]


def test_dp_adam_steps_lower_the_loss(runs):
    """Three steps of the stage-2 Adam (make_optimizer) lower the loss."""
    losses = runs["adam"][0][0]
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0], losses
