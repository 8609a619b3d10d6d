"""The render slice as a whole on the CPU: ``render_avatar_frame`` (pose
the mesh, shadow UNet on the AO map, SH shading, the worklist rasterizer
with K6's plain version, colour calibration) on a 20 x 18 body mesh at
96 x 64, the port against the JAX package from the same numpy data, and
the render benchmark at a cut size.

The two packages pose the mesh with float32 sums in another order, so a
splat's position and conic differ by ulps, and an alpha within ~1e-5 of
the 1/255 cutoff can fall on either side: the frame test counts the
pixels with any alpha within 1e-4 (relative) of the cutoff and holds the
others."""

import importlib.util
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_core import REPO, np_fields

from mpmavatar_tpu.render import gaussians as jg
from mpmavatar_tpu.render.avatar_model import AvatarParams as JAvatarParams
from mpmavatar_tpu.render.avatar_model import MeshAvatar as JMeshAvatar
from mpmavatar_tpu.render.rasterizer import camera_arrays as jcamera_arrays
from mpmavatar_tpu.render.shadow import init_shadow_unet as jinit_shadow
from mpmavatar_tpu.train import appearance as japp

from mpmavatar_tpu_torch import convert
from mpmavatar_tpu_torch.ops.composite import ALPHA_MIN
from mpmavatar_tpu_torch.render import bench_render
from mpmavatar_tpu_torch.render import gaussians as tg
from mpmavatar_tpu_torch.render.rasterizer import (camera_arrays,
                                                   project_gaussians)
from mpmavatar_tpu_torch.train import appearance as tapp

torch.set_num_threads(1)

W, H = 96, 64
MESH = (20, 18)
# image and alpha, absolute: the UNet's convolutions, SH shading and
# compositing in float32 in another order
TOL = 1e-5


def _jax_avatar(seed=0, n_frames=2, ao_size=32):
    """The JAX package's MeshAvatar / AvatarParams of the cut body mesh,
    with random learnables (offsets, calibration, splat parameters)."""
    rng = np.random.default_rng(seed)
    verts, faces = bench_render.build_body_mesh(*MESH)
    nf = len(faces)
    verts_orig = np.stack([verts + 0.001 * t for t in range(n_frames)])
    avatar = JMeshAvatar(
        faces=faces, verts_orig=verts_orig,
        ao_maps=(0.4 + 0.5 * rng.random((n_frames, 1, ao_size, ao_size))
                 ).astype(np.float32),
        uv_coord=(rng.random((nf, 2)) * 2.0 - 1.0).astype(np.float32),
        face_neighbors=np.zeros((nf, 3), np.int64),
        neighbor_weight=np.zeros((nf, 3), np.float32),
        neighbor_dist=np.zeros((nf, 3), np.float32),
        num_timesteps=n_frames, sh_degree=3)
    cap = nf + 64
    splats = np_fields(jg.init_from_mesh(nf, 3, rgb=rng.random((nf, 3)),
                                         capacity=cap))
    splats.update(
        xyz=rng.normal(0, 0.3, (cap, 3)).astype(np.float32),
        features_rest=rng.normal(0, 0.1, splats["features_rest"].shape
                                 ).astype(np.float32),
        scaling=rng.uniform(-3.0, -1.5, (cap, 3)).astype(np.float32),
        rotation=rng.normal(size=(cap, 4)).astype(np.float32),
        opacity=rng.normal(1.0, 1.0, (cap, 1)).astype(np.float32))
    shadow = {k: np.asarray(v) for k, v in jinit_shadow(
        jax.random.PRNGKey(seed), avatar.ao_maps.mean(0), uv_size=ao_size,
        shadow_size=ao_size, n_dims=4).items()}
    arrays = dict(
        splats=splats,
        verts_offset=rng.normal(0, 0.002, (n_frames,) + verts.shape
                                ).astype(np.float32),
        cam_m=rng.normal(0, 0.1, (4, 3)).astype(np.float32),
        cam_c=rng.normal(0, 0.05, (4, 3)).astype(np.float32),
        shadow=shadow)
    jparams = JAvatarParams(
        splats=jg.GaussianParams(**{k: jnp.asarray(v)
                                    for k, v in splats.items()}),
        verts_offset=jnp.asarray(arrays["verts_offset"]),
        cam_m=jnp.asarray(arrays["cam_m"]),
        cam_c=jnp.asarray(arrays["cam_c"]),
        shadow={k: jnp.asarray(v) for k, v in shadow.items()})
    return avatar, jparams, arrays


def _tied_pixels(avatar, params, verts, ca, rel=1e-4):
    """(H, W) bool: pixels where some splat's alpha is near the cutoff."""
    splats = params.splats
    frames = avatar.frames_for_verts(verts)
    m2d, _, conic, _, vis = project_gaussians(
        tg.get_xyz(splats, frames), tg.get_covariance(splats, frames), ca,
        W, H)
    op = tg.get_opacity(splats)[:, 0] * splats.alive * vis
    py, px = torch.meshgrid(torch.arange(H), torch.arange(W), indexing="ij")
    dx = px.reshape(-1, 1) - m2d[None, :, 0]
    dy = py.reshape(-1, 1) - m2d[None, :, 1]
    power = -0.5 * (conic[:, 0] * dx * dx + conic[:, 2] * dy * dy) \
        - conic[:, 1] * dx * dy
    alpha = op * torch.exp(torch.clamp_max(power, 0.0))
    near = (alpha - ALPHA_MIN).abs() < rel * ALPHA_MIN
    return near.any(dim=1).reshape(H, W).numpy()


@pytest.mark.parametrize("white_bkgd", [False, True])
def test_render_avatar_frame_matches_jax(white_bkgd):
    javatar, jparams, arrays = _jax_avatar()
    avatar = convert.mesh_avatar_from_numpy(
        {k: getattr(javatar, k) for k in javatar.__dataclass_fields__})
    params = convert.avatar_params_from_numpy(**arrays, device="cpu")
    cam = bench_render.look_down_z(W, H, 1400.0 * W / 1500, 2.6, 0.1, 20.0)
    kw = dict(tile_capacity=512, work_cap=64, chunk=32)
    bg = np.ones(3, np.float32) if white_bkgd else np.zeros(3, np.float32)

    ref_img, ref = japp.render_avatar_frame(
        javatar, jparams, javatar.select_verts(jparams, 1),
        jnp.asarray(javatar.ao_maps[1]), (jcamera_arrays(cam), W, H), 2, 3,
        jnp.asarray(bg), white_bkgd, **kw)
    verts = avatar.select_verts(params, 1)
    ca = camera_arrays(cam, "cpu")
    img, out = tapp.render_avatar_frame(
        avatar, params, verts, avatar.tensor("ao_maps", "cpu")[1],
        (ca, W, H), 2, 3, torch.as_tensor(bg), white_bkgd, **kw)
    tied = _tied_pixels(avatar, params, verts, ca)
    assert tied.sum() <= 12          # of 6,144

    assert int(ref["work_overflow"]) == 0 and int(ref["big_overflow"]) == 0
    assert int(out["n_items"]) > 0
    # the port bins only the alive splats (the dead ones, at opacity 0,
    # would take their tiles' capacity): JAX's counts of the alive ones
    alive = np.asarray(jparams.splats.alive)
    jalive = JAvatarParams(
        splats=jg.GaussianParams(**{
            f: getattr(jparams.splats, f)[alive]
            for f in jparams.splats.__dataclass_fields__}),
        verts_offset=jparams.verts_offset, cam_m=jparams.cam_m,
        cam_c=jparams.cam_c, shadow=jparams.shadow)
    _, ref_alive = japp.render_avatar_frame(
        javatar, jalive, javatar.select_verts(jalive, 1),
        jnp.asarray(javatar.ao_maps[1]), (jcamera_arrays(cam), W, H), 2, 3,
        jnp.asarray(bg), white_bkgd, **kw)
    assert int(np.asarray(ref["tile_counts"]).sum()) > int(
        np.asarray(ref_alive["tile_counts"]).sum())
    np.testing.assert_array_equal(out["tile_counts"].numpy(),
                                  np.asarray(ref_alive["tile_counts"]))
    keep = ~tied
    np.testing.assert_allclose(img.numpy()[:, keep],
                               np.asarray(ref_img)[:, keep], atol=TOL)
    np.testing.assert_allclose(out["alpha"].numpy()[:, keep],
                               np.asarray(ref["alpha"])[:, keep], atol=TOL)
    # a body in the frame, not an empty image
    assert 0.05 < float(out["alpha"].mean()) < 0.9


def test_load_mesh_avatar_matches_jax(tmp_path):
    """The tracking stage's assets (params_*.npz, AO maps, UV template)
    loaded by both packages: the same static assets, splats and
    calibration; the shadow UNet's weights come from each package's own
    generator, so only its shapes and its deterministic entries agree."""
    from test_train import make_fake_tracking_assets
    from mpmavatar_tpu.render.avatar_model import load_mesh_avatar as jload
    from mpmavatar_tpu_torch.render.avatar_model import load_mesh_avatar

    make_fake_tracking_assets(tmp_path)
    uv = str(tmp_path / "uv.obj")
    javatar, jparams = jload(str(tmp_path), uv, sh_degree=1,
                             capacity_factor=2.0)
    avatar, params = load_mesh_avatar(str(tmp_path), uv, sh_degree=1,
                                      capacity_factor=2.0, device="cpu")
    for name in javatar.__dataclass_fields__:
        np.testing.assert_array_equal(getattr(avatar, name),
                                      getattr(javatar, name), err_msg=name)
    for name, ref in np_fields(jparams.splats).items():
        np.testing.assert_allclose(getattr(params.splats, name).numpy(), ref,
                                   atol=1e-7, err_msg=name)
    for name in ("verts_offset", "cam_m", "cam_c"):
        np.testing.assert_array_equal(getattr(params, name).numpy(),
                                      np.asarray(getattr(jparams, name)))
    assert params.shadow.keys() == jparams.shadow.keys()
    for name, ref in jparams.shadow.items():
        assert tuple(params.shadow[name].shape) == ref.shape, name
        if not name.endswith("_v") and not name.endswith("_g"):
            np.testing.assert_allclose(params.shadow[name].numpy(),
                                       np.asarray(ref), atol=1e-6,
                                       err_msg=name)


def test_body_mesh_matches_the_jax_bench():
    spec = importlib.util.spec_from_file_location(
        "bench_appearance", REPO / "bench_appearance.py")
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    for a, b in zip(bench_render.build_body_mesh(*MESH),
                    bench.build_body_mesh(*MESH)):
        np.testing.assert_array_equal(a, b)
    verts, faces = bench_render.build_body_mesh()
    assert len(faces) == 50_244


def test_bench_render_runs_on_cpu(capsys):
    bench_render.main(["--scene", "avatar", "--device", "cpu", "--width",
                       str(W), "--height", str(H), "--mesh", "20x18",
                       "--frames", "1"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["scene"] == "avatar" and line["alive"] == 684
    assert line["tiles"] == 24 and line["n_items"] > 0
