"""Stage-4 evaluation of the port against the JAX package: the AO bake
(render/ao.py), the metrics (utils/metrics.py), train/evaluate.py's
helpers and its render loop, ``evaluate_appearance`` and the avatar
checkpoints, on tests/test_preprocess_ao.py's AO scenes and the toy
capture of tests/test_torch_data.py (the 5 x 5 tracked cloth of
tests/test_train.py under three 32 x 24 cameras).

Tolerances: the AO map per texel within 1e-5 of JAX's (the same float32
formulas; a voxel boundary an ulp away would show as far more); the
geometry metrics and the mask helpers exactly (the same numpy code);
PSNR, SSIM and ``evaluate_appearance``'s L1 and PSNR within 1e-5
relative; LPIPS within 2e-4 relative (as tests/test_torch_lpips.py); the
written PNGs within 1 of 255 of JAX's (a float an ulp either side of a
rounding step); checkpoint arrays exactly (float32 through the PLY and
npz files)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from test_lpips import _make_random_weights
from test_preprocess_ao import (_make_folded_garment_patch, _make_plane,
                                _make_sphere)
from test_substep_golden import make_cloth
from test_torch_data import toy_capture

from mpmavatar_tpu.data import ModelParams as JModelParams
from mpmavatar_tpu.data import Scene as JScene
from mpmavatar_tpu.render import ao as jao
from mpmavatar_tpu.render import avatar_model as javatar_model
from mpmavatar_tpu.train import appearance as japp
from mpmavatar_tpu.train import evaluate as jeval
from mpmavatar_tpu.utils import lpips_jax
from mpmavatar_tpu.utils import metrics as jmetrics

from mpmavatar_tpu_torch import convert
from mpmavatar_tpu_torch.data import ModelParams, Scene
from mpmavatar_tpu_torch.render import ao as tao
from mpmavatar_tpu_torch.render import avatar_model as tavatar_model
from mpmavatar_tpu_torch.train import appearance as tapp
from mpmavatar_tpu_torch.train import evaluate as teval
from mpmavatar_tpu_torch.utils import metrics as tmetrics

torch.set_num_threads(1)

AO_TOL = 1e-5
REL_TOL = 1e-5
LPIPS_RTOL = 2e-4


# ----------------------------------------------------------------------
# the AO bake
# ----------------------------------------------------------------------
def _layers():
    """Two parallel cloth layers 8 cm apart, each on half of a 64^2 chart
    (tests/test_preprocess_ao.py::test_ao_bake_occlusion_signal)."""
    verts, faces = make_cloth(nx=8, ny=8, y0=1.0, extent=0.6)
    all_v = np.concatenate([verts, verts + np.array([0.0, 0.08, 0.0])])
    all_f = np.concatenate([faces, faces + len(verts)])
    uvs = (verts[:, [0, 2]] - verts[:, [0, 2]].min(0)) / \
        np.ptp(verts[:, [0, 2]], 0)
    uv = np.concatenate([uvs * [0.48, 1.0], uvs * [0.48, 1.0] + [0.5, 0.0]])
    return (all_v.astype(np.float32), all_f, uv, all_f,
            dict(resolution=64, grid_res=20, n_rays=32, n_steps=8,
                 max_dist=0.3))


def _sphere_plane(res=64):
    pv, pf = _make_plane()
    sv, sf = _make_sphere(0.15, (0.0, 0.25, 0.0))
    return (np.concatenate([pv, sv]), np.concatenate([pf, sf + len(pv)]),
            (pv[:, [0, 2]] + 0.6) / 1.2, pf, dict(resolution=res))


def _garment():
    verts, faces, n_base = _make_folded_garment_patch()
    base = faces[:n_base]
    uv = (verts[:np.max(base) + 1][:, [0, 2]] / 0.6).astype(np.float32)
    return verts, faces, uv, base, dict(resolution=64)


AO_SCENES = {"layers": _layers, "sphere_plane": _sphere_plane,
             "garment": _garment}


@pytest.mark.parametrize("name", sorted(AO_SCENES))
def test_bake_ao_matches_jax(name):
    verts, faces, uv, uv_faces, kw = AO_SCENES[name]()
    chart = tao.rasterize_uv_chart(uv, uv_faces, resolution=kw["resolution"])
    jchart = jao.rasterize_uv_chart(uv, uv_faces,
                                    resolution=kw["resolution"])
    for k in ("face_idx", "bary", "texel_ij"):
        np.testing.assert_array_equal(getattr(chart, k), getattr(jchart, k))
    # a texel centre on an edge two faces share is listed twice; both
    # packages keep the last entry (JAX's scatter on the CPU runs in order)
    flat = chart.texel_ij[:, 0] * kw["resolution"] + chart.texel_ij[:, 1]
    assert len(np.unique(flat)) < len(flat)
    out = tao.bake_ao(torch.as_tensor(verts), torch.as_tensor(faces),
                      chart.face_idx, chart.bary, chart.texel_ij,
                      texel_chunk=1000, **kw)[0].numpy()
    ref = np.asarray(jao.bake_ao(
        jnp.asarray(verts), jnp.asarray(faces), jnp.asarray(chart.face_idx),
        jnp.asarray(chart.bary), jnp.asarray(chart.texel_ij), **kw))[0]
    assert out.shape == ref.shape == (kw["resolution"],) * 2
    assert np.abs(out - ref).max() <= AO_TOL
    covered = np.zeros(out.shape, bool)
    covered[chart.texel_ij[:, 0], chart.texel_ij[:, 1]] = True
    assert (out[~covered] == 1.0).all() and out[covered].min() < 0.99
    if name == "layers":
        lower = chart.texel_ij[:, 1] < 32
        vals = out[chart.texel_ij[:, 0], chart.texel_ij[:, 1]]
        assert vals[lower].mean() < vals[~lower].mean() - 0.05


def test_bake_ao_analytic_bound():
    """The sphere of radius r at height h over a plane: exact AO
    1 - (r/d)^2 (h/d) at a plane point d from the centre; the JAX
    package's bounds (mean |err| < 0.03, max < 0.22, lit far away) with
    the production rays, steps and occupancy grid, on a 64^2 map (the
    JAX test's 256^2 takes tens of seconds on the CPU here)."""
    verts, faces, uv, uv_faces, kw = _sphere_plane(res=64)
    chart = tao.rasterize_uv_chart(uv, uv_faces, resolution=64)
    img = tao.bake_ao(torch.as_tensor(verts), torch.as_tensor(faces),
                      chart.face_idx, chart.bary, chart.texel_ij,
                      **kw)[0].numpy()
    pv = verts[:np.max(uv_faces) + 1]
    pts = np.einsum("tc,tcd->td", chart.bary, pv[uv_faces[chart.face_idx]])
    rho = np.linalg.norm(pts[:, [0, 2]], axis=1)
    d = np.sqrt(rho ** 2 + 0.25 ** 2)
    exact = 1.0 - (0.15 / d) ** 2 * (0.25 / d)
    tex = chart.texel_ij
    err = img[tex[:, 0], tex[:, 1]] - exact
    assert np.abs(err).mean() < 0.03, np.abs(err).mean()
    assert np.abs(err).max() < 0.22, np.abs(err).max()
    assert img[tex[rho > 0.45, 0], tex[rho > 0.45, 1]].mean() > 0.97


def test_load_uv_chart_matches_jax(tmp_path):
    toy_capture(tmp_path)
    a = tao.load_uv_chart(str(tmp_path / "uv.obj"), resolution=64)
    b = jao.load_uv_chart(str(tmp_path / "uv.obj"), resolution=64)
    for k in ("face_idx", "bary", "texel_ij"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
    assert a.resolution == b.resolution == 64


# ----------------------------------------------------------------------
# metrics and the evaluation helpers
# ----------------------------------------------------------------------
def _meshes():
    v1, f1 = _make_sphere(0.3, (0.0, 0.0, 0.0), nt=12, nph=12)
    v2 = v1 * 1.01 + np.float32(0.004)
    return v1, f1, v2, f1


def test_mesh_metrics_match_jax():
    v1, f1, v2, f2 = _meshes()
    pa, na = tmetrics.sample_mesh_surface(v1, f1, 5000, seed=3)
    pb, nb = jmetrics.sample_mesh_surface(v1, f1, 5000, seed=3)
    np.testing.assert_array_equal(pa, pb)
    np.testing.assert_array_equal(na, nb)
    p2, _ = jmetrics.sample_mesh_surface(v2, f2, 5000, seed=4)
    assert tmetrics.chamfer_distance(pa, p2) == \
        jmetrics.chamfer_distance(pa, p2) > 0
    for tau in (1e-3, 1e-5):
        assert tmetrics.f_score(pa, p2, tau) == jmetrics.f_score(pa, p2, tau)
    assert tmetrics.all_mesh_metrics(v1, f1, v2, f2, 4000) == \
        jmetrics.all_mesh_metrics(v1, f1, v2, f2, 4000)
    assert teval.geometry_metrics(v1, f1, v2, f2, 4000) == \
        jeval.geometry_metrics(v1, f1, v2, f2, 4000)


def test_mask_helpers_and_merge_match_jax():
    rng = np.random.default_rng(0)
    mask = (rng.random((24, 32)) > 0.3).astype(np.float32)
    mask[4:20, 6:26] = 1.0
    for fn in ("erode", "gaussian_blur5", "eval_mask"):
        np.testing.assert_array_equal(getattr(teval, fn)(mask),
                                      getattr(jeval, fn)(mask))
    lo, up = rng.random((10, 3)), rng.random((10, 3))
    idx = np.array([1, 4, 7])
    np.testing.assert_array_equal(teval.merge_layered_meshes(lo, up, idx),
                                  jeval.merge_layered_meshes(lo, up, idx))


@pytest.mark.parametrize("suppress_white", [False, True])
def test_appearance_metrics_match_jax(suppress_white):
    rng = np.random.default_rng(1)
    gt = rng.random((3, 24, 32)).astype(np.float32)
    gt[:, :4] = 0.95
    pred = np.clip(gt + rng.normal(0, 0.05, gt.shape), 0, 1).astype(
        np.float32)
    mask = np.zeros((24, 32), np.float32)
    mask[2:22, 3:29] = 1.0
    weights = _make_random_weights(seed=5)
    jfn = jax.jit(lambda a, b: lpips_jax.lpips(
        {k: jnp.asarray(v) for k, v in weights.items()}, a, b))
    ours = teval.appearance_metrics(
        pred, gt, mask, convert.lpips_params_from_numpy(weights, "cpu"),
        suppress_white, device="cpu")
    ref = jeval.appearance_metrics(pred, gt, mask, jfn, suppress_white)
    assert ours.keys() == ref.keys() == {"PSNR", "SSIM", "LPIPS"}
    for k in ("PSNR", "SSIM"):
        assert abs(ours[k] - ref[k]) <= REL_TOL * abs(ref[k]), k
    assert abs(ours["LPIPS"] - ref["LPIPS"]) <= LPIPS_RTOL * ref["LPIPS"]


def test_evaluate_sequence_matches_jax(tmp_path):
    from mpmavatar_tpu_torch.utils.io import write_obj
    v1, f1, v2, _ = _meshes()
    os.makedirs(tmp_path / "pred")
    for i in range(2):
        write_obj(str(tmp_path / "pred" / f"{i:03d}.obj"), v2 + 0.01 * i, f1)
    rng = np.random.default_rng(2)
    pairs = [(rng.random((3, 16, 16)).astype(np.float32),
              rng.random((3, 16, 16)).astype(np.float32),
              np.ones((16, 16), np.float32)) for _ in range(2)]
    os.makedirs(tmp_path / "t")
    os.makedirs(tmp_path / "j")
    ours = teval.evaluate_sequence(str(tmp_path / "pred"), f1,
                                   lambda fr: (v1, f1), [10, 11], pairs,
                                   out_path=str(tmp_path / "t"),
                                   device="cpu")
    ref = jeval.evaluate_sequence(str(tmp_path / "pred"), f1,
                                  lambda fr: (v1, f1), [10, 11], pairs,
                                  out_path=str(tmp_path / "j"))
    assert ours.keys() == ref.keys() == {"CD", "F-Score", "PSNR", "SSIM"}
    for k in ref:
        assert abs(ours[k] - ref[k]) <= REL_TOL * abs(ref[k]), k
    a = np.load(tmp_path / "t" / "metric.npz")
    b = np.load(tmp_path / "j" / "metric.npz")
    assert sorted(a.files) == sorted(b.files)
    np.testing.assert_array_equal(a["CD"], b["CD"])


# ----------------------------------------------------------------------
# checkpoints, evaluate_appearance and the stage-4 render loop
# ----------------------------------------------------------------------
def _trained_jax_params(jparams, seed=0):
    """JAX's loaded avatar moved away from its start, as training would:
    splat offsets, colours, scales, opacities, vertex offsets, colour
    calibration and one splat made dead."""
    import dataclasses
    rng = np.random.default_rng(seed)
    s = jparams.splats

    def moved(a, scale):
        a = np.asarray(a)
        return jnp.asarray(a + scale * rng.standard_normal(a.shape).astype(
            np.float32))

    alive = np.asarray(s.alive).copy()
    alive[3] = False
    splats = dataclasses.replace(
        s, xyz=moved(s.xyz, 0.01), features_dc=moved(s.features_dc, 0.2),
        features_rest=moved(s.features_rest, 0.05),
        scaling=moved(s.scaling, 0.1), opacity=moved(s.opacity, 0.5),
        rotation=moved(s.rotation, 0.1), alive=jnp.asarray(alive))
    return dataclasses.replace(
        jparams, splats=splats,
        verts_offset=moved(jparams.verts_offset, 0.005),
        cam_m=moved(jparams.cam_m, 0.05), cam_c=moved(jparams.cam_c, 0.02))


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    """The toy capture, JAX's avatar (moved as training would) saved as a
    checkpoint, and the port's avatar with that checkpoint loaded."""
    root = tmp_path_factory.mktemp("toy")
    toy_capture(root)
    javatar, jparams0 = javatar_model.load_mesh_avatar(
        str(root), str(root / "uv.obj"), sh_degree=1, capacity_factor=2.0)
    jckpt = str(root / "jax_ckpt")
    javatar_model.save_avatar_checkpoint(
        jckpt, _trained_jax_params(jparams0), javatar)
    avatar, params = tavatar_model.load_mesh_avatar(
        str(root), str(root / "uv.obj"), sh_degree=1, capacity_factor=2.0,
        device="cpu")
    params = tavatar_model.load_avatar_checkpoint(jckpt, params)
    jparams = javatar_model.load_avatar_checkpoint(jckpt, jparams0)
    return dict(root=root, javatar=javatar, jparams=jparams, avatar=avatar,
                params=params)


def _params_arrays(p):
    out = {f"splats.{k}": np.asarray(getattr(p.splats, k).detach().cpu()
                                     if isinstance(getattr(p.splats, k),
                                                   torch.Tensor)
                                     else getattr(p.splats, k))
           for k in ("xyz", "features_dc", "features_rest", "scaling",
                     "rotation", "opacity", "binding", "alive")}
    for k in ("verts_offset", "cam_m", "cam_c"):
        v = getattr(p, k)
        out[k] = np.asarray(v.detach().cpu() if isinstance(v, torch.Tensor)
                            else v)
    for k, v in p.shadow.items():
        out[f"shadow.{k}"] = np.asarray(
            v.detach().cpu() if isinstance(v, torch.Tensor) else v)
    return out


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_checkpoints_load_in_the_other_package(toy, tmp_path, writer):
    """A checkpoint of the port loads in JAX and one of JAX in the port:
    the same files, and the alive splats packed into the first slots
    with every array equal."""
    path = str(tmp_path / "ckpt")
    if writer == "port":
        tavatar_model.save_avatar_checkpoint(path, toy["params"],
                                             toy["avatar"])
        got = javatar_model.load_avatar_checkpoint(path, toy["jparams"])
    else:
        javatar_model.save_avatar_checkpoint(path, toy["jparams"],
                                             toy["javatar"])
        got = tavatar_model.load_avatar_checkpoint(path, toy["params"])
    assert sorted(os.listdir(path)) == ["cams.npz", "point_cloud.ply",
                                        "shadow_net.npz", "verts_offset.npy"]
    a, b = _params_arrays(got), _params_arrays(toy["jparams"])
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k].astype(b[k].dtype), b[k],
                                      err_msg=k)
    n = int(a["splats.alive"].sum())
    assert n == len(toy["avatar"].faces) - 1
    assert a["splats.alive"][:n].all() and not a["splats.alive"][n:].any()


def _scenes(root):
    kw = dict(dataset_dir=str(root), train_frame_start_num=[0, 2],
              test_frame_start_num=[0, 2], test_camera_index=[0, 2])
    return Scene(ModelParams(**kw)), JScene(JModelParams(**kw))


def test_evaluate_appearance_matches_jax(toy):
    """The held-out evaluation through the tile path, with and without an
    LPIPS network of seeded weights."""
    scene, jscene = _scenes(toy["root"])
    weights = _make_random_weights(seed=6)
    net = convert.lpips_params_from_numpy(weights, "cpu")
    jfn = jax.jit(lambda a, b: lpips_jax.lpips(
        {k: jnp.asarray(v) for k, v in weights.items()}, a, b))
    ours = tapp.evaluate_appearance(toy["avatar"], toy["params"],
                                    scene.test_dataset,
                                    scene.test_camera_index, 1, False,
                                    lpips_fn=net, tile_capacity=64)
    ref = japp.evaluate_appearance(toy["javatar"], toy["jparams"],
                                   jscene.test_dataset,
                                   jscene.test_camera_index, 1, False,
                                   lpips_fn=jfn, tile_capacity=64)
    assert ours.keys() == ref.keys() == {"l1", "psnr", "lpips"}
    for k in ("l1", "psnr"):
        assert abs(ours[k] - ref[k]) <= REL_TOL * abs(ref[k]), k
    assert abs(ours["lpips"] - ref["lpips"]) <= LPIPS_RTOL * ref["lpips"]
    # the avatar is in view: with every opacity at zero the views differ
    import dataclasses
    p = toy["params"]
    hidden = dataclasses.replace(p, splats=dataclasses.replace(
        p.splats, opacity=torch.full_like(p.splats.opacity, -30.0)))
    empty = tapp.evaluate_appearance(toy["avatar"], hidden,
                                     scene.test_dataset,
                                     scene.test_camera_index, 1, False,
                                     tile_capacity=64, max_items=1)
    assert empty.keys() == {"l1", "psnr"}
    assert abs(empty["l1"] - ours["l1"]) > 1e-3


def _png(path):
    with Image.open(path) as im:
        return np.asarray(im).astype(np.int16)


def test_render_eval_sequence_matches_jax(toy, tmp_path):
    """The tree that scripts/eval.py reads (as tests/test_eval_render.py
    checks it), the AO and pred PNGs within 1/255 of JAX's and the GT
    PNGs equal."""
    from mpmavatar_tpu_torch.utils.io import write_obj
    root = toy["root"]
    verts = np.load(root / "params_0.npz")["vertices"]
    faces = toy["avatar"].faces
    mesh_dir = tmp_path / "uvmesh"
    os.makedirs(mesh_dir)
    for i in range(2):
        write_obj(str(mesh_dir / f"{i:03d}.obj"), verts + 0.01 * i, faces)
    scene, jscene = _scenes(root)
    kw = dict(active_sh_degree=1, skip_video=True, ao_resolution=64,
              tile_capacity=64)
    teval.render_eval_sequence(toy["avatar"], toy["params"], scene,
                               str(mesh_dir), str(tmp_path / "t"),
                               str(root / "uv.obj"), **kw)
    jeval.render_eval_sequence(toy["javatar"], toy["jparams"], jscene,
                               str(mesh_dir), str(tmp_path / "j"),
                               str(root / "uv.obj"), **kw)
    t, j = tmp_path / "t", tmp_path / "j"
    assert sorted(os.listdir(t)) == sorted(os.listdir(j)) == \
        ["Cam000", "Cam002", "aomap"]
    assert sorted(os.listdir(t / "aomap")) == ["0000.png", "0001.png"]
    lit = 0
    for cam in ("Cam000", "Cam002"):
        for kind in ("pred", "gt"):
            names = sorted(os.listdir(t / cam / kind))
            assert names == ["0000.png", "0001.png"], (cam, kind, names)
            for name in names:
                a, b = _png(t / cam / kind / name), _png(j / cam / kind / name)
                assert a.shape == (24, 32, 3)
                if kind == "gt":
                    np.testing.assert_array_equal(a, b)
                else:
                    assert np.abs(a - b).max() <= 1, (cam, name)
                    lit += int((a > 0).any(-1).sum())
    assert lit > 100
    for name in ("0000.png", "0001.png"):
        assert np.abs(_png(t / "aomap" / name)
                      - _png(j / "aomap" / name)).max() <= 1
