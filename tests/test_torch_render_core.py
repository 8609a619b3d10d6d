"""The port's render core against the JAX package on the CPU: spherical
harmonics, quaternion and face-frame geometry, the splat parameters and
their world-space views, the cameras, SH shading and ``render()`` with
extra gaussians; and that importing the render path loads no JAX."""

import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_rasterizer import simple_camera
from test_torch_core import REPO, np_fields, t

from mpmavatar_tpu import render as jrender
from mpmavatar_tpu.render import cameras as jcam
from mpmavatar_tpu.render import gaussians as jg
from mpmavatar_tpu.render import geometry as jgeo
from mpmavatar_tpu.render import sh as jsh

from mpmavatar_tpu_torch import convert
from mpmavatar_tpu_torch import render as trender
from mpmavatar_tpu_torch.render import cameras as tcam
from mpmavatar_tpu_torch.render import gaussians as tg
from mpmavatar_tpu_torch.render import geometry as tgeo
from mpmavatar_tpu_torch.render import sh as tsh

torch.set_num_threads(1)

TOL = 2e-6      # float32, O(1) values, a few operations in another order


def _close(a, b, atol=TOL, name=""):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol,
                               err_msg=name)


def _mesh(seed=0):
    """A bumpy 6x5 grid of triangles in front of the test camera."""
    rng = np.random.default_rng(seed)
    gx, gy = np.meshgrid(np.linspace(-0.6, 0.6, 6), np.linspace(-0.5, 0.5, 5))
    verts = np.stack([gx, gy, 0.1 * rng.normal(size=gx.shape)], -1).reshape(
        -1, 3).astype(np.float32)
    idx = np.arange(30).reshape(5, 6)
    a, b = idx[:-1, :-1].ravel(), idx[:-1, 1:].ravel()
    c, d = idx[1:, :-1].ravel(), idx[1:, 1:].ravel()
    faces = np.concatenate([np.stack([a, b, c], -1),
                            np.stack([b, d, c], -1)]).astype(np.int32)
    return verts, faces


def _splats(n_faces, sh_degree, seed=1, capacity=None):
    """JAX GaussianParams with random learnables, and the port's copy."""
    rng = np.random.default_rng(seed)
    g = jg.init_from_mesh(n_faces, sh_degree,
                          rgb=rng.random((n_faces, 3)), capacity=capacity)
    cap = g.capacity
    arrays = np_fields(g)
    arrays.update(
        xyz=rng.normal(0, 0.3, (cap, 3)).astype(np.float32),
        features_rest=rng.normal(0, 0.2, arrays["features_rest"].shape
                                 ).astype(np.float32),
        scaling=rng.uniform(-4, -2, (cap, 3)).astype(np.float32),
        rotation=rng.normal(size=(cap, 4)).astype(np.float32),
        opacity=rng.normal(size=(cap, 1)).astype(np.float32))
    return jg.GaussianParams(**{k: jnp.asarray(v) for k, v in
                                arrays.items()}), \
        convert.gaussians_from_numpy(arrays, "cpu")


@pytest.mark.parametrize("deg", [0, 1, 2, 3, 4])
def test_eval_sh_matches_jax(deg):
    rng = np.random.default_rng(deg)
    sh = rng.normal(size=(200, 3, (deg + 1) ** 2)).astype(np.float32)
    dirs = rng.normal(size=(200, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    _close(tsh.eval_sh(deg, t(sh), t(dirs)[:, None, :]),
           jsh.eval_sh(deg, jnp.asarray(sh), jnp.asarray(dirs)[:, None, :]),
           atol=1e-5)
    rgb = rng.random((5, 3)).astype(np.float32)
    _close(tsh.sh2rgb(tsh.rgb2sh(t(rgb))), rgb)
    _close(tsh.rgb2sh(t(rgb)), jsh.rgb2sh(jnp.asarray(rgb)))


def test_quaternions_match_jax():
    rng = np.random.default_rng(3)
    q = rng.normal(size=(300, 4)).astype(np.float32)
    q2 = rng.normal(size=(300, 4)).astype(np.float32)
    m = np.asarray(jgeo.quat_to_rotmat(jnp.asarray(q)))
    _close(tgeo.quat_to_rotmat(t(q)), m)
    # every branch of Shepperd's method: random rotations and the four
    # axis-dominant cases
    rots = np.concatenate([m, np.diag([1.0, -1, -1])[None],
                           np.diag([-1.0, 1, -1])[None],
                           np.diag([-1.0, -1, 1])[None]]).astype(np.float32)
    _close(tgeo.rotmat_to_quat(t(rots)),
           jgeo.rotmat_to_quat(jnp.asarray(rots)), atol=1e-5)
    _close(tgeo.quat_multiply(t(q), t(q2)),
           jgeo.quat_multiply(jnp.asarray(q), jnp.asarray(q2)), atol=1e-5)
    s = rng.uniform(0.01, 0.1, (300, 3)).astype(np.float32)
    _close(tgeo.covariance_from_scaling_rotation(t(s), 1.5, t(q)),
           jgeo.covariance_from_scaling_rotation(jnp.asarray(s), 1.5,
                                                 jnp.asarray(q)))


def test_face_orientation_frames_and_adjacency_match_jax():
    verts, faces = _mesh()
    orien, scale = tgeo.compute_face_orientation(t(verts), t(faces).long())
    r_orien, r_scale = jgeo.compute_face_orientation(jnp.asarray(verts),
                                                     jnp.asarray(faces))
    _close(orien, r_orien)
    _close(scale, r_scale)
    fr = tg.face_frames_from_verts(t(verts), t(faces).long())
    ref = jg.face_frames_from_verts(jnp.asarray(verts), jnp.asarray(faces))
    for name in ("center", "orien_mat", "orien_quat", "scaling"):
        _close(getattr(fr, name), getattr(ref, name), atol=1e-5, name=name)
    np.testing.assert_array_equal(tgeo.find_adjacent_faces(faces),
                                  jgeo.find_adjacent_faces(faces))


def test_init_from_mesh_matches_jax():
    rgb = np.random.default_rng(0).random((7, 3)).astype(np.float32)
    ref = np_fields(jg.init_from_mesh(7, 2, rgb=rgb, capacity=12))
    out = tg.init_from_mesh(7, 2, rgb=rgb, capacity=12, device="cpu")
    for name, a in ref.items():
        _close(getattr(out, name).numpy(), a, name=name)
    assert out.capacity == 12 and out.binding.dtype == torch.int64


@pytest.mark.parametrize("bound", [False, True])
def test_world_space_views_match_jax(bound):
    verts, faces = _mesh()
    jgp, tgp = _splats(len(faces), 2, capacity=len(faces) + 6)
    jfr = tfr = None
    if bound:
        jfr = jg.face_frames_from_verts(jnp.asarray(verts),
                                        jnp.asarray(faces))
        tfr = tg.face_frames_from_verts(t(verts), t(faces).long())
    _close(tg.get_xyz(tgp, tfr), jg.get_xyz(jgp, jfr), atol=1e-5)
    _close(tg.get_scaling(tgp, tfr), jg.get_scaling(jgp, jfr))
    _close(tg.get_rotation(tgp, tfr), jg.get_rotation(jgp, jfr), atol=1e-5)
    _close(tg.get_opacity(tgp), jg.get_opacity(jgp))
    _close(tg.get_features(tgp), jg.get_features(jgp))
    _close(tg.get_covariance(tgp, tfr, 1.2),
           jg.get_covariance(jgp, jfr, 1.2))


def test_cameras_match_jax():
    k = np.array([[300.0, 0, 64], [0, 310.0, 50], [0, 0, 1]])
    w2c = np.eye(4)
    w2c[:3, 3] = [0.1, -0.2, 2.5]
    a = tcam.Camera.from_kw2c("c", 128, 100, k, w2c, near=0.2, far=30.0)
    b = jcam.Camera.from_kw2c("c", 128, 100, k, w2c, near=0.2, far=30.0)
    for name in ("world_view_transform", "full_proj_transform",
                 "camera_center", "projection_matrix"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
    assert (a.tanfovx, a.tanfovy) == (b.tanfovx, b.tanfovy)
    for ca, cb in zip(tcam.spherical_camera_path(5, [0, 1, 0], 2.0, 0.5,
                                                 64, 48, 50.0),
                      jcam.spherical_camera_path(5, [0, 1, 0], 2.0, 0.5,
                                                 64, 48, 50.0)):
        np.testing.assert_array_equal(ca.full_proj_transform,
                                      cb.full_proj_transform)


def test_convert_sh_colors_matches_jax():
    jgp, tgp = _splats(40, 3)
    center = np.array([0.2, -0.1, -3.0], np.float32)
    _close(trender.convert_sh_colors(tg.get_features(tgp), tgp.xyz,
                                     t(center), 3),
           jrender.convert_sh_colors(jg.get_features(jgp), jgp.xyz,
                                     jnp.asarray(center), 3), atol=1e-5)


def test_render_with_extra_gaussians_matches_jax():
    """render(): mesh-bound splats plus appended world-space gaussians,
    through the dense compositor."""
    verts, faces = _mesh()
    jgp, tgp = _splats(len(faces), 1, capacity=len(faces) + 4)
    cam = simple_camera()
    rng = np.random.default_rng(4)
    n_extra = 5
    extra = (np.concatenate([rng.normal(0, 0.2, (n_extra, 2)),
                             -0.4 - 0.1 * np.arange(n_extra)[:, None]], 1),
             rng.random((n_extra, 3)), rng.uniform(0.5, 0.9, n_extra),
             np.broadcast_to(np.eye(3) * 0.01, (n_extra, 3, 3)))
    extra = [np.asarray(e, np.float32) for e in extra]
    ref = jrender.render(cam, jgp, jg.face_frames_from_verts(
        jnp.asarray(verts), jnp.asarray(faces)), jnp.zeros(3),
        active_sh_degree=1, extra=tuple(jnp.asarray(e) for e in extra))
    out = trender.render(cam, tgp, tg.face_frames_from_verts(
        t(verts), t(faces).long()), torch.zeros(3), active_sh_degree=1,
        extra=tuple(t(e) for e in extra))
    for key in ("render", "mask"):
        _close(out[key], ref[key], atol=1e-5, name=key)
    assert float(out["mask"].max()) > 0.5


def test_render_modules_load_no_jax():
    code = (
        "import sys\n"
        "import mpmavatar_tpu_torch.render.bench_render\n"
        "import mpmavatar_tpu_torch.train.appearance\n"
        "import mpmavatar_tpu_torch.ops.composite\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'mpmavatar_tpu')]\n"
        "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
