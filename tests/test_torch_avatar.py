"""The port's avatar (mpmavatar_tpu_torch/avatar) against the JAX package's
on the CPU: each LBS function, the SMPL-X loader and forward on an
archive in the official layout (PCA hands, trans, scale as () and (B,)),
the test rig, hand-region subdivision, the VPoser decoder through both
loaders and the loader's rejections, the gradient-safe 6D and axis-angle
conversions with their gradients against ``jax.grad``, the pose pipeline
against ``prepare_pose_playback``, and a cut-size run of
``sim/pose_playback`` against the JAX solver fed by JAX's playback.

Inputs come from numpy with a seed; the port runs with device="cpu".
Tolerances: the avatar's outputs within 1e-5 of max |JAX| each;
subdivision and the loaded archive exactly; the playback run at the
solver's golden bounds (x 2e-5, v 1e-3).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_smplx_npz import make_fake_smplx_npz
from test_vposer_official import _official_decode, _official_state_dict

from mpmavatar_tpu.avatar import lbs as jlbs
from mpmavatar_tpu.avatar import smplx as jsmplx
from mpmavatar_tpu.avatar import subdivide as jsub
from mpmavatar_tpu.avatar import vposer as jvp
from mpmavatar_tpu.core import types as jtypes
from mpmavatar_tpu.sim import MPMSolver as JSolver
from mpmavatar_tpu.train.demo import prepare_pose_playback as j_playback

from mpmavatar_tpu_torch import convert
from mpmavatar_tpu_torch.avatar import lbs, pipeline, smplx, subdivide, vposer
from mpmavatar_tpu_torch.sim import pose_playback

torch.set_num_threads(1)

REL_TOL = 1e-5
PATH_ATOL = {"x": 2e-5, "v": 1e-3}


def _rel(a, b):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.abs(a.astype(np.float64) - b).max()) / max(
        float(np.abs(b).max()), 1e-30)


def _close(a, b, tol=REL_TOL, what=""):
    err = _rel(a, b)
    assert err <= tol, f"{what}: rel err {err:.3e} > {tol:.0e}"


def _t(a):
    return torch.as_tensor(np.array(a))


# ----------------------------------------------------------------------
# lbs
# ----------------------------------------------------------------------
def _lbs_case(name, rng):
    """(port outputs, JAX outputs) of one lbs function on seeded inputs."""
    f32 = lambda *s: rng.normal(size=s).astype(np.float32)
    if name == "batch_rodrigues":
        rv = f32(40, 3)
        rv[:4] = 0.0                      # the rest pose's zero vectors
        return lbs.batch_rodrigues(_t(rv)), jlbs.batch_rodrigues(rv)
    if name == "blend_shapes":
        b, d = f32(3, 7), f32(20, 3, 7)
        return lbs.blend_shapes(_t(b), _t(d)), jlbs.blend_shapes(b, d)
    if name == "vertices2joints":
        j, v = np.abs(f32(6, 20)), f32(2, 20, 3)
        return lbs.vertices2joints(_t(j), _t(v)), jlbs.vertices2joints(j, v)
    if name == "batch_rigid_transform":
        rots = np.asarray(jlbs.batch_rodrigues(0.4 * f32(2 * 9, 3))
                          ).reshape(2, 9, 3, 3)
        joints = f32(2, 9, 3)
        parents = (-1, 0, 0, 1, 2, 3, 3, 5, 7)
        return (lbs.batch_rigid_transform(_t(rots), _t(joints), parents),
                jlbs.batch_rigid_transform(jnp.asarray(rots),
                                           jnp.asarray(joints), parents))
    if name in ("knn", "shepard_weights"):
        pts, verts = f32(30, 3), f32(50, 3)
        pn, vn = f32(30, 3), f32(50, 3)
        fn = (lbs.knn, jlbs.knn) if name == "knn" else \
            (lbs.shepard_weights, jlbs.shepard_weights)
        return (fn[0](_t(pts), _t(verts), 5, points_normals=_t(pn),
                      verts_normals=_t(vn)),
                fn[1](pts, verts, 5, points_normals=pn, verts_normals=vn))
    if name == "skinning_transforms":
        w, rel = np.abs(f32(25, 6)), f32(6, 4, 4)
        return (lbs.skinning_transforms(_t(w), _t(rel)),
                jlbs.skinning_transforms(w, rel))
    if name == "apply_transforms":
        t, p = f32(25, 4, 4), f32(25, 3)
        return (lbs.apply_transforms(_t(t), _t(p)),
                jlbs.apply_transforms(t, p))
    rig = jsmplx.make_test_rig()
    out = jsmplx.smplx_forward(rig, {
        "body_pose": jnp.asarray(0.3 * f32(1, 9)),
        "trans": jnp.asarray(0.1 * f32(1, 3)), "scale": jnp.float32(1.1)})
    verts = np.asarray(out.vertices[0])
    rel = np.asarray(out.transform_mat[0])
    pts = verts[rng.integers(0, len(verts), 20)] + 0.01 * f32(20, 3)
    if name == "transform_to_t_pose":
        tr, sc = np.float32([0.05, -0.02, 0.1]), np.float32(1.1)
        return (lbs.transform_to_t_pose(
            _t(pts), _t(verts), _t(rel),
            lbs_weights_packed=_t(rig.lbs_weights), global_transl=_t(tr),
            scale=_t(sc), k=4),
            jlbs.transform_to_t_pose(
                pts, verts, rel, lbs_weights_packed=rig.lbs_weights,
                global_transl=tr, scale=sc, k=4))
    w = np.abs(f32(20, 4))
    w /= w.sum(1, keepdims=True)
    return (lbs.transform_to_pose(_t(pts), _t(w), _t(rel),
                                  global_transl=_t(np.float32([0.1, 0, 0])),
                                  scale=_t(np.float32(0.9))),
            jlbs.transform_to_pose(pts, w, rel, global_transl=jnp.asarray(
                [0.1, 0.0, 0.0]), scale=jnp.float32(0.9)))


LBS_FUNCTIONS = ["batch_rodrigues", "blend_shapes", "vertices2joints",
                 "batch_rigid_transform", "knn", "shepard_weights",
                 "skinning_transforms", "apply_transforms",
                 "transform_to_t_pose", "transform_to_pose"]


@pytest.mark.parametrize("name", LBS_FUNCTIONS)
def test_lbs_function_matches_jax(name):
    out, ref = _lbs_case(name, np.random.default_rng(0))
    out = out if isinstance(out, tuple) else (out,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    assert len(out) == len(ref)
    for i, (a, b) in enumerate(zip(out, ref)):
        if a.dtype in (torch.int32, torch.int64):
            assert np.array_equal(a.numpy(), np.asarray(b)), f"{name}[{i}]"
        else:
            _close(a, b, what=f"{name}[{i}]")


def test_batched_transform_to_pose_is_the_per_pose_one():
    """A (B, J, 4, 4) stack of transforms poses every pose in one call,
    as B single calls do."""
    rng = np.random.default_rng(1)
    pts = _t(rng.normal(size=(30, 3)).astype(np.float32))
    w = _t(rng.dirichlet(np.ones(5), 30).astype(np.float32))
    rel = _t(rng.normal(size=(3, 5, 4, 4)).astype(np.float32))
    tr = _t(rng.normal(size=(3, 3)).astype(np.float32))
    sc = _t(rng.uniform(0.9, 1.1, 3).astype(np.float32))
    batched, _ = lbs.transform_to_pose(pts, w, rel, tr[:, None], sc[:, None,
                                                                    None])
    for b in range(3):
        one, _ = lbs.transform_to_pose(pts, w, rel[b], tr[b], sc[b])
        assert torch.allclose(batched[b], one, rtol=0, atol=1e-6)


def test_knn_in_row_chunks_is_the_unchunked_knn(monkeypatch):
    rng = np.random.default_rng(2)
    pts = _t(rng.normal(size=(100, 3)).astype(np.float32))
    verts = _t(rng.normal(size=(70, 3)).astype(np.float32))
    whole = lbs.knn(pts, verts, 6)
    monkeypatch.setattr(lbs, "KNN_BLOCK_BYTES", 7 * 70 * 3 * 4)
    chunked = lbs.knn(pts, verts, 6)
    assert torch.equal(whole[0], chunked[0])
    assert torch.equal(whole[1], chunked[1])


# ----------------------------------------------------------------------
# SMPL-X
# ----------------------------------------------------------------------
def _smplx_params(rng, b, n_pca=None, scale_shape=()):
    f = lambda *s, sd=0.2: rng.normal(0, sd, s).astype(np.float32)
    hand = n_pca or 45
    p = {"trans": f(b, 3), "orient": f(b, 3), "body_pose": f(b, 63),
         "beta": f(b, 300, sd=1.0), "expr": f(b, 100, sd=1.0),
         "jaw_pose": f(b, 3), "left_eye_pose": f(b, 3),
         "right_eye_pose": f(b, 3), "left_hand_pose": f(b, hand),
         "right_hand_pose": f(b, hand),
         "scale": rng.uniform(0.8, 1.2, scale_shape).astype(np.float32)}
    return p


@pytest.mark.parametrize("pca,scale_shape", [(False, ()), (True, (2,))])
def test_smplx_forward_on_the_official_layout_matches_jax(tmp_path, pca,
                                                          scale_shape):
    path = tmp_path / "SMPLX_NEUTRAL.npz"
    make_fake_smplx_npz(path)
    kw = dict(num_betas=300, num_expr=100, use_pca=pca, num_pca_comps=12)
    jm = jsmplx.load_smplx_npz(str(path), **kw)
    tm = smplx.load_smplx_npz(str(path), device="cpu", **kw)
    assert tm.parents == jm.parents and tm.parents[0] == -1
    for f in dataclasses.fields(tm):
        a, b = getattr(tm, f.name), getattr(jm, f.name)
        if f.name == "parents" or b is None:
            assert a is None or f.name == "parents", f.name
            continue
        assert a.dtype == (torch.int32 if f.name == "faces"
                           else torch.float32), f.name
        assert np.array_equal(a.numpy(), np.asarray(b)), f.name
    params = _smplx_params(np.random.default_rng(3), 2, 12 if pca else None,
                           scale_shape)
    out = smplx.smplx_forward(tm, {k: _t(v) for k, v in params.items()})
    ref = jsmplx.smplx_forward(jm, {k: jnp.asarray(v)
                                    for k, v in params.items()})
    for f in dataclasses.fields(ref):
        _close(getattr(out, f.name), getattr(ref, f.name), what=f.name)


def test_smplx_forward_without_pose_blendshapes_matches_jax():
    rig_t, rig_j = smplx.make_test_rig(device="cpu"), jsmplx.make_test_rig()
    rng = np.random.default_rng(4)
    params = {"body_pose": rng.normal(0, 0.3, (3, 9)).astype(np.float32),
              "trans": rng.normal(size=(3, 3)).astype(np.float32),
              "beta": rng.normal(size=(3, 5)).astype(np.float32)}
    for blend in (True, False):
        out = smplx.smplx_forward(rig_t, {k: _t(v) for k, v in
                                          params.items()}, blend)
        ref = jsmplx.smplx_forward(rig_j, {k: jnp.asarray(v) for k, v in
                                           params.items()}, blend)
        _close(out.vertices, ref.vertices, what=f"vertices, blend={blend}")
        _close(out.transform_mat, ref.transform_mat, what="transform_mat")


@pytest.mark.parametrize("n_joints,n_verts,seed", [(4, 64, 0), (6, 50, 3)])
def test_make_test_rig_is_the_jax_rig(n_joints, n_verts, seed):
    tm = smplx.make_test_rig(n_joints, n_verts, seed, device="cpu")
    jm = jsmplx.make_test_rig(n_joints, n_verts, seed)
    assert tm.parents == jm.parents
    for f in dataclasses.fields(jm):
        b = getattr(jm, f.name)
        if f.name == "parents" or b is None:
            assert getattr(tm, f.name) == b
            continue
        assert np.array_equal(getattr(tm, f.name).numpy(), np.asarray(b)), \
            f.name


def test_smplx_model_from_numpy_carries_the_jax_model():
    jm = jsmplx.make_test_rig()
    arrays = {f.name: None if getattr(jm, f.name) is None
              else np.asarray(getattr(jm, f.name))
              for f in dataclasses.fields(jm) if f.name != "parents"}
    tm = convert.smplx_model_from_numpy(arrays, jm.parents, "cpu")
    ref = smplx.make_test_rig(device="cpu")
    for f in dataclasses.fields(ref):
        a, b = getattr(tm, f.name), getattr(ref, f.name)
        assert (a == b if f.name == "parents" or b is None
                else torch.equal(a, b)), f.name


# ----------------------------------------------------------------------
# subdivision
# ----------------------------------------------------------------------
def test_subdivide_faces_is_the_jax_copy():
    rng = np.random.default_rng(5)
    verts = rng.normal(size=(30, 3))
    faces = rng.integers(0, 30, (40, 3))
    attrs = {"w": rng.random((30, 4))}
    out = subdivide.subdivide_faces(verts, faces, attrs, iterations=2)
    ref = jsub.subdivide_faces(verts, faces, attrs, iterations=2)
    assert np.array_equal(out[0], ref[0]) and np.array_equal(out[1], ref[1])
    assert np.array_equal(out[2]["w"], ref[2]["w"])


def test_subdivide_hand_region_is_the_jax_copy():
    rig = jsmplx.make_test_rig(n_joints=4, n_verts=64)
    args = (np.asarray(rig.v_template), np.asarray(rig.faces),
            np.asarray(rig.lbs_weights), slice(2, 4))
    out = subdivide.subdivide_hand_region(*args, iterations=1)
    ref = jsub.subdivide_hand_region(*args, iterations=1)
    assert len(out[1]) > len(args[1])          # some faces were split
    for a, b in zip(out, ref):
        assert np.array_equal(a, b)


# ----------------------------------------------------------------------
# VPoser
# ----------------------------------------------------------------------
def test_vposer_decode_through_both_loaders_matches_jax(tmp_path):
    """The official checkpoint through ``load_vposer_torch``, and the JAX
    loader's parameters through ``convert.vposer_from_numpy``, against
    JAX's decode and the official decoder's transliteration."""
    rng = np.random.default_rng(7)
    sd = _official_state_dict(rng)
    path = tmp_path / "TR00_E096.pt"
    torch.save(sd, path)
    jparams = jvp.load_vposer_torch(str(path))
    z = rng.standard_normal((4, 32)).astype(np.float32)
    ref = jvp.vposer_decode(jparams, z)
    loaded = vposer.load_vposer_torch(str(path), device="cpu")
    carried = convert.vposer_from_numpy(
        {k: jparams[k] for k in ("fc1", "fc2", "out")}, "cpu")
    with torch.no_grad():
        for dec in (loaded, carried):
            _close(dec(_t(z)), ref, what="decode")
        _close(loaded(_t(z)), _official_decode(sd, _t(z)).numpy(),
               what="official")


def test_vposer_loader_rejects_bad_checkpoints(tmp_path):
    sd = _official_state_dict(np.random.default_rng(3))
    incomplete = {k: v for k, v in sd.items()
                  if k != "bodyprior_dec_fc2.weight"}
    torch.save(incomplete, tmp_path / "missing.pt")
    with pytest.raises(ValueError, match="lacks decoder keys"):
        vposer.load_vposer_torch(str(tmp_path / "missing.pt"), device="cpu")
    wrong = dict(sd)
    wrong["bodyprior_dec_out.weight"] = torch.zeros(63, 512)
    torch.save(wrong, tmp_path / "badshape.pt")
    with pytest.raises(ValueError, match="shape mismatch"):
        vposer.load_vposer_torch(str(tmp_path / "badshape.pt"), device="cpu")


def test_vposer_loader_accepts_the_wrapped_state_dict(tmp_path):
    sd = _official_state_dict(np.random.default_rng(11))
    torch.save({"state_dict": {f"vp_model.{k}": v for k, v in sd.items()}},
               tmp_path / "wrapped.pt")
    dec = vposer.load_vposer_torch(str(tmp_path / "wrapped.pt"),
                                   device="cpu")
    z = torch.zeros((1, 32))
    with torch.no_grad():
        _close(dec(z), _official_decode(sd, z).numpy(), what="wrapped")


def test_init_vposer_decodes_rotations():
    dec = vposer.init_vposer(torch.Generator().manual_seed(0), device="cpu")
    assert float(dec.fc1.weight.detach().abs().max()) <= 1.0 / np.sqrt(32)
    assert float(dec.out.bias.detach().abs().max()) == 0.0
    with torch.no_grad():
        r = dec(torch.randn(3, 32, generator=torch.Generator().manual_seed(1)))
    eye = r.transpose(-1, -2) @ r
    assert torch.allclose(eye, torch.eye(3).expand_as(eye), atol=1e-5)
    assert bool((torch.linalg.det(r) > 0.99).all())


def _rot_inputs(kind, rng):
    if kind == "rot6d_random":
        return rng.normal(size=(5, 6)).astype(np.float32)
    if kind == "rot6d_zero":
        return np.zeros((2, 6), np.float32)
    if kind == "axis_angle_identity":
        return np.broadcast_to(np.eye(3, dtype=np.float32), (2, 3, 3)).copy()
    r = np.asarray(jlbs.batch_rodrigues(
        rng.normal(0, 0.8, (6, 3)).astype(np.float32)))
    return r


@pytest.mark.parametrize("kind", ["rot6d_random", "rot6d_zero",
                                  "axis_angle_random",
                                  "axis_angle_identity"])
def test_rotation_conversions_and_gradients_match_jax(kind):
    """Values and gradients of a seeded weighted sum against jax.grad;
    the gradients are finite at a zero 6D vector and at the identity."""
    rng = np.random.default_rng(8)
    x = _rot_inputs(kind, rng)
    fn_t, fn_j = ((vposer.rot6d_to_matrix, jvp.rot6d_to_matrix)
                  if kind.startswith("rot6d") else
                  (vposer.matrix_to_axis_angle, jvp.matrix_to_axis_angle))
    ref = fn_j(jnp.asarray(x))
    w = rng.normal(size=ref.shape).astype(np.float32)
    g_ref = jax.grad(lambda a: jnp.sum(jnp.asarray(w) * fn_j(a)))(
        jnp.asarray(x))
    xt = _t(x).requires_grad_(True)
    out = fn_t(xt)
    (g,) = torch.autograd.grad(torch.sum(_t(w) * out), xt)
    assert torch.isfinite(g).all() and np.isfinite(np.asarray(g_ref)).all()
    _close(out, ref, what="value")
    _close(g, g_ref, what="gradient")


# ----------------------------------------------------------------------
# the pose pipeline
# ----------------------------------------------------------------------
def _demo_rig_playback(n_poses=4):
    """tests/test_demo_playback.py's rig: the 4-joint test rig, its
    template lifted 5 cm in z as the tracked frame, the first joint's
    bend sweeping 0 -> 0.4 rad."""
    rig = jsmplx.make_test_rig(n_joints=4, n_verts=64)
    verts = np.asarray(rig.v_template) + np.asarray([0.0, 0.0, 0.05],
                                                    np.float32)
    first = {"body_pose": np.zeros((1, 9), np.float32),
             "trans": np.zeros((1, 3), np.float32)}
    pose = np.zeros((n_poses, 9), np.float32)
    pose[:, 0] = np.linspace(0, 0.4, n_poses)
    poses = {"body_pose": pose, "trans": np.zeros((n_poses, 3), np.float32)}
    return rig, verts, first, poses


def test_deform_tracked_to_poses_and_frame_velocities_match_jax():
    rig, verts, first, poses = _demo_rig_playback()
    ref = j_playback(rig, {k: jnp.asarray(v) for k, v in first.items()},
                     {k: jnp.asarray(v) for k, v in poses.items()}, verts,
                     k=4)
    tm = smplx.make_test_rig(n_joints=4, n_verts=64, device="cpu")
    deformed, out_poses, w = pipeline.deform_tracked_to_poses(
        tm, _t(verts), {k: _t(v) for k, v in first.items()},
        {k: _t(v) for k, v in poses.items()}, k=4)
    _close(deformed, ref["verts"], what="verts")
    _close(out_poses.vertices, ref["smplx"], what="smplx")
    _close(pipeline.frame_velocities(deformed, 25.0), ref["verts_velo"],
           what="verts_velo")
    _close(pipeline.frame_velocities(out_poses.vertices, 25.0),
           ref["smplx_velo"], what="smplx_velo")
    # frame 0 re-poses to the first fit's pose: the input mesh
    assert float((deformed[0] - _t(verts)).abs().max()) <= 1e-4


def test_deform_tracked_to_poses_with_given_weights_trans_and_scale():
    rig, verts, first, poses = _demo_rig_playback(3)
    rng = np.random.default_rng(9)
    first = dict(first, trans=np.float32([[0.1, 0.0, -0.2]]),
                 scale=np.float32(1.2))
    poses = dict(poses, trans=rng.normal(0, 0.1, (3, 3)).astype(np.float32),
                 scale=np.float32([0.9, 1.0, 1.1]))
    lbs_w = rng.dirichlet(np.ones(4), len(verts)).astype(np.float32)
    from mpmavatar_tpu.avatar.pipeline import deform_tracked_to_poses as jd
    ref, _, _ = jd(rig, jnp.asarray(verts),
                   {k: jnp.asarray(v) for k, v in first.items()},
                   {k: jnp.asarray(v) for k, v in poses.items()},
                   lbs_w=jnp.asarray(lbs_w))
    out, _, w = pipeline.deform_tracked_to_poses(
        smplx.make_test_rig(n_joints=4, n_verts=64, device="cpu"),
        _t(verts), {k: _t(v) for k, v in first.items()},
        {k: _t(v) for k, v in poses.items()}, lbs_w=_t(lbs_w))
    assert torch.equal(w, _t(lbs_w))
    _close(out, ref, what="verts")


# ----------------------------------------------------------------------
# the pose-playback run, cut size
# ----------------------------------------------------------------------
PLAY_NX, PLAY_GRID, PLAY_BODY, PLAY_SUBSTEPS = 12, 32, (13, 14), 50
# the cloth's first row of vertices and its faces pinned, as the full
# scene pins its first 256 of 33,489 vertices
PLAY_PINS = dict(num_joint_v=PLAY_NX, num_joint_f=PLAY_NX - 1)


def test_pose_playback_run_matches_the_jax_solver(tmp_path):
    """sim/pose_playback at a cut size (12 x 12 cloth pinned along its
    first row, 32^3, a 13 x 14 body archive, 2 frames x 50 substeps) against the JAX MPMSolver.frame
    fed by the JAX package's prepare_pose_playback on the same archive,
    poses and cloth, frame by frame."""
    npz = tmp_path / "body.npz"
    pose_playback.write_body_npz(npz, *PLAY_BODY)
    body = smplx.load_smplx_npz(str(npz), device="cpu")
    scene = pose_playback.build(PLAY_NX, PLAY_GRID,
                                substeps=PLAY_SUBSTEPS, body=body,
                                **PLAY_PINS, device="cpu")
    cfg = scene.solver.cfg
    # the JAX side: its loader, its playback, its solver
    jm = jsmplx.load_smplx_npz(str(npz))
    first, poses = pose_playback.make_poses()
    verts = scene.state.x[cfg.n_elements:].numpy()
    dt = pose_playback.DT
    fps = 1.0 / (PLAY_SUBSTEPS * dt)
    pb = j_playback(jm, {k: jnp.asarray(v) for k, v in first.items()},
                    {k: jnp.asarray(v) for k, v in poses.items()}, verts,
                    fps=fps, k=pose_playback.KNN_K)
    _close(scene.playback["verts"], pb["verts"], what="re-posed cloth")
    _close(scene.playback["smplx"], pb["smplx"], what="posed body")
    jcfg = jtypes.MPMStaticConfig(**dataclasses.asdict(cfg))
    jstate = jtypes.MPMState(**{k: jnp.asarray(v) for k, v in
                                convert.to_numpy(scene.state).items()})
    jmodel = jtypes.MPMModel(**{k: jnp.asarray(v) for k, v in
                                convert.to_numpy(scene.model).items()})
    js = JSolver(jcfg, column_k=0, fused_grid=True, fused_stress=True)
    js.add_surface_collider([0.0, 0.1, 0.0], [0.0, 1.0, 0.0])
    js.add_mesh_collider(np.asarray(jm.faces), friction=0.5)
    js.add_particle_mover()
    faces = np.asarray(jstate.faces)
    # the first pinned face reaches the cloth's second row, past the
    # pinned vertices: run_demo.py's mean reads it through JAX's clamp
    assert faces[:cfg.num_joint_f].max() >= cfg.num_joint_v
    state, t_j, t_t = scene.state, 0.0, 0.0
    for i in range(2):
        # the mover's inputs as scripts/run_demo.py:134-138 builds them
        jv = pb["verts_velo"][i, :cfg.num_joint_v]
        jstate, t_j = js.frame(
            jstate, jmodel, dt, PLAY_SUBSTEPS, t_j,
            mesh_x=pb["smplx"][i], mesh_v=pb["smplx_velo"][i],
            joint_verts_v=jv,
            joint_faces_v=jv[jnp.asarray(faces[:cfg.num_joint_f])].mean(1))
        state, t_t = scene.solver.frame(state, scene.model, dt,
                                        PLAY_SUBSTEPS, t_t,
                                        **scene.inputs(i))
        for name, atol in PATH_ATOL.items():
            err = float(np.abs(getattr(state, name).numpy()
                               - np.asarray(getattr(jstate, name))).max())
            assert err <= atol, f"frame {i}: {name} differs by {err:.3e}"
    assert np.isfinite(state.x.numpy()).all()
    # the body moved the cloth: contact, not a free fall
    free = pose_playback.build(PLAY_NX, PLAY_GRID,
                               substeps=PLAY_SUBSTEPS, body=body,
                               friction=0.0, **PLAY_PINS, device="cpu")
    moved = free.solver.frame(free.state, free.model, dt,
                              PLAY_SUBSTEPS, 0.0, **free.inputs(0))[0]
    first_frame = scene.solver.frame(scene.state, scene.model, dt,
                                     PLAY_SUBSTEPS, 0.0,
                                     **scene.inputs(0))[0]
    assert float((moved.v - first_frame.v).abs().max()) > 10 * PATH_ATOL["v"]


def test_entry_points_run_on_the_card_unless_asked_for_the_cpu(tmp_path):
    """Without a CUDA device the avatar's entry points raise unless the
    caller passes device="cpu"; none carries on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the entry points use it")
    npz = tmp_path / "SMPLX_NEUTRAL.npz"
    make_fake_smplx_npz(npz)
    torch.save(_official_state_dict(np.random.default_rng(0)),
               tmp_path / "vposer.pt")
    calls = [lambda: smplx.load_smplx_npz(str(npz)),
             lambda: smplx.make_test_rig(),
             lambda: vposer.load_vposer_torch(str(tmp_path / "vposer.pt")),
             lambda: vposer.init_vposer(torch.Generator().manual_seed(0)),
             lambda: pose_playback.build(nx=4, grid=16, n_theta=5, n_phi=6)]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
