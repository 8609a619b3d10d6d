"""Stage-2 appearance training of the port against the JAX package, on the
cut avatar of tests/test_torch_avatar_render.py (20 x 18 body mesh,
96 x 64, work_cap > 0 so that both packages go through the worklist
compositor: K6/K7's plain versions here, the Pallas kernels in interpret
mode in JAX): the four avatar regularizers, ``frame_loss``, the gradients
of one train step (every float leaf and the view-space gradient), the
parameters after its Adam step, and the train benchmark at a cut size.

Tolerances.  The two packages pose the mesh, run the UNet and shade in
float32 in another order, so values agree to ~1e-6 and gradients, per
leaf relative to the leaf's largest entry, to GRAD_TOL.  An alpha within
1e-4 of the 1/255 cutoff would be a rounding tie between the packages:
the scene is one with no such evaluation, and the test checks that it
still is.  With Adam's eps of 1e-15 the first step is lr * sign(g) for any
nonzero g, so a noise-level gradient can flip a whole lr: the updated
parameters are compared where |g| is well above float noise (or exactly 0
in both)."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_avatar_render import W, H, _jax_avatar, _tied_pixels

from mpmavatar_tpu.data.config import OptimizationParams as JOpt
from mpmavatar_tpu.render.geometry import find_adjacent_faces
from mpmavatar_tpu.render.rasterizer import camera_arrays as jcamera_arrays
from mpmavatar_tpu.train import appearance as japp

from mpmavatar_tpu_torch import convert
from mpmavatar_tpu_torch.data import OptimizationParams
from mpmavatar_tpu_torch.render import bench_render
from mpmavatar_tpu_torch.render.rasterizer import camera_arrays
from mpmavatar_tpu_torch.train import appearance as tapp
from mpmavatar_tpu_torch.train import bench_appearance

torch.set_num_threads(1)

T_STEP, CAM_IDX = 1, 2
# the cut avatar's seed: one whose evaluations all keep 1e-4 off the cutoff
AVATAR_SEED = 1
RASTER = dict(tile_capacity=512, work_cap=64, chunk=32)
VALUE_TOL = 1e-6
GRAD_TOL = 2e-5          # read: up to 4.3e-6
# an updated parameter is compared where |g| > NOISE * max |g| of its
# leaf, five times the gradients' tolerance: there the sign is certain
NOISE = 1e-4


def _avatar():
    """The cut avatar with real face neighbours (the regularizers read
    them), as numpy arrays for both packages."""
    javatar, jparams, arrays = _jax_avatar(seed=AVATAR_SEED)
    faces = javatar.faces
    nbr = find_adjacent_faces(faces)
    centers = javatar.verts_orig[0][faces].mean(1)
    sq = np.sum((centers[nbr] - centers[:, None]) ** 2, -1)
    javatar = dataclasses.replace(
        javatar, face_neighbors=nbr,
        neighbor_weight=np.exp(-2000 * sq).astype(np.float32),
        neighbor_dist=np.sqrt(sq).astype(np.float32))
    avatar = convert.mesh_avatar_from_numpy(
        {k: getattr(javatar, k) for k in javatar.__dataclass_fields__})
    return javatar, jparams, avatar, arrays


def _inputs(seed=5):
    rng = np.random.default_rng(seed)
    gt = rng.random((3, H, W)).astype(np.float32)
    msk = (rng.random((1, H, W)) > 0.2).astype(np.float32)
    return gt, msk


def _leaf(tree, name):
    node = tree
    for key in name.split("."):
        node = node[key] if isinstance(node, dict) else getattr(node, key)
    return np.asarray(node)


@pytest.fixture(scope="module")
def scene():
    javatar, jparams, avatar, arrays = _avatar()
    cam = bench_render.look_down_z(W, H, 1400.0 * W / 1500, 2.6, 0.1, 20.0)
    gt, msk = _inputs()
    return dict(javatar=javatar, jparams=jparams, avatar=avatar,
                arrays=arrays, cam=cam, gt=gt, msk=msk)


@pytest.fixture(scope="module")
def jax_run(scene):
    """JAX's gradients (float_leaf_grads over frame_loss, jitted) and one
    step of its jitted make_train_step."""
    javatar, jparams = scene["javatar"], scene["jparams"]
    opt = JOpt()
    weights = japp.AppearanceLossWeights()
    ca = jcamera_arrays(scene["cam"])
    gt, msk = jnp.asarray(scene["gt"]), jnp.asarray(scene["msk"])
    ao = jnp.asarray(javatar.ao_maps[T_STEP])

    @jax.jit
    def grads(params):
        def loss_fn(p, m2d):
            verts = javatar.select_verts(p, T_STEP)
            return japp.frame_loss(
                javatar, weights, p, m2d, verts, p.verts_offset[T_STEP], ao,
                ca, W, H, CAM_IDX, gt, msk, 3, jnp.zeros(3), False,
                RASTER["tile_capacity"], RASTER["work_cap"], RASTER["chunk"],
                None)
        return japp.float_leaf_grads(params, loss_fn,
                                     jnp.zeros((params.splats.capacity, 2)))

    (loss, aux), g, vgrad = grads(jparams)
    tx = japp.make_optimizer(opt, 1.0)
    step = japp.make_train_step(javatar, opt, tx, 3, False, weights=weights,
                                **RASTER)
    new, _, step_loss, step_aux = step(jparams, tx.init(jparams), T_STEP,
                                       CAM_IDX, ca, gt, msk, ao, W, H)
    return dict(loss=float(loss), aux=aux, grads=g, vgrad=np.asarray(vgrad),
                new=new, step_loss=float(step_loss), step_aux=step_aux)


def _port_params(scene):
    return convert.avatar_params_from_numpy(**scene["arrays"], device="cpu")


def _port_args(scene):
    avatar = scene["avatar"]
    return (T_STEP, CAM_IDX, camera_arrays(scene["cam"], "cpu"),
            torch.tensor(scene["gt"]), torch.tensor(scene["msk"]),
            avatar.tensor("ao_maps", "cpu")[T_STEP], W, H)


@pytest.fixture(scope="module")
def port_run(scene):
    """The port's loss and gradients, then one make_train_step on a fresh
    copy of the parameters."""
    avatar = scene["avatar"]
    opt = OptimizationParams()
    params = _port_params(scene)
    verts = avatar.select_verts(params, T_STEP)
    tied = _tied_pixels(avatar, params, verts,
                        camera_arrays(scene["cam"], "cpu"))
    loss, aux, grads = tapp.make_loss_and_grads(
        avatar, opt, 3, False, **RASTER)(params, *_port_args(scene))
    stepped = _port_params(scene)
    step = tapp.make_train_step(avatar, opt,
                                tapp.make_optimizer(opt, 1.0, stepped), 3,
                                False, **RASTER)
    step_loss, _ = step(stepped, *_port_args(scene))
    return dict(loss=float(loss), aux=aux, grads=grads, tied=tied,
                stepped=stepped, step_loss=float(step_loss))


@pytest.mark.parametrize("name", ["normal_loss", "iso_loss", "area_loss",
                                  "opacity_loss"])
def test_regularizers_match_jax(scene, name):
    """Value and gradient (w.r.t. the posed vertices, or the opacity
    logits) of each avatar regularizer."""
    javatar, jparams, avatar = (scene["javatar"], scene["jparams"],
                                scene["avatar"])
    params = _port_params(scene)
    if name == "opacity_loss":
        x0 = np.asarray(jparams.splats.opacity)

        def jfn(x):
            return javatar.opacity_loss(dataclasses.replace(
                jparams, splats=dataclasses.replace(jparams.splats,
                                                    opacity=x)))

        def tfn(x):
            return avatar.opacity_loss(dataclasses.replace(
                params, splats=dataclasses.replace(params.splats,
                                                   opacity=x)))
    else:
        x0 = np.asarray(javatar.select_verts(jparams, T_STEP))
        jfn, tfn = getattr(javatar, name), getattr(avatar, name)
    ref, ref_grad = jax.value_and_grad(jfn)(jnp.asarray(x0))
    x = torch.tensor(x0, requires_grad=True)
    out = tfn(x)
    (grad,) = torch.autograd.grad(out, x)
    assert float(ref) > 0.0
    assert abs(float(out.detach()) - float(ref)) <= VALUE_TOL * max(
        1.0, abs(float(ref)))
    ref_grad = np.asarray(ref_grad)
    assert np.abs(grad.numpy() - ref_grad).max() \
        <= GRAD_TOL * np.abs(ref_grad).max()


def test_frame_loss_matches_jax(scene, jax_run, port_run):
    assert not port_run["tied"].any()      # no alpha near the cutoff
    aux, ref = port_run["aux"], jax_run["aux"]
    assert int(ref["work_overflow"]) == 0 and int(ref["big_overflow"]) == 0
    assert int(aux["work_overflow"]) == 0 and int(aux["n_items"]) > 0
    assert port_run["loss"] == pytest.approx(jax_run["loss"], abs=1e-5)
    for key in ("l1", "dssim"):
        assert float(aux[key]) == pytest.approx(float(ref[key]), abs=1e-6)
    np.testing.assert_array_equal(aux["radii"].numpy(),
                                  np.asarray(ref["radii"]))
    np.testing.assert_array_equal(aux["visible"].numpy(),
                                  np.asarray(ref["visible"]))


def test_train_step_gradients_match_jax(jax_run, port_run):
    """Every float leaf's gradient and the NDC-scaled view-space gradient,
    per leaf relative to its largest entry."""
    grads = port_run["grads"]
    assert set(grads) == {
        "splats." + f for f in tapp.SPLAT_FLOATS} | {
        "verts_offset", "cam_m", "cam_c"} | {
        "shadow." + k for k in jax_run["grads"].shadow}
    nested = convert.float_grads_to_numpy(grads)
    for name in grads:
        ref = _leaf(jax_run["grads"], name)
        out = _leaf(nested, name)
        assert out.shape == ref.shape, name
        scale = np.abs(ref).max()
        assert scale > 0.0, name
        err = np.abs(out - ref).max() / scale
        assert err < GRAD_TOL, (name, err)
    ref_v = np.asarray(jax_run["step_aux"]["vgrad"])
    np.testing.assert_allclose(ref_v, jax_run["vgrad"] * [0.5 * W, 0.5 * H],
                               rtol=1e-6)
    out_v = port_run["aux"]["vgrad"].numpy()
    assert np.abs(out_v - ref_v).max() < GRAD_TOL * np.abs(ref_v).max()


def test_train_step_adam_update_matches_jax(scene, jax_run, port_run):
    """The parameters after one step, where the gradient is well above
    float noise (or zero in both packages)."""
    assert port_run["step_loss"] == pytest.approx(jax_run["step_loss"],
                                                  abs=1e-5)
    nested = convert.float_grads_to_numpy(port_run["grads"])
    stepped = tapp.float_leaves(port_run["stepped"])
    compared = 0
    for name, leaf in stepped.items():
        g_ref = _leaf(jax_run["grads"], name)
        g_out = _leaf(nested, name)
        sure = (np.abs(g_ref) > NOISE * np.abs(g_ref).max()) | \
            ((g_ref == 0) & (g_out == 0))
        ref = _leaf(jax_run["new"], name)
        np.testing.assert_allclose(leaf.detach().numpy()[sure], ref[sure],
                                   atol=1e-6, rtol=1e-6, err_msg=name)
        compared += int(sure.sum())
    assert compared > 0.9 * sum(t.numel() for t in stepped.values())
    # the frozen leaves did not move
    for k in tapp.FROZEN_SHADOW:
        np.testing.assert_array_equal(
            port_run["stepped"].shadow[k].detach().numpy(),
            scene["arrays"]["shadow"][k])


def test_viewspace_gradients_match_jax(scene):
    """The standalone view-space gradient probe (dense compositor)."""
    javatar, jparams, avatar = (scene["javatar"], scene["jparams"],
                                scene["avatar"])
    ref = np.asarray(japp.viewspace_gradients(
        javatar, jparams, T_STEP, (jcamera_arrays(scene["cam"]), W, H),
        CAM_IDX, jnp.asarray(scene["gt"]), jnp.asarray(scene["msk"]),
        jnp.asarray(javatar.ao_maps[T_STEP]), 3, False))
    params = _port_params(scene)
    _, _, ca, gt, msk, ao, _, _ = _port_args(scene)
    out = tapp.viewspace_gradients(avatar, params, T_STEP, (ca, W, H),
                                   CAM_IDX, gt, msk, ao, 3, False).numpy()
    assert np.abs(ref).max() > 0.0
    assert np.abs(out - ref).max() < GRAD_TOL * np.abs(ref).max()


def test_bench_appearance_runs_on_cpu(capsys):
    bench_appearance.main(["--device", "cpu", "--width", str(W), "--height",
                           str(H), "--mesh", "20x18", "--work-cap", "64",
                           "--steps", "3"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["steps"] == 3 and len(line["loss"]) == 3
    assert all(np.isfinite(line["loss"]))
    assert line["n_items"] > 0 and line["faces"] == 684
    assert line["work_overflow"] == 0 and line["big_overflow"] == 0
    assert line["alive_before"] == 684
    assert line["min_splats_per_face"] >= 1
