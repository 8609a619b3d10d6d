"""The port's LPIPS (utils/lpips.py) against the JAX package's
(utils/lpips_jax.py) with the same seeded random weights of the published
shapes (tests/test_lpips.py's ``_make_random_weights``: the trained VGG
and head weights are not in the repository), and against that file's
transliteration of the reference torch modules.

Tolerances: the distance at 16 x 16 within rtol 2e-4 of both (13 float32
convolutions in another order), the identity 0 within 1e-8, and the
gradient w.r.t. the first image within 1e-3 of its largest entry.  The
npz schema, the converter and the loud no-weights case are checked as
tests/test_lpips.py checks the JAX package's, plus each package reading
the other's file, and the LPIPS term of the stage-2 loss."""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_lpips import _CONV_IDX, _make_random_weights, _torch_lpips

from mpmavatar_tpu.utils import lpips_jax

from mpmavatar_tpu_torch import convert
from mpmavatar_tpu_torch.utils import lpips as tlpips

torch.set_num_threads(1)

RTOL = 2e-4
GRAD_TOL = 1e-3


@pytest.fixture(scope="module")
def weights():
    return _make_random_weights(seed=0)


def _images(seed=1, size=16):
    rng = np.random.default_rng(seed)
    x = rng.random((1, 3, size, size)).astype(np.float32)
    y = np.clip(x + rng.normal(0, 0.1, x.shape).astype(np.float32), 0, 1)
    return x, y


def test_lpips_matches_jax_and_the_reference_modules(weights):
    x, y = _images()
    net = convert.lpips_params_from_numpy(weights, device="cpu")
    with torch.no_grad():
        ours = float(net(torch.from_numpy(x), torch.from_numpy(y)))
        same = float(net(torch.from_numpy(x), torch.from_numpy(x)))
    jw = {k: jnp.asarray(v) for k, v in weights.items()}
    ref_jax = float(lpips_jax.lpips(jw, jnp.asarray(x), jnp.asarray(y)))
    ref_torch = _torch_lpips(weights, x, y)
    assert ours > 0
    np.testing.assert_allclose(ours, ref_jax, rtol=RTOL)
    np.testing.assert_allclose(ours, ref_torch, rtol=RTOL)
    assert abs(same) < 1e-8


def test_lpips_gradient_matches_jax(weights):
    x, y = _images(seed=2)
    net = convert.lpips_params_from_numpy(weights, device="cpu")
    xt = torch.from_numpy(x).requires_grad_(True)
    (g,) = torch.autograd.grad(net(xt, torch.from_numpy(y)), xt)
    jw = {k: jnp.asarray(v) for k, v in weights.items()}
    ref = np.asarray(jax.grad(lambda a: lpips_jax.lpips(
        jw, a, jnp.asarray(y)))(jnp.asarray(x)))
    err = np.abs(g.numpy() - ref).max() / np.abs(ref).max()
    assert err < GRAD_TOL, err


def test_schema_matches_jax_and_validates(tmp_path, weights):
    assert tlpips.expected_weight_schema() == \
        lpips_jax.expected_weight_schema()
    good = str(tmp_path / "good.npz")
    np.savez(good, **weights)
    assert set(tlpips.load_weights_npz(good)) == set(weights)

    bad1 = dict(weights)
    del bad1["lin4_w"]
    np.savez(str(tmp_path / "miss.npz"), **bad1)
    with pytest.raises(ValueError, match="missing=\\['lin4_w'\\]"):
        tlpips.load_weights_npz(str(tmp_path / "miss.npz"))
    bad2 = dict(weights, conv0_w=np.zeros((64, 3, 5, 5), np.float32))
    np.savez(str(tmp_path / "shape.npz"), **bad2)
    with pytest.raises(ValueError, match="conv0_w"):
        tlpips.load_weights_npz(str(tmp_path / "shape.npz"))


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_export_weights_npz_reads_in_both_packages(tmp_path, writer):
    params = _make_random_weights(seed=2)
    vgg_state = {}
    for ci, i in enumerate(_CONV_IDX):
        vgg_state[f"{i}.weight"] = torch.from_numpy(params[f"conv{ci}_w"])
        vgg_state[f"{i}.bias"] = torch.from_numpy(params[f"conv{ci}_b"])
    lin_state = {f"{i}.1.weight": torch.from_numpy(params[f"lin{i}_w"])
                 for i in range(5)}
    out = str(tmp_path / "lpips.npz")
    (tlpips if writer == "port" else lpips_jax).export_weights_npz(
        out, vgg_state, lin_state)
    for loaded in (tlpips.load_weights_npz(out),
                   lpips_jax.load_weights_npz(out)):
        assert set(loaded) == set(params)
        for k in params:
            np.testing.assert_array_equal(np.asarray(loaded[k]), params[k])
    net = tlpips.make_lpips_fn(out, device="cpu")
    assert isinstance(net, tlpips.LPIPS)
    np.testing.assert_array_equal(net.conv3_w.numpy(), params["conv3_w"])


def test_make_lpips_fn_warns_without_weights():
    with pytest.warns(UserWarning, match="DISABLED"):
        assert tlpips.make_lpips_fn(None) is None
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert tlpips.make_lpips_fn(None, quiet=True) is None


def test_lpips_term_of_the_stage2_loss(weights):
    """frame_loss with an lpips_fn adds lambda_lpips times the LPIPS of the
    clamped render and the masked GT, and reports it in aux; without one
    aux["lpips"] is NaN.  The LPIPS is JAX's on the same images (the cut
    avatar of tests/test_torch_train_appearance.py, 96 x 64)."""
    from test_torch_train_appearance import (CAM_IDX, H, RASTER, T_STEP, W,
                                             _avatar, _inputs, _port_args,
                                             _port_params)
    from mpmavatar_tpu_torch.data import OptimizationParams
    from mpmavatar_tpu_torch.render import bench_render
    from mpmavatar_tpu_torch.train import appearance as tapp

    _, _, avatar, arrays = _avatar()
    gt, msk = _inputs()
    scene = dict(avatar=avatar, arrays=arrays, gt=gt, msk=msk,
                 cam=bench_render.look_down_z(W, H, 1400.0 * W / 1500, 2.6,
                                              0.1, 20.0))
    params = _port_params(scene)
    args = _port_args(scene)
    net = convert.lpips_params_from_numpy(weights, device="cpu")
    opt = OptimizationParams()
    runs = {}
    for name, fn in (("without", None), ("with", net)):
        loss, aux, _ = tapp.make_loss_and_grads(
            avatar, opt, 3, False, lpips_fn=fn, **RASTER)(params, *args)
        runs[name] = (float(loss), aux)
    assert np.isnan(float(runs["without"][1]["lpips"]))
    lp = float(runs["with"][1]["lpips"])
    with torch.no_grad():
        rendering, _ = tapp.render_avatar_frame(
            avatar, params, avatar.select_verts(params, T_STEP), args[5],
            scene["cam"], CAM_IDX, 3, torch.zeros(3), False, **RASTER)
    rendering = np.clip(rendering.numpy(), 0, 1)
    jw = {k: jnp.asarray(v) for k, v in weights.items()}
    ref = float(lpips_jax.lpips(jw, jnp.asarray(rendering[None]),
                                jnp.asarray((gt * msk)[None])))
    assert lp > 0
    np.testing.assert_allclose(lp, ref, rtol=RTOL)
    np.testing.assert_allclose(runs["with"][0] - runs["without"][0],
                               opt.lambda_lpips * lp, rtol=1e-4)
