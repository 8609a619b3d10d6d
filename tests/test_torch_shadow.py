"""The port's quasi-shadow UNet against the JAX package on the CPU: the
forward with the JAX package's weights carried across (shadow_size 32 and
64, so the encoder's antialiased 2x shrinks, the decoder's 2x growth and
the growth to the 256 UV map all run, edges included), the resize alone
against ``jax.image.resize`` at two sizes, and the UV lookup."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_core import t

from mpmavatar_tpu.render import shadow as jsh

from mpmavatar_tpu_torch.render import shadow as tsh

torch.set_num_threads(1)

# float32 3x3 convolutions and bilinear weights summed in another order
TOL = 2e-6


def _jax_params(shadow_size, seed=0):
    rng = np.random.default_rng(seed)
    ao_mean = (0.4 + 0.5 * rng.random((1, shadow_size, shadow_size))
               ).astype(np.float32)
    params = jsh.init_shadow_unet(jax.random.PRNGKey(seed), ao_mean,
                                  shadow_size=shadow_size, n_dims=4)
    # nonzero untied biases so the bias layouts are exercised
    for k in list(params):
        if k.endswith("_b"):
            params[k] = jnp.asarray(0.1 * rng.normal(
                size=params[k].shape).astype(np.float32))
    return params


@pytest.mark.parametrize("shadow_size", [32, 64])
def test_shadow_unet_matches_jax(shadow_size):
    params = _jax_params(shadow_size)
    ao = (0.3 + 0.6 * np.random.default_rng(1).random(
        (1, 1, 48, 48))).astype(np.float32)       # resized to shadow_size
    ref = jsh.shadow_unet_apply(params, jnp.asarray(ao))
    out = tsh.shadow_unet_apply({k: t(v) for k, v in params.items()}, t(ao))
    for key in ("shadow_map", "shadow_map_lowres", "ao_map"):
        assert out[key].shape == ref[key].shape
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]),
                                   atol=TOL, err_msg=key)
    assert out["shadow_map"].shape == (1, 1, 256, 256)


@pytest.mark.parametrize("src,dst", [(64, 32), (32, 64), (48, 32),
                                     (20, 96)])
def test_resize_matches_jax_image_resize(src, dst):
    x = np.random.default_rng(src + dst).normal(
        size=(1, 3, src, src)).astype(np.float32)
    ref = jax.image.resize(jnp.asarray(x), (1, 3, dst, dst),
                           method="bilinear")
    out = tsh._resize(t(x), (dst, dst))
    # relative to the largest value (standard normal inputs reach ~4)
    ref = np.asarray(ref)
    np.testing.assert_allclose(out.numpy(), ref,
                               atol=TOL * np.abs(ref).max())


def test_init_shadow_unet_shapes_match_jax():
    ao_mean = np.full((1, 64, 64), 0.5, np.float32)
    ref = jsh.init_shadow_unet(jax.random.PRNGKey(0), ao_mean,
                               shadow_size=32, n_dims=4)
    out = tsh.init_shadow_unet(0, ao_mean, shadow_size=32, n_dims=4,
                               device="cpu")
    assert set(out) == set(ref)
    for k in ref:
        assert tuple(out[k].shape) == tuple(np.shape(ref[k])), k
    np.testing.assert_allclose(out["ao_mean"].numpy(),
                               np.asarray(ref["ao_mean"]), atol=TOL)


def test_grid_sample_bilinear_matches_jax():
    rng = np.random.default_rng(2)
    img = rng.random((2, 16, 24)).astype(np.float32)
    uv = rng.uniform(-1.1, 1.1, (500, 2)).astype(np.float32)  # some outside
    ref = jsh.grid_sample_bilinear(jnp.asarray(img), jnp.asarray(uv))
    out = tsh.grid_sample_bilinear(t(img), t(uv))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL)
