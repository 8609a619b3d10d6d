"""The port's training losses (utils/losses.py) against the JAX package's
on seeded (3, 40, 56) images: L1, L2, PSNR, and SSIM's value and
gradient (banded-Toeplitz filtering with zero padding on both sides)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpmavatar_tpu.utils import losses as jl

from mpmavatar_tpu_torch.utils import losses as tl

torch.set_num_threads(1)

SHAPE = (3, 40, 56)
# float32 band products and the SSIM quotient, summed in another order
VALUE_TOL = 1e-6
GRAD_TOL = 1e-5         # relative to the largest gradient entry


def _images(seed=0):
    rng = np.random.default_rng(seed)
    a = rng.random(SHAPE).astype(np.float32)
    # b correlated with a, so SSIM is far from 0 and 1
    b = np.clip(a + rng.normal(0, 0.2, SHAPE), 0, 1).astype(np.float32)
    return a, b


@pytest.mark.parametrize("name", ["l1_loss", "l2_loss", "psnr"])
def test_pixel_losses_match_jax(name):
    a, b = _images(1)
    ref = float(getattr(jl, name)(jnp.asarray(a), jnp.asarray(b)))
    out = float(getattr(tl, name)(torch.tensor(a), torch.tensor(b)))
    assert out == pytest.approx(ref, rel=1e-6)


@pytest.mark.parametrize("batched", [False, True])
def test_ssim_value_and_gradient_match_jax(batched):
    a, b = _images(2)
    if batched:
        a, b = np.stack([a, b[::-1]]), np.stack([b, a])
    ref, ref_grad = jax.value_and_grad(
        lambda x: jl.ssim(x, jnp.asarray(b)))(jnp.asarray(a))
    x = torch.tensor(a, requires_grad=True)
    out = tl.ssim(x, torch.tensor(b))
    (grad,) = torch.autograd.grad(out, x)
    assert 0.2 < float(ref) < 0.9
    assert abs(float(out.detach()) - float(ref)) < VALUE_TOL
    ref_grad = np.asarray(ref_grad)
    err = np.abs(grad.numpy() - ref_grad).max() / np.abs(ref_grad).max()
    assert err < GRAD_TOL
    per_image = tl.ssim(torch.tensor(a), torch.tensor(b),
                        size_average=False)
    np.testing.assert_allclose(
        per_image.numpy(), np.asarray(jl.ssim(jnp.asarray(a), jnp.asarray(b),
                                              size_average=False)),
        atol=VALUE_TOL)


def test_ssim_of_an_image_with_itself_is_one():
    a, _ = _images(3)
    assert float(tl.ssim(torch.tensor(a), torch.tensor(a))) == \
        pytest.approx(1.0, abs=1e-6)
