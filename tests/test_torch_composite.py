"""K6 (segment compositing) and K7 (its VJP) of the PyTorch port against
the JAX package: the plain versions (and the CPU wrappers, which run them)
against pallas_composite.segment_composite and _seg_bwd_pallas in
interpret mode at C = 32 and 128, items made only of sentinels, and the
CPU gradient against the JAX custom VJP.

An alpha within 1e-4 (relative) of the 1/255 cutoff is a rounding tie
between two exp implementations: the tests count the pixels with such an
evaluation (a few in ~200k) and hold the outputs on the others."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_core import t

from mpmavatar_tpu.render import pallas_composite as jpc

from mpmavatar_tpu_torch.ops import composite as tcomp

torch.set_num_threads(1)

NC = 3
# max |a - b| over an output, absolute: colours and transmittance are in
# [0, 1]; float32 products in another order (the JAX kernel's doubling
# cumprod and matmul against a sequential product)
TOL = 2e-6
GRAD_TOL = 2e-5


def _items(w, c, seed=0, fill=0.7):
    """(pgT (W, 6+NC, C), pix0 (W, 2)): per item, a tile origin and C
    gaussians around it (a ``fill`` share real, the rest sentinels)."""
    rng = np.random.default_rng(seed)
    pix0 = (16.0 * rng.integers(0, 8, (w, 2))).astype(np.float32)
    pg = np.zeros((w, 6 + NC, c), np.float32)
    pg[:, 0:2] = pix0[:, :, None] + rng.uniform(-6, 22, (w, 2, c))
    sig = rng.uniform(1.0, 6.0, (w, 2, c))
    rho = rng.uniform(-0.6, 0.6, (w, c))
    det = 1.0 - rho ** 2
    pg[:, 2] = 1.0 / (sig[:, 0] ** 2 * det)
    pg[:, 3] = -rho / (sig[:, 0] * sig[:, 1] * det)
    pg[:, 4] = 1.0 / (sig[:, 1] ** 2 * det)
    pg[:, 5:5 + NC] = rng.random((w, NC, c))
    pg[:, 5 + NC] = rng.uniform(0.05, 1.0, (w, c))
    sentinel = rng.random((w, c)) > fill
    pg[:, 0:2][np.broadcast_to(sentinel[:, None], (w, 2, c))] = -1e6
    pg[:, 2:][np.broadcast_to(sentinel[:, None], (w, 4 + NC, c))] = 0.0
    return pg, pix0


def _tied_pixels(pg, pix0, rel=1e-4):
    """(W, 256) bool: pixels with an alpha near the cutoff."""
    _, alpha = tcomp.segment_power_alpha(t(pg), t(pix0), NC)
    near = (alpha - tcomp.ALPHA_MIN).abs() < rel * tcomp.ALPHA_MIN
    return near.any(dim=1).numpy()


def _jax(pg, pix0):
    w = pg.shape[0]
    return np.asarray(jpc.segment_composite(
        jnp.asarray(pg), jnp.asarray(pix0), NC, jpc.pick_block(w), True))


@pytest.mark.parametrize("c", [32, 128])
def test_segment_composite_plain_matches_pallas_interpret(c):
    pg, pix0 = _items(24, c, seed=c)
    tied = _tied_pixels(pg, pix0)
    assert tied.sum() <= 8
    ref = _jax(pg, pix0)
    out = tcomp.segment_composite_plain(t(pg), t(pix0), NC)
    assert out.shape == (24, NC + 1, 256)
    keep = np.broadcast_to(~tied[:, None, :], out.shape)
    np.testing.assert_allclose(out.numpy()[keep], ref[keep], atol=TOL)
    # the CPU wrapper runs the plain version
    np.testing.assert_allclose(tcomp.segment_composite(
        t(pg), t(pix0), NC).numpy(), out.numpy(), atol=0)
    # the scene exercises the cutoffs and real occlusion
    power, alpha = tcomp.segment_power_alpha(t(pg), t(pix0), NC)
    assert int((alpha < tcomp.ALPHA_MIN).sum()) > 0
    assert float(out[:, NC].min()) < 0.1


def test_sentinel_only_items_are_the_identity():
    """Items of sentinels only (id n: means -1e6, opacity 0) give colour 0
    and transmittance 1, as phase 2's tail items must."""
    pg = np.zeros((8, 6 + NC, 32), np.float32)
    pg[:, 0:2] = -1e6
    pix0 = (16.0 * np.arange(16, dtype=np.float32)).reshape(8, 2)
    ref = _jax(pg, pix0)
    out = tcomp.segment_composite(t(pg), t(pix0), NC).numpy()
    np.testing.assert_array_equal(out[:, :NC], 0.0)
    np.testing.assert_array_equal(out[:, NC], 1.0)
    np.testing.assert_array_equal(out, ref)


def test_segment_composite_gradient_matches_jax_vjp():
    """Autograd over the plain version (the CPU backward) against the JAX
    custom VJP, whose backward is K7 in interpret mode."""
    pg, pix0 = _items(8, 32, seed=6)
    assert not _tied_pixels(pg, pix0).any()
    cot = np.random.default_rng(9).normal(size=(8, NC + 1, 256)).astype(
        np.float32)
    _, vjp = jax.vjp(lambda a: jpc.segment_composite(
        a, jnp.asarray(pix0), NC, 8, True), jnp.asarray(pg))
    (ref,) = vjp(jnp.asarray(cot))
    x = t(pg).requires_grad_(True)
    out = tcomp.segment_composite(x, t(pix0), NC)
    (grad,) = torch.autograd.grad(out, x, t(cot))
    ref = np.asarray(ref)
    scale = np.abs(ref).max(axis=(0, 2), keepdims=True)
    # per parameter row, relative to its largest gradient
    np.testing.assert_array_less(
        np.abs(grad.numpy() - ref) / scale, GRAD_TOL)


@pytest.mark.parametrize("c", [32, 128])
def test_segment_composite_vjp_plain_matches_pallas_interpret(c):
    """K7's plain version against _seg_bwd_pallas in interpret mode, a
    seeded cotangent on every row (the transmittance row too), means off
    the pixel grid; per parameter row, relative to its largest gradient,
    on the items with no alpha near the cutoff (a flip there moves every
    gradient of the pixel).  The CPU wrapper of K7 runs the plain
    version."""
    pg, pix0 = _items(16, c, seed=100 + c)
    keep = ~_tied_pixels(pg, pix0).any(axis=1)
    assert keep.sum() >= 12
    cot = np.random.default_rng(c).normal(size=(16, NC + 1, 256)).astype(
        np.float32)
    ref = np.asarray(jpc._seg_bwd_pallas(
        jnp.asarray(pg), jnp.asarray(pix0), jnp.asarray(cot), NC,
        jpc.pick_block(16), True))
    out = tcomp.segment_composite_vjp_plain(t(pg), t(pix0), t(cot), NC)
    assert out.shape == pg.shape
    scale = np.abs(ref[keep]).max(axis=(0, 2), keepdims=True)
    assert (scale > 0).all()
    np.testing.assert_array_less(
        np.abs(out.numpy()[keep] - ref[keep]) / scale, GRAD_TOL)
    np.testing.assert_array_equal(
        tcomp.segment_composite_vjp(t(pg), t(pix0), t(cot), NC).numpy(),
        out.numpy())
    # the transmittance cotangent reaches the geometry and opacity rows
    cot_t = cot.copy()
    cot_t[:, :NC] = 0.0
    only_t = tcomp.segment_composite_vjp_plain(t(pg), t(pix0), t(cot_t),
                                               NC).numpy()
    assert np.abs(only_t[:, [0, 1, 2, 3, 4, 5 + NC]]).max() > 0.0
    np.testing.assert_array_equal(only_t[:, 5:5 + NC], 0.0)


def test_segment_composite_vjp_of_sentinel_items_is_zero():
    """Items of sentinels only get an exactly zero gradient, as in JAX."""
    pg = np.zeros((8, 6 + NC, 32), np.float32)
    pg[:, 0:2] = -1e6
    pix0 = (16.0 * np.arange(16, dtype=np.float32)).reshape(8, 2)
    cot = np.random.default_rng(3).normal(size=(8, NC + 1, 256)).astype(
        np.float32)
    ref = np.asarray(jpc._seg_bwd_pallas(
        jnp.asarray(pg), jnp.asarray(pix0), jnp.asarray(cot), NC, 8, True))
    out = tcomp.segment_composite_vjp(t(pg), t(pix0), t(cot), NC).numpy()
    np.testing.assert_array_equal(out, 0.0)
    np.testing.assert_array_equal(ref, 0.0)


def test_segment_composite_rejects_bad_shapes():
    pg, pix0 = _items(4, 32)
    with pytest.raises(ValueError):
        tcomp.segment_composite(t(pg), t(pix0), NC + 1)
    with pytest.raises(ValueError):
        tcomp.segment_composite(t(pg), t(pix0[:3]), NC)
    with pytest.raises(ValueError):
        tcomp.segment_composite(t(pg[:, :, :0]), t(pix0), NC)
    with pytest.raises(ValueError):
        tcomp.segment_composite_vjp(t(pg), t(pix0),
                                    torch.zeros((4, NC, 256)), NC)
