"""K6 (segment compositing) and K7 (its VJP) of the PyTorch port against
the JAX package: the plain versions (and the CPU wrappers, which run them)
against pallas_composite.segment_composite and _seg_bwd_pallas in
interpret mode at C = 32 and 128, items made only of sentinels, and the
CPU gradient against the JAX custom VJP; the gathered entry
(segment_composite_gather: a parameter table and per-item ids, the
rasterizer's call) against JAX's gather + segment_composite, its
gradient w.r.t. the table against jax.vjp, and the per-slot wrappers
against it.

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


def _table_items(w, c, seed, n=None):
    """(packed (N+1, 6+NC), ids (W, C) int64, pix0 (W, 2)): N gaussians
    over a 64 x 64 pixel patch (a 4 x 4 tile block) with the sentinel row
    N (means -1e6, the rest 0), and per item a tile origin and C distinct
    ids in random depth order, each slot live with probability ~0.6
    (sentinels inside the item and at its tail), the last three items all
    sentinels.  With N = 2 C every gaussian sits in several items."""
    rng = np.random.default_rng(seed)
    n = 2 * c if n is None else n
    packed = np.zeros((n + 1, 6 + NC), np.float32)
    packed[:n, 0:2] = rng.uniform(-4, 68, (n, 2))
    sig = rng.uniform(1.0, 6.0, (n, 2))
    rho = rng.uniform(-0.6, 0.6, n)
    det = 1.0 - rho ** 2
    packed[:n, 2] = 1.0 / (sig[:, 0] ** 2 * det)
    packed[:n, 3] = -rho / (sig[:, 0] * sig[:, 1] * det)
    packed[:n, 4] = 1.0 / (sig[:, 1] ** 2 * det)
    packed[:n, 5:5 + NC] = rng.random((n, NC))
    packed[:n, 5 + NC] = rng.uniform(0.05, 1.0, n)
    packed[n, 0:2] = -1e6
    ids = np.stack([rng.permutation(n)[:c] for _ in range(w)])
    ids[rng.random((w, c)) > 0.6] = n
    ids[-3:] = n
    pix0 = (16.0 * rng.integers(0, 4, (w, 2))).astype(np.float32)
    return packed, ids.astype(np.int64), pix0


def _gathered(packed, ids):
    """The items' instances as the per-slot contract lays them out."""
    return np.ascontiguousarray(packed[ids].transpose(0, 2, 1))


@pytest.mark.parametrize("c", [32, 128])
def test_segment_composite_gather_matches_pallas_interpret(c):
    """The gathered entry on the CPU (its plain version) against JAX's
    gather + segment_composite in interpret mode; items of sentinels only
    are the identity."""
    packed, ids, pix0 = _table_items(24, c, seed=200 + c)
    pg = _gathered(packed, ids)
    tied = _tied_pixels(pg, pix0)
    assert tied.sum() <= 8
    ref = _jax(pg, pix0)
    out = tcomp.segment_composite_gather(t(packed), t(ids), t(pix0), NC)
    assert out.shape == (24, NC + 1, 256)
    keep = np.broadcast_to(~tied[:, None, :], out.shape)
    np.testing.assert_allclose(out.numpy()[keep], ref[keep], atol=TOL)
    np.testing.assert_array_equal(tcomp.segment_composite_gather_plain(
        t(packed), t(ids), t(pix0), NC).numpy(), out.numpy())
    np.testing.assert_array_equal(out[-3:, :NC].numpy(), 0.0)
    np.testing.assert_array_equal(out[-3:, NC].numpy(), 1.0)
    # real occlusion in the scene
    assert float(out[:, NC].min()) < 0.1


@pytest.mark.parametrize("c", [32, 128])
def test_segment_composite_gather_gradient_matches_jax_vjp(c):
    """d(table) through the gathered entry's autograd backward (the CPU
    runs K7's plain version) against jax.vjp of JAX's gather +
    segment_composite (its backward _seg_bwd_pallas in interpret mode, then
    the gather's scatter-add) w.r.t. the table: per parameter column,
    relative to its largest gradient, on the rows of gaussians in no item
    with an alpha near the cutoff.  Gaussians sit in several items, so the
    rows are real sums over items; the sentinel row's gradient is exactly
    0 in both."""
    w = 16
    packed, ids, pix0 = _table_items(w, c, seed=300 + c)
    n = len(packed) - 1
    tied_items = _tied_pixels(_gathered(packed, ids), pix0).any(axis=1)
    assert tied_items.sum() <= 2
    cot = np.random.default_rng(c).normal(size=(w, NC + 1, 256)).astype(
        np.float32)
    _, vjp = jax.vjp(lambda p: jpc.segment_composite(
        p[jnp.asarray(ids)].transpose(0, 2, 1), jnp.asarray(pix0), NC,
        jpc.pick_block(w), True), jnp.asarray(packed))
    ref = np.asarray(vjp(jnp.asarray(cot))[0])
    x = t(packed).requires_grad_(True)
    out = tcomp.segment_composite_gather(x, t(ids), t(pix0), NC)
    (grad,) = torch.autograd.grad(out, x, t(cot))
    grad = grad.numpy()
    assert grad[n].tolist() == [0.0] * (6 + NC)
    assert ref[n].tolist() == [0.0] * (6 + NC)
    keep = np.ones(n + 1, bool)
    keep[np.unique(ids[tied_items])] = False
    keep[n] = False
    # live rows summed over two or more items
    live = ids[~tied_items][ids[~tied_items] < n]
    shared = np.flatnonzero(np.bincount(live, minlength=n + 1) >= 2)
    assert keep.sum() >= n // 2 and len(shared) >= n // 4
    scale = np.abs(ref[keep]).max(axis=0)
    assert (scale > 0).all()
    np.testing.assert_array_less(
        np.abs(grad[keep] - ref[keep]) / scale, GRAD_TOL)
    np.testing.assert_array_equal(
        tcomp.segment_composite_gather_vjp(t(packed), t(ids), t(pix0),
                                           t(cot), NC).numpy(), grad)


def test_segment_composite_gather_sentinel_items_give_identity_and_zero():
    """Items of sentinels only: (0, 1) forward, and no gradient at all
    (the sentinel row included), as in JAX."""
    packed, _, _ = _table_items(8, 32, seed=5)
    n = len(packed) - 1
    ids = np.full((8, 32), n, np.int64)
    pix0 = (16.0 * np.arange(16, dtype=np.float32)).reshape(8, 2)
    out = tcomp.segment_composite_gather(t(packed), t(ids), t(pix0), NC)
    np.testing.assert_array_equal(out[:, :NC].numpy(), 0.0)
    np.testing.assert_array_equal(out[:, NC].numpy(), 1.0)
    cot = np.random.default_rng(4).normal(size=(8, NC + 1, 256)).astype(
        np.float32)
    d = tcomp.segment_composite_gather_vjp(t(packed), t(ids), t(pix0),
                                           t(cot), NC)
    np.testing.assert_array_equal(d.numpy(), 0.0)


def test_per_slot_wrappers_equal_the_gathered_path_with_arange_ids():
    """segment_composite and segment_composite_vjp (the per-slot
    contract) against the gathered entry on the slots as a table with a
    sentinel row appended and ids = arange: the same segments and the same
    gradient, the appended row's gradient 0."""
    pg, pix0 = _items(12, 32, seed=11)
    w, rows, c = pg.shape
    table = np.concatenate([pg.transpose(0, 2, 1).reshape(w * c, rows),
                            np.zeros((1, rows), np.float32)])
    table[-1, 0:2] = -1e6
    ids = np.arange(w * c, dtype=np.int64).reshape(w, c)
    cot = np.random.default_rng(12).normal(size=(w, NC + 1, 256)).astype(
        np.float32)
    np.testing.assert_array_equal(
        tcomp.segment_composite(t(pg), t(pix0), NC).numpy(),
        tcomp.segment_composite_gather(t(table), t(ids), t(pix0),
                                       NC).numpy())
    d = tcomp.segment_composite_gather_vjp(t(table), t(ids), t(pix0),
                                           t(cot), NC).numpy()
    np.testing.assert_array_equal(d[-1], 0.0)
    np.testing.assert_array_equal(
        tcomp.segment_composite_vjp(t(pg), t(pix0), t(cot), NC).numpy(),
        d[:-1].reshape(w, c, rows).transpose(0, 2, 1))


def test_segment_composite_gather_rejects_bad_inputs():
    packed, ids, pix0 = _table_items(4, 32, seed=0)
    with pytest.raises(ValueError):
        tcomp.segment_composite_gather(t(packed), t(ids), t(pix0), NC + 1)
    with pytest.raises(ValueError):       # int32 ids
        tcomp.segment_composite_gather(t(packed), t(ids.astype(np.int32)),
                                       t(pix0), NC)
    with pytest.raises(ValueError):
        tcomp.segment_composite_gather(t(packed), t(ids[:3]), t(pix0), NC)
    with pytest.raises(ValueError):
        tcomp.segment_composite_gather(t(packed), t(ids[:, :0]), t(pix0),
                                       NC)
    with pytest.raises(ValueError):
        tcomp.segment_composite_gather_vjp(t(packed), t(ids), t(pix0),
                                           torch.zeros((4, NC, 256)), NC)


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
