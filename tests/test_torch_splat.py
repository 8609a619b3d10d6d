"""K4 (the collider/mover splat) of the PyTorch port against the JAX
package: the plain version against stepping.rasterize_to_grid and against
the Pallas column kernel in interpret mode (splat_columns_fused), on
random points that include points with base G - 3 (dropped whole by the
reference's asymmetric bounds check) and points below 0."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_core import t

from mpmavatar_tpu.core import stepping as jstep
from mpmavatar_tpu.core import types as jtypes
from mpmavatar_tpu.ops import pallas_transfer as pt

from mpmavatar_tpu_torch.ops import splat as tsplat

torch.set_num_threads(1)

G = 32
DX = 2.0 / G
# max |a - b| / max |ref|: float32 sums in another order
TOL_SCATTER = 1e-6      # against the XLA scatter
TOL_COLUMNS = 1e-5      # against the column kernel (MXU-style products)


def _cfg():
    return jtypes.MPMStaticConfig(n_elements=0, n_traditional=1,
                                  n_vertices=0, n_grid=G, grid_lim=2.0)


def _points(n=300, ch=6, seed=0):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(0.1, 1.9, (n, 3)).astype(np.float32)
    # base G - 3 on one axis (grid_pos - 0.5 in [G - 3, G - 2)): dropped
    pts[:6, 0] = ((G - 2.3) * DX + rng.uniform(0, 0.5 * DX, 6))
    pts[6:12, 2] = ((G - 2.2) * DX + rng.uniform(0, 0.5 * DX, 6))
    # base G - 4 (kept) and base 0 (kept)
    pts[12:18, 1] = (G - 3.2) * DX
    pts[18:24] = 0.6 * DX + rng.uniform(0, 0.3 * DX, (6, 3))
    # below 0 and base -1: dropped
    pts[24:30, 1] = -rng.uniform(0.01, 0.2, 6)
    pts[30:36] = 0.2 * DX
    vals = rng.normal(size=(n, ch)).astype(np.float32)
    return pts, vals


def _rel(a, b):
    b = np.asarray(b)
    return float(np.abs(np.asarray(a) - b).max()) / float(np.abs(b).max())


@pytest.mark.parametrize("ch", [3, 6])
def test_splat_plain_matches_rasterize_to_grid(ch):
    pts, vals = _points(ch=ch)
    gv_ref, gw_ref = jstep.rasterize_to_grid(_cfg(), jnp.asarray(pts),
                                             jnp.asarray(vals), G ** 3)
    gv, gw = tsplat.splat(t(pts), t(vals), G, G / 2.0)
    assert gv.shape == (G ** 3, ch) and gw.shape == (G ** 3,)
    assert _rel(gw, gw_ref) <= TOL_SCATTER
    assert _rel(gv, gv_ref) <= TOL_SCATTER


def test_splat_plain_matches_pallas_interpret():
    pts, vals = _points(n=200)
    b_v, b_w, overflow = pt.splat_columns_fused(
        _cfg(), jnp.asarray(pts), jnp.asarray(vals), 8, interpret=True)
    assert int(overflow) == 0
    gv, gw = tsplat.splat(t(pts), t(vals), G, G / 2.0)
    assert _rel(gw, b_w) <= TOL_COLUMNS
    assert _rel(gv, b_v) <= TOL_COLUMNS


def test_splat_bounds_check_drops_whole_points():
    """A point with base G - 3 or below 0 on any axis contributes nothing;
    one with base G - 4 or 0 keeps all 27 nodes (weights sum to 1)."""
    pts, vals = _points()
    keep = np.all((np.floor(pts * G / 2.0 - 0.5) >= 0)
                  & (np.floor(pts * G / 2.0 - 0.5) < G - 3), axis=-1)
    assert (~keep[:12]).all() and keep[12:24].all() and (~keep[24:36]).all()
    _, gw = tsplat.splat(t(pts), t(vals), G, G / 2.0)
    np.testing.assert_allclose(float(gw.sum()), float(keep.sum()),
                               rtol=1e-5)


def test_splat_without_bounds_check_uses_the_scatter_rule():
    """bounds_check=False: every node is scattered with the JAX scatter's
    index rule (an index in [-G^3, 0) wraps, the rest outside [0, G^3)
    drops), as ``.at[].add(mode="drop")`` computes it."""
    pts, vals = _points(ch=3)
    base, _, w, _ = jstep.bspline(jnp.asarray(pts), G / 2.0)
    w27 = jstep._stencil_products(w)
    flat = jstep._flat_indices(base, G).reshape(-1)
    ref_w = jnp.zeros((G ** 3,)).at[flat].add(w27.reshape(-1), mode="drop")
    ref_v = jnp.zeros((G ** 3, 3)).at[flat].add(
        (w27[..., None] * jnp.asarray(vals)[:, None, :]).reshape(-1, 3),
        mode="drop")
    gv, gw = tsplat.splat(t(pts), t(vals), G, G / 2.0, bounds_check=False)
    assert _rel(gw, ref_w) <= TOL_SCATTER
    assert _rel(gv, ref_v) <= TOL_SCATTER


def test_splat_rejects_bad_shapes():
    with pytest.raises(ValueError):
        tsplat.splat(torch.zeros((4, 2)), torch.zeros((4, 3)), 8, 4.0)
    with pytest.raises(ValueError):
        tsplat.splat(torch.zeros((4, 3)), torch.zeros((5, 3)), 8, 4.0)
