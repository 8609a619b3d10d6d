"""K4 (the collider/mover splat) of the PyTorch port against the JAX
package: the plain version against stepping.rasterize_to_grid and against
the Pallas column kernel in interpret mode (splat_columns_fused), on
random points that include points with base G - 3 (dropped whole by the
reference's asymmetric bounds check) and points below 0; on stencil tails
read as K5 reads them (the covered cells and acc / w); and the plain
version's fields against the same points in another order, the premise
of the kernel's per-block tile."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_core import t
from test_torch_cuda import _torso_faces

import chip_fixtures

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


def _as_torch(out):
    return tuple(torch.from_numpy(np.array(o)) for o in out)


def test_splat_plain_reads_stencil_tails_as_jax():
    """Stencil tails (chip_fixtures.tail_lattice: cells that only tails
    reach, weights down to ~1e-19, thousands between 1e-12 and 1e-6 and
    a dozen within 2x of K5's coverage threshold 1e-15): the plain version
    against rasterize_to_grid as K5 reads the fields
    (chip_fixtures.splat_coverage): the covered cells (w > 1e-15) the same
    but at cells whose reference weight lies within 2x of 1e-15, and on the
    cells both cover acc / w within TOL_SCATTER of max |velocity| and the
    unit normal within TOL_SCATTER times its conditioning, w / |acc_n|
    (each a ratio of two float32 sums of at most 3 terms)."""
    pts, vals = chip_fixtures.tail_lattice(8, G)
    ref = _as_torch(jstep.rasterize_to_grid(_cfg(), jnp.asarray(pts),
                                            jnp.asarray(vals), G ** 3))
    out = tsplat.splat(t(pts), t(vals), G, G / 2.0)
    w_ref = ref[1]
    assert bool(((w_ref > 0) & (w_ref < 1e-12)).any())
    assert int(((w_ref >= 1e-12) & (w_ref < 1e-6)).sum()) >= 100
    cover = chip_fixtures.splat_coverage(out, ref, t(vals))
    assert cover["differ"] == cover["threshold"]
    assert cover["velocity"] <= TOL_SCATTER
    assert cover["normal"] <= TOL_SCATTER


@pytest.mark.parametrize("shape", ["torso", "tails"])
def test_splat_plain_does_not_depend_on_point_order(shape):
    """The kernel sums each warp's points in a shared-memory tile and sends
    the tiles to the grid in no fixed order, so its fields may differ from
    the plain version's only by the order of the sums.  The plain version
    on the same points in a seeded random order: each output within
    n 2^-23 of its largest entry, n the most terms on one cell (a float32
    sum of n terms in another order moves by at most (n - 1) 2^-24 of the
    sum of their magnitudes), and as K5 reads it: the covered cells the
    same but within 2x of 1e-15, acc / w and the normal within the same
    tolerance.  On the posed body's 20,736 faces at 128^3 (its pole rings
    pile up to 1,204 points on one cell) and on stencil tails."""
    if shape == "torso":
        pts, vals = _torso_faces("cpu")
        g = 128
    else:
        pts, vals = (t(a) for a in chip_fixtures.tail_lattice(8, G))
        g = G
    perm = torch.randperm(len(pts), generator=torch.Generator().manual_seed(0))
    ref = tsplat.splat_plain(pts, vals, g, g / 2.0)
    out = tsplat.splat_plain(pts[perm], vals[perm], g, g / 2.0)
    base = torch.floor(pts * (g / 2.0) - 0.5).long()
    n_terms = int(torch.bincount(
        tsplat.flat_indices(base, g).reshape(-1).clamp(0, g ** 3 - 1)).max())
    tol = n_terms * 2.0 ** -23
    for a, b in zip(out, ref):
        assert _rel(a, b) <= tol
    cover = chip_fixtures.splat_coverage(out, ref, vals)
    assert cover["differ"] == cover["threshold"]
    assert cover["velocity"] <= tol and cover["normal"] <= tol
