"""The port's rasterizer against the JAX package on the CPU: projection,
the (tile, depth)-sorted instances (packed and two-key sorts, footprint
tiers, big_overflow) with exact equality, ``rasterize`` through the dense
compositor (work_cap=0, and two-tier) and the worklist compositor (K6's
plain version against K6 in interpret mode; chunk 32 and 128, stop_eps
with tiers, an overflowing work_cap), the gradient wrt opacity, and a
frame's autograd graph, which holds no gather of the parameter table by
the worklists' (W, C) ids (K6 gathers them itself).

Scenes keep their depths 1e-3 apart (the depth rank decides the
compositing order, so an ulp of difference between two matmuls must not
swap two gaussians)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_rasterizer import simple_camera
from test_torch_core import np_fields, t

from mpmavatar_tpu.render import camera_arrays as jcamera_arrays
from mpmavatar_tpu.render import rasterizer as jr
from mpmavatar_tpu.render.geometry import \
    covariance_from_scaling_rotation as jcov

from mpmavatar_tpu_torch import convert
from mpmavatar_tpu_torch.render import rasterizer as tr

torch.set_num_threads(1)

# image and alpha, absolute: float32 sums in another order
IMG_TOL = 1e-5
GRAD_TOL = 1e-4


def _scene(n=1000, seed=0, spread=0.3, scale=(0.01, 0.05), behind=0):
    """Gaussians with distinct depths (z a permutation of a 1e-3-spaced
    grid), random anisotropic covariances; ``behind`` of them behind the
    camera (z < -3)."""
    rng = np.random.default_rng(seed)
    xyz = rng.normal(0, spread, (n, 3)).astype(np.float32)
    xyz[:, 2] = rng.permutation(np.linspace(-0.6, 0.6, n)).astype(
        np.float32)
    xyz[:behind, 2] = -3.5 - rng.random(behind)
    colors = rng.random((n, 3)).astype(np.float32)
    opac = (0.3 + 0.6 * rng.random(n)).astype(np.float32)
    scales = rng.uniform(*scale, (n, 3)).astype(np.float32)
    rots = rng.normal(size=(n, 4)).astype(np.float32)
    cov = np.asarray(jcov(jnp.asarray(scales), 1.0, jnp.asarray(rots)))
    return xyz, colors, opac, cov


def _cams(w=64, h=64, f=60.0):
    """The test camera for JAX, and the port's copy of JAX's arrays."""
    cam = simple_camera(w, h, f)
    jca = jcamera_arrays(cam)
    tca = convert.camera_arrays_from_numpy(np_fields(jca), "cpu")
    for name in np_fields(jca):
        assert torch.equal(getattr(tca, name),
                           getattr(tr.camera_arrays(cam, "cpu"), name)), name
    return cam, jca, tca


def _both(xyz, colors, opac, cov, w=64, h=64, f=60.0, **kw):
    _, jca, tca = _cams(w, h, f)
    ref = jr.rasterize(jnp.asarray(xyz), jnp.asarray(colors),
                       jnp.asarray(opac), jnp.asarray(cov), jca,
                       jnp.zeros(3), w, h, **kw)
    out = tr.rasterize(t(xyz), t(colors), t(opac), t(cov), tca,
                       torch.zeros(3), w, h, **kw)
    return out, {k: np.asarray(v) for k, v in ref.items()}


def _assert_same_frame(out, ref):
    for key in ("render", "alpha"):
        assert out[key].shape == ref[key].shape
        np.testing.assert_allclose(out[key].numpy(), ref[key], atol=IMG_TOL,
                                   err_msg=key)
    for key in ("radii", "tile_counts", "big_overflow", "work_overflow"):
        np.testing.assert_array_equal(out[key].numpy(), ref[key],
                                      err_msg=key)
    np.testing.assert_allclose(out["depth"].numpy(), ref["depth"],
                               atol=1e-6)


def test_project_gaussians_matches_jax():
    xyz, _, _, cov = _scene(300, seed=1, behind=20)
    _, jca, tca = _cams()
    ref = jr.project_gaussians(jnp.asarray(xyz), jnp.asarray(cov), jca,
                               64, 64)
    out = tr.project_gaussians(t(xyz), t(cov), tca, 64, 64)
    m2d, depth, conic, radius, vis = (np.asarray(r) for r in ref)
    assert (~vis).sum() == 20
    np.testing.assert_allclose(out[0].numpy()[vis], m2d[vis], atol=1e-4)
    np.testing.assert_allclose(out[1].numpy(), depth, atol=1e-6)
    np.testing.assert_allclose(out[2].numpy()[vis], conic[vis], rtol=2e-5)
    np.testing.assert_array_equal(out[3].numpy(), radius)
    np.testing.assert_array_equal(out[4].numpy(), vis)


def _instances_inputs(n, seed, width, height):
    """Screen-space inputs handed to both packages' _sorted_instances:
    footprints from 1 to ~20 tiles across, some invalid."""
    rng = np.random.default_rng(seed)
    means2d = np.stack([rng.uniform(-40, width + 40, n),
                        rng.uniform(-40, height + 40, n)], -1).astype(
        np.float32)
    depth = rng.permutation(np.linspace(0.5, 5.0, n)).astype(np.float32)
    radius = np.ceil(rng.choice([3.0, 12.0, 40.0, 160.0], n,
                                p=[0.6, 0.25, 0.1, 0.05])
                     * rng.uniform(0.5, 1.0, n)).astype(np.float32)
    valid = rng.random(n) > 0.1
    radius[~valid] = 0.0
    return means2d, depth, radius, valid


@pytest.mark.parametrize("case", ["packed", "packed_tiers", "two_key"])
def test_sorted_instances_match_jax_exactly(case):
    if case == "two_key":
        # (T+1)(N+1) >= 2^31 takes the lexicographic two-key sort
        n, width, height = 300, 4096 * 16, 1800 * 16
    else:
        n, width, height = 400, 160, 128
    means2d, depth, radius, valid = _instances_inputs(n, 3, min(width, 640),
                                                      min(height, 480))
    kw = {} if case == "packed" else {
        "tiers": ((2, None), (4, 24), (6, 8), (9, 4))}
    tiles = ((width + 15) // 16) * ((height + 15) // 16)
    assert ((tiles + 1) * (n + 1) < 2 ** 31) == (case != "two_key")
    ref = jr._sorted_instances(jnp.asarray(means2d), jnp.asarray(depth),
                               jnp.asarray(radius), jnp.asarray(valid),
                               width, height, 36, **kw)
    out = tr._sorted_instances(t(means2d), t(depth), t(radius), t(valid),
                               width, height, 36, **kw)
    names = ("tile_sorted", "gauss_sorted", "edges", "big_overflow")
    for name, a, b in zip(names, out, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                      err_msg=name)
    if case != "packed":
        assert int(out[3]) > 0          # stragglers and clipped rects


@pytest.mark.parametrize("two_tier", [False, True])
def test_rasterize_dense_matches_jax(two_tier):
    kw = dict(tile_capacity=256)
    if two_tier:
        kw.update(tile_capacity_lo=32, hot_tiles=16)
    out, ref = _both(*_scene(1200, seed=2), **kw)
    _assert_same_frame(out, ref)
    assert float(ref["alpha"].max()) > 0.9


@pytest.mark.parametrize("chunk", [32, 128])
def test_rasterize_worklist_matches_jax(chunk):
    out, ref = _both(*_scene(1200, seed=4), tile_capacity=256,
                     work_cap=512, chunk=chunk)
    assert int(ref["work_overflow"]) == 0
    assert int(out["n_items"]) > 0
    _assert_same_frame(out, ref)


def test_rasterize_worklist_stop_eps_and_tiers_match_jax():
    """The big-splat configuration's knobs at test size: early tile stop,
    explicit tiers, 128-wide chunks."""
    scene = _scene(800, seed=6, spread=0.5, scale=(0.15, 0.4))
    kw = dict(tile_capacity=512, chunk=128, work_cap=64,
              tiers=((2, None), (3, 400), (4, 300)))
    out, ref = _both(*scene, stop_eps=1e-3, **kw)
    assert int(ref["work_overflow"]) == 0
    assert int(ref["big_overflow"]) > 0     # the tiers' stragglers
    _assert_same_frame(out, ref)
    full, _ = _both(*scene, **kw)
    # stop_eps skipped some phase-2 items and moved no pixel by more
    # than the transmittance it stopped at
    assert int(out["n_items"]) < int(full["n_items"])
    assert float((out["render"] - full["render"]).abs().max()) < 1e-3


def test_rasterize_worklist_overflow_matches_jax():
    """A work_cap too small: both drop the same items and report the same
    overflow."""
    out, ref = _both(*_scene(1200, seed=4), tile_capacity=256, work_cap=8)
    assert int(ref["work_overflow"]) > 0
    assert int(out["n_items"]) == 8 + int(ref["work_overflow"])
    _assert_same_frame(out, ref)


def test_rasterize_gradient_wrt_opacity_matches_jax():
    """The CPU gradient through K6's plain version against jax.grad of
    rasterize (the custom VJP, K7 in interpret mode)."""
    xyz, colors, opac, cov = _scene(600, seed=8)
    _, jca, tca = _cams()

    def jloss(op):
        o = jr.rasterize(jnp.asarray(xyz), jnp.asarray(colors), op,
                         jnp.asarray(cov), jca, jnp.zeros(3), 64, 64,
                         tile_capacity=256, work_cap=512)
        return jnp.sum(o["render"] ** 2)

    ref = np.asarray(jax.grad(jloss)(jnp.asarray(opac)))
    op = t(opac).requires_grad_(True)
    o = tr.rasterize(t(xyz), t(colors), op, t(cov), tca, torch.zeros(3),
                     64, 64, tile_capacity=256, work_cap=512)
    (grad,) = torch.autograd.grad(torch.sum(o["render"] ** 2), op)
    assert float(np.abs(ref).max()) > 1.0
    np.testing.assert_allclose(grad.numpy(), ref, atol=GRAD_TOL)


def _graph_nodes(out):
    """Every node of ``out``'s autograd graph."""
    nodes, stack = set(), [out.grad_fn]
    while stack:
        node = stack.pop()
        if node is not None and node not in nodes:
            nodes.add(node)
            stack += [f for f, _ in node.next_functions]
    return nodes


def test_rasterize_worklist_gathers_no_item_parameters_in_autograd():
    """The worklist compositor hands the parameter table and the (W, C)
    instance ids to segment_composite_gather: the graph of a frame holds
    no gather of the table by the ids (whose backward is an index_put
    onto the table's rows), only the compositor's own node."""
    xyz, colors, opac, cov = _scene(600, seed=8)
    _, _, tca = _cams()
    op = t(opac).requires_grad_(True)
    o = tr.rasterize(t(xyz), t(colors), op, t(cov), tca, torch.zeros(3),
                     64, 64, tile_capacity=256, work_cap=512)
    assert int(o["n_items"]) > 0
    nodes = _graph_nodes(torch.sum(o["render"] ** 2))
    index_shapes = [tuple(i.shape) for node in nodes
                    if node.name().startswith("IndexBackward")
                    for i in node._saved_indices if i is not None]
    assert not [s for s in index_shapes if len(s) == 2], index_shapes
    assert "_SegmentCompositeBackward" in {node.name() for node in nodes}
