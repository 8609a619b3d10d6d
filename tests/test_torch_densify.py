"""Densification of the port (render/gaussians.py) against the JAX
package on a small body mesh: the view-space statistics, clone + split +
prune in padded capacity, the opacity reset.

Both packages get the same splats, statistics and split offsets (JAX's
``jax.random.normal`` draws, handed to the port as ``normals``), with a
capacity that runs out so that the lowest-priority copies are dropped.
Scales, gradients and opacities are kept off the thresholds (a face
frame an ulp apart must not flip a comparison).  alive, binding and the
copied fields must agree bit for bit; xyz and scaling, which the split
recomputes, to 1e-6."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_core import np_fields, t

from mpmavatar_tpu.render import gaussians as jg

from mpmavatar_tpu_torch import convert
from mpmavatar_tpu_torch.render import bench_render
from mpmavatar_tpu_torch.render import gaussians as tg

torch.set_num_threads(1)

MESH = (5, 6)             # 48 faces
CAP = 64
MAX_GRAD = 1e-3
EXTENT = 1.0
XYZ_TOL = 1e-6


def _scene(seed=0, min_opacity_logit=None):
    """(JAX params, port params, JAX frames, port frames, number of faces,
    stats arrays): every face's splat alive plus four extra on faces 3,
    3, 7 and 20; scales in three bands (clone, split, oversized), each
    away from the thresholds."""
    rng = np.random.default_rng(seed)
    verts, faces = bench_render.build_body_mesh(*MESH)
    nf = len(faces)
    splats = np_fields(jg.init_from_mesh(nf, 1, capacity=CAP))
    extra = {52: 3, 55: 3, 57: 7, 60: 20}
    for slot, face in extra.items():
        splats["binding"][slot] = face
        splats["alive"][slot] = True
    jframes = jg.face_frames_from_verts(jnp.asarray(verts),
                                        jnp.asarray(faces))
    face_scale = np.asarray(jframes.scaling)[:, 0][splats["binding"]]
    band = rng.integers(0, 3, CAP)
    lo = np.array([0.002, 0.012, 0.15])[band]
    hi = np.array([0.008, 0.05, 0.3])[band]
    target = rng.uniform(lo[:, None], hi[:, None], (CAP, 3))
    splats.update(
        xyz=rng.normal(0, 0.3, (CAP, 3)).astype(np.float32),
        features_dc=rng.normal(size=(CAP, 1, 3)).astype(np.float32),
        features_rest=rng.normal(size=(CAP, 3, 3)).astype(np.float32),
        scaling=np.log(target / face_scale[:, None]).astype(np.float32),
        rotation=rng.normal(size=(CAP, 4)).astype(np.float32),
        opacity=rng.choice([-3.0, -0.5, 0.5, 2.0], (CAP, 1)).astype(
            np.float32) + rng.uniform(-0.2, 0.2, (CAP, 1)).astype(
            np.float32))
    stats = dict(
        xyz_gradient_accum=rng.uniform(0, 4e-3, (CAP, 1)).astype(np.float32),
        denom=rng.integers(0, 4, (CAP, 1)).astype(np.float32),
        max_radii2d=rng.uniform(0, 40, CAP).astype(np.float32))
    jparams = jg.GaussianParams(**{k: jnp.asarray(v)
                                   for k, v in splats.items()})
    params = convert.gaussians_from_numpy(splats, "cpu")
    frames = tg.face_frames_from_verts(t(verts), t(faces).long())
    return jparams, params, jframes, frames, nf, stats


def _assert_same(out, ref):
    ref = np_fields(ref)
    for name, a in convert.to_numpy(out).items():
        if name in ("xyz", "scaling"):
            np.testing.assert_allclose(a, ref[name], atol=XYZ_TOL,
                                       rtol=XYZ_TOL, err_msg=name)
        else:
            np.testing.assert_array_equal(a, ref[name], err_msg=name)


def test_add_densification_stats_matches_jax():
    rng = np.random.default_rng(4)
    stats = dict(xyz_gradient_accum=rng.random((CAP, 1)).astype(np.float32),
                 denom=rng.integers(0, 5, (CAP, 1)).astype(np.float32),
                 max_radii2d=rng.uniform(0, 9, CAP).astype(np.float32))
    vgrad = rng.normal(size=(CAP, 2)).astype(np.float32)
    radii = rng.integers(0, 12, CAP).astype(np.float32)
    visible = rng.random(CAP) > 0.3
    ref = jg.add_densification_stats(
        jg.DensifyState(**{k: jnp.asarray(v) for k, v in stats.items()}),
        jnp.asarray(vgrad), jnp.asarray(radii), jnp.asarray(visible))
    out = tg.add_densification_stats(
        convert.densify_state_from_numpy(stats, "cpu"), t(vgrad), t(radii),
        t(visible))
    ref = np_fields(ref)
    out = convert.to_numpy(out)
    np.testing.assert_allclose(out["xyz_gradient_accum"],
                               ref["xyz_gradient_accum"], rtol=1e-6)
    np.testing.assert_array_equal(out["denom"], ref["denom"])
    np.testing.assert_array_equal(out["max_radii2d"], ref["max_radii2d"])


@pytest.mark.parametrize("max_screen_size", [None, 20.0])
def test_densify_and_prune_matches_jax(max_screen_size):
    jparams, params, jframes, frames, nf, stats = _scene()
    key = jax.random.PRNGKey(7)
    normals = np.asarray(jax.random.normal(key, (CAP * 2, 3)))
    ref, ref_ds = jg.densify_and_prune(
        jparams, jg.DensifyState(**{k: jnp.asarray(v)
                                    for k, v in stats.items()}),
        jframes, nf, MAX_GRAD, 0.3, EXTENT, key=key,
        max_screen_size=max_screen_size)
    out, out_ds = tg.densify_and_prune(
        params, convert.densify_state_from_numpy(stats, "cpu"), frames, nf,
        MAX_GRAD, 0.3, EXTENT, normals=t(normals),
        max_screen_size=max_screen_size)
    _assert_same(out, ref)
    for name, a in convert.to_numpy(out_ds).items():
        np.testing.assert_array_equal(a, np.asarray(getattr(ref_ds, name)))
    # the scene exercises clones, splits, the capacity running out and
    # pruning; every face keeps a splat
    alive0 = np.asarray(jparams.alive)
    alive = convert.to_numpy(out)["alive"]
    grads = stats["xyz_gradient_accum"][:, 0] / np.maximum(
        stats["denom"][:, 0], 1e-12)
    assert (alive0 & (grads >= MAX_GRAD)).sum() > (~alive0).sum()
    if max_screen_size is None:
        assert alive[~alive0].all()              # every free slot taken
    assert (alive0 & ~alive).any()               # something pruned
    counter = np.bincount(convert.to_numpy(out)["binding"][alive],
                          minlength=nf)
    assert (counter >= 1).all()
    np.testing.assert_array_equal(
        tg._binding_counter(out, nf).numpy(),
        np.asarray(jg._binding_counter(ref, nf)))


def test_densify_keeps_one_splat_per_face():
    """Every opacity under min_opacity: prune wants everything, and no
    face loses its splats (a face would be left bare), in both
    packages."""
    jparams, params, jframes, frames, nf, stats = _scene(seed=1)
    jparams = dataclasses.replace(jparams, opacity=jnp.full_like(
        jparams.opacity, -10.0))
    params = dataclasses.replace(params, opacity=torch.full_like(
        params.opacity, -10.0))
    zeros = {k: np.zeros_like(v) for k, v in stats.items()}
    ref, _ = jg.densify_and_prune(
        jparams, jg.DensifyState(**{k: jnp.asarray(v)
                                    for k, v in zeros.items()}),
        jframes, nf, MAX_GRAD, 0.5, EXTENT)
    out, _ = tg.densify_and_prune(
        params, convert.densify_state_from_numpy(zeros, "cpu"), frames, nf,
        MAX_GRAD, 0.5, EXTENT, generator=torch.Generator().manual_seed(0))
    _assert_same(out, ref)
    np.testing.assert_array_equal(tg._binding_counter(out, nf).numpy(),
                                  tg._binding_counter(params, nf).numpy())


def test_reset_opacity_matches_jax():
    jparams, params, *_ = _scene(seed=2)
    ref = jg.reset_opacity(jparams)
    out = tg.reset_opacity(params)
    np.testing.assert_array_equal(out.opacity.numpy(),
                                  np.asarray(ref.opacity))
    assert (out.opacity.numpy() < np.asarray(jparams.opacity)).any()
