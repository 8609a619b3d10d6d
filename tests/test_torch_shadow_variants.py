"""The port's layer library, the four other shadow networks and
``init_from_pcd`` against the JAX package on the CPU.

Every layer function on seeded inputs (<= 1e-6); the four variants'
outputs (<= 1e-5) and parameter gradients (<= 1e-4 of each leaf's
largest entry) with the JAX package's weights carried across by
``convert.shadow_variant_params_from_numpy``, at cut sizes that keep
every resize case (the antialiased shrink, the growth, the identity) and
the stride-2 and transposed convs; the resize case by case; the
initializers' names and shapes; ``init_from_pcd`` with the native
KD-tree (exact) and on the dense fallback (<= 1e-6)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_core import t

from mpmavatar_tpu.render import gaussians as jg
from mpmavatar_tpu.render import layers as jl
from mpmavatar_tpu.render import shadow_variants as jsv

from mpmavatar_tpu_torch import convert
from mpmavatar_tpu_torch.render import gaussians as tg
from mpmavatar_tpu_torch.render import layers as tl
from mpmavatar_tpu_torch.render import shadow_variants as tsv

torch.set_num_threads(1)

LAYER_TOL = 1e-6
OUT_TOL = 1e-5
GRAD_TOL = 1e-4


def _rng(seed):
    return np.random.default_rng(seed)


def _x(shape, seed, scale=1.0):
    return (scale * _rng(seed).normal(size=shape)).astype(np.float32)


def _with_biases(params, seed):
    """Nonzero biases, so the untied-bias layouts are exercised."""
    rng = _rng(seed)

    def walk(p):
        if isinstance(p, dict):
            return {k: (jnp.asarray(0.05 * rng.normal(size=v.shape)
                                    .astype(np.float32))
                        if k == "b" else walk(v)) for k, v in p.items()}
        return p
    return walk(params)


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return np.asarray(tree)


def _both(jinit, *args, seed=0, **kw):
    """(JAX params, the port's copy of them)."""
    p = _with_biases(jinit(jax.random.PRNGKey(seed), *args, **kw), seed + 7)
    return p, convert.shadow_variant_params_from_numpy(_np(p), "cpu")


LAYER_CASES = {
    "linear_wn": (jl.linear_wn_init, (5, 7), {},
                  lambda m, p, x: m.linear_wn_apply(p, x), (3, 5)),
    "conv2d_wn": (jl.conv2d_wn_init, (3, 4), {"k": 3, "height": 9},
                  lambda m, p, x: m.conv2d_wn_apply(p, x), (2, 3, 9, 9)),
    "conv2d_wn stride 2, k 4": (
        jl.conv2d_wn_init, (3, 4), {"k": 4},
        lambda m, p, x: m.conv2d_wn_apply(p, x, stride=2), (2, 3, 10, 10)),
    "conv2d_wn stride 2, k 3, odd": (
        jl.conv2d_wn_init, (3, 4), {"k": 3},
        lambda m, p, x: m.conv2d_wn_apply(p, x, stride=2), (1, 3, 9, 11)),
    "conv2d_wn VALID": (
        jl.conv2d_wn_init, (3, 4), {"k": 3},
        lambda m, p, x: m.conv2d_wn_apply(p, x, padding="VALID"),
        (1, 3, 8, 8)),
    "conv2d_wn transposed, stride 2, k 4": (
        jl.conv2d_wn_init, (3, 4), {"k": 4, "height": 12},
        lambda m, p, x: m.conv2d_wn_apply(p, x, stride=2, transpose=True),
        (2, 3, 6, 6)),
    "conv2d_wn transposed, stride 2, k 3": (
        jl.conv2d_wn_init, (3, 4), {"k": 3},
        lambda m, p, x: m.conv2d_wn_apply(p, x, stride=2, transpose=True),
        (1, 3, 5, 7)),
    "conv2d_wn transposed, VALID": (
        jl.conv2d_wn_init, (3, 2), {"k": 4},
        lambda m, p, x: m.conv2d_wn_apply(p, x, stride=2, padding="VALID",
                                          transpose=True), (1, 3, 5, 5)),
    "linear_elr": (jl.linear_elr_init, (6, 4), {},
                   lambda m, p, x: m.linear_elr_apply(p, x), (3, 6)),
    "conv2d_elr": (jl.conv2d_elr_init, (3, 5), {},
                   lambda m, p, x: m.conv2d_elr_apply(p, x, stride=2),
                   (2, 3, 8, 8)),
    "upconv2d": (jl.conv2d_wn_init, (3, 4), {"k": 3},
                 lambda m, p, x: m.upconv2d(p, x), (2, 3, 5, 7)),
}


@pytest.mark.parametrize("name", list(LAYER_CASES))
def test_layer_matches_jax(name):
    init, args, kw, apply, shape = LAYER_CASES[name]
    p, pt = _both(init, *args, **kw)
    x = _x(shape, 1)
    ref = np.asarray(apply(jl, p, jnp.asarray(x)))
    out = apply(tl, pt, t(x))
    assert tuple(out.shape) == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, atol=LAYER_TOL)


@pytest.mark.parametrize("name", ["downsample_aa", "concat_pyramid",
                                  "tile2d"])
def test_parameter_free_layer_matches_jax(name):
    if name == "downsample_aa":
        x = _x((2, 3, 12, 10), 2)
        ref, out = jl.downsample_aa(jnp.asarray(x)), tl.downsample_aa(t(x))
    elif name == "concat_pyramid":
        levels = [_x((1, 2, 16, 16), 3), _x((1, 3, 8, 8), 4),
                  _x((1, 1, 4, 4), 5)]
        ref = jl.concat_pyramid([jnp.asarray(v) for v in levels])
        out = tl.concat_pyramid([t(v) for v in levels])
    else:
        x = _x((2, 5), 6)
        ref, out = jl.tile2d(jnp.asarray(x), 7), tl.tile2d(t(x), 7)
    assert tuple(out.shape) == np.asarray(ref).shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=LAYER_TOL)


# the resize cases the variants run: shrink by 2 and by a non-integer
# factor (antialiased), grow by 2 and 4 and by a non-integer factor, the
# identity; and the growth from one pixel
@pytest.mark.parametrize("src,dst", [((16, 16), (8, 8)), ((24, 24), (16, 16)),
                                     ((8, 8), (16, 16)), ((8, 8), (32, 32)),
                                     ((6, 10), (16, 16)), ((12, 12), (12, 12)),
                                     ((1, 1), (4, 4))])
def test_resize_matches_jax_image_resize(src, dst):
    x = _x((2, 3) + src, sum(src) + sum(dst))
    ref = jax.image.resize(jnp.asarray(x), (2, 3) + dst, method="bilinear")
    np.testing.assert_allclose(tl.resize(t(x), dst).numpy(),
                               np.asarray(ref), atol=LAYER_TOL)


def _variant_cases():
    ao_mean = (0.4 + 0.5 * _rng(9).random((1, 32, 32))).astype(np.float32)
    return {
        "floor": (lambda k: jsv.init_floor_shadow_decoder(k, uv_size=32),
                  lambda m, p, x: m.apply_floor_shadow_decoder(
                      p, x["ao"], uv_size=32),
                  {"ao": (1, 1, 48, 48)}),
        "posecond": (lambda k: jsv.init_shadow_unet_posecond(
            k, ao_mean, shadow_size=32, n_dims=8, n_pose_dims=6,
            n_pose_enc_dims=4),
            lambda m, p, x: m.apply_shadow_unet_posecond(
                p, x["ao"], x["pose"], uv_size=64),
            {"ao": (2, 1, 32, 32), "pose": (2, 6)}),
        "pose_to_shadow": (lambda k: jsv.init_pose_to_shadow(k, 9),
                           lambda m, p, x: m.apply_pose_to_shadow(
                               p, x["pose"], uv_size=64),
                           {"pose": (2, 9)}),
        "distmap": (lambda k: jsv.init_distmap_shadow_unet(
            k, 5, shadow_size=32, n_dims=8),
            lambda m, p, x: m.apply_distmap_shadow_unet(p, x["dist"],
                                                        uv_size=64),
            {"dist": (1, 5, 40, 40)}),
        "distmap, tied head": (lambda k: jsv.init_distmap_shadow_unet(
            k, 5, shadow_size=32, n_dims=8, biases=False),
            lambda m, p, x: m.apply_distmap_shadow_unet(p, x["dist"],
                                                        uv_size=16),
            {"dist": (1, 5, 32, 32)}),
    }


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


@pytest.mark.parametrize("name", list(_variant_cases()))
def test_shadow_variant_matches_jax(name):
    """Outputs and the gradient of a seeded weighted sum of the shadow
    map w.r.t. every parameter."""
    init, apply, shapes = _variant_cases()[name]
    p = _with_biases(init(jax.random.PRNGKey(3)), 4)
    pt = convert.shadow_variant_params_from_numpy(_np(p), "cpu")
    x = {k: (0.5 + 0.3 * _x(s, 10 + i)) for i, (k, s) in
         enumerate(shapes.items())}
    xj = {k: jnp.asarray(v) for k, v in x.items()}
    ref = jax.jit(lambda q: apply(jsv, q, xj))(p)
    for leaf in _leaves(pt).values():
        leaf.requires_grad_(True)
    out = apply(tsv, pt, {k: t(v) for k, v in x.items()})
    assert set(out) == set(ref)
    for key in ref:
        assert tuple(out[key].shape) == ref[key].shape, key
        np.testing.assert_allclose(out[key].detach().numpy(),
                                   np.asarray(ref[key]), atol=OUT_TOL,
                                   err_msg=key)

    w = _x(ref["shadow_map"].shape, 20)
    jgrad = jax.jit(jax.grad(lambda q: jnp.sum(
        apply(jsv, q, xj)["shadow_map"] * w)))(p)
    torch.sum(out["shadow_map"] * t(w)).backward()
    jleaves, tleaves = _leaves(jgrad), _leaves(pt)
    assert set(jleaves) == set(tleaves)
    largest = max(float(jnp.abs(v).max()) for v in jleaves.values())
    for k, ref_g in jleaves.items():
        got = tleaves[k].grad
        ref_g = np.asarray(ref_g)
        if got is None:         # not on the path (the AO mean)
            assert not np.any(ref_g), k
            continue
        scale = max(float(np.abs(ref_g).max()), 1e-6 * largest)
        err = float(np.abs(got.numpy() - ref_g).max()) / scale
        assert err <= GRAD_TOL, (k, err)


@pytest.mark.parametrize("name", list(_variant_cases()))
def test_shadow_variant_init_names_and_shapes(name):
    """The port's initializer gives the JAX initializer's names and
    shapes (its draws come from a torch.Generator)."""
    init = _variant_cases()[name][0]
    ref = _leaves(init(jax.random.PRNGKey(0)))
    port = {"floor": lambda: tsv.init_floor_shadow_decoder(
        0, uv_size=32, device="cpu"),
        "posecond": lambda: tsv.init_shadow_unet_posecond(
            0, np.ones((1, 32, 32), np.float32), shadow_size=32, n_dims=8,
            n_pose_dims=6, n_pose_enc_dims=4, device="cpu"),
        "pose_to_shadow": lambda: tsv.init_pose_to_shadow(0, 9,
                                                          device="cpu"),
        "distmap": lambda: tsv.init_distmap_shadow_unet(
            0, 5, shadow_size=32, n_dims=8, device="cpu"),
        "distmap, tied head": lambda: tsv.init_distmap_shadow_unet(
            0, 5, shadow_size=32, n_dims=8, biases=False, device="cpu"),
    }[name]()
    got = _leaves(port)
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: tuple(np.shape(v)) for k, v in ref.items()}
    # weight normalisation starts at g = ||v||
    for k, v in got.items():
        if k.endswith("/v") and v.dim() == 4:
            g = got[k[:-1] + "g"]
            np.testing.assert_allclose(
                g.numpy(), torch.sqrt((v * v).sum((1, 2, 3), keepdim=True))
                .numpy(), rtol=1e-6)


def _cloud(n=300, seed=0):
    rng = _rng(seed)
    return (rng.normal(size=(n, 3)).astype(np.float32),
            rng.random((n, 3)).astype(np.float32))


@pytest.mark.parametrize("native", [True, False], ids=["native", "dense"])
def test_init_from_pcd_matches_jax(native, monkeypatch):
    """With the native KD-tree both packages build and call the same
    library code: identical.  Without it (the import raising in both)
    both take the dense distances."""
    pts, cols = _cloud()
    if not native:
        import mpmavatar_tpu.native as jnative
        import mpmavatar_tpu_torch.native as tnative

        class Broken:
            @staticmethod
            def mean_dist2_3nn(points):
                raise OSError("no native library")
        monkeypatch.setattr(jnative, "knn", Broken)
        monkeypatch.setattr(tnative, "knn", Broken)
    ref = jg.init_from_pcd(pts, cols, sh_degree=2, capacity=320)
    out = tg.init_from_pcd(pts, cols, sh_degree=2, capacity=320,
                           device="cpu")
    tol = 0.0 if native else 1e-6
    for f in ("xyz", "features_dc", "features_rest", "scaling", "rotation",
              "opacity", "binding", "alive"):
        a, b = getattr(out, f).numpy(), np.asarray(getattr(ref, f))
        assert a.shape == b.shape, f
        np.testing.assert_allclose(a, b, atol=tol, rtol=0, err_msg=f)
    assert int(out.alive.sum()) == len(pts)
