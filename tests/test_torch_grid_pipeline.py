"""K5 (fused grid pipeline) of the PyTorch port against the JAX package:
the plain version against make_grid_pipeline(interpret=True) on random
fields for every supported BC, with and without the mesh / mover
channels; the unfused grid_update + apply_grid_bc against JAX for all
four BC types."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_core import assert_close, port_collider, t

from mpmavatar_tpu.core import colliders as jcol
from mpmavatar_tpu.core import stepping as jstep
from mpmavatar_tpu.core import types as jtypes
from mpmavatar_tpu.ops import pallas_grid_pipeline as jgp

from mpmavatar_tpu_torch.core import stepping as tstep
from mpmavatar_tpu_torch.core import types as ttypes
from mpmavatar_tpu_torch.ops import grid_pipeline as tgp

torch.set_num_threads(1)

G = 16
CFG = jtypes.MPMStaticConfig(n_elements=0, n_traditional=1, n_vertices=0,
                             n_grid=G, grid_lim=2.0)
TCFG = ttypes.MPMStaticConfig(n_elements=0, n_traditional=1, n_vertices=0,
                              n_grid=G, grid_lim=2.0)
F32 = jnp.float32


def _surface(kind, point, normal, friction=0.0, t0=0.0, t1=1.0):
    n = np.asarray(normal, np.float32)
    return jcol.SurfaceCollider(
        point=jnp.asarray(point, F32), normal=jnp.asarray(n / np.linalg.norm(n)),
        friction=F32(friction), start_time=F32(t0), end_time=F32(t1),
        surface_type=kind)


# plane points sit off the grid nodes (x = i * dx): a node exactly on a
# plane is inside or not by the last bit of its rounding
_BBOX = jcol.BoundingBoxCollider(start_time=F32(0.0), end_time=F32(1.0))
_SCENES = {
    "sticky": (_surface(jcol.STICKY, [0, 0.51, 0], [0, 1, 0]),),
    "slip": (_surface(jcol.SLIP, [0, 0, 1.03], [0, 0.6, 0.8], 0.3),),
    "frictional": (_surface(jcol.FRICTIONAL, [1.03, 0, 0], [1, 1, 0], 0.4),),
    "bbox": (_BBOX,),
    # bbox registered first: the kernel still applies it last
    "all": (_BBOX, _surface(jcol.STICKY, [0, 0.31, 0], [0, 1, 0]),
            _surface(jcol.SLIP, [0, 0, 1.03], [0, 0.6, 0.8], 0.3),
            _surface(jcol.FRICTIONAL, [1.03, 0, 0], [1, 1, 0], 0.4),
            _surface(jcol.STICKY, [0, 1.91, 0], [0, -1, 0], 0.0, 0.5, 1.0)),
}


def _fields(seed=0):
    """Random grid fields; weights are 0 on a third of the cells and in
    [0.5, 1.5) elsewhere, so the divisions stay well conditioned."""
    rng = np.random.default_rng(seed)
    n = G ** 3
    weight = lambda: np.where(rng.random(n) > 0.33,
                              0.5 + rng.random(n), 0.0).astype(np.float32)
    return dict(gv=rng.normal(size=(n, 3)).astype(np.float32), gm=weight(),
                macc=rng.normal(size=(n, 6)).astype(np.float32),
                mw=weight(), mv=rng.normal(size=(n, 3)).astype(np.float32),
                mvw=weight())


@pytest.mark.parametrize("mesh_mover", [False, True])
@pytest.mark.parametrize("scene", sorted(_SCENES))
def test_grid_pipeline_plain_matches_pallas_interpret(scene, mesh_mover):
    grid_post = _SCENES[scene]
    f = _fields()
    damping = 0.9 if mesh_mover else 1.1
    ref_fn = jgp.make_grid_pipeline(CFG, grid_post, has_mesh=mesh_mover,
                                    has_mover=mesh_mover, interpret=True)
    port_post = tuple(port_collider(c) for c in grid_post)
    out_fn = tgp.make_grid_pipeline(TCFG, port_post, has_mesh=mesh_mover,
                                    has_mover=mesh_mover)
    opt = lambda k, conv: conv(f[k]) if mesh_mover else None
    gravity = [0.0, -9.8, 0.0]
    ref = ref_fn(jnp.asarray(f["gv"]), jnp.asarray(f["gm"]),
                 opt("macc", jnp.asarray), opt("mw", jnp.asarray),
                 opt("mv", jnp.asarray), opt("mvw", jnp.asarray),
                 jnp.asarray(gravity, F32), F32(damping), F32(0.5),
                 F32(0.7), F32(1e-3), jgp.pack_surface_params(grid_post))
    out = out_fn(t(f["gv"]), t(f["gm"]), opt("macc", t), opt("mw", t),
                 opt("mv", t), opt("mvw", t), torch.tensor(gravity),
                 torch.tensor(damping), torch.tensor(0.5), 0.7, 1e-3,
                 tgp.pack_surface_params(port_post))
    assert_close(out, ref, 1e-5)


def test_supported_bcs_gating():
    cut = _surface(jcol.CUT, [0, 0.5, 0], [0, 1, 0])
    mask = jcol.GridMaskCollider(mask=jnp.zeros((2, 2, 2), jnp.int32))
    for post, ok in (((_SCENES["all"]), True), ((cut,), False),
                     ((mask,), False), ((_BBOX, cut), False)):
        port_post = tuple(port_collider(c) for c in post)
        assert jgp.supported_bcs(post) == ok
        assert tgp.supported_bcs(port_post) == ok
    with pytest.raises(ValueError):
        tgp.make_grid_pipeline(TCFG, (port_collider(cut),), False, False)


_UNFUSED = {
    "sticky": _SCENES["sticky"][0],
    "slip": _SCENES["slip"][0],
    "frictional": _SCENES["frictional"][0],
    "cut": _surface(jcol.CUT, [0, 1.0, 0], [0, 1, 0]),
    "cuboid": jcol.CuboidCollider(
        point=jnp.asarray([1.0, 1.0, 1.0], F32),
        size=jnp.asarray([0.3, 0.2, 0.4], F32),
        velocity=jnp.asarray([0.1, 0.0, -0.2], F32),
        start_time=F32(0.0), end_time=F32(1.0)),
    "cuboid_reset": jcol.CuboidCollider(
        point=jnp.asarray([1.0, 1.0, 1.0], F32),
        size=jnp.asarray([0.3, 0.2, 0.4], F32),
        velocity=jnp.asarray([0.1, 0.0, -0.2], F32),
        start_time=F32(0.0), end_time=F32(0.69), reset=1),
    "bbox": _BBOX,
    "grid_mask": jcol.GridMaskCollider(mask=jnp.asarray(
        (np.random.default_rng(3).random((G, G, G)) > 0.5).astype(
            np.int32))),
}


@pytest.mark.parametrize("name", sorted(_UNFUSED))
def test_grid_update_and_bc_match_jax(name):
    """The unfused path (taken for BCs the kernel does not cover) against
    JAX grid_update + apply_grid_bc."""
    f = _fields(1)
    jm = jtypes.make_model(1, grid_v_damping_scale=0.95)
    tm = ttypes.make_model(1, grid_v_damping_scale=0.95, device="cpu")
    col = _UNFUSED[name]
    ref = jstep.grid_update(CFG, jm, jnp.asarray(f["gv"]),
                            jnp.asarray(f["gm"]), 1e-3)
    ref = jstep.apply_grid_bc(CFG, col, ref, F32(0.7), 1e-3)
    out = tstep.grid_update(TCFG, tm, t(f["gv"]), t(f["gm"]), 1e-3)
    out = tstep.apply_grid_bc(TCFG, port_collider(col), out, 0.7, 1e-3)
    assert_close(out, ref, 1e-5, name)
