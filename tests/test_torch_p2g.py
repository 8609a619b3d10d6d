"""K2 (P2G) of the PyTorch port against the JAX package: the plain
version against stepping.p2g and against the Pallas column kernel in
interpret mode (p2g_columns_fused), on the small scenes of
tests/test_pallas_transfer.py with random velocities and affine fields."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_substep_golden import build_pair, make_cloth
from test_torch_core import assert_close, port_of, t

from mpmavatar_tpu.core import stepping as jstep
from mpmavatar_tpu.core import types as jtypes
from mpmavatar_tpu.ops import column_transfer as ct
from mpmavatar_tpu.ops import pallas_transfer as pt

from mpmavatar_tpu_torch.core import stepping as tstep
from mpmavatar_tpu_torch.ops import transfer as ttr

torch.set_num_threads(1)

DT = 2e-4
# the JAX package's own fused-vs-XLA bound (tests/test_pallas_transfer.py)
P2G_ATOL = 1e-6
_SMALL = dict(nx=7, grid=32, K=8, cap=128)


def _scene(nx, grid, K=None, cap=None, rpic=0.0):
    verts, faces = make_cloth(nx=nx, ny=nx, y0=1.1, extent=0.5)
    _, cfg, state, model = build_pair(verts, faces, E=500.0, n_grid=grid)
    rng = np.random.default_rng(0)
    P = cfg.n_particles
    state = dataclasses.replace(
        state,
        v=jnp.asarray(rng.normal(0, 0.1, (P, 3)), jnp.float32),
        C=jnp.asarray(rng.normal(0, 0.5, (P, 3, 3)), jnp.float32),
        d=state.d + jnp.asarray(rng.normal(0, 0.01, state.d.shape),
                                jnp.float32))
    model = dataclasses.replace(model, rpic_damping=jnp.float32(rpic))
    _, _, _, stress, vforce = jstep.compute_stress(cfg, state, model, DT)
    bins = None
    if K is not None:
        bins = ct.build_bins(state.x, cfg, K, c_cap=cap)
        assert int(bins.overflow) == 0
    return cfg, state, model, stress, vforce, bins


def _port_p2g_args(cfg, state, stress, vforce):
    """The K2 wrapper's inputs for a JAX state (c_eff = C, no RPIC)."""
    _, tst, _ = port_of(cfg, state, jtypes.make_model(cfg.n_particles))
    sel = (tst.selection == 0).float()
    return (tst.x, tst.v, tst.C, tst.mass, sel, DT * t(stress),
            DT * t(vforce), cfg.n_grid, cfg.inv_dx, cfg.dx)


def test_p2g_plain_matches_pallas_interpret():
    cfg, state, model, stress, vforce, bins = _scene(**_SMALL)
    sel = (state.selection == 0).astype(jnp.float32)
    nnv = cfg.n_no_vertices
    gv_ref, gm_ref = pt.p2g_columns_fused(
        cfg, state, DT * sel[:nnv, None, None] * stress, DT * vforce,
        _SMALL["K"], bins=bins, interpret=True)
    gv, gm = ttr.p2g(*_port_p2g_args(cfg, state, stress, vforce))
    assert_close(gm, gm_ref, P2G_ATOL, "grid_m")
    assert_close(gv, gv_ref, P2G_ATOL, "grid_v_in")


@pytest.mark.parametrize("rpic", [0.0, 0.3])
def test_p2g_matches_stepping_p2g(rpic):
    """The port's stepping.p2g (RPIC mix + dt scaling + K2) against the
    JAX scatter P2G, on the 24x24 / 48^3 scene of __graft_entry__."""
    cfg, state, model, stress, vforce, _ = _scene(24, 48, rpic=rpic)
    gv_ref, gm_ref = jstep.p2g(cfg, state, model, stress, vforce, DT)
    tcfg, tst, tm = port_of(cfg, state, model)
    gv, gm = tstep.p2g(tcfg, tst, tm, t(stress), t(vforce), DT)
    assert_close(gm, gm_ref, P2G_ATOL, "grid_m")
    assert_close(gv, gv_ref, P2G_ATOL, "grid_v_in")


def _edge_scene(x):
    n = len(x)
    rng = np.random.default_rng(5)
    cfg = jtypes.MPMStaticConfig(n_elements=0, n_traditional=n,
                                 n_vertices=0, n_grid=16, grid_lim=2.0,
                                 material=0)
    state = jtypes.make_state(cfg, jnp.asarray(x), vol=jnp.full((n,), 1e-3),
                              v=jnp.asarray(rng.normal(size=(n, 3)),
                                            jnp.float32))
    stress = jnp.asarray(rng.normal(size=(n, 3, 3)), jnp.float32)
    return cfg, state, jtypes.make_model(n), stress, jnp.zeros((0, 3))


def test_p2g_drops_nodes_past_the_grid():
    """Stencil nodes whose flat index reaches G^3 or more are dropped (and
    ones that wrap into the next row are kept), as in the JAX scatter."""
    rng = np.random.default_rng(4)
    x = rng.uniform(0.2, 2.0, (64, 3)).astype(np.float32)
    x[:8] = rng.uniform(1.93, 2.0, (8, 3))       # past the last cell
    x[8:16, 1:] = rng.uniform(0.0, 0.08, (8, 2))  # base -1 on y / z
    cfg, state, model, stress, vforce = _edge_scene(x)
    gv_ref, gm_ref = jstep.p2g(cfg, state, model, stress, vforce, DT)
    tcfg, tst, tm = port_of(cfg, state, model)
    gv, gm = tstep.p2g(tcfg, tst, tm, t(stress), t(vforce), DT)
    assert_close(gm, gm_ref, P2G_ATOL, "grid_m")
    assert_close(gv, gv_ref, P2G_ATOL, "grid_v_in")


def test_p2g_drops_negative_flat_indices():
    """A stencil node with a flat index in [-G^3, 0) wraps to the far end
    of the grid and only what still lies outside [0, G^3) is dropped, as
    JAX's ``.at[].add(mode="drop")`` does: the port against JAX
    stepping.p2g on a particle at base (-1, -1, -1) (outside the position
    clip band [2 dx, lim - 2 dx], which keeps the main path's bases >= 1).
    """
    x = np.full((1, 3), 0.01, np.float32)        # base (-1, -1, -1)
    cfg, state, model, stress, vforce = _edge_scene(x)
    gv_ref, gm_ref = jstep.p2g(cfg, state, model, stress, vforce, DT)
    tcfg, tst, tm = port_of(cfg, state, model)
    gv, gm = tstep.p2g(tcfg, tst, tm, t(stress), t(vforce), DT)
    G = cfg.n_grid
    # the wrapped nodes land in the last x-slab
    assert float(gm.reshape(G, G, G)[G - 1].sum()) > 0.0
    assert_close(gm, gm_ref, P2G_ATOL, "grid_m")
    assert_close(gv, gv_ref, P2G_ATOL, "grid_v_in")


def test_wrappers_reject_bad_shapes():
    x = torch.zeros((4, 3))
    with pytest.raises(ValueError):
        ttr.g2p(x, torch.zeros((7, 3)), 2, 1.0)
    with pytest.raises(ValueError):
        ttr.p2g(x, x, torch.zeros((4, 3, 3)), torch.zeros(4), torch.zeros(4),
                torch.zeros((2, 3, 3)), torch.zeros((1, 3)), 2, 1.0, 1.0)
