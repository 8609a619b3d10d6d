"""K3 (G2P) of the PyTorch port against the JAX package: the plain
version against stepping.gather_quantities and against the Pallas column
kernel in interpret mode (g2p_columns_fused), and the advection tail
against stepping.g2p."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import torch

from test_torch_core import assert_close, port_of, t
from test_torch_p2g import DT, _SMALL, _scene

from mpmavatar_tpu.core import stepping as jstep
from mpmavatar_tpu.ops import pallas_transfer as pt

from mpmavatar_tpu_torch.core import stepping as tstep
from mpmavatar_tpu_torch.ops import transfer as ttr

torch.set_num_threads(1)

# the JAX package's own fused-vs-XLA bound (tests/test_pallas_transfer.py)
G2P_ATOL = 2e-5


def _grid_v_out(cfg, state, model, stress, vforce):
    gv, gm = jstep.p2g(cfg, state, model, stress, vforce, DT)
    return jstep.grid_update(cfg, model, gv, gm, DT)


def test_g2p_plain_matches_pallas_interpret():
    cfg, state, model, stress, vforce, bins = _scene(**_SMALL)
    grid_v_out = _grid_v_out(cfg, state, model, stress, vforce)
    ref = pt.g2p_columns_fused(cfg, state, grid_v_out, _SMALL["K"],
                               bins=bins, interpret=True)
    out = ttr.g2p(t(state.x), t(grid_v_out), cfg.n_grid, cfg.inv_dx)
    for a, b, name in zip(out, ref, ("v", "C", "grad_v")):
        assert_close(a, b, G2P_ATOL, name)


def test_g2p_matches_gather_quantities():
    cfg, state, model, stress, vforce, _ = _scene(24, 48)
    grid_v_out = _grid_v_out(cfg, state, model, stress, vforce)
    ref = jstep.gather_quantities(cfg, state, grid_v_out)
    tcfg, tst, _ = port_of(cfg, state, model)
    out = tstep.gather_quantities(tcfg, tst, t(grid_v_out))
    for a, b, name in zip(out, ref, ("v", "C", "grad_v")):
        assert_close(a, b, G2P_ATOL, name)


def test_g2p_advection_matches_jax():
    """The advection tail (position clip, element rebuild from updated
    vertices, d3 advanced by grad_v) on the gathered fields."""
    cfg, state, model, stress, vforce, _ = _scene(**_SMALL)
    sel = np.zeros(cfg.n_particles, np.int32)
    sel[::7] = 1                                      # some frozen particles
    state = dataclasses.replace(state, selection=jnp.asarray(sel))
    grid_v_out = _grid_v_out(cfg, state, model, stress, vforce)
    ref = jstep.g2p(cfg, state, model, grid_v_out, DT)
    tcfg, tst, tm = port_of(cfg, state, model)
    out = tstep.g2p(tcfg, tst, tm, t(grid_v_out), DT)
    for a, b, name in zip(out, ref, ("x", "v", "C", "F_trial", "d")):
        assert_close(a, b, G2P_ATOL, name)
