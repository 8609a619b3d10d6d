"""K8 (the fused sand stress) of the PyTorch port against the JAX package:
the plain version against sand_stress_fused(interpret=True) on the
tip / compression / reflected set of tests/test_pallas_stress.py, and the
port's compute_stress on a material-2 config against JAX
compute_stress(pallas=True)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_pallas_stress import _sand_inputs
from test_torch_core import assert_close, port_of, t

from mpmavatar_tpu.core import stepping as jstep
from mpmavatar_tpu.core import types as jtypes
from mpmavatar_tpu.ops import pallas_stress as jps

from mpmavatar_tpu_torch.core import stepping as tstep
from mpmavatar_tpu_torch.ops import stress as tstress

torch.set_num_threads(1)

# F is O(1): the JAX package's own fused-vs-(T,3,3) bound
F_ATOL = 2e-5
# stress: relative to mu.  log(s) of s ~ 1 carries ~1e-7 of rounding, and
# the stress is (2 mu + 3 lam) log s ~ 10 mu log s; the Jacobi SVD on
# f^T f squares the condition number, so singular values well below 1
# lose more (measured plain vs interpret here: ~3e-6 mu)
STRESS_TOL_MU = 3e-5


def _jax_branch(f_trial, sel, mu, lam, alpha):
    """The JAX kernel's branch codes, from its own _svd3_planes and the
    return map's two tests (the kernel does not return them)."""
    f = [[f_trial[None, :, i, j] for j in range(3)] for i in range(3)]
    _, sig, _ = jps._svd3_planes(f)
    eps = [jnp.log(jnp.maximum(jnp.abs(s[0]), 1e-14)) for s in sig]
    tr = eps[0] + eps[1] + eps[2]
    eh = [e - tr / 3.0 for e in eps]
    ehn = jnp.sqrt(eh[0] ** 2 + eh[1] ** 2 + eh[2] ** 2 + 1e-24)
    dg = ehn + (3.0 * lam + 2.0 * mu) / (2.0 * mu) * tr * alpha
    code = jnp.where(dg > 0, jnp.where(tr > 0, tstress.TIP, tstress.CONE),
                     tstress.ELASTIC)
    return np.asarray(jnp.where(sel > 0.5, code, tstress.UNSELECTED))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_sand_stress_plain_matches_pallas_interpret(seed):
    args = _sand_inputs(seed=seed)
    f_ref, st_ref = (np.asarray(a) for a in
                     jps.sand_stress_fused(*args, interpret=True))
    f_new, stress, branch = tstress.sand_stress(*[t(a) for a in args],
                                                return_branch=True)
    f_new, stress, branch = f_new.numpy(), stress.numpy(), branch.numpy()
    ref_branch = _jax_branch(*args[:1], *args[2:])
    # every branch occurs in the set
    assert set(np.unique(ref_branch)) == {0, 1, 2, 3}
    # branch flips sit on rounding ties; none on this set
    same = branch == ref_branch
    assert same.sum() == len(same), f"{(~same).sum()} branch flips"
    # NaN (log of a negative singular value on the elastic branch) in the
    # same places
    assert np.array_equal(np.isnan(stress), np.isnan(st_ref))
    assert np.array_equal(np.isnan(f_new), np.isnan(f_ref))
    ok = same & ~np.isnan(st_ref).any(axis=(1, 2))
    assert_close(f_new[ok], f_ref[ok], F_ATOL, "f_new")
    mu = float(args[3][0])
    assert_close(stress[ok] / mu, st_ref[ok] / mu, STRESS_TOL_MU, "stress")


def test_sand_stress_plain_keeps_nan_of_reflected_elastic():
    """det F < 0 on the elastic branch: log of the negative singular value
    is NaN in both, as on the (T,3,3) path."""
    f = np.diag([1.0, 1.0, -1.0]).astype(np.float32)[None] \
        * np.ones((4, 1, 1), np.float32)
    f[:, 0, 0] = [0.999, 1.0, 1.001, 1.0]
    args = (jnp.asarray(f), jnp.asarray(np.eye(3, dtype=np.float32)[None]
                                        * np.ones((4, 1, 1), np.float32)),
            jnp.ones(4), jnp.full(4, 400.0), jnp.full(4, 600.0),
            jnp.float32(-0.3))
    _, st_ref = jps.sand_stress_fused(*args, interpret=True)
    _, stress = tstress.sand_stress(*[t(a) for a in args])
    assert np.isnan(np.asarray(st_ref)).any()
    assert np.array_equal(np.isnan(stress.numpy()),
                          np.isnan(np.asarray(st_ref)))


def test_compute_stress_sand_matches_jax_pallas():
    """compute_stress on a material-2 config (cloth + sand): the port's K8
    route against JAX compute_stress(pallas=True), as
    tests/test_pallas_stress.py::test_compute_stress_sand_pallas_dispatch
    holds the JAX kernel against pallas=False."""
    n = 257
    rng = np.random.default_rng(1)
    cfg = jtypes.MPMStaticConfig(n_elements=0, n_traditional=n,
                                 n_vertices=0, n_grid=32, grid_lim=2.0,
                                 material=2)
    x = jnp.asarray(rng.uniform(0.6, 1.4, (n, 3)), jnp.float32)
    state = jtypes.make_state(cfg, x, vol=jnp.full((n,), 1e-7, jnp.float32))
    f_trial = jnp.asarray(np.eye(3) + 0.2 * rng.standard_normal(
        (n, 3, 3)), jnp.float32)
    sel = (rng.random(n) > 0.2).astype(np.int32)
    state = dataclasses.replace(state, F_trial=f_trial,
                                selection=jnp.asarray(sel))
    model = jtypes.make_model(n, E=2000.0, nu=0.3)
    ref = jstep.compute_stress(cfg, state, model, 1e-4, pallas=True)
    tcfg, tst, tm = port_of(cfg, state, model)
    out = tstep.compute_stress(tcfg, tst, tm, 1e-4)
    mu = float(model.mu[0])
    for a, b, name in zip(out, ref, ("new_d", "new_F", "yield", "stress",
                                     "vertex_force")):
        b = np.asarray(b)
        if not b.size:
            continue
        scale = mu if name == "stress" else 1.0
        tol = STRESS_TOL_MU if name == "stress" else F_ATOL
        assert_close(np.asarray(a) / scale, b / scale, tol, name)
