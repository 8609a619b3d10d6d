"""The port's CUDA kernels against their plain PyTorch versions on the
card, at small shapes.  They need a CUDA device and nvcc and skip
without them (a CUDA kernel has no CPU mode; the plain versions are held
against JAX by the other test_torch_* files).  This file imports neither
JAX nor the JAX package, so it runs where only PyTorch is installed:

    python -m pytest tests/test_torch_cuda.py --noconftest -m cuda
"""

import dataclasses

import pytest
import torch

from mpmavatar_tpu_torch.core import colliders as tcol
from mpmavatar_tpu_torch.core import stepping
from mpmavatar_tpu_torch.core.types import (MPMStaticConfig, build_cloth,
                                            cloth_scene, make_model,
                                            make_state)
from mpmavatar_tpu_torch.ops import _build
from mpmavatar_tpu_torch.ops import grid_pipeline as gp
from mpmavatar_tpu_torch.ops import stress as kstress
from mpmavatar_tpu_torch.ops import transfer as ktr
from mpmavatar_tpu_torch.sim import MPMSolver

pytestmark = pytest.mark.cuda

DT = 1e-4


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels run only on "
                    "the card")
    return torch.device("cuda")


def _rel_err(a, b):
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


def _scene(dev, nx=16, grid=32, seed=0):
    verts, faces = build_cloth(nx, nx, y0=1.1, extent=0.5)
    cfg, state, model = cloth_scene(verts, faces, grid, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    rnd = lambda *s: torch.randn(s, generator=gen, device=dev)
    d = state.d + 0.02 * rnd(*state.d.shape)
    d[:, :, 2] *= 0.5 + 1.1 * torch.rand((len(d), 1), generator=gen,
                                         device=dev)
    state = dataclasses.replace(state, d=d,
                                v=0.1 * rnd(cfg.n_particles, 3),
                                C=0.5 * rnd(cfg.n_particles, 3, 3))
    return cfg, state, model, rnd


def test_cloth_stress_kernel_matches_plain(dev):
    cfg, st, model, rnd = _scene(dev)
    E = cfg.n_elements
    sel = (torch.arange(E, device=dev) % 7 != 0).float()
    args = (st.d, st.R_inv, st.vol[:E], sel, model.mu[:E], model.lam[:E],
            model.gamma[:E], model.kappa[:E], model.friction_coeff)
    before = _build.launch_counts().get(kstress.KERNEL, 0)
    out = kstress.cloth_stress(*args)
    assert _build.launch_counts()[kstress.KERNEL] == before + 1
    for a, b in zip(out, kstress.cloth_stress_plain(*args)):
        assert _rel_err(a, b) < 1e-4


def test_p2g_kernel_matches_plain(dev):
    cfg, st, model, rnd = _scene(dev)
    nnv = cfg.n_no_vertices
    args = (st.x, st.v, st.C, st.mass, (st.selection == 0).float(),
            DT * rnd(nnv, 3, 3), DT * rnd(cfg.n_vertices, 3), cfg.n_grid,
            cfg.inv_dx, cfg.dx)
    for a, b in zip(ktr.p2g(*args), ktr.p2g_plain(*args)):
        assert _rel_err(a, b) < 1e-5


def test_g2p_kernel_matches_plain(dev):
    cfg, st, model, rnd = _scene(dev)
    grid_v = rnd(cfg.n_grid ** 3, 3)
    out = ktr.g2p(st.x, grid_v, cfg.n_grid, cfg.inv_dx)
    ref = ktr.g2p_plain(st.x, grid_v, cfg.n_grid, cfg.inv_dx)
    for a, b in zip(out, ref):
        assert _rel_err(a, b) < 1e-5


@pytest.mark.parametrize("mesh_mover", [False, True])
def test_grid_pipeline_kernel_matches_plain(dev, mesh_mover):
    cfg = MPMStaticConfig(n_elements=0, n_traditional=1, n_vertices=0,
                          n_grid=32)
    f = lambda *v: torch.tensor(v, device=dev)
    # plane points off the grid nodes (a node on a plane is a rounding tie)
    post = (tcol.BoundingBoxCollider(f(0.0), f(1.0)),
            tcol.SurfaceCollider(f(0.0, 0.313, 0.0), f(0.0, 1.0, 0.0),
                                 f(0.0), f(0.0), f(1.0), tcol.STICKY),
            tcol.SurfaceCollider(f(0.0, 0.0, 1.0037), f(0.0, 0.6, 0.8),
                                 f(0.3), f(0.0), f(1.0), tcol.SLIP),
            tcol.SurfaceCollider(f(1.0171, 0.0, 0.0), f(0.6, 0.8, 0.0),
                                 f(0.4), f(0.0), f(1.0), tcol.FRICTIONAL))
    n = cfg.n_grid ** 3
    gen = torch.Generator(device=dev).manual_seed(1)
    rnd = lambda *s: torch.randn(s, generator=gen, device=dev)
    weight = lambda: torch.where(
        torch.rand((n,), generator=gen, device=dev) > 0.33,
        0.5 + torch.rand((n,), generator=gen, device=dev), 0.0)
    gv, gm = rnd(n, 3), weight()
    mesh = (rnd(n, 6), weight()) if mesh_mover else (None, None)
    mover = (rnd(n, 3), weight()) if mesh_mover else (None, None)
    scalars = (f(0.0, -9.8, 0.0), f(0.9), f(0.5))
    run = gp.make_grid_pipeline(cfg, post, mesh_mover, mesh_mover)
    surf = gp.pack_surface_params(post)
    out = run(gv, gm, *mesh, *mover, *scalars, 0.5, DT, surf)
    ref = gp.grid_pipeline_plain(gv, gm, *mesh, *mover, *scalars, surf, 0.5,
                                 DT, cfg.n_grid, cfg.dx, (0, 1, 2), True, 3)
    assert _rel_err(out, ref) < 1e-5


def test_p2g2p_goes_through_every_kernel_and_matches_the_cpu(dev):
    cfg, st, model, rnd = _scene(dev, nx=12, grid=32)
    solver = MPMSolver(cfg, device=dev)
    solver.add_surface_collider([0.0, 0.1, 0.0], [0.0, 1.0, 0.0])
    cpu = MPMSolver(cfg, device="cpu")
    cpu.add_surface_collider([0.0, 0.1, 0.0], [0.0, 1.0, 0.0])
    _build.reset_launch_counts()
    out, _ = solver.frame(st, model, DT, 5, 0.0)
    assert _build.launch_counts() == {"cloth_stress": 5, "p2g": 5,
                                      "grid_pipeline": 5, "g2p": 5}
    ref, _ = cpu.frame(st.to("cpu"), model.to("cpu"), DT, 5, 0.0)
    for name, atol in (("x", 2e-5), ("v", 1e-3), ("d", 2e-4)):
        err = float((getattr(out, name).cpu() - getattr(ref, name)).abs()
                    .max())
        assert err < atol, (name, err)


def test_sand_needs_k8_on_cuda(dev):
    n = 8
    cfg = MPMStaticConfig(n_elements=0, n_traditional=n, n_vertices=0,
                          n_grid=16, material=2)
    x = 0.8 + 0.4 * torch.rand((n, 3))
    state = make_state(cfg, x, vol=torch.full((n,), 1e-6), device=dev)
    with pytest.raises(NotImplementedError, match="K8"):
        stepping.compute_stress(cfg, state, make_model(n, device=dev), DT)


def test_wrappers_reject_wrong_dtype(dev):
    x = torch.zeros((4, 3), dtype=torch.float64, device=dev)
    with pytest.raises(TypeError):
        ktr.g2p(x, torch.zeros((8, 3), dtype=torch.float64, device=dev), 2,
                1.0)
