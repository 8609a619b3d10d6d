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
from mpmavatar_tpu_torch.ops import composite as kcomp
from mpmavatar_tpu_torch.ops import grid_pipeline as gp
from mpmavatar_tpu_torch.ops import splat as ksplat
from mpmavatar_tpu_torch.ops import stress as kstress
from mpmavatar_tpu_torch.ops import transfer as ktr
from mpmavatar_tpu_torch.data import OptimizationParams
from mpmavatar_tpu_torch.render import bench_render
from mpmavatar_tpu_torch.sim import MPMSolver, bench_scene
from mpmavatar_tpu_torch.train import appearance as tapp
from mpmavatar_tpu_torch.train import bench_appearance

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


def test_p2g_kernel_wraps_negative_flat_indices(dev):
    """Particles at base (-1, -1, -1) and past the far end: the kernel
    wraps a flat index in [-G^3, 0) and drops the rest, as the plain
    version (and JAX's scatter) does."""
    G, n = 16, 8
    x = torch.full((n, 3), 0.01, device=dev)
    x[4:] = 1.97
    gen = torch.Generator(device=dev).manual_seed(3)
    rnd = lambda *s: torch.randn(s, generator=gen, device=dev)
    args = (x, rnd(n, 3), rnd(n, 3, 3), torch.full((n,), 1e-3, device=dev),
            torch.ones(n, device=dev), DT * rnd(n, 3, 3),
            torch.zeros((0, 3), device=dev), G, G / 2.0, 2.0 / G)
    out, ref = ktr.p2g(*args), ktr.p2g_plain(*args)
    assert float(ref[1].reshape(G, G, G)[G - 1].sum()) > 0.0
    for a, b in zip(out, ref):
        assert _rel_err(a, b) < 1e-5


def _splat_points(dev, n=500, G=32, seed=0):
    """Random points with some at base G - 3 and some below 0."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    dx = 2.0 / G
    pts = 0.1 + 1.8 * torch.rand((n, 3), generator=gen, device=dev)
    pts[:20, 0] = (G - 2.3) * dx + 0.4 * dx * torch.rand(
        20, generator=gen, device=dev)
    pts[20:40, 1] = -0.2 * torch.rand(20, generator=gen, device=dev)
    pts[40:60] = 0.2 * dx
    return pts


@pytest.mark.parametrize("ch", [3, 6])
@pytest.mark.parametrize("bounds_check", [True, False])
def test_splat_kernel_matches_plain(dev, ch, bounds_check):
    G = 32
    pts = _splat_points(dev, G=G)
    vals = torch.randn((pts.shape[0], ch), device=dev)
    before = _build.launch_counts().get(ksplat.KERNEL, 0)
    out = ksplat.splat(pts, vals, G, G / 2.0, bounds_check)
    assert _build.launch_counts()[ksplat.KERNEL] == before + 1
    ref = ksplat.splat_plain(pts, vals, G, G / 2.0, bounds_check)
    for a, b in zip(out, ref):
        assert _rel_err(a, b) < 1e-5


def _sand_set(dev, t=2000, seed=0):
    """tests/test_pallas_stress.py::_sand_inputs, built here without JAX:
    expanding (tip), compressing (cone) and reflected cases."""
    gen = torch.Generator().manual_seed(seed)
    f_trial = torch.eye(3) + 0.15 * torch.randn((t, 3, 3), generator=gen)
    f_trial[: t // 8] *= 1.5
    f_trial[t // 8: t // 4] *= 0.5
    f_trial[t // 4] = torch.diag(torch.tensor([1.0, 1.0, -1.0])) \
        @ f_trial[t // 4]
    f_prev = torch.eye(3) + 0.05 * torch.randn((t, 3, 3), generator=gen)
    sel = (torch.rand(t, generator=gen) > 0.2).float()
    return [a.to(dev) for a in (f_trial, f_prev, sel, torch.full((t,), 400.0),
                                torch.full((t,), 600.0), torch.tensor(0.3))]


def test_sand_kernel_matches_plain(dev):
    args = _sand_set(dev)
    before = _build.launch_counts().get(kstress.SAND_KERNEL, 0)
    f_new, stress, branch = kstress.sand_stress(*args, return_branch=True)
    assert _build.launch_counts()[kstress.SAND_KERNEL] == before + 1
    f_ref, st_ref, b_ref = kstress.sand_stress_plain(*args,
                                                     return_branch=True)
    same = branch == b_ref
    assert int((~same).sum()) <= 2
    assert torch.equal(torch.isnan(stress), torch.isnan(st_ref))
    ok = same & ~torch.isnan(st_ref).flatten(1).any(1)
    assert float((f_new - f_ref)[ok].abs().max()) < 2e-5
    assert float((stress - st_ref)[ok].abs().max()) / 400.0 < 3e-5


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
    """Sand (material 2) takes K8 in compute_stress on the card, and
    agrees with the plain route on the CPU."""
    n = 300
    cfg = MPMStaticConfig(n_elements=0, n_traditional=n, n_vertices=0,
                          n_grid=16, material=2)
    gen = torch.Generator().manual_seed(0)
    x = 0.8 + 0.4 * torch.rand((n, 3), generator=gen)
    state = make_state(cfg, x, vol=torch.full((n,), 1e-6), device="cpu")
    state = dataclasses.replace(state, F_trial=torch.eye(3) + 0.1 * torch.randn(
        (n, 3, 3), generator=gen))
    model = make_model(n, device="cpu")
    _build.reset_launch_counts()
    out = stepping.compute_stress(cfg, state.to(dev), model.to(dev), DT)
    assert _build.launch_counts() == {kstress.SAND_KERNEL: 1}
    ref = stepping.compute_stress(cfg, state, model, DT)
    assert float((out[1].cpu() - ref[1]).abs().max()) < 2e-5
    assert float((out[3].cpu() - ref[3]).abs().max()) \
        / float(model.mu[0]) < 3e-5


def test_bench_substep_goes_through_every_kernel(dev):
    """The bench scene (collider, mover, floor, sand) at a small size:
    K1, K8, K2, K5, K3 once and K4 twice per substep, and the kernel path
    against the plain path on the CPU."""
    solver, state, model, scene = bench_scene.build(32, sand=300, nx=12,
                                                    device=dev)
    cpu, st_c, m_c, sc_c = bench_scene.build(32, sand=300, nx=12,
                                             device="cpu")
    _build.reset_launch_counts()
    out, _ = solver.frame(state, model, DT, 5, 0.0, **scene)
    assert _build.launch_counts() == {
        "cloth_stress": 5, "sand_stress": 5, "p2g": 5, "splat": 10,
        "grid_pipeline": 5, "g2p": 5}
    ref, _ = cpu.frame(st_c, m_c, DT, 5, 0.0, **sc_c)
    for name, atol in (("x", 2e-5), ("v", 1e-3)):
        err = float((getattr(out, name).cpu() - getattr(ref, name)).abs()
                    .max())
        assert err < atol, (name, err)


def test_wrappers_reject_wrong_dtype(dev):
    x = torch.zeros((4, 3), dtype=torch.float64, device=dev)
    with pytest.raises(TypeError):
        ktr.g2p(x, torch.zeros((8, 3), dtype=torch.float64, device=dev), 2,
                1.0)


def _composite_items(dev, w, c, nc=3, seed=0):
    """Random K6 work items around their tiles, 30% sentinels."""
    gen = torch.Generator().manual_seed(seed)
    u = lambda lo, hi, *s: lo + (hi - lo) * torch.rand(s, generator=gen)
    pix0 = 16.0 * torch.randint(0, 8, (w, 2), generator=gen).float()
    pg = torch.zeros((w, 6 + nc, c))
    pg[:, 0:2] = pix0[:, :, None] + u(-6, 22, w, 2, c)
    sx, sy, rho = u(1, 6, w, c), u(1, 6, w, c), u(-0.6, 0.6, w, c)
    det = 1.0 - rho ** 2
    pg[:, 2], pg[:, 3], pg[:, 4] = (1 / (sx ** 2 * det),
                                    -rho / (sx * sy * det),
                                    1 / (sy ** 2 * det))
    pg[:, 5:5 + nc] = u(0, 1, w, nc, c)
    pg[:, 5 + nc] = u(0.05, 1, w, c)
    sent = torch.rand((w, c), generator=gen) > 0.7
    pg.permute(0, 2, 1)[sent] = 0.0
    pg[:, 0:2].permute(0, 2, 1)[sent] = -1e6
    return pg.to(dev), pix0.to(dev)


def _composite_err(out, ref, pg, pix0, nc=3):
    """Max abs error on the pixels with no alpha near the 1/255 cutoff
    (a rounding tie between expf and torch.exp), and their count."""
    _, alpha = kcomp.segment_power_alpha(pg, pix0, nc)
    tied = ((alpha - kcomp.ALPHA_MIN).abs() < 1e-4 * kcomp.ALPHA_MIN).any(1)
    keep = ~tied[:, None, :].expand(out.shape)
    return float((out - ref)[keep].abs().max()), int(tied.sum())


@pytest.mark.parametrize("chunk", [32, 128])
def test_composite_kernel_matches_plain(dev, chunk):
    pg, pix0 = _composite_items(dev, 300, chunk)
    before = _build.launch_counts().get(kcomp.KERNEL, 0)
    out = kcomp.segment_composite(pg, pix0, 3)
    assert _build.launch_counts()[kcomp.KERNEL] == before + 1
    ref = kcomp.segment_composite_plain(pg, pix0, 3)
    err, tied = _composite_err(out, ref, pg, pix0)
    assert err < 1e-5 and tied < 300 * 256 // 100


def test_composite_kernel_sentinel_items_are_the_identity(dev):
    pg = torch.zeros((64, 9, 32), device=dev)
    pg[:, 0:2] = -1e6
    pix0 = torch.zeros((64, 2), device=dev)
    out = kcomp.segment_composite(pg, pix0, 3)
    assert torch.equal(out[:, :3], torch.zeros_like(out[:, :3]))
    assert torch.equal(out[:, 3], torch.ones_like(out[:, 3]))


@pytest.mark.parametrize("chunk", [32, 128])
def test_composite_backward_kernel_matches_plain(dev, chunk):
    """K7 against autograd over K6's plain version, per parameter row
    relative to its largest gradient, on the items with no alpha near the
    cutoff; the autograd backward of segment_composite launches K7."""
    pg, pix0 = _composite_items(dev, 300, chunk, seed=1)
    g = torch.randn((300, 4, 256), generator=torch.Generator(
        device=dev).manual_seed(2), device=dev)
    before = _build.launch_counts().get(kcomp.KERNEL_BWD, 0)
    out = kcomp.segment_composite_vjp(pg, pix0, g, 3)
    assert _build.launch_counts()[kcomp.KERNEL_BWD] == before + 1
    ref = kcomp.segment_composite_vjp_plain(pg, pix0, g, 3)
    _, alpha = kcomp.segment_power_alpha(pg, pix0, 3)
    keep = ~((alpha - kcomp.ALPHA_MIN).abs()
             < 1e-4 * kcomp.ALPHA_MIN).flatten(1).any(1)
    assert int(keep.sum()) > 200
    scale = ref[keep].abs().amax(dim=(0, 2))
    err = (out - ref)[keep].abs().amax(dim=(0, 2)) / scale
    assert float(err.max()) < 1e-4
    x = pg.clone().requires_grad_(True)
    (auto,) = torch.autograd.grad(kcomp.segment_composite(x, pix0, 3), x, g)
    assert _build.launch_counts()[kcomp.KERNEL_BWD] == before + 2
    assert torch.equal(auto, out)


def test_composite_backward_kernel_at_the_largest_shape(dev):
    """nc = 8 and C = 512, the largest shape segment_composite takes: K7's
    shared memory (59 KB) needs the opt-in above 48 KB.  At C = 512 nearly
    every item has some alpha near the cutoff, so the gaussians with one
    get opacity 0 (alpha 0, far from it) and every item is held."""
    pg, pix0 = _composite_items(dev, 40, 512, nc=8, seed=4)
    _, alpha = kcomp.segment_power_alpha(pg, pix0, 8)
    tied = ((alpha - kcomp.ALPHA_MIN).abs()
            < 1e-4 * kcomp.ALPHA_MIN).any(-1)                 # (W, C)
    assert int(tied.sum()) < 40 * 512 // 20
    pg[:, 13] = torch.where(tied, 0.0, pg[:, 13])
    g = torch.randn((40, 9, 256), generator=torch.Generator(
        device=dev).manual_seed(5), device=dev)
    out = kcomp.segment_composite_vjp(pg, pix0, g, 8)
    ref = kcomp.segment_composite_vjp_plain(pg, pix0, g, 8)
    err = (out - ref).abs().amax(dim=(0, 2)) / ref.abs().amax(dim=(0, 2))
    assert float(err.max()) < 1e-4


def test_composite_backward_kernel_sentinel_items_give_zero(dev):
    pg = torch.zeros((64, 9, 32), device=dev)
    pg[:, 0:2] = -1e6
    pix0 = torch.zeros((64, 2), device=dev)
    g = torch.randn((64, 4, 256), device=dev)
    out = kcomp.segment_composite_vjp(pg, pix0, g, 3)
    assert torch.equal(out, torch.zeros_like(out))


def test_avatar_render_launches_k6_twice_and_matches_the_cpu(dev):
    """The render benchmark's avatar at a cut size: two K6 launches per
    frame and no other kernel; the frame against the plain path on the
    CPU."""
    kw = dict(width=96, height=64, mesh=(20, 18))
    frame, _ = bench_render.make_scene("avatar", dev, **kw)
    _build.reset_launch_counts()
    img, out = frame()
    assert _build.launch_counts() == {kcomp.KERNEL: 2}
    frame_cpu, _ = bench_render.make_scene("avatar", "cpu", **kw)
    img_cpu, out_cpu = frame_cpu()
    assert int(out["work_overflow"]) == 0 and int(out["big_overflow"]) == 0
    assert torch.equal(out["tile_counts"].cpu(), out_cpu["tile_counts"])
    # the two devices pose the mesh with other roundings, so a few pixels
    # see an alpha cross the 1/255 cutoff or two near-tied depths swap
    diff = (img.cpu() - img_cpu).abs()
    assert int((diff > 1e-4).sum()) < diff.numel() // 100
    assert float(diff.median()) < 1e-6


def _perturbed(params, device):
    """The bench's parameters moved off their ties, the same on every
    device: random offsets (at the rest pose every neighbour distance
    equals its rest length up to rounding, where the iso term's gradient
    is a rounding-decided sign), positions (the UV sphere's mirror-image
    splats share depths exactly, and an ulp of posing swaps their order),
    anisotropic scales and rotations (at isotropic scales the rotation's
    gradient is noise)."""
    gen = torch.Generator().manual_seed(3)
    rnd = lambda *shape: torch.randn(shape, generator=gen).to(device)
    s = params.splats
    return dataclasses.replace(
        params, verts_offset=0.002 * rnd(*params.verts_offset.shape),
        splats=dataclasses.replace(
            s, xyz=0.3 * rnd(*s.xyz.shape),
            scaling=s.scaling + 0.2 * rnd(*s.scaling.shape),
            rotation=rnd(*s.rotation.shape)))


def test_train_step_launches_k6_and_k7_twice_and_matches_the_cpu(dev):
    """The train benchmark's scene at a cut size, moved off its ties: one
    step's loss and gradients launch K6 twice and K7 twice and no other
    kernel, and agree with the plain path on the CPU (the loss to 1e-5;
    each float leaf and the view-space gradient per leaf relative to its
    largest entry: the devices pose the mesh with other roundings)."""
    kw = dict(width=96, height=64, mesh=(20, 18))
    runs = {}
    for device in (dev, torch.device("cpu")):
        avatar, params, _, cam, gt, msk, ao = bench_appearance.build(device,
                                                                     **kw)
        params = _perturbed(params, device)
        fn = tapp.make_loss_and_grads(
            avatar, OptimizationParams(), bench_appearance.ACTIVE_SH, False,
            tile_capacity=512, work_cap=64, chunk=32)
        _build.reset_launch_counts()
        loss, aux, grads = fn(params, 0, 0, cam[0], gt, msk, ao, *cam[1:])
        runs[device.type] = (loss, aux, grads, _build.launch_counts())
    loss, aux, grads, launches = runs["cuda"]
    assert launches == {kcomp.KERNEL: 2, kcomp.KERNEL_BWD: 2}
    loss_c, aux_c, grads_c, _ = runs["cpu"]
    assert int(aux["work_overflow"]) == 0 and int(aux["n_items"]) > 0
    assert abs(float(loss) - float(loss_c)) < 1e-5
    pairs = [(grads[k], grads_c[k]) for k in grads]
    pairs.append((aux["vgrad"], aux_c["vgrad"]))
    for a, b in pairs:
        assert _rel_err(a.cpu(), b) < 1e-4
