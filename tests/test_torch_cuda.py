"""The port's CUDA kernels against their plain PyTorch versions on the
card, at small shapes.  They need a CUDA device and nvcc and skip
without them (a CUDA kernel has no CPU mode; the plain versions are held
against JAX by the other test_torch_* files).  This file imports neither
JAX nor the JAX package, so it runs where only PyTorch is installed:

    python -m pytest tests/test_torch_cuda.py --noconftest -m cuda
"""

import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke

from mpmavatar_tpu_torch.core import colliders as tcol
from mpmavatar_tpu_torch.core import stepping
from mpmavatar_tpu_torch.core.types import (MPMStaticConfig,
                                            build_body_sphere, build_cloth,
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
from mpmavatar_tpu_torch.sim import MPMSolver, bench_scene, pose_playback
from mpmavatar_tpu_torch.train import appearance as tapp
from mpmavatar_tpu_torch.train import bench_appearance, bench_material

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


def _stress_branch_inputs(dev, n, seed=0):
    """K1 inputs of ``n`` elements on the return map's branches, one
    quarter each by index mod 4: separated (R33 > 1), slipping (R33 < 1,
    the tangential part outside the friction cone), sticking (inside it),
    unselected; each well away from the branch points (R33 = 1, the
    cone's surface)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    rnd = lambda *s: torch.randn(s, generator=gen, device=dev)
    uni = lambda lo, hi: lo + (hi - lo) * torch.rand((n,), generator=gen,
                                                     device=dev)
    d1 = torch.tensor([0.02, 0.0, 0.0], device=dev) + 0.004 * rnd(n, 3)
    d2 = torch.tensor([0.0, 0.0, 0.02], device=dev) + 0.004 * rnd(n, 3)
    q1 = d1 / d1.norm(dim=1, keepdim=True)
    u2 = d2 - (q1 * d2).sum(1, keepdim=True) * q1
    q2 = u2 / u2.norm(dim=1, keepdim=True)
    q3 = torch.cross(q1, q2, dim=1)
    kind = torch.arange(n, device=dev) % 4
    r33 = torch.where(kind == 0, uni(1.05, 1.5), uni(0.5, 0.8))
    # fn = kappa (1 - R33)^2 >= 20 on contact; |(R13, R23)| of 0.3 gives
    # gamma |.| ~ 200 > mu_f fn, of 1e-3 gives ~0.7 < mu_f fn
    tang = torch.where(kind == 1, 0.3, torch.where(kind == 2, 1e-3, 0.1))
    r13, r23 = tang * torch.sign(rnd(n)), tang * torch.sign(rnd(n))
    d3 = r13[:, None] * q1 + r23[:, None] * q2 + r33[:, None] * q3
    d = torch.stack([d1, d2, d3], dim=2)                   # columns
    model = make_model(n, device=dev)
    r_inv = torch.stack([uni(40.0, 60.0), 5.0 * rnd(n), uni(40.0, 60.0)], 1)
    sel = (kind != 3).float()
    return (d, r_inv, uni(1e-7, 2e-7), sel, model.mu, model.lam,
            model.gamma, model.kappa, model.friction_coeff)


@pytest.mark.parametrize("n", [1, 127, 129, 66_248])
@pytest.mark.parametrize("aligned", [True, False])
def test_cloth_stress_kernel_on_every_branch_and_block_edge(dev, n,
                                                            aligned):
    """K1 against its plain version at E = 1, one short of and one past a
    block of 128 and at the full cloth's E, on every return-map branch;
    unaligned: every per-element input a view one element past the start
    of its storage, so no slab starts on a 16-byte boundary."""
    args = _stress_branch_inputs(dev, n)
    if not aligned:
        args = tuple(torch.cat([a[:1], a])[1:] if a.dim() and len(a) == n
                     else a for a in args)
        assert args[0].data_ptr() % 16 != 0 and args[0].is_contiguous()
    ref = kstress.cloth_stress_plain(*args)
    new_d, stress = ref[0], ref[1]
    # each branch is where it was built to be: d3 mapped on the separated
    # and slipping elements, kept on the sticking and unselected ones
    moved = (new_d[:, :, 2] - args[0][:, :, 2]).abs().amax(1) > 1e-6
    kind = torch.arange(n, device=dev) % 4
    assert torch.equal(moved, kind < 2)
    assert float(stress[kind == 3].abs().max() if n > 3 else 0.0) == 0.0
    before = _build.launch_counts().get(kstress.KERNEL, 0)
    out = kstress.cloth_stress(*args)
    assert _build.launch_counts()[kstress.KERNEL] == before + 1
    for a, b in zip(out, ref):
        assert _rel_err(a, b) < 1e-4


def test_cloth_stress_kernel_info(dev):
    info = kstress.kernel_info()[kstress.KERNEL]
    assert info["spill_bytes"] == 0
    assert info["blocks_per_sm"] >= 4 and info["shared_bytes"] > 0


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
    # the same wrap through the shared-memory tile: only the particles at
    # base (-1, -1, -1), whose stencil box fits the tile
    near = tuple(a[:4] if torch.is_tensor(a) and a.shape[:1] == (n,) else a
                 for a in args)
    counts = torch.zeros(2, dtype=torch.int32, device=dev)
    out = ktr.p2g(*near, branch_counts=counts)
    ref = ktr.p2g_plain(*near)
    assert counts.tolist() == [1, 0]
    assert float(ref[1].reshape(G, G, G)[G - 1].sum()) > 0.0
    for a, b in zip(out, ref):
        assert _rel_err(a, b) < 1e-5


# P2G's particle orders: the cloth in mesh order (consecutive particles
# are neighbours, each block's stencil box fits the shared-memory tile),
# the same particles in a random order and sand spread over a block (the
# boxes do not fit: the blocks add straight into the grid)
P2G_ORDERS = ("mesh", "permuted", "sand")


def _p2g_inputs(dev, order, G=128):
    gen = torch.Generator(device=dev).manual_seed(4)
    rnd = lambda *s: torch.randn(s, generator=gen, device=dev)
    if order == "sand":
        n = 20_000
        x = 0.6 + 0.8 * torch.rand((n, 3), generator=gen, device=dev)
        return (x, 0.1 * rnd(n, 3), 0.5 * rnd(n, 3, 3),
                torch.full((n,), 1e-6, device=dev), torch.ones(n, device=dev),
                DT * rnd(n, 3, 3), torch.zeros((0, 3), device=dev), G,
                G / 2.0, 2.0 / G)
    verts, faces = build_cloth(64, 64)
    cfg, st, _ = cloth_scene(verts, faces, G, device=dev)
    x, v, c, mass, sel = (st.x, 0.1 * rnd(cfg.n_particles, 3),
                          0.5 * rnd(cfg.n_particles, 3, 3), st.mass,
                          (st.selection == 0).float())
    if order == "permuted":
        # stress and vforce stay with the elements and the vertices
        nnv = cfg.n_no_vertices
        g_cpu = torch.Generator().manual_seed(5)
        perm = torch.cat([torch.randperm(nnv, generator=g_cpu),
                          nnv + torch.randperm(cfg.n_vertices,
                                               generator=g_cpu)]).to(dev)
        x, v, c, mass, sel = (a[perm] for a in (x, v, c, mass, sel))
    return (x, v, c, mass, sel, DT * rnd(cfg.n_no_vertices, 3, 3),
            DT * rnd(cfg.n_vertices, 3), G, cfg.inv_dx, cfg.dx)


@pytest.mark.parametrize("order", P2G_ORDERS)
def test_p2g_kernel_matches_plain_in_every_particle_order(dev, order):
    """K2 against its plain version at 128^3, with the blocks counted by
    branch: the mesh-ordered cloth mostly through the tile (the blocks
    that span two runs of the mesh do not fit it), the permuted cloth and
    the sand block straight into the grid."""
    args = _p2g_inputs(dev, order)
    counts = torch.zeros(2, dtype=torch.int32, device=dev)
    out = ktr.p2g(*args, branch_counts=counts)
    ref = ktr.p2g_plain(*args)
    for a, b in zip(out, ref):
        assert _rel_err(a, b) < 1e-5
    tile, direct = counts.tolist()
    # a block takes 128 consecutive particles (csrc/transfer.cu)
    assert tile + direct == -(-args[0].shape[0] // 128)
    if order == "mesh":
        assert tile > 3 * direct
    else:       # the last block's few particles may fit the tile
        assert tile <= 1 < direct


# the five kernels with a backward, at small shapes: (wrapper, plain
# version, inputs, differentiable input indices)
GRAD_KERNELS = ("cloth_stress", "sand_stress", "p2g", "g2p", "grid_pipeline",
                "splat")


def _grad_case(dev, kernel):
    cfg, st, model, rnd = _scene(dev)
    E = cfg.n_elements
    if kernel == "cloth_stress":
        sel = (torch.arange(E, device=dev) % 7 != 0).float()
        return (kstress.cloth_stress, kstress.cloth_stress_plain,
                [st.d, st.R_inv, st.vol[:E], sel, model.mu[:E],
                 model.lam[:E], model.gamma[:E], model.kappa[:E],
                 model.friction_coeff], (0, 1, 2, 4, 5, 6, 7, 8))
    if kernel == "sand_stress":
        # without the reflected particle, whose log of a negative singular
        # value is NaN
        args = _sand_set(dev)
        keep = torch.arange(len(args[0]), device=dev) != len(args[0]) // 4
        return (kstress.sand_stress, kstress.sand_stress_plain,
                [a[keep] for a in args[:5]] + args[5:], (0, 1, 3, 4, 5))
    if kernel == "splat":
        # the mover's shape: joint points (CH = 3), some dropped by the
        # bounds check
        pts = _splat_points(dev, n=200, G=cfg.n_grid)
        return (lambda *a: ksplat.splat(*a, cfg.n_grid, cfg.inv_dx),
                lambda *a: ksplat.splat_plain(*a, cfg.n_grid, cfg.inv_dx),
                [pts, rnd(len(pts), 3)], (0, 1))
    grid = (cfg.n_grid, cfg.inv_dx, cfg.dx)
    if kernel == "p2g":
        return (lambda *a: ktr.p2g(*a, *grid),
                lambda *a: ktr.p2g_plain(*a, *grid),
                [st.x, st.v, st.C, st.mass, (st.selection == 0).float(),
                 DT * rnd(cfg.n_no_vertices, 3, 3),
                 DT * rnd(cfg.n_vertices, 3)], tuple(range(7)))
    if kernel == "g2p":
        return (lambda *a: ktr.g2p(*a, cfg.n_grid, cfg.inv_dx),
                lambda *a: ktr.g2p_plain(*a, cfg.n_grid, cfg.inv_dx),
                [st.x, rnd(cfg.n_grid ** 3, 3)], (0, 1))
    f = lambda *v: torch.tensor(v, device=dev)
    post = (tcol.BoundingBoxCollider(f(0.0), f(1.0)),
            tcol.SurfaceCollider(f(1.0171, 0.0, 0.0), f(0.6, 0.8, 0.0),
                                 f(0.4), f(0.0), f(1.0), tcol.FRICTIONAL),
            tcol.SurfaceCollider(f(0.0, 0.313, 0.0), f(0.0, 1.0, 0.0),
                                 f(0.0), f(0.0), f(1.0), tcol.STICKY))
    n = cfg.n_grid ** 3
    w = lambda: 0.5 + torch.rand((n,), device=dev)
    run = gp.make_grid_pipeline(cfg, post, True, True)
    surf = gp.pack_surface_params(post)
    return (lambda *a: run(*a, 0.5, DT, surf),
            lambda *a: gp.grid_pipeline_plain(*a, surf, 0.5, DT, cfg.n_grid,
                                              cfg.dx, (2, 0), True, 3),
            [rnd(n, 3), w(), rnd(n, 6), w(), rnd(n, 3), w(),
             f(0.0, -9.8, 0.0), f(0.9), f(0.5)], tuple(range(9)))


@pytest.mark.parametrize("kernel", GRAD_KERNELS)
def test_kernel_gradient_matches_the_plain_version(dev, kernel):
    """Under grad the wrapper launches its kernel once, its outputs carry
    a grad_fn, and its gradient equals autograd over the plain version on
    the same inputs (up to the atomics in the plain version's index
    backward); without grad the outputs carry none."""
    wrapper, plain, args, wrt = _grad_case(dev, kernel)
    leaves = [a.detach().clone().requires_grad_(i in wrt)
              for i, a in enumerate(args)]
    before = _build.launch_counts().get(kernel, 0)
    outs = wrapper(*leaves)
    outs = [outs] if torch.is_tensor(outs) else list(outs)
    assert _build.launch_counts()[kernel] == before + 1
    assert all(o.grad_fn is not None for o in outs)
    gen = torch.Generator(device=dev).manual_seed(9)
    cots = [torch.randn(o.shape, generator=gen, device=dev) for o in outs]
    got = torch.autograd.grad(outs, [leaves[i] for i in wrt], cots,
                              allow_unused=True)
    ref_outs = plain(*leaves)
    ref_outs = [ref_outs] if torch.is_tensor(ref_outs) else list(ref_outs)
    ref = torch.autograd.grad(ref_outs, [leaves[i] for i in wrt], cots,
                              allow_unused=True)
    for a, b in zip(got, ref):
        assert (a is None) == (b is None)
        if a is not None:
            assert _rel_err(a, b) < 1e-5
    with torch.no_grad():
        outs = wrapper(*leaves)
    outs = [outs] if torch.is_tensor(outs) else list(outs)
    assert all(o.grad_fn is None for o in outs)


def test_substep_gradient_on_the_card_matches_the_cpu(dev):
    """d(vertex loss after 3 substeps) / d(mu, lam, mass, R_inv) on the
    card (K1, K2, K5, K3 forward, autograd over their plain versions
    backward) against the plain path on the CPU, per leaf relative to its
    largest entry.  The cloth is stretched in its plane, so that mu and
    lam see a strain well above the positions' rounding, and d3 is scaled
    to 0.9, so every element sits on the return map's contact branch,
    away from R33 = 1."""
    verts, faces = build_cloth(12, 12, y0=1.1, extent=0.5)
    grads = {}
    for device in (dev, torch.device("cpu")):
        cfg, st, model = cloth_scene(verts, faces, 32, device=device)
        gen = torch.Generator().manual_seed(7)
        v = 0.05 * torch.randn((cfg.n_particles, 3), generator=gen)
        weights = torch.randn((cfg.n_vertices, 3), generator=gen)
        scale = torch.tensor([1.15, 1.0, 0.9], device=device)
        centre = torch.tensor([1.0, 0.0, 1.0], device=device)
        x = centre + (st.x - centre) * scale
        d = st.d * scale[:, None]
        d[:, :, 2] *= 0.9
        solver = MPMSolver(cfg, device=device)
        solver.add_surface_collider([0.0, 0.1, 0.0], [0.0, 1.0, 0.0])
        leaves = [a.detach().clone().requires_grad_(True)
                  for a in (model.mu, model.lam, st.mass, st.R_inv)]
        m = dataclasses.replace(model, mu=leaves[0], lam=leaves[1])
        s = dataclasses.replace(st, x=x, d=d, v=v.to(device), mass=leaves[2],
                                R_inv=leaves[3])
        _build.reset_launch_counts()
        out, _ = solver.frame(s, m, DT, 3, 0.0)
        loss = (out.x[cfg.n_elements:] * weights.to(device)).sum()
        grads[device.type] = torch.autograd.grad(loss, leaves)
        if device.type == "cuda":
            assert _build.launch_counts() == {"cloth_stress": 3, "p2g": 3,
                                              "grid_pipeline": 3, "g2p": 3}
    for a, b in zip(grads["cuda"], grads["cpu"]):
        assert float(b.abs().max()) > 0
        assert _rel_err(a.cpu(), b) < 1e-3


def test_material_train_step_on_the_card_matches_the_cpu(dev):
    """One material train step of a small hanging cloth (pinned top row
    turning about the vertical axis, rest shape 10% shorter in y), 2
    frames x 10 substeps at dt = 1e-4: K1, K2, K5, K3 three times per
    substep (forward, the frame's recompute, the substep's recompute) and
    K4 six; the loss, d/d(D, E, H) and the stepped parameters against the
    same step on the CPU."""
    verts, faces = bench_material.hanging_cloth(12, 12)
    ang = 2.0 * np.arange(3) / 1000.0
    x, z = verts[:, 0] - 1.0, verts[:, 2] - 1.0
    train = [verts.copy() for _ in ang]
    for frame, a in zip(train, ang):
        frame[:, 0] = 1.0 + x * np.cos(a) + z * np.sin(a)
        frame[:, 2] = 1.0 - x * np.sin(a) + z * np.cos(a)
    first = verts * np.float32([1.0, 0.9, 1.0])
    out = {}
    for device in (dev, torch.device("cpu")):
        tr, *_ = bench_material.make_trainer(
            12, 12, 32, 10, 2, 10, train_verts=np.stack(train), fps=1000.0,
            first_frame_verts=first, device=device)
        loss = tr.rollout_loss(tr.params)
        grads = torch.autograd.grad(loss, [tr.params[k] for k in "DEH"])
        _build.reset_launch_counts()
        step_loss, params = tr.train_one_step()
        if device.type == "cuda":
            assert _build.launch_counts() == {
                "cloth_stress": 60, "p2g": 60, "grid_pipeline": 60,
                "g2p": 60, "splat": 120}
        out[device.type] = (float(loss.detach()), grads, step_loss, params)
    (la, ga, sa, pa), (lb, gb, sb, pb) = out["cuda"], out["cpu"]
    assert abs(la - lb) <= 1e-5 * abs(lb) and abs(sa - sb) <= 1e-5 * abs(sb)
    for a, b in zip(ga, gb):
        assert float(b) != 0.0
        assert abs(float(a) - float(b)) <= 1e-3 * abs(float(b))
    for k in "DEH":
        assert abs(pa[k] - pb[k]) <= 1e-4 * abs(pb[k])


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


@pytest.mark.parametrize("ch", [1, 3, 6, 9])
@pytest.mark.parametrize("bounds_check", [True, False])
@pytest.mark.parametrize("G", [32, 200])
def test_splat_kernel_matches_plain(dev, ch, bounds_check, G):
    """At G = 200 inv_dx (100) is not a power of two, so x * inv_dx
    rounds: the kernel must round it as the plain version does, before
    the floor and the subtraction.  A multiply contracted into them moves
    fx by up to half an ulp of x * inv_dx, which each cell's weight
    shows relative to itself (up to ~1e-2 where fx - 0.5 is small); the
    plain version's own rounding stays within a few ulps.  The random
    points' boxes do not fit the tile, so every block adds straight into
    the grid; CH = 9 takes the kernel's instantiation for more than 7
    channels (scalar atomics)."""
    pts = _splat_points(dev, G=G)
    vals = torch.randn((pts.shape[0], ch), device=dev)
    before = _build.launch_counts().get(ksplat.KERNEL, 0)
    out = ksplat.splat(pts, vals, G, G / 2.0, bounds_check)
    assert _build.launch_counts()[ksplat.KERNEL] == before + 1
    ref = ksplat.splat_plain(pts, vals, G, G / 2.0, bounds_check)
    for a, b in zip(out, ref):
        assert _rel_err(a, b) < 1e-5
    w, w_ref = out[1], ref[1]
    covered = w_ref > 1e-20
    assert float(((w - w_ref).abs() / w_ref)[covered].max()) < 1e-5



def _torso_faces(dev, seed=0):
    """The posed body's template at rest: build_body_sphere(97, 108) on
    pose_playback's torso ellipsoid, wound outward, its 20,736 faces in
    mesh order (rings of 108 quads' first triangles, then their second);
    K4's collider inputs (stepping.mesh_face_values) with seeded vertex
    velocities."""
    unit, faces = build_body_sphere(97, 108, center=(0.0, 0.0, 0.0), r=1.0)
    verts = torch.as_tensor(
        unit * np.asarray(pose_playback.BODY_RADII, np.float32)
        + np.asarray(pose_playback.BODY_CENTER, np.float32), device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    col = tcol.MeshCollider(
        faces=torch.as_tensor(faces[:, [0, 2, 1]], device=dev),
        friction=torch.tensor(0.5, device=dev))
    return stepping.mesh_face_values(
        col, verts, torch.randn(verts.shape, generator=gen, device=dev))


def _splat_shape(dev, shape):
    """(points, values, G) of a K4 branch test at 128^3."""
    if shape.startswith("tails"):
        # 3 n^3 points: enough for the tile kernel, or (", few") not
        n = int(np.ceil((ksplat.TILE_MIN_POINTS / 3) ** (1 / 3)))
        pts, vals = chip_smoke.tail_lattice(n if shape == "tails" else 6,
                                            128)
        return torch.as_tensor(pts, device=dev), torch.as_tensor(
            vals, device=dev), 128
    pts, vals = _torso_faces(dev)
    if shape == "torso shuffled":
        perm = torch.randperm(len(pts), device=dev, generator=torch.Generator(
            device=dev).manual_seed(1))
        pts, vals = pts[perm], vals[perm]
    return pts, vals, 128


@pytest.mark.parametrize("shape", ["torso", "torso shuffled", "tails",
                                   "tails, few"])
def test_splat_kernel_tile_and_direct_branches(dev, shape):
    """K4 against its plain version on the posed body's 20,736 faces in
    mesh order (most warps' stencil boxes fit their shared-memory tile),
    the same faces shuffled (every warp adds straight into the grid), on
    stencil tails (chip_smoke.tail_lattice) in the tiles, and on fewer
    tails than ops/splat.py's TILE_MIN_POINTS (the kernel with one thread
    per point and node): each output within max(1e-5, n_max 2^-23) of its
    largest entry (float sums in another order, n_max the most points on
    one base cell), and as K5 reads it (chip_smoke.splat_coverage): the
    covered cells (w > 1e-15) the same but at cells whose plain weight
    lies within 2x of 1e-15, acc / w and the unit normal on the cells both
    cover within the same tolerance."""
    pts, vals, g = _splat_shape(dev, shape)
    counts = torch.zeros(2, dtype=torch.int32, device=dev)
    before = _build.launch_counts().get(ksplat.KERNEL, 0)
    out = ksplat.splat(pts, vals, g, g / 2.0, branch_counts=counts)
    assert _build.launch_counts()[ksplat.KERNEL] == before + 1
    ref = ksplat.splat_plain(pts, vals, g, g / 2.0)
    tile, direct = counts.tolist()
    assert tile + direct == -(-len(pts) // 32)      # counted per warp
    if shape in ("torso shuffled", "tails, few"):
        assert tile == 0
    else:      # the lattice's runs of sites: a third of its warps span two
        assert len(pts) >= ksplat.TILE_MIN_POINTS
        assert tile > (direct if shape == "torso" else 0)
    tol = max(1e-5, chip_smoke.splat_n_max(pts, g, True) * 2.0 ** -23)
    for a, b in zip(out, ref):
        assert _rel_err(a, b) <= tol
    cover = chip_smoke.splat_coverage(out, ref, vals)
    assert cover["differ"] == cover["threshold"]
    assert cover["velocity"] <= tol and cover["normal"] <= tol


def test_splat_kernel_info(dev):
    """K4 as built, at CH = 6 and CH = 3: no spills, two blocks per SM."""
    for name, v in ksplat.kernel_info().items():
        assert v["spill_bytes"] == 0, name
        assert v["blocks_per_sm"] >= 2, name


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


SAND_BLOCK = 128      # K8's particles per block (csrc/sand.cu kSandThreads)


def _check_sand(args):
    """K8 against its plain version at the tolerances of
    test_sand_kernel_matches_plain: one launch, at most 2 branch flips,
    NaN positions equal, F_new within 2e-5 and the stress within 3e-5 mu
    on the rest; returns (kernel, plain) outputs with the branch codes."""
    before = _build.launch_counts().get(kstress.SAND_KERNEL, 0)
    out = kstress.sand_stress(*args, return_branch=True)
    assert _build.launch_counts()[kstress.SAND_KERNEL] == before + 1
    ref = kstress.sand_stress_plain(*args, return_branch=True)
    (f_new, stress, branch), (f_ref, st_ref, b_ref) = out, ref
    same = branch == b_ref
    assert int((~same).sum()) <= 2
    assert torch.equal(torch.isnan(stress), torch.isnan(st_ref))
    ok = same & ~torch.isnan(st_ref).flatten(1).any(1)
    if bool(ok.any()):
        mu = float(args[3].abs().max())
        assert float((f_new - f_ref)[ok].abs().max()) < 2e-5
        assert float((stress - st_ref)[ok].abs().max()) / mu < 3e-5
    return out, ref


def _odd_row_view(a):
    """``a`` as a contiguous view one row past the start of its storage:
    a (T, 3, 3) slab at a 36-byte offset, not 16-byte aligned."""
    view = torch.cat([a[:1], a])[1:]
    assert view.is_contiguous() and view.data_ptr() % 16 != 0
    return view


# T = 1, one short of and one past a block, and a T whose last slab
# (9 x 7 floats) ends in scalars past its last 16-byte vector
@pytest.mark.parametrize("t", [1, SAND_BLOCK - 1, SAND_BLOCK + 1,
                               3 * SAND_BLOCK + 7])
@pytest.mark.parametrize("aligned", [True, False])
def test_sand_kernel_on_block_edges_and_unaligned_views(dev, t, aligned):
    """K8 at block edges, and with F_trial and F_prev as views at an odd
    row offset (the slabs copied and written as scalars)."""
    args = _sand_set(dev, t=t, seed=t)
    if not aligned:
        args[0], args[1] = _odd_row_view(args[0]), _odd_row_view(args[1])
    (f_new, stress, branch), _ = _check_sand(args)
    unsel = args[2] <= 0.5
    assert torch.equal(f_new[unsel], args[1][unsel])
    assert float(stress[unsel].abs().max() if bool(unsel.any()) else 0.0) \
        == 0.0
    assert torch.equal(branch[unsel],
                       torch.zeros_like(branch[unsel]))


def _selection(kind, t, dev):
    """Selections over 4 blocks and a part block: every particle, none,
    or blocks of each kind (all selected, none, one unselected particle,
    every other one)."""
    sel = torch.ones(t)
    if kind == "none":
        sel.zero_()
    elif kind == "mixed_blocks":
        b = SAND_BLOCK
        sel[b:2 * b] = 0.0
        sel[2 * b + 37] = 0.0
        sel[3 * b::2] = 0.0
    return sel.to(dev)


@pytest.mark.parametrize("kind", ["all", "none", "mixed_blocks"])
def test_sand_kernel_reads_f_prev_where_a_block_needs_it(dev, kind):
    """The F_prev vote: a block copies F_prev's slab only where one of its
    particles is unselected.  Each unselected particle gets its own F_prev
    row exactly and zero stress; the selected ones match the plain
    version, whether their block copied F_prev or not."""
    t = 4 * SAND_BLOCK + 50
    args = _sand_set(dev, t=t)
    args[2] = _selection(kind, t, dev)
    (f_new, stress, branch), (f_ref, st_ref, b_ref) = _check_sand(args)
    unsel = args[2] <= 0.5
    assert torch.equal(f_new[unsel], args[1][unsel])
    assert torch.equal(stress[unsel], torch.zeros_like(stress[unsel]))
    assert torch.equal(branch == kstress.UNSELECTED, unsel)
    assert torch.equal(b_ref == kstress.UNSELECTED, unsel)


def test_sand_kernel_branch_counts_match_the_plain_version(dev):
    """Off the return map's ties (|tr| and |delta_gamma| of the float64
    singular values above 1e-3), K8 picks the plain version's branch for
    every particle, so the branch counts are equal there."""
    args = _sand_set(dev, t=20_000, seed=3)
    (_, _, branch), (_, _, b_ref) = _check_sand(args)
    f64 = args[0].double()
    eps = torch.log(torch.linalg.svdvals(f64).clamp_min(1e-14))
    tr = eps.sum(1)
    eh = eps - tr[:, None] / 3.0
    mu, lam, alpha = 400.0, 600.0, 0.3
    dg = eh.norm(dim=1) + (3 * lam + 2 * mu) / (2 * mu) * tr * alpha
    off = (tr.abs() > 1e-3) & (dg.abs() > 1e-3)
    assert int(off.sum()) > 15_000
    assert torch.equal(branch[off], b_ref[off])
    counts = torch.bincount(branch[off].long(), minlength=4)
    assert torch.equal(counts, torch.bincount(b_ref[off].long(),
                                              minlength=4))
    assert bool((counts > 0).all())


def test_sand_kernel_on_scaled_identities(dev):
    """F_trial = s I (s = 0.9, 1, 1.1 by particle) and s I with a
    symmetric 0.01 coupling of its first two axes: F^T F has equal
    diagonal entries, so the Jacobi rotations divide a zero difference,
    the case K8 keeps off the division's slow path.  The kernel matches
    the plain version there, each particle on the plain version's
    branch, each away from the ties: elastic (compression), the cone
    (at F = I exactly: delta_gamma = 1e-12 > 0, tr = 0), the tip
    (expansion)."""
    t = 3 * SAND_BLOCK + 5
    scale = torch.tensor([0.9, 1.0, 1.1], device=dev)[
        torch.arange(t, device=dev) % 3]
    eye = scale[:, None, None] * torch.eye(3, device=dev)
    coupled = eye.clone()
    coupled[:, 0, 1] = coupled[:, 1, 0] = 0.01
    want = torch.tensor([kstress.ELASTIC, kstress.CONE, kstress.TIP],
                        dtype=torch.int32, device=dev)[
        torch.arange(t, device=dev) % 3]
    for f_trial in (eye, coupled):
        args = _sand_set(dev, t=t)
        args[0], args[2] = f_trial, torch.ones(t, device=dev)
        (_, _, branch), (_, _, b_ref) = _check_sand(args)
        assert torch.equal(branch, b_ref)
        if f_trial is eye:
            assert torch.equal(branch, want)


def test_sand_kernel_info(dev):
    """K8 as built: no stack or spills, and path B's 100,000 particles
    (782 blocks) in one wave on the card."""
    info = kstress.kernel_info()[kstress.SAND_KERNEL]
    assert info["spill_bytes"] == 0 and info["shared_bytes"] > 0
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert info["blocks_per_sm"] * sms >= -(-100_000 // SAND_BLOCK)


def test_g2p_kernel_matches_plain(dev):
    cfg, st, model, rnd = _scene(dev)
    grid_v = rnd(cfg.n_grid ** 3, 3)
    out = ktr.g2p(st.x, grid_v, cfg.n_grid, cfg.inv_dx)
    ref = ktr.g2p_plain(st.x, grid_v, cfg.n_grid, cfg.inv_dx)
    for a, b in zip(out, ref):
        assert _rel_err(a, b) < 1e-5


# K3's particle orders: the cloth in mesh order (each block's stencil box
# fits the shared-memory tile), the same particles permuted, the cloth
# followed by randomly ordered sand (path B's shape), and blocks at both
# ends of the flat-index clip beside one inside the grid
G2P_ORDERS = ("mesh", "permuted", "cloth_and_sand", "clip_ends")
G2P_BLOCK = 256              # particles per block of K3 (csrc/transfer.cu)


def _g2p_positions(dev, order, G=128):
    gen = torch.Generator(device=dev).manual_seed(6)
    dx = 2.0 / G
    if order == "clip_ends":
        # base -1 on every axis (flat indices below 0), base G - 2 (past
        # G^3 - 1) and a block well inside
        block = (G2P_BLOCK, 3)
        low = 0.45 * dx * torch.rand(block, generator=gen, device=dev)
        high = 2.0 - 0.5 * dx - 0.9 * dx * torch.rand(block, generator=gen,
                                                      device=dev)
        mid = 1.0 + 0.5 * dx * torch.rand(block, generator=gen, device=dev)
        return torch.cat([low, high, mid])
    verts, faces = build_cloth(64, 64)
    cfg, st, _ = cloth_scene(verts, faces, G, device=dev)
    x = st.x
    if order == "permuted":
        x = x[torch.randperm(len(x), generator=gen, device=dev)]
    if order == "cloth_and_sand":
        x = torch.cat([x, 0.6 + 0.8 * torch.rand((20_000, 3), generator=gen,
                                                  device=dev)])
    return x.contiguous()


def _g2p_branches(x, G, threads=G2P_BLOCK, tile_cells=2048):
    """[tile, direct] blocks by K3's rule: a block gathers from its tile
    where its stencil box has at most tile_cells cells and lies inside
    [0, G)^3 (csrc/transfer.cu)."""
    base = torch.floor(x * (G / 2.0) - 0.5).long()
    pad = -len(base) % threads
    base = torch.cat([base, base[-1:].expand(pad, 3)])
    blocks = base.reshape(-1, threads, 3)
    lo, hi = blocks.amin(1), blocks.amax(1)
    ext = hi - lo + 3
    tile = (ext.prod(1) <= tile_cells) & (lo >= 0).all(1) \
        & (lo + ext <= G).all(1)
    return [int(tile.sum()), int((~tile).sum())]


@pytest.mark.parametrize("order", G2P_ORDERS)
def test_g2p_kernel_matches_plain_in_every_particle_order(dev, order):
    """K3 against its plain version at 128^3, its blocks counted by
    branch: the mesh-ordered cloth through the tile, the permuted cloth
    and the sand straight from the grid, and the blocks whose stencils
    reach a clipped flat index straight from the grid too."""
    G = 128
    x = _g2p_positions(dev, order, G)
    gen = torch.Generator(device=dev).manual_seed(7)
    grid_v = torch.randn((G ** 3, 3), generator=gen, device=dev)
    counts = torch.zeros(2, dtype=torch.int32, device=dev)
    out = ktr.g2p(x, grid_v, G, G / 2.0, branch_counts=counts)
    ref = ktr.g2p_plain(x, grid_v, G, G / 2.0)
    for a, b in zip(out, ref):
        assert _rel_err(a, b) < 1e-5
    tile, direct = counts.tolist()
    assert [tile, direct] == _g2p_branches(x, G)
    n_blocks = -(-len(x) // G2P_BLOCK)
    if order == "mesh":
        # only the blocks that span two distant runs of the mesh: from the
        # faces' first triangles to their second ones, and from the
        # elements to the vertices
        assert direct <= 2 and tile == n_blocks - direct
    elif order == "permuted":
        assert tile == 0
    elif order == "cloth_and_sand":
        assert direct >= 20_000 // G2P_BLOCK and tile >= 40
    else:
        assert [tile, direct] == [1, 2]


def test_g2p_kernel_info(dev):
    info = ktr.kernel_info()
    assert info[ktr.G2P_KERNEL]["spill_bytes"] == 0
    # one wave: the full cloth's 390 blocks on the card's 132 SMs
    assert info[ktr.G2P_KERNEL]["blocks_per_sm"] >= 3
    assert info[ktr.P2G_KERNEL]["blocks_per_sm"] >= 4


@pytest.mark.parametrize("case", ["single_particle_ballistic",
                                  "uniform_translation"])
def test_analytic_fixtures_through_the_kernels(dev, case):
    """tests/test_torch_analytic.py's closed-form cases on the card: K2,
    K5 and K3 every substep, and K1 for the translating cloth."""
    import test_torch_analytic
    _build.reset_launch_counts()
    getattr(test_torch_analytic, case)(dev)
    counts = _build.launch_counts()
    n = counts["g2p"]
    assert n > 0 and counts["p2g"] == counts["grid_pipeline"] == n
    assert counts.get("cloth_stress", 0) == (
        n if case == "uniform_translation" else 0)


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


@pytest.mark.parametrize("n_slabs", [2, 4])
def test_grid_pipeline_kernel_on_slabs_matches_plain(dev, n_slabs):
    """K5 from a nonzero first cell: each slab against the plain version
    from the same cell, and the slabs put together against the whole
    grid's launch, every branch on."""
    cfg = MPMStaticConfig(n_elements=0, n_traditional=1, n_vertices=0,
                          n_grid=32)
    f = lambda *v: torch.tensor(v, device=dev)
    post = (tcol.SurfaceCollider(f(0.0, 0.313, 0.0), f(0.0, 1.0, 0.0),
                                 f(0.0), f(0.0), f(1.0), tcol.STICKY),
            tcol.SurfaceCollider(f(0.0, 0.0, 1.0037), f(0.0, 0.6, 0.8),
                                 f(0.3), f(0.0), f(1.0), tcol.SLIP),
            tcol.SurfaceCollider(f(1.0171, 0.0, 0.0), f(0.6, 0.8, 0.0),
                                 f(0.4), f(0.0), f(1.0), tcol.FRICTIONAL),
            tcol.BoundingBoxCollider(f(0.0), f(1.0)))
    n = cfg.n_grid ** 3
    gen = torch.Generator(device=dev).manual_seed(2)
    rnd = lambda *s: torch.randn(s, generator=gen, device=dev)
    weight = lambda: torch.where(
        torch.rand((n,), generator=gen, device=dev) > 0.33,
        0.5 + torch.rand((n,), generator=gen, device=dev), 0.0)
    fields = (rnd(n, 3), weight(), rnd(n, 6), weight(), rnd(n, 3), weight())
    scalars = (f(0.0, -9.8, 0.0), f(0.9), f(0.5))
    run = gp.make_grid_pipeline(cfg, post, True, True)
    surf = gp.pack_surface_params(post)
    whole = run(*fields, *scalars, 0.5, DT, surf)
    k = n // n_slabs
    parts = []
    for r in range(n_slabs):
        sl = [a[r * k:(r + 1) * k] for a in fields]
        before = _build.launch_counts().get(gp.KERNEL, 0)
        out = run(*sl, *scalars, 0.5, DT, surf, cell_start=r * k)
        assert _build.launch_counts()[gp.KERNEL] == before + 1
        ref = gp.grid_pipeline_plain(*sl, *scalars, surf, 0.5, DT,
                                     cfg.n_grid, cfg.dx, (0, 1, 2), True, 3,
                                     cell_start=r * k)
        assert _rel_err(out, ref) < 1e-5
        parts.append(out)
    assert torch.equal(torch.cat(parts), whole)


@pytest.fixture(scope="module")
def nccl_group():
    """A one-rank NCCL process group in this process (the card's machine
    has one card; NCCL refuses two ranks on one device)."""
    import torch.distributed as dist
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: NCCL runs on the card")
    dist.init_process_group("nccl", init_method="tcp://localhost:"
                            f"{chip_smoke.free_port()}", rank=0, world_size=1)
    yield dist.group.WORLD
    dist.destroy_process_group()


def test_sharded_frame_over_nccl_matches_the_solver(dev, nccl_group):
    """The world-1 sharded frame through the kernels (path B's launches
    per substep) against MPMSolver.frame on the card: the bench scene
    cut to a 24 x 24 cloth, 500 sand, 48^3, the sphere collider and the
    joint pins."""
    from mpmavatar_tpu_torch.parallel import (UniformModel,
                                              make_sharded_cloth_state,
                                              make_sharded_frame)
    solver, state, model, scene = bench_scene.build(48, 500, nx=24,
                                                    device=dev)
    cfg = solver.cfg
    col = solver.colliders.mesh_colliders[0]
    gen = torch.Generator(device=dev).manual_seed(3)
    state = dataclasses.replace(state, v=state.v + 0.1 * torch.randn(
        state.v.shape, generator=gen, device=dev))
    frame = make_sharded_frame(
        cfg, nccl_group, 5, DT, num_joint_v=cfg.num_joint_v,
        grid_post=solver.colliders.grid_post, with_mesh=True,
        with_joints=True, num_joint_f=cfg.num_joint_f)
    um = UniformModel(mu=model.mu[0], lam=model.lam[0], gamma=model.gamma[0],
                      kappa=model.kappa[0],
                      friction_coeff=model.friction_coeff,
                      gravity=model.gravity, mesh_friction=col.friction,
                      alpha=model.alpha)
    _build.reset_launch_counts()
    out = frame(make_sharded_cloth_state(cfg, state, 1), um,
                scene["mesh_x"][col.faces], scene["mesh_v"][col.faces],
                scene["joint_verts_v"], scene["joint_faces_v"])
    assert _build.launch_counts() == {
        "cloth_stress": 5, "sand_stress": 5, "p2g": 5, "grid_pipeline": 5,
        "g2p": 5, "splat": 10}
    ref, _ = solver.frame(state, model, DT, 5, 0.0, **scene)
    x = torch.cat([out.xe, out.xt, out.xv])
    v = torch.cat([out.ve, out.vt, out.vv])
    assert float((x - ref.x).abs().max()) < 2e-5
    assert float((v - ref.v).abs().max()) < 1e-3


def test_collectives_autograd_over_nccl_at_world_1(dev, nccl_group):
    """At world 1 each collective is the identity forward and backward,
    on the card, under autograd."""
    from mpmavatar_tpu_torch.parallel import collectives as C
    x = torch.randn(6, 3, device=dev, dtype=torch.float64,
                    requires_grad=True)
    y = C.all_reduce(C.reduce_scatter(C.all_gather(x, nccl_group) * 2.0,
                                      nccl_group) ** 2, nccl_group)
    torch.testing.assert_close(y, (2.0 * x) ** 2)
    (g,) = torch.autograd.grad(y.sum(), x)
    torch.testing.assert_close(g, 8.0 * x)
    assert C.rank(nccl_group) == 0 and C.world_size(nccl_group) == 1
    torch.testing.assert_close(C.all_max(x, nccl_group), x.detach())
    torch.testing.assert_close(C.all_mean(x, nccl_group), x)


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


def _composite_table(dev, w, c, nc=3, seed=0):
    """(packed (N+1, 6+nc), ids (W, C) int64, pix0 (W, 2)) with N = W C / 6
    gaussians over a 64 x 64 pixel patch and the sentinel row N: per item
    a tile origin and C distinct ids, ~40% of the slots sentinels (inside
    the item and at its tail), the last four items all sentinels; a
    gaussian sits in ~3.6 items."""
    gen = torch.Generator().manual_seed(seed)
    u = lambda lo, hi, *s: lo + (hi - lo) * torch.rand(s, generator=gen)
    n = w * c // 6
    packed = torch.zeros((n + 1, 6 + nc))
    packed[:n, 0:2] = u(-4, 68, n, 2)
    sx, sy, rho = u(1, 6, n), u(1, 6, n), u(-0.6, 0.6, n)
    det = 1.0 - rho ** 2
    packed[:n, 2], packed[:n, 3], packed[:n, 4] = (
        1 / (sx ** 2 * det), -rho / (sx * sy * det), 1 / (sy ** 2 * det))
    packed[:n, 5:5 + nc] = u(0, 1, n, nc)
    packed[:n, 5 + nc] = u(0.05, 1, n)
    packed[n, 0:2] = -1e6
    ids = torch.stack([torch.randperm(n, generator=gen)[:c]
                       for _ in range(w)])
    ids[torch.rand((w, c), generator=gen) > 0.6] = n
    ids[-4:] = n
    pix0 = 16.0 * torch.randint(0, 4, (w, 2), generator=gen).float()
    return packed.to(dev), ids.to(dev), pix0.to(dev)


def _tied_items(packed, ids, pix0, nc):
    """(W,) bool: items with an alpha within 1e-4 of the 1/255 cutoff."""
    _, alpha = kcomp.segment_power_alpha(packed[ids].transpose(1, 2), pix0,
                                         nc)
    return ((alpha - kcomp.ALPHA_MIN).abs()
            < 1e-4 * kcomp.ALPHA_MIN).flatten(1).any(1)


def _check_gather_kernels(packed, ids, pix0, nc, seed):
    """K6 and K7 through segment_composite_gather against their plain
    versions: K6 to 1e-5 off the tied pixels, K7 per parameter column
    relative to its largest on the rows of gaussians in no tied item (the
    atomics add a row's items in any order), the sentinel row exactly 0,
    sentinel-only items (0, 1); the autograd backward launches K7."""
    w = ids.shape[0]
    n = len(packed) - 1
    g = torch.randn((w, nc + 1, 256), generator=torch.Generator(
        device=packed.device).manual_seed(seed), device=packed.device)
    before = _build.launch_counts()
    x = packed.clone().requires_grad_(True)
    out = kcomp.segment_composite_gather(x, ids, pix0, nc)
    (auto,) = torch.autograd.grad(out, x, g)
    d = kcomp.segment_composite_gather_vjp(packed, ids, pix0, g, nc)
    after = _build.launch_counts()
    assert after.get(kcomp.KERNEL, 0) == before.get(kcomp.KERNEL, 0) + 1
    assert after[kcomp.KERNEL_BWD] == before.get(kcomp.KERNEL_BWD, 0) + 2
    ref = kcomp.segment_composite_gather_plain(packed, ids, pix0, nc)
    err, tied_px = _composite_err(out.detach(), ref,
                                  packed[ids].transpose(1, 2), pix0, nc)
    assert err < 1e-5 and tied_px < w * 256 // 100
    sent = (ids == n).all(1)
    assert int(sent.sum()) >= 4
    assert torch.equal(out[sent, :nc], torch.zeros_like(out[sent, :nc]))
    assert torch.equal(out[sent, nc], torch.ones_like(out[sent, nc]))
    d_ref = kcomp.segment_composite_gather_vjp_plain(packed, ids, pix0, g,
                                                     nc)
    keep = torch.ones(n + 1, dtype=torch.bool, device=packed.device)
    keep[ids[_tied_items(packed, ids, pix0, nc)]] = False
    keep[n] = False
    assert int(keep.sum()) > n // 2
    # rows summed over two or more items
    assert int((torch.bincount(ids[ids < n], minlength=n) >= 2).sum()) \
        > n // 4
    scale = d_ref[keep].abs().amax(0)
    for dk in (d, auto):
        assert torch.equal(dk[n], torch.zeros_like(dk[n]))
        assert float(((dk - d_ref)[keep].abs().amax(0) / scale).max()) < 1e-4


@pytest.mark.parametrize("chunk", [32, 128])
def test_composite_gather_kernels_match_plain(dev, chunk):
    _check_gather_kernels(*_composite_table(dev, 300, chunk, seed=chunk), 3,
                          seed=chunk + 1)


def test_composite_gather_kernels_at_the_largest_shape(dev):
    """nc = 8 and C = 512: K7's shared memory needs the opt-in above 48
    KB.  At C = 512 nearly every item has an alpha near the cutoff, so the
    gaussians with one get opacity 0 (alpha 0, far from it) and every row
    is held."""
    packed, ids, pix0 = _composite_table(dev, 40, 512, nc=8, seed=6)
    _, alpha = kcomp.segment_power_alpha(packed[ids].transpose(1, 2), pix0,
                                         8)
    tied = ((alpha - kcomp.ALPHA_MIN).abs()
            < 1e-4 * kcomp.ALPHA_MIN).any(-1)                 # (W, C)
    assert int(tied.sum()) < 40 * 512 // 20
    packed[ids[tied], 13] = 0.0
    packed[-1, 13] = 0.0
    _check_gather_kernels(packed, ids, pix0, 8, seed=7)


def test_per_slot_wrappers_are_the_gathered_kernels_on_arange_ids(dev):
    """segment_composite / segment_composite_vjp launch the same K6 and K7
    as the gathered entry on the slots as a table (a sentinel row
    appended) and ids = arange: bit-equal results, since each entry of
    d(table) gets at most one atomic add onto zero."""
    pg, pix0 = _composite_items(dev, 200, 32, seed=8)
    w, rows, c = pg.shape
    table = torch.cat([pg.transpose(1, 2).reshape(w * c, rows),
                       torch.zeros((1, rows), device=dev)])
    table[-1, 0:2] = -1e6
    ids = torch.arange(w * c, device=dev).view(w, c)
    g = torch.randn((w, 4, 256), generator=torch.Generator(
        device=dev).manual_seed(9), device=dev)
    assert torch.equal(kcomp.segment_composite(pg, pix0, 3),
                       kcomp.segment_composite_gather(table, ids, pix0, 3))
    d = kcomp.segment_composite_gather_vjp(table, ids, pix0, g, 3)
    assert torch.equal(d[-1], torch.zeros_like(d[-1]))
    assert torch.equal(kcomp.segment_composite_vjp(pg, pix0, g, 3),
                       d[:-1].view(w, c, rows).transpose(1, 2))


def test_composite_kernel_info(dev):
    """The built K6 and K7 report their registers and occupancy: K7 within
    its launch bounds (at most 64 registers, four blocks per SM at the
    main path's C = 32), neither spilling."""
    info = kcomp.kernel_info(32, 3)
    for kernel in (kcomp.KERNEL, kcomp.KERNEL_BWD):
        assert info[kernel]["spill_bytes"] == 0, info
    assert info[kcomp.KERNEL_BWD]["registers"] <= 64
    assert info[kcomp.KERNEL_BWD]["blocks_per_sm"] >= 4
    assert kcomp.kernel_info(512, 8)[kcomp.KERNEL_BWD]["blocks_per_sm"] >= 1


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


def _index_gathers(monkeypatch):
    """Index shapes of every IndexBackward node in the graphs that
    torch.autograd.grad is handed from here on."""
    shapes, grad = [], torch.autograd.grad

    def spy(outputs, *args, **kw):
        nodes, stack = set(), [outputs.grad_fn]
        while stack:
            node = stack.pop()
            if node is not None and node not in nodes:
                nodes.add(node)
                stack += [f for f, _ in node.next_functions]
        shapes.extend(tuple(i.shape) for node in nodes
                      if node.name().startswith("IndexBackward")
                      for i in node._saved_indices if i is not None)
        return grad(outputs, *args, **kw)

    monkeypatch.setattr(torch.autograd, "grad", spy)
    return shapes


def test_train_step_launches_k6_and_k7_twice_and_matches_the_cpu(
        dev, monkeypatch):
    """The train benchmark's scene at a cut size, moved off its ties: one
    step's loss and gradients launch K6 twice and K7 twice and no other
    kernel, and agree with the plain path on the CPU (the loss to 1e-5;
    each float leaf and the view-space gradient per leaf relative to its
    largest entry: the devices pose the mesh with other roundings).  The
    step's graph on the card holds no gather of the parameter table by the
    worklists' (W, C) ids: K6 gathers, K7 scatters."""
    kw = dict(width=96, height=64, mesh=(20, 18))
    runs = {}
    for device in (dev, torch.device("cpu")):
        avatar, params, _, cam, gt, msk, ao = bench_appearance.build(device,
                                                                     **kw)
        params = _perturbed(params, device)
        fn = tapp.make_loss_and_grads(
            avatar, OptimizationParams(), bench_appearance.ACTIVE_SH, False,
            tile_capacity=512, work_cap=64, chunk=32)
        gathers = _index_gathers(monkeypatch) if device.type == "cuda" \
            else None
        _build.reset_launch_counts()
        loss, aux, grads = fn(params, 0, 0, cam[0], gt, msk, ao, *cam[1:])
        runs[device.type] = (loss, aux, grads, _build.launch_counts())
        monkeypatch.undo()
        if gathers is not None:
            # phase 1's ids are (tiles, 32), phase 2's (work_cap, 32); the
            # faces' (F, 3) and the bindings' gathers stay
            assert gathers and not {(24, 32), (64, 32)} & set(gathers), \
                gathers
    loss, aux, grads, launches = runs["cuda"]
    assert launches == {kcomp.KERNEL: 2, kcomp.KERNEL_BWD: 2}
    loss_c, aux_c, grads_c, _ = runs["cpu"]
    assert int(aux["work_overflow"]) == 0 and int(aux["n_items"]) > 0
    assert abs(float(loss) - float(loss_c)) < 1e-5
    pairs = [(grads[k], grads_c[k]) for k in grads]
    pairs.append((aux["vgrad"], aux_c["vgrad"]))
    for a, b in pairs:
        assert _rel_err(a.cpu(), b) < 1e-4


# ----------------------------------------------------------------------
# the avatar and the posed body (sim/pose_playback)
# ----------------------------------------------------------------------
def _body_pair(dev, tmp_path, body=(25, 28)):
    """The pose-playback body archive at a cut template, loaded onto the
    card and onto the CPU."""
    from mpmavatar_tpu_torch.avatar import load_smplx_npz
    from mpmavatar_tpu_torch.sim import pose_playback
    path = str(tmp_path / "SMPLX_NEUTRAL.npz")
    pose_playback.write_body_npz(path, *body)
    return (load_smplx_npz(path, device=dev),
            load_smplx_npz(path, device="cpu"))


def test_avatar_on_the_card_matches_the_cpu(dev, tmp_path):
    """smplx_forward and deform_tracked_to_poses (k = 10) on the card
    against the CPU, within 1e-5 of max |cpu|: float32 sums in other
    orders and another LU for the blended 4x4s' inverse."""
    from mpmavatar_tpu_torch.avatar import deform_tracked_to_poses, \
        smplx_forward
    from mpmavatar_tpu_torch.sim import pose_playback
    body, body_c = _body_pair(dev, tmp_path)
    first, poses = pose_playback.make_poses()
    on = lambda d, device: {k: torch.as_tensor(v, device=device)
                            for k, v in d.items()}
    out, ref = smplx_forward(body, on(poses, dev)), smplx_forward(
        body_c, on(poses, "cpu"))
    for f in ("vertices", "joints", "transform_mat", "v_shaped"):
        assert _rel_err(getattr(out, f).cpu(), getattr(ref, f)) < 1e-5, f
    cloth = torch.as_tensor(build_cloth(20, 20, y0=pose_playback.CLOTH_Y)[0])
    a = deform_tracked_to_poses(body, cloth.to(dev), on(first, dev),
                                on(poses, dev))
    b = deform_tracked_to_poses(body_c, cloth, on(first, "cpu"),
                                on(poses, "cpu"))
    assert _rel_err(a[0].cpu(), b[0]) < 1e-5
    assert _rel_err(a[2].cpu(), b[2]) < 1e-5


def test_vposer_on_the_card_matches_the_cpu(dev):
    from mpmavatar_tpu_torch.avatar import vposer
    dec = vposer.init_vposer(torch.Generator().manual_seed(0), device="cpu")
    z = torch.randn((8, 32), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        ref = dec(z)
        out = dec.to(dev)(z.to(dev))
    assert _rel_err(out.cpu(), ref) < 1e-5
    r = out.cpu()
    aa_d = vposer.matrix_to_axis_angle(r.to(dev))
    assert _rel_err(aa_d.cpu(), vposer.matrix_to_axis_angle(r)) < 1e-5


def test_pose_playback_goes_through_the_kernels_and_matches_the_cpu(
        dev, tmp_path):
    """The posed body at a cut size (16 x 16 cloth, 32^3, the body's
    template cut to 25 x 28): K1, K2, K5, K3 once and K4 twice per
    substep, and the kernel path against the plain path on the CPU fed
    the card's posed sequence."""
    from mpmavatar_tpu_torch.sim import pose_playback
    body, body_c = _body_pair(dev, tmp_path)
    kw = dict(nx=16, grid=32, substeps=10)
    scene = pose_playback.build(body=body, device=dev, **kw)
    cpu = pose_playback.build(body=body_c, device="cpu", **kw)
    cpu.playback = {k: v.cpu() for k, v in scene.playback.items()}
    _build.reset_launch_counts()
    out, _ = scene.solver.frame(scene.state, scene.model, DT, 10, 0.0,
                                **scene.inputs(0))
    assert _build.launch_counts() == {
        "cloth_stress": 10, "p2g": 10, "splat": 20, "grid_pipeline": 10,
        "g2p": 10}
    ref, _ = cpu.solver.frame(cpu.state, cpu.model, DT, 10, 0.0,
                              **cpu.inputs(0))
    for name, atol in (("x", 2e-5), ("v", 1e-3)):
        err = float((getattr(out, name).cpu() - getattr(ref, name)).abs()
                    .max())
        assert err < atol, (name, err)


def test_bake_ao_on_the_card_matches_the_cpu(dev):
    """The AO bake on the card against the CPU on the bench's body mesh
    (the port's 20 x 18 cut) under a spherical UV chart at 64^2, per
    texel within 1e-5 (the same float32 formulas; the occupancy counts
    exact)."""
    from mpmavatar_tpu_torch.render.ao import bake_ao, rasterize_uv_chart
    verts, faces = bench_render.build_body_mesh(n_theta=20, n_phi=18)
    uv = np.stack([(np.arctan2(verts[:, 2], verts[:, 0]) + np.pi)
                   / (2 * np.pi), 0.5 + verts[:, 1] / 1.8], -1)
    chart = rasterize_uv_chart(uv.astype(np.float32), faces, resolution=64)
    args = (chart.face_idx, chart.bary, chart.texel_ij)
    out = bake_ao(torch.as_tensor(verts, device=dev),
                  torch.as_tensor(faces, device=dev), *args, resolution=64,
                  texel_chunk=512)
    ref = bake_ao(torch.as_tensor(verts), torch.as_tensor(faces), *args,
                  resolution=64)
    assert float((out.cpu() - ref).abs().max()) <= 1e-5
    assert float(ref.min()) < 0.9


def test_avatar_checkpoint_round_trip_on_the_card(dev, tmp_path):
    """A checkpoint of the bench avatar (cut) with some slots dead saved
    from the card and loaded on the card: the alive splats packed in
    order, the other arrays equal."""
    from mpmavatar_tpu_torch.render import avatar_model as am
    avatar, params, n = bench_render.build_avatar(
        capacity=1400, n_theta=20, n_phi=18, device=dev)
    alive = params.splats.alive.clone()
    alive[::5] = False
    params = dataclasses.replace(params, splats=dataclasses.replace(
        params.splats, alive=alive,
        xyz=torch.randn_like(params.splats.xyz) * 0.01))
    am.save_avatar_checkpoint(str(tmp_path), params, avatar)
    loaded = am.load_avatar_checkpoint(str(tmp_path), params)
    k = int(alive.sum())
    assert loaded.splats.xyz.device.type == "cuda"
    assert bool(loaded.splats.alive[:k].all()) and \
        not bool(loaded.splats.alive[k:].any())
    for f in ("xyz", "features_dc", "features_rest", "scaling", "rotation",
              "opacity", "binding"):
        assert torch.equal(getattr(loaded.splats, f)[:k],
                           getattr(params.splats, f)[alive]), f
    for f in ("verts_offset", "cam_m", "cam_c"):
        assert torch.equal(getattr(loaded, f), getattr(params, f)), f
    assert all(torch.equal(loaded.shadow[key], v)
               for key, v in params.shadow.items())


def test_demo_cut_scene_goes_through_the_kernels_and_matches_the_cpu(dev):
    """chip_smoke's cut demo scene (a 48 x 48 skirt, 3,000 sand held by
    live release windows, the body and the chair in contact, 64^3): 10
    substeps launch K1, K2, K5, K3, K4 (the collider) and K8 once each
    and match the CPU plain path (x 2e-5, v 1e-3)."""
    s_k, st_k, m_k, in_k = chip_smoke.demo_cut_scene(dev, True)
    s_c, _, m_c, in_c = chip_smoke.demo_cut_scene("cpu", True)
    g = torch.Generator(device=dev).manual_seed(4)
    a0 = dataclasses.replace(st_k, v=st_k.v + 0.05 * torch.randn(
        st_k.v.shape, generator=g, device=dev))
    _build.reset_launch_counts()
    out, _ = s_k.frame(a0, m_k, DT, 10, 0.0, **in_k)
    assert _build.launch_counts() == {
        "cloth_stress": 10, "p2g": 10, "grid_pipeline": 10, "g2p": 10,
        "splat": 10, "sand_stress": 10}
    ref, _ = s_c.frame(a0.to("cpu"), m_c, DT, 10, 0.0, **in_c)
    for name, atol in (("x", 2e-5), ("v", 1e-3)):
        err = float((getattr(out, name).cpu() - getattr(ref, name)).abs()
                    .max())
        assert err < atol, (name, err)


def test_tracking_loss_through_k6_k7_matches_the_cpu(dev):
    """One tracking loss and its gradient w.r.t. every parameter on a
    jittered 6 x 6 cloth at 32^2 through the worklist compositor: K6 and
    K7 twice each on the card, the loss within 1e-5 and each gradient
    within 1e-4 of its largest entry of the CPU's."""
    from mpmavatar_tpu_torch.render import camera_arrays
    from mpmavatar_tpu_torch.render.cameras import Camera
    from mpmavatar_tpu_torch.train import tracking as tt
    rng = np.random.default_rng(0)
    verts, faces = build_cloth(6, 6, y0=0.0, extent=0.8)
    verts = (verts - np.float32([1.0, 0.0, 1.0]))[:, [0, 2, 1]]
    verts[:, 2] = 0.03 * rng.normal(size=len(verts))
    cam = Camera.from_kw2c("t", 32, 32, np.array(
        [[20.0, 0, 16], [0, 20.0, 16], [0, 0, 1]]), np.array(
        [[1.0, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 2.0], [0, 0, 0, 1]]),
        near=0.5, far=20.0)
    gt = rng.random((3, 32, 32)).astype(np.float32)
    msk = (rng.random((1, 32, 32)) > 0.2).astype(np.float32)
    colors = rng.uniform(0.2, 0.8, (len(faces), 3)).astype(np.float32)
    cfg = tt.TrackingConfig(tile_capacity=64, work_cap=256)
    out = {}
    for d in (dev, torch.device("cpu")):
        params = tt.init_tracking_params(verts, faces, 2, d)
        with torch.no_grad():
            params["rgb_colors"].copy_(torch.as_tensor(colors))
        for v in params.values():
            v.requires_grad_(True)
        var = tt.init_tracking_variables(verts, faces, None, d)
        _build.reset_launch_counts()
        loss, _ = tt.tracking_loss(
            params, var, camera_arrays(cam, d), 32, 32, 1,
            torch.as_tensor(gt, device=d), torch.as_tensor(msk, device=d),
            None, None, None, True, cfg)
        loss.backward()
        out[d.type] = (float(loss), {k: v.grad.cpu() for k, v in
                                     params.items()},
                       _build.launch_counts())
    assert out["cuda"][2] == {"composite": 2, "composite_bwd": 2}
    assert abs(out["cuda"][0] - out["cpu"][0]) <= 1e-5
    for k, ref in out["cpu"][1].items():
        assert _rel_err(out["cuda"][1][k], ref) <= 1e-4, k
