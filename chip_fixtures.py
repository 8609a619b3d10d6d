"""What ``chip_smoke.py``, ``ab_kernel_times.py`` and the tests share: the
main path's shapes, the port's kernels' seeded inputs at and beside them,
device time by CUDA-graph replay or CUDA events, the port's kernels read
from a device trace, the cut demo scene, and JAX-free copies of the JAX
suite's stage-level scenes.  Importing it imports the standard library
only; each function imports PyTorch and the port when it runs."""

from __future__ import annotations

import re
import statistics
import subprocess
from pathlib import Path

# the cloth drop and path A (183 x 183 cloth, 128^3) and path B (250^3,
# 100,000 sand): 2 frames x 100 substeps at dt = 1e-4
NX, GRID, DT = 183, 128, 1e-4
FRAMES, SUBSTEPS = 2, 100
GRID_B, SAND_B = 250, 100_000
# K4 as K5 reads it (splat_coverage): a cell is covered where its weight
# exceeds COVER_EPS (csrc/grid_pipeline.cu kEps); the kernel and the plain
# version must cover the same cells but those whose plain weight lies
# within a factor COVER_BAND of COVER_EPS (counted, and printed), and on
# the cells both cover acc / w and the unit normal must agree within the
# splat's tolerance: each is a ratio of two sums of the same n <= n_max
# terms in another order, each sum within (n - 1) 2^-24 of the sum of its
# terms' magnitudes, so the velocity within n_max 2^-23 of max |values|,
# and the normal within it times w / |acc[:, 3:6]| (opposing normals
# cancel).  A fixed-point tile would fail it where only stencil tails
# (weights far below its quantum) reach a cell
COVER_EPS, COVER_BAND = 1e-15, 2.0
# the material trainer (bench_material's production shape: 183 x 183
# hanging cloth, 200^3, the pinned top row), the tracked cloth turning at
# MAT_OMEGA about the vertical axis
MAT_NX, MAT_GRID = 183, 200
MAT_OMEGA = 2.0
# the cut demo scene (demo_cut_scene): a 48 x 48 skirt, 3,000 sand
# lowered into the grid and held by live windows, the chair, the body
# widened against the skirt's top and moving, 64^3
DEMO_CUT = dict(grid=64, skirt=(48, 48), sand_res=(30, 5, 20),
                sand_center=(-0.4, 1.2, -0.1), release=(0.0, 0.05),
                body_r=0.25, body_v=(0.0, 0.0, 0.5))
# tests/test_convergence.py's tracking iterations and stage-2 steps
STAGE_TRACK_ITERS, STAGE_PSNR_ITERS = 250, 120

REPO = Path(__file__).resolve().parent
OUT = REPO / "chiprun_out"


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def event_ms(fn, reps: int = 5, inner: int = 20, warmup: int = 3) -> float:
    """Median over ``reps`` runs of the mean time of ``inner``
    back-to-back calls, from CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        torch.cuda.synchronize()
        runs.append(a.elapsed_time(b) / inner)
    return statistics.median(runs)


def graph_ms(fn, reps: int = 5, inner: int = 20) -> float:
    """Device time of one call of ``fn``: ``inner`` calls captured in one
    CUDA graph, the graph replayed back to back and timed with CUDA events,
    per call.  Neither the host's launches of the calls nor its launch of
    each replay is counted: with one call per graph a replay of a
    1-element fill read 0.0110 ms once the profiler had run in the process
    (H100 80GB HBM3, 700 W), above a fast kernel's time."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    return event_ms(graph.replay, reps, 2, warmup=2) / inner


# the port's simulation kernels by their names in a device trace, to the
# names ops/_build.py counts their launches under
TRACE_KERNELS = {"cloth_stress_kernel": "cloth_stress",
                 "sand_kernel": "sand_stress", "p2g_kernel": "p2g",
                 "grid_pipeline_kernel": "grid_pipeline",
                 "g2p_kernel": "g2p", "splat_kernel": "splat",
                 "splat_direct_kernel": "splat", "windows_kernel": "windows"}


def traced_launches(rows) -> dict:
    """The calls of the port's simulation kernels in ``profile_device``'s
    rows, by launch-count name: what the device ran, which a replayed CUDA
    graph's launch counts (the capture's, once per replay) cannot show."""
    out = {}
    for key, _, calls in rows:
        m = re.match(r"(?:void )?\(anonymous namespace\)::(\w+)", key)
        name = TRACE_KERNELS.get(m.group(1)) if m else None
        if name is not None:
            out[name] = out.get(name, 0) + calls
    return out


def check_traced(name, rows, per_sub, n) -> dict:
    """Raise unless the device trace ``rows`` of ``n`` substeps ran each
    kernel of ``per_sub`` (name -> launches per substep) that many times
    and no other of the port's simulation kernels; returns its counts."""
    traced = traced_launches(rows)
    want = {k: per * n for k, per in per_sub.items()}
    print(f"{name}: the device trace of {n} substeps ran {traced}")
    if traced != want:
        raise AssertionError(f"{name}: the device trace of {n} substeps "
                             f"ran {traced}, expected {want}")
    return traced


def icosphere(levels: int, in_place: bool = False):
    """A unit icosahedron whose triangles are split into 4, ``levels``
    times, the new vertices pushed onto the sphere: 10 * 4^levels + 2
    vertices and 20 * 4^levels faces, wound outward, of near-equal area
    and with no pole.  Returns (verts (V, 3) float32, faces (F, 3)).

    The faces come by kind of child (each face's first child, then each
    face's second, ...), so that consecutive faces lie on the 20 faces of
    the icosahedron, all over the sphere; with ``in_place`` each face's
    four children replace it where it stood, so that consecutive faces
    are neighbours, as a mesh keeps them."""
    import numpy as np
    t = (1.0 + 5 ** 0.5) / 2.0
    verts = np.asarray([(-1, t, 0), (1, t, 0), (-1, -t, 0), (1, -t, 0),
                        (0, -1, t), (0, 1, t), (0, -1, -t), (0, 1, -t),
                        (t, 0, -1), (t, 0, 1), (-t, 0, -1), (-t, 0, 1)])
    faces = np.asarray([(0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10),
                        (0, 10, 11), (1, 5, 9), (5, 11, 4), (11, 10, 2),
                        (10, 7, 6), (7, 1, 8), (3, 9, 4), (3, 4, 2),
                        (3, 2, 6), (3, 6, 8), (3, 8, 9), (4, 9, 5),
                        (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1)])
    unit = lambda a: a / np.linalg.norm(a, axis=1, keepdims=True)
    verts = unit(verts)
    for _ in range(levels):
        edges = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]],
                                faces[:, [2, 0]]])
        ends, edge = np.unique(np.sort(edges, 1), axis=0,
                               return_inverse=True)
        ab, bc, ca = len(verts) + edge.reshape(3, -1)
        verts = np.concatenate([verts, unit(verts[ends[:, 0]]
                                            + verts[ends[:, 1]])])
        a, b, c = faces.T
        faces = np.stack([np.stack(f, -1) for f in (
            (a, ab, ca), (ab, b, bc), (ca, bc, c), (ab, bc, ca))],
            1 if in_place else 0).reshape(-1, 3)
    return verts.astype(np.float32), faces


def graph_floor_ms(dev) -> float:
    """graph_ms of a 1-element fill: what a call in a graph costs with
    next to no work."""
    import torch
    tiny = torch.zeros(1, device=dev)
    return graph_ms(tiny.zero_)


def k4_shapes(dev, gen, solver_a, state_a, scene_a, scene_p) -> dict:
    """K4's inputs at the main path's shapes and beside them, by key:
    (label, points, values, G, bounds_check).  The bench collider's faces
    (CH = 6) and the joint points (CH = 3) of path A's state at 128^3, the
    faces at 250^3; the posed body's 20,736 faces (phase 10's collider) at
    its first pose; a pole-free torso (``icosphere(5)``, 20,480 faces, on
    the posed body's ellipsoid, turning at 1 rad/s about the vertical
    axis) in its construction order and in place (``in_place``); the
    material trainer's mover (its 183 pinned points on 200^3, turning at
    MAT_OMEGA); 20,000 random points with some at base G - 3 and below 0,
    with and without the bounds check; the stencil tails of
    ``tail_lattice(16, GRID)``; the posed body's faces in a random order.
    Random draws from ``gen``."""
    import numpy as np
    import torch
    from mpmavatar_tpu_torch.core import stepping
    from mpmavatar_tpu_torch.core.colliders import MeshCollider
    from mpmavatar_tpu_torch.sim import SimTransform, pose_playback
    from mpmavatar_tpu_torch.train import bench_material
    shapes = {}
    face_pts, face_vals = stepping.mesh_face_values(
        solver_a.colliders.mesh_colliders[0], scene_a["mesh_x"],
        scene_a["mesh_v"])
    joint_pts, joint_vals = stepping.mover_points(
        solver_a.cfg, state_a, scene_a["joint_verts_v"],
        scene_a["joint_faces_v"], None)
    shapes["faces"] = (f"splat (collider faces, {GRID}^3)", face_pts,
                       face_vals, GRID, True)
    shapes["joints"] = (f"splat (joint points, {GRID}^3)", joint_pts,
                        joint_vals, GRID, True)
    shapes["faces_b"] = (f"splat (collider faces, {GRID_B}^3)", face_pts,
                         face_vals, GRID_B, True)
    in_p = scene_p.inputs(0)
    pose_pts, pose_vals = stepping.mesh_face_values(
        scene_p.solver.colliders.mesh_colliders[0], in_p["mesh_x"],
        in_p["mesh_v"])
    shapes["posed"] = (f"splat (the posed body's {len(pose_pts)} faces, "
                       f"{GRID}^3)", pose_pts, pose_vals, GRID, True)
    ico_c = torch.tensor(pose_playback.BODY_CENTER, device=dev)
    for key, in_place in (("ico", False), ("ico_in_place", True)):
        ico_v, ico_f = icosphere(5, in_place)
        ico_x = torch.as_tensor(ico_v, device=dev) * torch.tensor(
            pose_playback.BODY_RADII, device=dev) + ico_c
        rel = ico_x - ico_c
        ico_vel = torch.stack([rel[:, 2], torch.zeros_like(rel[:, 0]),
                               -rel[:, 0]], -1)
        ico_pts, ico_vals = stepping.mesh_face_values(
            MeshCollider(faces=torch.as_tensor(ico_f, device=dev),
                         friction=torch.tensor(0.5, device=dev)), ico_x,
            ico_vel)
        label = (f"splat (the icosphere torso, its faces in place, "
                 f"{GRID}^3)" if in_place else
                 f"splat (a pole-free {len(ico_pts)}-face icosphere torso, "
                 f"{GRID}^3)")
        shapes[key] = (label, ico_pts, ico_vals, GRID, True)
    cloth_m, _ = bench_material.hanging_cloth(MAT_NX, MAT_NX)
    tf_m = SimTransform.from_verts(cloth_m)
    row = cloth_m[:MAT_NX]
    row_v = MAT_OMEGA * np.stack([row[:, 2] - 1.0, np.zeros(MAT_NX),
                                  1.0 - row[:, 0]], -1)
    shapes["mover"] = (f"splat (the material trainer's {MAT_NX} pinned "
                       f"points, {MAT_GRID}^3)", tf_m.wld2sim(row, dev),
                       tf_m.vel2sim(row_v, dev), MAT_GRID, True)
    edge = 0.1 + 1.8 * torch.rand((20_000, 3), generator=gen, device=dev)
    dx = 2.0 / GRID
    edge[:2000, 0] = (GRID - 2.3) * dx + 0.4 * dx * torch.rand(
        2000, generator=gen, device=dev)          # base G - 3: dropped
    edge[2000:4000, 1] = -0.2 * torch.rand(2000, generator=gen, device=dev)
    # base -1 on x, distinct points spread over the (y, z) cells; 16 of
    # them with base (-1, -1, -1): dropped, or wrapped without the check
    edge[4000:6000, 0] = 0.45 * dx * torch.rand(2000, generator=gen,
                                                device=dev)
    edge[4000:4016] = 0.45 * dx * torch.rand((16, 3), generator=gen,
                                             device=dev)
    edge_vals = torch.randn((20_000, 6), generator=gen, device=dev)
    for bc in (True, False):
        shapes[f"random_{bc}"] = (
            f"splat (random points with base G-3 and below 0, "
            f"bounds_check={bc})", edge, edge_vals, GRID, bc)
    tail_pts, tail_vals = tail_lattice(16, GRID)
    shapes["tails"] = (f"splat (stencil tails: 3 points on each of 16^3 "
                       f"lattice sites, {GRID}^3)",
                       torch.as_tensor(tail_pts, device=dev),
                       torch.as_tensor(tail_vals, device=dev), GRID, True)
    shuffle = torch.randperm(len(pose_pts), generator=gen, device=dev)
    shapes["posed_shuffled"] = (
        f"splat (the posed body's {len(pose_pts)} faces in a random order, "
        f"{GRID}^3)", pose_pts[shuffle], pose_vals[shuffle], GRID, True)
    return shapes


def tail_lattice(n: int, g: int):
    """K4's stencil tails: n^3 sites in lattice order on bases three cells
    apart (from 4 on every axis: no two sites' stencils meet), 3 points on
    each; per site and axis the points' fractions fx = grid_pos - base are
    either all 1.5 - d (the stencil's first node weighs d^2 / 2 there) or
    all 0.5 + d (its last node), d log-uniform in [1e-4, 0.3] per point,
    so that the cells which only such tails reach carry sums of 3 weights
    from ~0.05 down to ~1e-25, many around K5's 1e-15; per point a seeded
    velocity and unit normal (CH = 6).  Returns numpy float32 (points
    (3 n^3, 3), values (3 n^3, 6)) on a grid of g cells over 2.0 (g >=
    3 n + 5)."""
    import numpy as np
    rng = np.random.default_rng(0)
    sites = 4 + 3 * np.stack(np.meshgrid(*[np.arange(n)] * 3,
                                         indexing="ij"), -1).reshape(-1, 3)
    base = np.repeat(sites, 3, axis=0)
    d = 10.0 ** rng.uniform(-4.0, np.log10(0.3), base.shape)
    first = np.repeat(rng.random(sites.shape) < 0.5, 3, axis=0)
    fx = np.where(first, 1.5 - d, 0.5 + d)
    pts = ((base + fx) * (2.0 / g)).astype(np.float32)
    nrm = rng.normal(size=(len(pts), 3))
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    vals = np.concatenate([rng.normal(size=(len(pts), 3)), nrm], 1)
    return pts, vals.astype(np.float32)


def splat_n_max(pts, g: int, bounds_check: bool) -> int:
    """The most points whose base cell is one cell, by K4's index rule."""
    import torch
    from mpmavatar_tpu_torch.ops import transfer as ktransfer
    base = torch.floor(pts * g / 2.0 - 0.5).long()
    flat = ktransfer.flat_indices(base, g)
    flat = torch.where(flat < 0, flat + g ** 3, flat)
    keep = (flat >= 0) & (flat < g ** 3)
    if bounds_check:
        keep &= torch.all((base >= 0) & (base < g - 3), dim=1)[:, None]
    return int(torch.bincount(flat[keep]).max()) if bool(keep.any()) else 0


def splat_coverage(out, ref, vals) -> dict:
    """K4's output as K5 reads it, kernel (``out``) against plain
    (``ref``): the cells covered (grid_w > COVER_EPS) by one and not the
    other, those of them whose plain weight lies within a factor
    COVER_BAND of COVER_EPS (``threshold``), and on the cells both cover
    the largest error of acc[:, :3] / w over max |values[:, :3]|
    (``velocity``) and, with CH = 6, of the normal acc[:, 3:6] /
    max(|acc[:, 3:6]|, 1e-12) over its conditioning, max(1, w /
    max(|acc[:, 3:6]|, 1e-12)) (``normal``)."""
    import torch
    (acc, w), (acc_r, w_r) = out, ref
    cov, cov_r = w > COVER_EPS, w_r > COVER_EPS
    differ = cov != cov_r
    band = ((w_r >= COVER_EPS / COVER_BAND)
            & (w_r <= COVER_EPS * COVER_BAND))
    both = cov & cov_r
    res = {"covered": int(cov_r.sum()), "differ": int(differ.sum()),
           "threshold": int((differ & band).sum()),
           "velocity": 0.0, "normal": 0.0}
    if not bool(both.any()):
        return res
    a, b, wa, wb = acc[both], acc_r[both], w[both, None], w_r[both, None]
    vmax = max(float(vals[:, :3].abs().max()), 1e-30)
    res["velocity"] = float((a[:, :3] / wa - b[:, :3] / wb).abs().max()) \
        / vmax
    if acc.shape[1] == 6:
        na = a[:, 3:].norm(dim=1, keepdim=True).clamp_min(1e-12)
        nb = b[:, 3:].norm(dim=1, keepdim=True).clamp_min(1e-12)
        cond = torch.clamp_min(wb / nb, 1.0)
        res["normal"] = float(((a[:, 3:] / na - b[:, 3:] / nb).abs()
                               / cond).max())
    return res


def k1_inputs(state, model, n_el, gen):
    """K1's inputs on a cloth state: d perturbed (off the return map's
    R33 = 1 branch point, where a flat cloth sits) and a tenth of the
    elements unselected, drawn from ``gen``."""
    import torch
    dev = state.x.device
    d = state.d + 0.02 * torch.randn((n_el, 3, 3), generator=gen, device=dev)
    d[:, :, 2] *= 0.5 + 1.1 * torch.rand((n_el, 1), generator=gen,
                                         device=dev)
    sel_e = (torch.rand((n_el,), generator=gen, device=dev) > 0.1).float()
    return (d, state.R_inv, state.vol[:n_el], sel_e, model.mu[:n_el],
            model.lam[:n_el], model.gamma[:n_el], model.kappa[:n_el],
            model.friction_coeff)


def sand_set(n, dev, all_selected=False):
    """K8's tip / cone / reflected set of ``n`` particles, seeded: F_trial
    I + 0.15 N(0, 1), its first eighth scaled by 1.5 (tr(eps) > 0: the
    tip), the next eighth by 0.5 (compression: the cone) and 100 more
    reflected (det F < 0); F_prev I + 0.05 N(0, 1); four fifths of the
    particles selected, or all of them with ``all_selected`` (path B's
    case); mu 400, lam 600, alpha 0.3."""
    import torch
    g_cpu = torch.Generator().manual_seed(7)
    f_set = torch.eye(3) + 0.15 * torch.randn((n, 3, 3), generator=g_cpu)
    f_set[: n // 8] *= 1.5                    # tr(eps) > 0: tip
    f_set[n // 8: n // 4] *= 0.5              # compression: cone
    f_set[n // 4: n // 4 + 100] = torch.diag(torch.tensor(
        [1.0, 1.0, -1.0])) @ f_set[n // 4: n // 4 + 100]
    f_prev = torch.eye(3) + 0.05 * torch.randn((n, 3, 3), generator=g_cpu)
    sel = (torch.rand(n, generator=g_cpu) > 0.2).float()
    if all_selected:
        sel = torch.ones(n)
    return tuple(a.to(dev) for a in (
        f_set, f_prev, sel, torch.full((n,), 400.0),
        torch.full((n,), 600.0), torch.tensor(0.3)))


def random_order(cfg):
    """A seeded random order of a cloth's particles: elements among
    elements, vertices among vertices (CPU int64)."""
    import torch
    g_perm = torch.Generator().manual_seed(11)
    nnv = cfg.n_no_vertices
    return torch.cat([torch.randperm(nnv, generator=g_perm),
                      nnv + torch.randperm(cfg.n_vertices,
                                           generator=g_perm)])


def demo_cut_scene(device, release: bool, friction: float = 0.5):
    """The cut demo scene: ``build_demo_sim`` at DEMO_CUT's grid, skirt
    and sand (the block lowered into the grid so that the release windows
    hold it), the chair (the skirt starts inside its box) and the capsule body
    widened to DEMO_CUT's radius, against the skirt's top, and moving at
    DEMO_CUT's velocity; the collider's friction ``friction``; the
    windows live over the run, or left out.  Returns (solver, state,
    model, frame inputs)."""
    import numpy as np
    import torch
    from mpmavatar_tpu_torch.data import make_demo_assets as mda
    from mpmavatar_tpu_torch.sim import SimTransform
    from mpmavatar_tpu_torch.train import demo as tdemo
    cloth_v, cloth_f = mda.skirt_cloth(*DEMO_CUT["skirt"])
    body_v, body_f = mda.capsule_body(radius=DEMO_CUT["body_r"])
    chair_v, chair_f = mda.chair_box()
    col_v = np.concatenate([body_v, chair_v])
    col_f = np.concatenate([body_f, chair_f + len(body_v)])
    sand, vol = tdemo.get_sand(center=DEMO_CUT["sand_center"],
                               res=DEMO_CUT["sand_res"])
    tf = SimTransform.from_verts(cloth_v)
    _, state, model, solver = tdemo.build_demo_sim(
        cloth_v, cloth_f, sand, vol, col_v, col_f, tf,
        grid_size=DEMO_CUT["grid"], mesh_friction=friction, device=device)
    if release:
        z = tf.wld2sim(sand)[:, 2]
        tdemo.sand_release_schedule(solver, state, None, (0.0, 0.0, 1.0),
                                    float(z.max()), float(z.min()),
                                    *DEMO_CUT["release"])
    mesh_x = tf.wld2sim(col_v, device)
    mesh_v = torch.zeros_like(mesh_x)
    mesh_v[:len(body_v)] = tf.vel2sim(DEMO_CUT["body_v"], device)
    return solver, state, model, {"mesh_x": mesh_x, "mesh_v": mesh_v}


def free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def stage_cloth(nx=5, ny=5, y0=1.0, extent=0.4):
    """tests/test_substep_golden.py::make_cloth (the JAX suite's cloth),
    without JAX."""
    import numpy as np
    xs = np.linspace(1.0 - extent / 2, 1.0 + extent / 2, nx)
    zs = np.linspace(1.0 - extent / 2, 1.0 + extent / 2, ny)
    verts = np.stack(np.meshgrid(xs, zs, indexing="ij"), -1).reshape(-1, 2)
    verts = np.stack([verts[:, 0], np.full(len(verts), y0), verts[:, 1]], -1)
    faces = []
    for i in range(nx - 1):
        for j in range(ny - 1):
            a = i * ny + j
            faces += [[a, a + 1, a + ny], [a + 1, a + ny + 1, a + ny]]
    return verts.astype(np.float64), np.asarray(faces, np.int32)


def lookat_cams(eyes, target=(0.0, 0.0, 0.0), w=80, h=80, f=160.0):
    """tests/test_convergence.py::_lookat_cams with the port's Camera:
    OpenCV-convention cameras at ``eyes`` looking at ``target``."""
    import numpy as np
    from mpmavatar_tpu_torch.render.cameras import Camera
    k = np.array([[f, 0.0, w / 2], [0.0, f, h / 2], [0.0, 0.0, 1.0]])
    tgt = np.asarray(target, np.float64)
    cams = []
    for i, eye in enumerate(eyes):
        eye = np.asarray(eye, np.float64)
        z = (tgt - eye) / np.linalg.norm(tgt - eye)
        x = np.cross(z, [0.0, 1.0, 0.0])
        x = x / np.linalg.norm(x)
        c2w = np.eye(4)
        c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = \
            x, np.cross(z, x), z, eye
        cams.append(Camera.from_kw2c(f"cam{i}", w, h, k,
                                     np.linalg.inv(c2w)))
    return cams


def fake_tracking_assets(path, n_frames=2, nx=5, ny=5):
    """tests/test_train.py::make_fake_tracking_assets without JAX: the
    tracking stage's params_*.npz, AO maps and UV obj under ``path``."""
    import numpy as np
    from PIL import Image
    verts, faces = stage_cloth(nx=nx, ny=ny, y0=1.0, extent=0.5)
    (path / "aomap").mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(0)
    for t in range(n_frames):
        np.savez(path / f"params_{t}.npz", vertices=verts + 0.01 * t,
                 faces=faces,
                 rgb_colors=rng.random((len(faces), 3)).astype(np.float32),
                 cam_m=np.zeros((4, 3), np.float32),
                 cam_c=np.zeros((4, 3), np.float32))
        Image.fromarray((rng.random((64, 64)) * 255).astype(np.uint8)).save(
            path / "aomap" / f"mesh_cloth_{t}.png")
    with open(path / "uv.obj", "w") as f:
        for v in verts:
            f.write(f"v {v[0]} {v[1]} {v[2]}\n")
        for i in range(len(verts)):
            f.write(f"vt {rng.random():.4f} {rng.random():.4f}\n")
        for fc in faces:
            f.write(f"f {fc[0]+1}/{fc[0]+1} {fc[1]+1}/{fc[1]+1} "
                    f"{fc[2]+1}/{fc[2]+1}\n")
    return verts, faces


def converge_tracking(make_cloth, lookat, device, work_cap=0) -> tuple:
    """tests/test_convergence.py::test_tracking_converges_to_target_mesh
    on the port: a 9 x 9 cloth tracked toward a bumped and shifted target
    seen by 3 views (the GT rendered through the tile path), 250
    iterations from the true colours; ``make_cloth`` and ``lookat`` build
    the scene (the JAX suite's or their copies).  Returns (losses, the
    mean vertex error before, after, a function that runs one more
    iteration on the first view)."""
    import numpy as np
    import torch
    from mpmavatar_tpu_torch.render import camera_arrays, rasterize
    from mpmavatar_tpu_torch.render.geometry import \
        covariance_from_scaling_rotation
    from mpmavatar_tpu_torch.train import tracking as tt
    verts, faces = make_cloth(nx=9, ny=9, y0=0.0, extent=0.7)
    verts = (verts - np.array([1.0, 0.0, 1.0])).astype(np.float32)
    tgt = verts.copy()
    tgt[:, 1] += 0.10 * np.sin(np.pi * (tgt[:, 0] + 0.35) / 0.7) \
        * np.sin(np.pi * (tgt[:, 2] + 0.35) / 0.7)
    tgt[:, 0] += 0.04
    colors = np.random.default_rng(0).random((len(faces), 3)).astype(
        np.float32)
    cams = lookat([(1.2, 1.5, 0.3), (-0.9, 1.6, 0.9), (0.2, 1.8, -1.1)])
    gt = tt.init_tracking_params(tgt, faces, max_cams=len(cams),
                                 device=device)
    gt["rgb_colors"] = torch.as_tensor(colors, device=device)
    rv = tt.params2rendervar(gt, torch.as_tensor(faces.astype(np.int64),
                                                 device=device))
    cov3d = covariance_from_scaling_rotation(rv["scales"], 1.0,
                                             rv["rotations"])
    batches = []
    for i, cam in enumerate(cams):
        out = rasterize(rv["means3d"], rv["colors"], rv["opacities"], cov3d,
                        camera_arrays(cam, device),
                        torch.zeros(3, device=device),
                        width=cam.image_width, height=cam.image_height,
                        tile_capacity=128)
        if not float(out["alpha"].sum()) > 200:
            raise AssertionError(f"camera {i} does not see the cloth")
        batches.append({"cam": cam, "camera_idx": i,
                        "rgb": out["render"].cpu().numpy(),
                        "msk": out["alpha"].cpu().numpy()})
    cfg = tt.TrackingConfig(iters_first=STAGE_TRACK_ITERS, tile_capacity=256,
                            collision_weight=0.0, work_cap=work_cap)
    tracker = tt.MeshTracker(verts, faces, cfg, max_cams=len(cams),
                             scene_radius=4.0, device=device)
    with torch.no_grad():
        tracker.params["rgb_colors"].copy_(torch.as_tensor(colors))
    body_v = np.full((8, 3), 5.0, np.float32)       # a far-away body
    body_vn = np.zeros((8, 3), np.float32)
    body_vn[:, 1] = 1.0
    err0 = float(np.linalg.norm(verts - tgt, axis=1).mean())
    losses = tracker.fit_frame(batches, body_v, body_vn, is_initial=True)
    fitted = tracker.params["vertices"].detach().cpu().numpy()
    first = tracker._device_batches(batches)[0]
    body = [torch.as_tensor(a, device=device) for a in (body_v, body_vn)]
    return (losses, err0,
            float(np.linalg.norm(fitted - tgt, axis=1).mean()),
            lambda: tracker.step(first, *body, True))


def heldout_psnr(asset_dir, lookat, device, work_cap=0) -> tuple:
    """tests/test_convergence.py::test_appearance_psnr_rises_on_heldout_view
    on the port: the avatar of the tracking assets in ``asset_dir`` (the
    JAX suite's make_fake_tracking_assets or its copy), opacity and scale
    boosted, trained for 120 steps toward a second colour assignment seen
    from 3 views (GT and held-out renders through the tile path, the
    steps through the worklist compositor when ``work_cap`` > 0).
    Returns (held-out PSNR before, after, the last loss, a function that
    runs one more step on the first view)."""
    import dataclasses
    import numpy as np
    import torch
    from mpmavatar_tpu_torch.data import OptimizationParams
    from mpmavatar_tpu_torch.render import camera_arrays
    from mpmavatar_tpu_torch.render.avatar_model import load_mesh_avatar
    from mpmavatar_tpu_torch.train.appearance import (make_optimizer,
                                                      make_train_step,
                                                      render_avatar_frame)
    avatar, params = load_mesh_avatar(str(asset_dir),
                                      str(asset_dir / "uv.obj"),
                                      sh_degree=1, capacity_factor=1.0,
                                      device=device)
    avatar = dataclasses.replace(
        avatar, verts_orig=avatar.verts_orig - np.array([1.0, 1.0, 1.0]),
        _on_device={})
    # the fresh avatar is nearly transparent at this scale: both sides
    # boosted, as the JAX test does
    with torch.no_grad():
        params.splats.opacity.fill_(3.0)
        params.splats.scaling.add_(np.log(6.0))
    tgt_dc = np.random.default_rng(1).random(
        tuple(params.splats.features_dc.shape)).astype(np.float32)
    tgt = dataclasses.replace(params, splats=dataclasses.replace(
        params.splats, features_dc=torch.as_tensor(tgt_dc, device=device)))
    cams = lookat([(0.6, 0.85, 0.25), (-0.5, 0.9, 0.45), (0.2, 1.0, -0.55),
                   (0.55, 0.8, -0.35)], w=80, h=80, f=150.0)
    ao = avatar.tensor("ao_maps", device)[0]
    bg = torch.zeros(3, device=device)

    @torch.no_grad()
    def render(p, cam):
        return render_avatar_frame(avatar, p, avatar.select_verts(p, 0), ao,
                                   cam, 0, 0, bg, False, tile_capacity=128)

    views = []
    for i, cam in enumerate(cams):
        img, out = render(tgt, cam)
        if not float(out["alpha"].sum()) > 200:
            raise AssertionError(f"camera {i} does not see the avatar")
        views.append((cam, img, out["alpha"]))
    train_views, held = views[:3], views[3]

    def psnr(p):
        img, _ = render(p, held[0])
        mse = float(torch.mean((torch.clamp(img, 0, 1) - held[1]) ** 2))
        return -10.0 * np.log10(max(mse, 1e-10))

    opt = OptimizationParams()
    step = make_train_step(avatar, opt, make_optimizer(opt, 1.0, params), 0,
                           False, tile_capacity=128, work_cap=work_cap)
    def train(it):
        cam, gt, msk = train_views[it % 3]
        return step(params, 0, it % 3, camera_arrays(cam, device), gt, msk,
                    ao, cam.image_width, cam.image_height)

    psnr0 = psnr(params)
    for it in range(STAGE_PSNR_ITERS):
        loss, _ = train(it)
    return psnr0, psnr(params), float(loss), lambda: train(0)
