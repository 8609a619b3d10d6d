#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one GPU and hold every kernel against
its plain PyTorch version.

    python3 chip_smoke.py

Phases (any failure exits nonzero; no phase carries on past its own):
  1. build the CUDA kernels of mpmavatar_tpu_torch/ops/csrc (timed);
  2. the main path: the full-width cloth drop (183 x 183 cloth = 99,737
     particles, 128^3 grid, sticky floor, dt = 1e-4) for 2 frames of 100
     substeps through MPMSolver.frame, with every launch counter reset
     just before and read just after; the cloth's fall is held against
     g dt^2 n(n+1)/2 and every kernel must have launched once per substep;
     then a torch.profiler breakdown of 20 more substeps;
  3. each kernel (K1 cloth stress, K2 P2G, K5 grid pipeline, K3 G2P) at
     the main path's shapes against its plain version on the card; its
     device time from CUDA-graph replays (and, as eager_ms, back-to-back
     eager calls), beside its plain version's time and its memory/compute
     bound;
  4. 10 substeps on the kernel path against 10 on the plain path (CPU)
     from the same perturbed state, for a few seeds, beside two sound
     plain runs an ulp apart and two wrong paths (the return map without
     its friction scaling; one substep short); the elements that cross
     the return map's branch point between the paths are counted.
The last lines are the card's name and power limit, one JSON object
with every kernel's numbers, and the JSON status line.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s, FP32 FLOP/s
# outside the tensor cores.
PEAK_BYTES = 3.35e12
PEAK_FP32 = 67e12

NX, GRID, DT = 183, 128, 1e-4
FRAMES, SUBSTEPS = 2, 100
COMPARE_SUBSTEPS = 10
# tolerances: kernel vs plain on identical inputs, as max |a - b| over
# max |plain| per output (float32, reordered sums and fused multiply-adds;
# P2G's atomics also reorder the per-cell sums)
KERNEL_REL_TOL = {"cloth_stress": 1e-4, "p2g": 1e-5, "grid_pipeline": 1e-5,
                  "g2p": 1e-5}
# kernel path vs plain path over COMPARE_SUBSTEPS substeps, from
# perturbed states of PATH_SEEDS: x and v at the golden bounds of the JAX
# package.  d is ill-conditioned on this flat cloth: every element sits
# within rounding of R33 = 1, the anisotropic return map's branch point
# (separated keeps R13/R23, contact scales them to ~0), so each path picks
# branches by its own rounding, and d3 on the contact branch follows its
# triangle's normal, which a position ulp turns by ~ulp / edge.  D_TOL
# lies between the largest sound reading (kernel vs plain, and two plain
# runs whose positions differ by about an ulp: up to 3.6e-4) and a wrong
# path (the return map without its friction scaling: 6.0e-4 and up), and
# every run checks that it still does.
PATH_ATOL = {"x": 2e-5, "v": 1e-3}
D_TOL = 4.5e-4
PATH_SEEDS = (0, 1, 2)
# fall of the vertex mean against g dt^2 n(n+1)/2 (flat cloth in free
# fall: internal forces cancel)
FALL_REL_TOL = 0.02

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
    """Device time of one call of ``fn``: the call captured once in a CUDA
    graph, the graph replayed back to back and timed with CUDA events (so
    host-side launch overhead between calls is not counted)."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return event_ms(graph.replay, reps, inner, warmup=2)


def profile_substeps(solver, state, model, t, n: int):
    """torch.profiler over ``n`` substeps: (device-busy seconds, profiled
    wall seconds, [(kernel name, device us, launches)] by device time).
    Only the device-side entries are summed: an operator's entry repeats
    the time of the kernels it launched."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        solver.frame(state, model, DT, n, t)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if us > 0:
            rows.append((e.key, float(us), int(e.count)))
    rows.sort(key=lambda r: -r[1])
    return sum(r[1] for r in rows) * 1e-6, wall, rows


def rel_err(outs, refs):
    """(max abs error, max over outputs of abs error / max |ref|)."""
    worst_abs, worst_rel = 0.0, 0.0
    for a, b in zip(outs, refs):
        err = float((a - b).abs().max())
        scale = max(float(b.abs().max()), 1e-30)
        worst_abs = max(worst_abs, err)
        worst_rel = max(worst_rel, err / scale)
    return worst_abs, worst_rel


def bound(n_bytes: float, n_flops: float):
    t_bytes, t_ops = n_bytes / PEAK_BYTES, n_flops / PEAK_FP32
    if t_bytes >= t_ops:
        return 1e3 * t_bytes, "bytes"
    return 1e3 * t_ops, "operations"


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < 1:
        return 2
    try:
        from mpmavatar_tpu_torch.ops import _build
    except ImportError as exc:
        print(f"chip_smoke: the port is not importable here: {exc}",
              file=sys.stderr)
        return 2
    from mpmavatar_tpu_torch.ops import grid_pipeline as gp
    from mpmavatar_tpu_torch.ops import stress as kstress
    from mpmavatar_tpu_torch.ops import transfer as ktransfer
    from mpmavatar_tpu_torch.sim import cloth_drop

    dev = torch.device("cuda")
    smi = nvidia_smi_line()
    print(f"card: {smi}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")
    OUT.mkdir(exist_ok=True)

    # ---- 1. build -------------------------------------------------------
    t0 = time.perf_counter()
    _build.library()
    info = _build.build_info()
    print(f"build: {time.perf_counter() - t0:.2f} s "
          f"(cached={info.get('cached')}) -> {info.get('path')}")
    if info.get("log"):
        (OUT / "chip_smoke_build.log").write_text(info["log"])
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line:
                print("  ptxas:", line.strip())

    # ---- 2. main path -------------------------------------------------
    solver, state0, model = cloth_drop.build(NX, GRID, device=dev)
    cfg = solver.cfg
    E, P = cfg.n_elements, cfg.n_particles
    print(f"scene: {NX}x{NX} cloth, E={E}, V={cfg.n_vertices}, P={P}, "
          f"G={GRID}^3, dt={DT}, {FRAMES}x{SUBSTEPS} substeps")
    y0 = float(state0.x[E:, 1].mean())
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    state, t = state0, 0.0
    frame_s = []
    for f in range(FRAMES):
        t_f = time.perf_counter()
        state, t = solver.frame(state, model, DT, SUBSTEPS, t)
        torch.cuda.synchronize()
        frame_s.append(time.perf_counter() - t_f)
    launches = _build.launch_counts()
    solver.check_finite(state, "main path")
    n_sub = FRAMES * SUBSTEPS
    for name in ("cloth_stress", "p2g", "grid_pipeline", "g2p"):
        if launches.get(name, 0) != n_sub:
            raise AssertionError(f"{name} launched {launches.get(name, 0)}"
                                 f" times in {n_sub} substeps")
    fall = y0 - float(state.x[E:, 1].mean())
    expect = 9.8 * DT * DT * n_sub * (n_sub + 1) / 2.0
    if abs(fall / expect - 1.0) > FALL_REL_TOL:
        raise AssertionError(f"cloth fell {fall:.6e}, expected {expect:.6e}")
    ms_sub = 1e3 * frame_s[-1] / SUBSTEPS
    print(f"main path: launches {launches}; fall {fall:.6e} vs "
          f"g dt^2 n(n+1)/2 = {expect:.6e}; frame wall times "
          f"{[round(s, 4) for s in frame_s]} s; steady frame "
          f"{ms_sub:.4f} ms/substep = {1e3 / ms_sub:.1f} substeps/s")

    busy_s, prof_wall, rows = profile_substeps(solver, state, model, t, 20)
    table = "\n".join(f"{us:12.1f} us {calls:6d}x  {name}"
                      for name, us, calls in rows)
    (OUT / "chip_smoke_profile.txt").write_text(table + "\n")
    if not rows:
        print("profile: the profiler recorded no device time; device busy "
              "share not measured")
    else:
        idle = 100 * max(0.0, 1 - busy_s / 20 / (ms_sub * 1e-3))
        print(f"profile of 20 substeps: device busy "
              f"{1e3 * busy_s / 20:.4f} ms/substep in "
              f"{sum(r[2] for r in rows) / 20:.1f} kernels/substep, "
              f"{1e3 * prof_wall / 20:.4f} ms/substep profiled wall; "
              f"against the unprofiled steady frame the device is idle "
              f"{idle:.1f}% of the time")
    for name, us, calls in rows[:12]:
        print(f"  {us / 20:10.2f} us/substep {calls // 20:4d}/substep  "
              f"{name[:90]}")

    # ---- 3. kernels against their plain versions -----------------------
    gen = torch.Generator(device=dev).manual_seed(0)
    rnd = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    st = dataclasses.replace(state, v=state.v + 0.05 * rnd(P, 3))
    d = st.d + 0.02 * rnd(E, 3, 3)
    d[:, :, 2] *= 0.5 + 1.1 * torch.rand((E, 1), generator=gen, device=dev)
    sel_e = (torch.rand((E,), generator=gen, device=dev) > 0.1).float()
    k1_in = (d, st.R_inv, st.vol[:E], sel_e, model.mu[:E], model.lam[:E],
             model.gamma[:E], model.kappa[:E], model.friction_coeff)
    results = []

    # no single PyTorch call computes any of these functions: library_ms
    # stays null
    def check(name, outs, refs, source, replaces, run, run_plain, n_bytes,
              n_flops):
        torch.cuda.synchronize()
        err_abs, err_rel = rel_err(outs, refs)
        ok = err_rel <= KERNEL_REL_TOL[name]
        ms, eager_ms = graph_ms(run), event_ms(run)
        plain_ms = event_ms(run_plain, reps=3, inner=5)
        b_ms, b_by = bound(n_bytes, n_flops)
        print(f"{name}: max_abs_err {err_abs:.3e}, max rel-to-max err "
              f"{err_rel:.3e} (tol {KERNEL_REL_TOL[name]:.0e}) "
              f"{'ok' if ok else 'FAIL'}; {ms:.4f} ms (eager "
              f"{eager_ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
              f"{b_ms:.4f} ms by {b_by}); launches on the main path "
              f"{launches.get(name, 0)}")
        if not ok:
            raise AssertionError(f"{name} disagrees with its plain version")
        results.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches.get(name, 0),
            "max_abs_err": err_abs, "ms": ms, "eager_ms": eager_ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None})

    csrc = "mpmavatar_tpu_torch/ops/csrc/"
    k1 = kstress.cloth_stress(*k1_in)
    k1_ref = kstress.cloth_stress_plain(*k1_in)
    # bytes: 18 floats in + 27 out per element; ~310 FP32 operations per
    # element (QR 60, return map 30, stress + inverse + P 160, outputs 60)
    check("cloth_stress", k1, k1_ref, csrc + "stress.cu",
          "mpmavatar_tpu/ops/pallas_stress.py:160",
          lambda: kstress.cloth_stress(*k1_in),
          lambda: kstress.cloth_stress_plain(*k1_in),
          E * (18 + 27) * 4 + 4, E * 310.0)

    _, stress_e, f1, f2, f3 = k1
    vforce = torch.zeros((cfg.n_vertices, 3), device=dev)
    faces = st.faces.long()
    for c, fc in enumerate((f1, f2, f3)):
        vforce.index_add_(0, faces[:, c], fc)
    c_eff = 0.5 * rnd(P, 3, 3)
    sel = (st.selection == 0).float()
    k2_in = (st.x, st.v, c_eff, st.mass, sel, DT * stress_e, DT * vforce,
             GRID, cfg.inv_dx, cfg.dx)
    k2 = ktransfer.p2g(*k2_in)
    k2_ref = ktransfer.p2g_plain(*k2_in)
    n_cells = GRID ** 3
    # bytes: x, v, C, mass, sel (17 floats) per particle, stress (9) per
    # non-vertex, vforce (3) per vertex, 4 floats out per cell; ~1800 FP32
    # operations per particle (27 nodes x ~66, weights ~30)
    check("p2g", k2, k2_ref, csrc + "transfer.cu",
          "mpmavatar_tpu/ops/pallas_transfer.py:225",
          lambda: ktransfer.p2g(*k2_in), lambda: ktransfer.p2g_plain(*k2_in),
          4 * (17 * P + 9 * E + 3 * cfg.n_vertices + 4 * n_cells),
          P * 1800.0)

    pipeline = gp.make_grid_pipeline(cfg, solver.colliders.grid_post,
                                     has_mesh=False, has_mover=False)
    surf = gp.pack_surface_params(solver.colliders.grid_post)
    k5_in = (*k2, None, None, None, None, model.gravity,
             model.grid_v_damping_scale, None)
    k5_plain = lambda: gp.grid_pipeline_plain(
        *k5_in, surf, 0.01, DT, GRID, cfg.dx, (0,), False, 3)
    k5 = pipeline(*k5_in, 0.01, DT, surf)
    k5_ref = k5_plain()
    active = int((k2[1] > 1e-15).sum())
    # bytes: grid_m in and grid_v out (4 floats) per cell, grid_v in (3
    # floats) per active cell only; ~20 FP32 operations per cell
    check("grid_pipeline", [k5], [k5_ref], csrc + "grid_pipeline.cu",
          "mpmavatar_tpu/ops/pallas_grid_pipeline.py:149",
          lambda: pipeline(*k5_in, 0.01, DT, surf), k5_plain,
          16 * n_cells + 12 * active, 20.0 * n_cells)
    print(f"grid_pipeline: {active} active cells of {n_cells}")
    # every branch, on random fields: mesh, mover, sticky / slip /
    # frictional surfaces and the bounding box (the main path's cloth
    # never reaches its floor, so its sticky cells are all empty)
    from mpmavatar_tpu_torch.core.colliders import (BoundingBoxCollider,
                                                    SurfaceCollider)
    f32 = lambda *v: torch.tensor(v, device=dev)
    # plane points off the grid nodes: a node exactly on a plane is
    # inside or not by the last bit of its rounding
    cols = (SurfaceCollider(f32(0.0, 0.2017, 0.0), f32(0.0, 0.8, 0.6),
                            f32(0.0), f32(0.0), f32(1.0), 0),
            SurfaceCollider(f32(0.0, 0.503, 0.0), f32(0.0, 1.0, 0.0),
                            f32(0.3), f32(0.0), f32(1.0), 1),
            SurfaceCollider(f32(0.0, 0.0, 1.0037), f32(0.0, 0.6, 0.8),
                            f32(0.4), f32(0.0), f32(1.0), 2),
            BoundingBoxCollider(f32(0.0), f32(1.0)))
    full = gp.make_grid_pipeline(cfg, cols, has_mesh=True, has_mover=True)
    # weights in [0.5, 1.5) or exactly 0 (a third of the cells), so the
    # divisions stay well conditioned
    weight = lambda: torch.where(
        torch.rand((n_cells,), generator=gen, device=dev) > 0.33,
        0.5 + torch.rand((n_cells,), generator=gen, device=dev), 0.0)
    fields = (rnd(n_cells, 3), weight(), rnd(n_cells, 6), weight(),
              rnd(n_cells, 3), weight())
    full_in = (*fields, model.gravity, f32(0.9), f32(0.5))
    full_surf = gp.pack_surface_params(cols)
    out_full = full(*full_in, 0.01, DT, full_surf)
    ref_full = gp.grid_pipeline_plain(*full_in, full_surf, 0.01, DT, GRID,
                                      cfg.dx, (0, 1, 2), True, 3)
    e_abs, e_rel = rel_err([out_full], [ref_full])
    print(f"grid_pipeline mesh+mover+sticky+slip+frictional+bbox: "
          f"max_abs_err {e_abs:.3e}, rel {e_rel:.3e}")
    if e_rel > KERNEL_REL_TOL["grid_pipeline"]:
        raise AssertionError("grid_pipeline (all branches) disagrees")

    k3 = ktransfer.g2p(st.x, k5, GRID, cfg.inv_dx)
    k3_ref = ktransfer.g2p_plain(st.x, k5, GRID, cfg.inv_dx)
    base = torch.floor(st.x * cfg.inv_dx - 0.5).long()
    touched = torch.unique(torch.clamp(
        ktransfer.flat_indices(base, GRID), 0, n_cells - 1)).numel()
    # bytes: x in (3 floats), v, C, grad_v out (21) per particle, plus the
    # grid cells the stencils touch (3 floats each); ~1900 FP32 operations
    # per particle (27 nodes x ~70)
    check("g2p", k3, k3_ref, csrc + "transfer.cu",
          "mpmavatar_tpu/ops/pallas_transfer.py:256",
          lambda: ktransfer.g2p(st.x, k5, GRID, cfg.inv_dx),
          lambda: ktransfer.g2p_plain(st.x, k5, GRID, cfg.inv_dx),
          4 * (24 * P + 3 * touched), P * 1900.0)
    print(f"g2p: {touched} grid cells touched by the stencils")

    # ---- 4. kernel path vs plain path over several substeps ------------
    from mpmavatar_tpu_torch.core import linalg
    solver_cpu = type(solver)(cfg, device="cpu")
    solver_cpu.add_surface_collider([0.0, 0.1, 0.0], [0.0, 1.0, 0.0])
    model_cpu = model.to("cpu")
    # a wrong path: the return map without its friction scaling
    model_wrong = dataclasses.replace(
        model_cpu, friction_coeff=torch.full_like(model_cpu.friction_coeff,
                                                  1e30))
    r33 = lambda s: linalg.qr3_pos(s.d)[1][:, 2, 2].cpu()
    d_err = lambda a, b, keep=slice(None): float(
        (a.d.cpu() - b.d)[keep].abs().max()) if b.d[keep].numel() else 0.0
    t_cpu, n_cpu, sound, wrong = 0.0, 0, [], []
    for seed in PATH_SEEDS:
        g = torch.Generator(device=dev).manual_seed(1000 + seed)
        a = dataclasses.replace(state, v=state.v + 0.05 * torch.randn(
            (P, 3), generator=g, device=dev))
        b = w = a.to("cpu")
        # a sound twin: the plain path from positions about an ulp away
        c = dataclasses.replace(b, x=b.x * (1.0 + 1.2e-7 * torch.randn(
            b.x.shape, generator=torch.Generator().manual_seed(seed))))
        t_s = t
        crossed = torch.zeros(E, dtype=torch.bool)
        crossed_c = torch.zeros(E, dtype=torch.bool)
        one_d, one_n, one_r = 0.0, 0, 0.0
        for _ in range(COMPARE_SUBSTEPS):
            ra, rb = r33(a), r33(b)
            crossed |= (ra > 1.0) != (rb > 1.0)
            crossed_c |= (r33(c) > 1.0) != (rb > 1.0)
            short = b
            t_c = time.perf_counter()
            b, t_next = solver_cpu.frame(b, model_cpu, DT, 1, t_s)
            c = solver_cpu.frame(c, model_cpu, DT, 1, t_s)[0]
            w = solver_cpu.frame(w, model_wrong, DT, 1, t_s)[0]
            t_cpu, n_cpu = t_cpu + time.perf_counter() - t_c, n_cpu + 3
            a_next = solver.frame(a, model, DT, 1, t_s)[0]
            if seed == PATH_SEEDS[0]:
                # one substep of each path from the same state
                one = solver_cpu.frame(a.to("cpu"), model_cpu, DT, 1, t_s)[0]
                diff = (a_next.d.cpu() - one.d).abs().amax(dim=(1, 2))
                big = diff > 1e-5
                one_d = max(one_d, float(diff.max()))
                one_n = max(one_n, int(big.sum()))
                if bool(big.any()):
                    one_r = max(one_r, float((ra - 1.0).abs()[big].max()))
            a, t_s = a_next, t_next
        errs = {f: float((getattr(a, f).cpu() - getattr(b, f)).abs().max())
                for f in ("x", "v")}
        d_k, d_c, d_w = d_err(a, b), d_err(c, b), d_err(w, b)
        sound += [d_k, d_c]
        wrong.append(d_w)
        print(f"path vs plain path, seed {seed}, {COMPARE_SUBSTEPS} "
              f"substeps: x {errs['x']:.3e} (tol {PATH_ATOL['x']:.0e}), "
              f"v {errs['v']:.3e} (tol {PATH_ATOL['v']:.0e}), d {d_k:.3e} "
              f"(tol {D_TOL:.1e}); {int(crossed.sum())} of {E} elements "
              f"crossed R33 = 1 between the paths, d "
              f"{d_err(a, b, ~crossed):.3e} on the others; sound twin an "
              f"ulp apart: d {d_c:.3e}, {int(crossed_c.sum())} crossed; "
              f"wrong paths: no friction scaling d {d_w:.3e}, one substep "
              f"short d {d_err(short, b):.3e} (x "
              f"{float((short.x - b.x).abs().max()):.3e}, v "
              f"{float((short.v - b.v).abs().max()):.3e})")
        if seed == PATH_SEEDS[0]:
            print(f"  single substeps from the kernel path's states: d "
                  f"differs by up to {one_d:.3e}; by more than 1e-5 on at "
                  f"most {one_n} elements, all within {one_r:.3e} of "
                  f"R33 = 1")
        for field, tol in PATH_ATOL.items():
            if not errs[field] <= tol:
                raise AssertionError(f"kernel path disagrees with the "
                                     f"plain path in {field}")
        if not d_k <= D_TOL:
            raise AssertionError("kernel path disagrees with the plain path "
                                 "in d")
    if not max(sound) < D_TOL < min(wrong):
        raise AssertionError(f"D_TOL no longer separates sound runs (up to "
                             f"{max(sound):.3e}) from a wrong path (from "
                             f"{min(wrong):.3e})")
    print(f"plain path on the CPU: {1e3 * t_cpu / n_cpu:.1f} ms/substep")

    print(f"slice: {ms_sub:.4f} ms/substep, {1e3 / ms_sub:.2f} substeps/s "
          f"({P} particles, {GRID}^3 grid) on {smi}")
    print(smi)
    print(json.dumps({"kernels": results}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
