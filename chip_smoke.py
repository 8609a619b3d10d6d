#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one GPU and hold every kernel against
its plain PyTorch version.

    python3 chip_smoke.py

Phases (any failure exits nonzero; no phase carries on past its own):
  1. build the CUDA kernels of mpmavatar_tpu_torch/ops/csrc (timed);
  2. the paths, each through MPMSolver.frame with every launch counter
     reset just before it and read just after, each kernel's launches
     held to its count per substep, and a torch.profiler breakdown of 20
     more substeps:
     - the cloth drop (183 x 183 cloth = 99,737 particles, 128^3 grid,
       sticky floor, dt = 1e-4), 2 frames x 100 substeps; the cloth's
       fall is held against g dt^2 n(n+1)/2;
     - path A, the bench's garment substep (sim/bench_scene.py --grid
       128: the same cloth on the bench's sphere collider with 256 pinned
       vertices and 128 pinned faces), 2 x 100 substeps; the pinned
       vertices must not move;
     - path B, the bench's demo shape (--grid 250 --sand 100000: 199,737
       particles), 2 x 100 substeps; the sand's fall is held against
       g dt^2 n(n+1)/2;
  3. the drape: the cloth drop onto the still body sphere for 3,000
     substeps; no cloth vertex may end deeper than DRAPE_TOL inside the
     sphere, beside the same run without the collider (which falls
     through), and K5's mesh branch must change the velocity of some
     cells;
  4. each kernel (K1 cloth stress, K2 P2G, K5 grid pipeline with its mesh
     and mover fields, K3 G2P, K4 splat, K8 sand stress) at the paths'
     shapes against its plain version on the card; its device time from
     CUDA-graph replays (and, as eager_ms, back-to-back eager calls),
     beside its plain version's time and its memory/compute bound;
  5. 10 substeps on the kernel path against 10 on the plain path (CPU)
     from the same perturbed states, for a few seeds:
     - the cloth drop, beside two sound plain runs an ulp apart and two
       wrong paths (the return map without its friction scaling; one
       substep short); the elements that cross the return map's branch
       point between the paths are counted;
     - a contact scene (the bench scene cut to a 48 x 48 cloth, 64^3 and
       3,000 sand particles, the sphere's top under the cloth rising into
       it), beside two wrong paths (collider friction 0; the mover left
       out);
  6. the render path (render/bench_render.py's scenes at full width): the
     stage-2 avatar (50,244 splats of 65,536, SH 3, shadow UNet 256^2,
     1500 x 1000) through render_avatar_frame, and the two 1080p splat
     scenes (50,000 gaussians, small and big) through rasterize, each for
     RENDER_FRAMES frames with the launch counters reset just before and
     read just after (2 K6 launches per frame, no other kernel), zero
     overflow, and a profile of one more frame; K6 (which gathers each
     item's live rows of the parameter table itself and skips the
     sentinel slots) against its gathered plain version on each scene's
     own table and worklists (avatar phases 1 and 2 at C = 32,
     big_splats' phase 2 at C = 128) and on sentinel-only items, the
     alpha-cutoff ties counted; the avatar frame through K6 against the
     frame through the plain version, beside a wrong path (compositing
     back to front); one gaussian on a 1080p frame against the analytic
     alpha;
  7. the stage-2 train step (train/bench_appearance.py's scene: the
     avatar of phase 6 with a seeded random GT, the full regularizer set,
     per-group Adam) for TRAIN_STEPS steps with the launch counters reset
     just before and read just after (2 K6 and 2 K7 launches per step, no
     other kernel), steady ms/step (the median of the steps after
     WARM_STEPS, with its range), peak memory and a profile of one more
     step, and by input shape for the indexing backwards (none may be of
     the worklists' (W, C) ids); K7 (d of the parameter table, added with
     atomics) against its plain version on the step's own worklists and
     cotangents (phases 1 and 2, captured with a hook), on big_splats'
     C = 128 worklist and on sentinel-only items; the step's gradients
     (every float leaf and the view-space gradient) through K7 against
     the same step through the plain compositor, beside a wrong path (K7
     with the transmittance cotangent dropped); SSIM's share of the step;
     one densification pass (alive splats before and after, at least one
     per face); LOSS_STEPS steps, the opacity group frozen, toward the
     avatar rendered with a second seed's colours, whose L1 must fall by
     more than through K7 with its colour rows zeroed.
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
PROFILE_SUBSTEPS = 20
GRID_B, SAND_B = 250, 100_000
COMPARE_SUBSTEPS = 10
# tolerances: kernel vs plain on identical inputs, as max |a - b| over
# max |plain| per output (float32, reordered sums and fused multiply-adds;
# P2G's and the splat's atomics also reorder the per-cell sums)
KERNEL_REL_TOL = {"cloth_stress": 1e-4, "p2g": 1e-5, "grid_pipeline": 1e-5,
                  "g2p": 1e-5, "splat": 1e-5}
# ... and for the splat at least n_max ulps (2^-23 each) of the largest
# sum, n_max the most points that reach one cell: a float32 sum of n terms
# in another (atomic) order differs by up to ~n/2 ulps, and the bench
# sphere's 96 zero-area pole faces and the thin faces around them pile
# their centroids into a few cells
# K8, on the particles whose return-map branch is the same in both: F_new
# (O(1)) absolutely, the stress relative to mu.  The stress is
# (2 mu + 3 lam) log s ~ 10 mu log s, and log s of s ~ 1 carries ~1e-7 of
# rounding; the Jacobi SVD works on F^T F, squaring F's condition number,
# so small singular values lose more.  The branch tests (delta_gamma > 0,
# tr > 0) sit on rounding ties where F_trial ~ I (free-falling sand):
# those particles are counted, not held.
SAND_F_TOL, SAND_STRESS_TOL_MU = 2e-5, 3e-5
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
# fall of the vertex (or sand) mean against g dt^2 n(n+1)/2 (free fall:
# internal forces cancel)
FALL_REL_TOL = 0.02
# path A: the pinned vertices' whole stencil is covered by their own
# zero-velocity mover splat
PIN_TOL = 1e-6
# the drape: 3,000 substeps (0.3 s; the cloth reaches the sphere's top at
# 1.1 after ~0.2 s); the deepest cloth vertex inside the sphere, at most
# one cell (dx = 2/128)
DRAPE_SUBSTEPS = 3000
DRAPE_TOL = 2.0 / GRID
# the contact scene: the bench scene cut down, the sphere's top 0.02 under
# the cloth (y = 1.3; under one cell, dx = 2/64) and rising at 0.5 m/s
CONTACT = dict(grid=64, sand=3000, nx=48, body_center=(1.0, 1.03, 1.0),
               body_r=0.25)
CONTACT_MESH_V = (0.0, 0.5, 0.0)

# the render path (phase 6): frames per scene; K6 against its plain
# version as max |a - b| / max |plain| per output on the pixels with no
# alpha within CUTOFF_BAND (relative) of the 1/255 cutoff (there expf and
# torch.exp may fall on either side; such pixels are counted, and no pixel
# outside them may differ by more than K6_REL_TOL); the avatar frame
# through K6 against the frame through the plain version, max abs over
# image and alpha on the frame's pixels with no such tie (a flipped
# cutoff moves a pixel by up to 1/255 of its colour; those pixels are
# counted and their largest difference printed), with a wrong path (back
# to front) read beside it; one gaussian's alpha against
# o exp(-d^T conic d / 2) in float64
RENDER_FRAMES = 4
K6_REL_TOL = 1e-5
CUTOFF_BAND = 1e-4
FRAME_TOL = 1e-5
ANALYTIC_TOL = 1e-5

# the train path (phase 7): steps driven and counted (the steady step is
# the median of those after the warm-up), steps toward the second seed's
# colours; K7 against its plain version as max |a - b| /
# max |plain| per parameter row, on the items with no evaluation within
# CUTOFF_BAND of the cutoff (a flip there moves every gradient of the
# pixel): each entry is a sum over 256 pixels of terms carried through the
# T and S recurrences, against autograd's reverse cumulative sums in
# another order; the step's gradients through K7 against the step through
# the plain compositor, per leaf relative to its largest entry or to a
# millionth of the step's largest gradient, whichever is larger (both
# forwards are K6-exact to ~4e-7 and cutoff flips between expf and
# torch.exp move a few pixels), with the wrong path read beside it
TRAIN_STEPS = 7
WARM_STEPS = 2
LOSS_STEPS = 30
K7_REL_TOL = 1e-4
STEP_GRAD_TOL = 1e-3

REPO = Path(__file__).resolve().parent
OUT = REPO / "chiprun_out"
CSRC = "mpmavatar_tpu_torch/ops/csrc/"


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


def profile_device(fn):
    """torch.profiler over one call of ``fn``: (device-busy seconds,
    profiled wall seconds, [(kernel name, device us, launches)] by device
    time).  Only the device-side entries are summed: an operator's entry
    repeats the time of the kernels it launched."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
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


def drive(name, solver, state, model, scene, frames, substeps, expect):
    """One path: ``frames`` x ``substeps`` substeps with the launch
    counters reset just before and read just after; each kernel in
    ``expect`` (name -> launches per substep) must have launched that
    many times and no other kernel at all.  Then a profile of
    PROFILE_SUBSTEPS more.  Returns (final state, time, launches, steady
    ms/substep)."""
    import torch
    from mpmavatar_tpu_torch.ops import _build
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    t, frame_s = 0.0, []
    for _ in range(frames):
        t_f = time.perf_counter()
        state, t = solver.frame(state, model, DT, substeps, t, **scene)
        torch.cuda.synchronize()
        frame_s.append(time.perf_counter() - t_f)
    launches = _build.launch_counts()
    solver.check_finite(state, name)
    n_sub = frames * substeps
    want = {k: per * n_sub for k, per in expect.items()}
    if launches != want:
        raise AssertionError(f"{name}: launches {launches}, expected {want}")
    ms_sub = 1e3 * frame_s[-1] / substeps
    print(f"{name}: launches {launches} in {n_sub} substeps; frame wall "
          f"times {[round(s, 4) for s in frame_s]} s; steady frame "
          f"{ms_sub:.4f} ms/substep = {1e3 / ms_sub:.1f} substeps/s")

    busy_s, prof_wall, rows = profile_device(
        lambda: solver.frame(state, model, DT, PROFILE_SUBSTEPS, t, **scene))
    n = PROFILE_SUBSTEPS
    table = "\n".join(f"{us:12.1f} us {calls:6d}x  {key}"
                      for key, us, calls in rows)
    (OUT / f"chip_smoke_profile_{name}.txt").write_text(table + "\n")
    if not rows:
        print(f"{name} profile: the profiler recorded no device time; "
              "device busy share not measured")
    else:
        idle = 100 * max(0.0, 1 - busy_s / n / (ms_sub * 1e-3))
        print(f"{name} profile of {n} substeps: device busy "
              f"{1e3 * busy_s / n:.4f} ms/substep in "
              f"{sum(r[2] for r in rows) / n:.1f} kernels/substep, "
              f"{1e3 * prof_wall / n:.4f} ms/substep profiled wall; "
              f"against the unprofiled steady frame the device is idle "
              f"{idle:.1f}% of the time")
    for key, us, calls in rows[:12]:
        print(f"  {us / n:10.2f} us/substep {calls // n:4d}/substep  "
              f"{key[:90]}")
    return state, t, launches, ms_sub


def sphere_depth(x, center, r):
    """Deepest point of ``x`` (N, 3) inside the sphere (negative: all
    outside)."""
    import torch
    c = torch.tensor(center, dtype=x.dtype, device=x.device)
    return float((r - (x - c).norm(dim=1)).max())


def composite_calls(run):
    """[packed, ids, pix0] of each K6 call of one more ``run``, and the
    cotangent that K7 receives where ``run`` differentiates through the
    call (a hook on the segment output keeps it)."""
    from unittest import mock
    from mpmavatar_tpu_torch.ops import composite as kcomp
    from mpmavatar_tpu_torch.render import rasterizer
    calls = []

    def record(packed, ids, pix0, nc):
        out = kcomp.segment_composite_gather(packed, ids, pix0, nc)
        entry = [packed.detach(), ids, pix0]
        if out.requires_grad:
            out.register_hook(lambda g: entry.append(g.detach().clone()))
        calls.append(entry)
        return out

    with mock.patch.object(rasterizer, "segment_composite_gather", record):
        run()
    return calls


def live_slots(packed, ids, nc):
    """(W, C) bool: the slots that hold a gaussian of nonzero opacity (the
    sentinel row N has opacity 0, as have the dead splats)."""
    return packed[:, 5 + nc][ids] > 0


def render_path(dev, check) -> dict:
    """Phase 6: each render scene driven with the launch counters reset
    just before and read just after, K6 against its plain version on the
    scenes' own worklists, the kernel-path frame against the plain-path
    frame beside a wrong path, and the analytic single gaussian.  Returns
    scene -> (steady ms/frame, launches)."""
    import numpy as np
    import torch
    from unittest import mock
    from mpmavatar_tpu_torch.ops import _build
    from mpmavatar_tpu_torch.ops import composite as kcomp
    from mpmavatar_tpu_torch.render import (bench_render, camera_arrays,
                                            rasterize, rasterizer)

    nc = 3
    scenes = {}
    for name in bench_render.SCENES:
        t0 = time.perf_counter()
        frame, info = bench_render.make_scene(name, dev)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        _build.reset_launch_counts()
        frame_s = []
        for _ in range(RENDER_FRAMES):
            t_f = time.perf_counter()
            img, out = frame()
            torch.cuda.synchronize()
            frame_s.append(time.perf_counter() - t_f)
        launches = _build.launch_counts()
        want = {kcomp.KERNEL: 2 * RENDER_FRAMES}
        if launches != want:
            raise AssertionError(f"render {name}: launches {launches}, "
                                 f"expected {want}")
        bench_render.check_overflow(out, name)
        if img.shape != (nc, info["height"], info["width"]) or \
                not bool(torch.isfinite(img).all()):
            raise AssertionError(f"render {name}: image {tuple(img.shape)} "
                                 "not finite or of the wrong shape")
        ms = 1e3 * frame_s[-1]
        counts = out["tile_counts"]
        print(f"render {name} ({info['width']}x{info['height']}, "
              f"{info['gaussians']} gaussians): set-up {setup_s:.2f} s; "
              f"launches {launches} in {RENDER_FRAMES} frames; frame wall "
              f"times {[round(1e3 * f, 3) for f in frame_s]} ms; "
              f"{counts.numel()} tiles, {int(counts.sum())} instances "
              f"(most on one tile {int(counts.max())}), phase-2 items "
              f"{int(out['n_items'])} of work_cap {info['work_cap']}; "
              f"alpha mean {float(out['alpha'].mean()):.4f}")
        busy_s, prof_wall, rows = profile_device(frame)
        (OUT / f"chip_smoke_profile_render_{name}.txt").write_text(
            "\n".join(f"{us:12.1f} us {calls:6d}x  {key}"
                      for key, us, calls in rows) + "\n")
        if rows:
            idle = 100 * max(0.0, 1 - busy_s / (ms * 1e-3))
            print(f"  profile of one frame: device busy {1e3 * busy_s:.4f} "
                  f"ms in {sum(r[2] for r in rows)} kernels, "
                  f"{1e3 * prof_wall:.4f} ms profiled wall; against the "
                  f"unprofiled steady frame ({ms:.4f} ms) the device is "
                  f"idle {idle:.1f}% of the time")
            for key, us, calls in rows[:8]:
                print(f"  {us:10.2f} us {calls:4d}x  {key[:90]}")
        else:
            print("  the profiler recorded no device time; device busy "
                  "share not measured")
        scenes[name] = dict(frame=frame, img=img, out=out, ms=ms,
                            launches=launches, calls=composite_calls(frame))

    # K6 against its plain version on the scenes' own worklists
    def k6_check(label, packed, ids, pix, launches_of):
        out = kcomp.segment_composite_gather(packed, ids, pix, nc)
        ref = kcomp.segment_composite_gather_plain(packed, ids, pix, nc)
        _, alpha = kcomp.segment_power_alpha(packed[ids].transpose(1, 2),
                                             pix, nc)
        near = (alpha - kcomp.ALPHA_MIN).abs() \
            < CUTOFF_BAND * kcomp.ALPHA_MIN                  # (W, C, P)
        n_near, tied = int(near.sum()), near.any(1)          # (W, P)
        del alpha, near
        diff = (out - ref).abs()                             # (W, nc+1, P)
        keep = ~tied
        rel = [float(diff[:, k][keep].max())
               / max(float(ref[:, k].abs().max()), 1e-30)
               for k in range(nc + 1)]
        off = diff.amax(1) > K6_REL_TOL                      # (W, P)
        n_off, off_untied = int(off.sum()), int((off & keep).sum())
        err_abs = float(diff.amax(1)[keep].max())
        ok = max(rel) <= K6_REL_TOL and off_untied == 0
        W, C = ids.shape
        sentinel = len(packed) - 1
        filled = int((ids != sentinel).sum())
        live = int(live_slots(packed, ids, nc).sum())
        verdict = (f"W={W}, C={C}: {n_near} evaluations within "
                   f"{CUTOFF_BAND:.0e} of the cutoff on {int(tied.sum())} "
                   f"pixels; {n_off} pixels differ by more than "
                   f"{K6_REL_TOL:.0e} ({off_untied} of them untied); on the "
                   f"untied pixels max rel err per output "
                   f"{[f'{r:.2e}' for r in rel]} (tol {K6_REL_TOL:.0e}), "
                   f"max_abs_err {err_abs:.3e};")
        # what the function needs from this data.  Bytes: the ids (8 C per
        # item), the rows of the live slots (a gaussian of nonzero
        # opacity; the sentinels that pad the tiles and fill phase 2 past
        # n_items, and the dead splats, leave a segment as it is), the
        # tile origins (8 per item) and the segments out ((nc+1) 256
        # floats per item); operations: ~20 FP32 per live (gaussian,
        # pixel), expf included
        check("composite", [out], [ref], "composite.cu",
              "mpmavatar_tpu/render/pallas_composite.py:87",
              lambda: kcomp.segment_composite_gather(packed, ids, pix, nc),
              lambda: kcomp.segment_composite_gather_plain(packed, ids, pix,
                                                           nc),
              8.0 * W * C + 4.0 * (live * (6 + nc) + 2 * W
                                   + W * (nc + 1) * 256),
              20.0 * live * 256, launches_of, label=label,
              err=(err_abs, ok, verdict),
              extra={"items": W, "chunk": C, "filled_slots": filled,
                     "live_slots": live,
                     "near_cutoff_evaluations": n_near,
                     "tied_pixels": int(tied.sum()),
                     "pixels_over_tol": n_off,
                     **kcomp.kernel_info(C, nc)[kcomp.KERNEL]})

    av = scenes["avatar"]
    (pk1, ids1, pix1), (pk2, ids2, pix2) = av["calls"]
    k6_check("composite (avatar phase 1, every tile)", pk1, ids1, pix1,
             av["launches"])
    k6_check("composite (avatar phase 2, the worklist)", pk2, ids2, pix2,
             av["launches"])
    k6_check("composite (big_splats phase 2, C = 128)",
             *scenes["big_splats"]["calls"][1],
             scenes["big_splats"]["launches"])
    sent = torch.full_like(ids2, len(pk2) - 1)
    s_out = kcomp.segment_composite_gather(pk2, sent, pix2, nc)
    torch.cuda.synchronize()
    if not (bool((s_out[:, :nc] == 0).all())
            and bool((s_out[:, nc] == 1).all())):
        raise AssertionError("K6 on sentinel-only items is not (0, 1)")
    print(f"composite on {sent.shape[0]} sentinel-only items: colour exactly "
          f"0, transmittance exactly 1")

    # the avatar frame through K6 against the frame through the plain
    # version, and a wrong path: compositing back to front
    sorted_instances = rasterizer._sorted_instances

    def back_to_front(means2d, depth, *args, **kw):
        return sorted_instances(means2d, -depth, *args, **kw)

    with mock.patch.object(rasterizer, "segment_composite_gather",
                           kcomp.segment_composite_gather_plain):
        img_p, out_p = av["frame"]()
    with mock.patch.object(rasterizer, "_sorted_instances", back_to_front):
        img_w, out_w = av["frame"]()
    torch.cuda.synchronize()

    # the frame's pixels where some K6 evaluation is near the cutoff
    height, width = img_p.shape[1:]
    tied = torch.zeros((height + 16, width + 16), dtype=torch.bool,
                       device=dev)
    for packed, ids, pix in av["calls"]:
        _, alpha = kcomp.segment_power_alpha(packed[ids].transpose(1, 2),
                                             pix, nc)
        item, p = ((alpha - kcomp.ALPHA_MIN).abs()
                   < CUTOFF_BAND * kcomp.ALPHA_MIN).any(1).nonzero(
            as_tuple=True)
        del alpha
        tied[pix[item, 1].long() + p // 16, pix[item, 0].long() + p % 16] \
            = True
    tied = tied[:height, :width]

    def frame_err(img, out):
        diff = torch.maximum((img - img_p).abs().amax(0),
                             (out["alpha"] - out_p["alpha"]).abs()[0])
        return (float(diff[~tied].max()), float(diff.max()),
                int((diff > FRAME_TOL).sum()))

    sound, sound_all, n_sound = frame_err(av["img"], av["out"])
    wrong, _, n_wrong = frame_err(img_w, out_w)
    print(f"avatar frame, K6 against the plain version: {int(tied.sum())} "
          f"pixels with an alpha within {CUTOFF_BAND:.0e} of the cutoff; on "
          f"the others max abs {sound:.3e} over image and alpha (tol "
          f"{FRAME_TOL:.0e}); on all {sound_all:.3e}, {n_sound} pixels over "
          f"the tol; wrong path (back to front): {wrong:.3e}, {n_wrong} "
          f"pixels over the tol")
    if not sound <= FRAME_TOL < wrong:
        raise AssertionError(f"the frame limit {FRAME_TOL:.0e} does not "
                             f"separate the kernel path ({sound:.3e}) from "
                             f"the wrong path ({wrong:.3e})")

    # one gaussian on a 1080p frame against the analytic alpha
    from mpmavatar_tpu_torch.render.rasterizer import project_gaussians
    cam = bench_render.look_down_z(1920, 1080, 1500.0, 3.0, 0.5, 20.0)
    ca = camera_arrays(cam, dev)
    means = torch.zeros((1, 3), device=dev)
    # sigma 10 px: the 3-sigma rect (4 x 4 tiles) fits the default tiers
    cov = (0.02 ** 2 * torch.eye(3, device=dev))[None]
    opac = 0.8
    _build.reset_launch_counts()
    out = rasterize(means, torch.ones((1, 3), device=dev),
                    torch.tensor([opac], device=dev), cov, ca,
                    torch.zeros(3, device=dev), 1920, 1080, work_cap=8192)
    launches = _build.launch_counts()
    if launches != {kcomp.KERNEL: 2}:
        raise AssertionError(f"analytic frame: launches {launches}")
    bench_render.check_overflow(out, "analytic frame")
    m2d, _, conic, _, _ = project_gaussians(means, cov, ca, 1920, 1080)
    mu = m2d[0].double().cpu().numpy()
    c = conic[0].double().cpu().numpy()
    alpha = out["alpha"][0].cpu().numpy()
    errs = []
    for px, py in ((960, 540), (967, 535), (975, 548)):
        dx, dy = px - mu[0], py - mu[1]
        expect = opac * np.exp(-0.5 * (c[0] * dx * dx + c[2] * dy * dy)
                               - c[1] * dx * dy)
        expect = expect if expect >= kcomp.ALPHA_MIN else 0.0
        errs.append(abs(float(alpha[py, px]) - expect))
        print(f"  one gaussian: alpha at ({px}, {py}) {alpha[py, px]:.7f}, "
              f"analytic {expect:.7f}")
    print(f"one gaussian on a 1080p frame: launches {launches}; max error "
          f"{max(errs):.3e} (tol {ANALYTIC_TOL:.0e})")
    if max(errs) > ANALYTIC_TOL:
        raise AssertionError("the single gaussian disagrees with the "
                             "analytic alpha")
    return ({name: (sc["ms"], sc["launches"]) for name, sc in scenes.items()},
            scenes["big_splats"]["calls"][1])


def train_path(dev, check, big_call) -> tuple:
    """Phase 7: the stage-2 train step driven with the launch counters
    reset just before and read just after, K7 against its plain version,
    the step against the plain-compositor step beside a wrong path, one
    densification pass, and the loss falling toward a rendered GT.
    Returns (steady ms/step, launches)."""
    from unittest import mock
    import numpy as np
    import torch
    from mpmavatar_tpu_torch.data import OptimizationParams
    from mpmavatar_tpu_torch.ops import _build
    from mpmavatar_tpu_torch.ops import composite as kcomp
    from mpmavatar_tpu_torch.render import bench_render, rasterizer
    from mpmavatar_tpu_torch.train import appearance as tapp
    from mpmavatar_tpu_torch.train import bench_appearance as bapp
    from mpmavatar_tpu_torch.utils import losses

    nc = 3
    raster = bench_render.AVATAR_RASTER
    t0 = time.perf_counter()
    avatar, params, n_faces, cam, gt_rgb, gt_msk, ao = bapp.build(dev)
    opt = OptimizationParams()
    optimizer = tapp.make_optimizer(opt, bapp.EXTENT, params)
    step = tapp.make_train_step(avatar, opt, optimizer, bapp.ACTIVE_SH,
                                False, **raster)
    loss_and_grads = tapp.make_loss_and_grads(avatar, opt, bapp.ACTIVE_SH,
                                              False, **raster)
    args = (0, 0, cam[0], gt_rgb, gt_msk, ao, cam[1], cam[2])
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    step_s, losses_seen = [], []
    for _ in range(TRAIN_STEPS):
        t_s = time.perf_counter()
        loss, aux = step(params, *args)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t_s)
        losses_seen.append(float(loss))
        bench_render.check_overflow(aux, "train step")
    launches = _build.launch_counts()
    want = {kcomp.KERNEL: 2 * TRAIN_STEPS, kcomp.KERNEL_BWD: 2 * TRAIN_STEPS}
    if launches != want:
        raise AssertionError(f"train: launches {launches}, expected {want}")
    if not all(np.isfinite(losses_seen)):
        raise AssertionError(f"train: losses {losses_seen}")
    peak = torch.cuda.max_memory_allocated()
    steady = [1e3 * s for s in step_s[WARM_STEPS:]]
    ms = statistics.median(steady)
    print(f"train step (1500x1000, {params.splats.capacity} splats, "
          f"{n_faces} alive): set-up {setup_s:.2f} s; launches {launches} "
          f"in {TRAIN_STEPS} steps; step wall times "
          f"{[round(1e3 * s, 3) for s in step_s]} ms; steady step (median "
          f"of steps {WARM_STEPS + 1}-{TRAIN_STEPS}) {ms:.4f} ms, range "
          f"{min(steady):.4f}-{max(steady):.4f} ms; losses "
          f"{[round(v, 6) for v in losses_seen]}; phase-2 items "
          f"{int(aux['n_items'])} of work_cap {raster['work_cap']}; peak "
          f"allocated {peak / 2 ** 30:.3f} GiB")
    busy_s, prof_wall, rows = profile_device(lambda: step(params, *args))
    (OUT / "chip_smoke_profile_train_step.txt").write_text(
        "\n".join(f"{us:12.1f} us {calls:6d}x  {key}"
                  for key, us, calls in rows) + "\n")
    if rows:
        idle = 100 * max(0.0, 1 - busy_s / (ms * 1e-3))
        print(f"  profile of one step: device busy {1e3 * busy_s:.4f} ms in "
              f"{sum(r[2] for r in rows)} kernels, {1e3 * prof_wall:.4f} ms "
              f"profiled wall; against the unprofiled steady step "
              f"({ms:.4f} ms) the device is idle {idle:.1f}% of the time")
        for key, us, calls in rows[:15]:
            print(f"  {us:10.2f} us {calls:4d}x  {key[:90]}")
    else:
        print("  the profiler recorded no device time; device busy share "
              "not measured")

    # the device time of the indexing backwards (scatter-adds of the
    # gathers' gradients), by operator and input shapes; index_put_ runs
    # through _index_put_impl_, which alone is counted
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        step(params, *args)
        torch.cuda.synchronize()
    idx_rows = []
    for e in prof.key_averages(group_by_input_shape=True):
        us = getattr(e, "device_time_total", None)
        if us is None:
            us = getattr(e, "cuda_time_total", 0.0)
        if "_index_put_impl_" in e.key and us > 0:
            idx_rows.append((float(us), e.key, str(e.input_shapes)[:120],
                             int(e.count)))
    idx_rows.sort(reverse=True)
    print("  indexing backwards (index_put with accumulate) by input shapes:")
    for us, key, shapes, count in idx_rows[:8]:
        print(f"  {us:10.1f} us {count:3d}x  {key} {shapes}")

    # SSIM's share: forward, and forward + backward, at the frame's shape
    img = gt_rgb.flip(-1).contiguous().requires_grad_(True)
    ssim_ms = event_ms(lambda: losses.ssim(img, gt_rgb), reps=3, inner=5)
    ssim_bwd_ms = event_ms(lambda: torch.autograd.grad(
        losses.ssim(img, gt_rgb), img), reps=3, inner=5)
    print(f"  SSIM at 3x1000x1500 (band products, ~112 GFLOP forward): "
          f"forward {ssim_ms:.4f} ms, forward + backward {ssim_bwd_ms:.4f} "
          f"ms")

    # K7 against its plain version on the step's own worklists
    calls = composite_calls(lambda: loss_and_grads(params, *args))

    # no index backward of the worklists' (W, C) ids is left: it scattered
    # each slot's (6+nc)-row gradient, (W, C, 6+nc) values, onto the table
    wl_shapes = [f"[{ids.shape[0]}, {ids.shape[1]}, {6 + nc}]"
                 for _, ids, _, _ in calls]
    wl_rows = [r for r in idx_rows if any(w in r[2] for w in wl_shapes)]
    print(f"  index backward of the worklists' (W, C) ids "
          f"{[tuple(ids.shape) for _, ids, _, _ in calls]}: "
          f"{sum(r[0] for r in wl_rows) / 1e3:.4f} ms in {len(wl_rows)} "
          f"operators (the gather outside the kernels took 29.12 + 40.32 "
          f"= 69.44 ms on an H100 80GB HBM3 at 700 W); every index "
          f"backward of the step {sum(r[0] for r in idx_rows) / 1e3:.4f} "
          f"ms")
    if wl_rows:
        raise AssertionError(f"the step still scatters the worklists' "
                             f"gradients through index_put: {wl_rows}")

    def k7_check(label, packed, ids, pix, g):
        out = kcomp.segment_composite_gather_vjp(packed, ids, pix, g, nc)
        ref = kcomp.segment_composite_gather_vjp_plain(packed, ids, pix, g,
                                                       nc)
        sentinel = len(packed) - 1
        power, alpha = kcomp.segment_power_alpha(
            packed[ids].transpose(1, 2), pix, nc)
        near = (alpha - kcomp.ALPHA_MIN).abs() \
            < CUTOFF_BAND * kcomp.ALPHA_MIN                  # (W, C, P)
        n_near, tied = int(near.sum()), near.flatten(1).any(1)   # (W,)
        n_pass = int(((power <= 0.0) & (alpha >= kcomp.ALPHA_MIN)).sum())
        del power, alpha, near
        # the rows of the gaussians in no tied item (a flip moves every
        # gradient of its pixel)
        keep = torch.ones(len(packed), dtype=torch.bool, device=dev)
        keep[ids[tied]] = False
        keep[sentinel] = False
        diff = (out - ref).abs()[keep]                       # (rows, 6+nc)
        rel = [float(diff[:, r].max()) / max(float(ref[:, r].abs().max()),
                                             1e-30)
               for r in range(6 + nc)]
        err_abs = float(diff.max())
        # the atomics add a row's items in another order on every run
        again = kcomp.segment_composite_gather_vjp(packed, ids, pix, g, nc)
        rerun = max(float((again - out)[:, r].abs().max())
                    / max(float(ref[:, r].abs().max()), 1e-30)
                    for r in range(6 + nc))
        sentinel_zero = bool((out[sentinel] == 0).all())
        ok = max(rel) <= K7_REL_TOL and rerun <= K7_REL_TOL and sentinel_zero
        W, C = ids.shape
        live_of = live_slots(packed, ids, nc)                # (W, C)
        live = int(live_of.sum())
        live_items = int(live_of.any(1).sum())
        touched = torch.zeros_like(keep)
        touched[ids[live_of]] = True
        held = int((keep & touched).sum())
        verdict = (f"W={W}, C={C}: {n_near} evaluations within "
                   f"{CUTOFF_BAND:.0e} of the cutoff on {int(tied.sum())} "
                   f"items; on the rows of the {held} gaussians in none of "
                   f"those items (of {int(touched.sum())} with a live "
                   f"slot) max rel err per parameter row "
                   f"{[f'{r:.2e}' for r in rel]} "
                   f"(tol {K7_REL_TOL:.0e}), max_abs_err {err_abs:.3e}; a "
                   f"second run differs by {rerun:.2e} of a row's largest "
                   f"(the atomics' order); the sentinel row "
                   f"{'exactly 0' if sentinel_zero else 'NOT 0'};")
        # what the function needs from this data.  Bytes: the ids (8 C per
        # item), the rows of the live slots, the tile origins (8 per item),
        # the cotangent ((nc+1) 256 floats) only for the items that hold a
        # live slot (elsewhere nothing reaches d packed, whatever g is),
        # d packed read and written once per live slot and its zero fill.
        # Operations: ~20 FP32 per live (gaussian, pixel) to evaluate
        # alpha (expf included), and ~50 more per evaluation that passes
        # both cutoffs (the walk back, the parameter gradients and their
        # sums over the pixels; a cut alpha leaves S and every gradient as
        # they are)
        check("composite_bwd", [out], [ref], "composite_bwd.cu",
              "mpmavatar_tpu/render/pallas_composite.py:125",
              lambda: kcomp.segment_composite_gather_vjp(packed, ids, pix, g,
                                                         nc),
              lambda: kcomp.segment_composite_gather_vjp_plain(
                  packed, ids, pix, g, nc),
              8.0 * W * C + 4.0 * (3 * live * (6 + nc) + 2 * W
                                   + live_items * (nc + 1) * 256
                                   + len(packed) * (6 + nc)),
              20.0 * live * 256 + 50.0 * n_pass, launches, label=label,
              err=(err_abs, ok, verdict),
              extra={"items": W, "chunk": C, "live_slots": live,
                     "live_items": live_items, "passing_evaluations": n_pass,
                     "near_cutoff_evaluations": n_near,
                     "tied_items": int(tied.sum()),
                     "rows_held": held, "rerun_rel": rerun,
                     **kcomp.kernel_info(C, nc)[kcomp.KERNEL_BWD]})

    (pk1, ids1, pix1, g1), (pk2, ids2, pix2, g2) = calls
    k7_check("composite_bwd (train step phase 1, every tile)", pk1, ids1,
             pix1, g1)
    k7_check("composite_bwd (train step phase 2, the worklist)", pk2, ids2,
             pix2, g2)
    pk_b, ids_b, pix_b = big_call
    g_b = torch.randn((ids_b.shape[0], nc + 1, 256), device=dev,
                      generator=torch.Generator(device=dev).manual_seed(3))
    k7_check("composite_bwd (big_splats phase 2, C = 128, seeded "
             "cotangent)", pk_b, ids_b, pix_b, g_b)
    # at C = 128 most gaussians share an item with a near-cutoff alpha, so
    # the same worklist again with those gaussians silenced (opacity 0:
    # alpha 0 at every pixel, far from the cutoff), every row held
    _, alpha = kcomp.segment_power_alpha(pk_b[ids_b].transpose(1, 2), pix_b,
                                         nc)
    near = ((alpha - kcomp.ALPHA_MIN).abs()
            < CUTOFF_BAND * kcomp.ALPHA_MIN).any(-1)          # (W, C)
    del alpha
    pk_s = pk_b.clone()
    pk_s[ids_b[near], 5 + nc] = 0.0
    k7_check(f"composite_bwd (big_splats phase 2, C = 128, seeded "
             f"cotangent, its {int(ids_b[near].unique().numel())} "
             f"near-cutoff gaussians silenced)", pk_s, ids_b, pix_b, g_b)
    sent =torch.full_like(ids2, len(pk2) - 1)
    s_out = kcomp.segment_composite_gather_vjp(pk2, sent, pix2, g2, nc)
    torch.cuda.synchronize()
    if not bool((s_out == 0).all()):
        raise AssertionError("K7 on sentinel-only items is not zero")
    print(f"composite_bwd on {sent.shape[0]} sentinel-only items with the "
          f"step's cotangent: d packed exactly zero")

    # the step's gradients through K7 against the plain compositor's, and
    # a wrong path: K7 with the transmittance cotangent dropped
    def step_grads(patch=None):
        if patch is None:
            loss, aux, grads = loss_and_grads(params, *args)
        else:
            with mock.patch.object(rasterizer, "segment_composite_gather",
                                   patch):
                loss, aux, grads = loss_and_grads(params, *args)
        return loss, dict(grads, vgrad=aux["vgrad"])

    loss_k, g_k = step_grads()
    loss_p, g_p = step_grads(kcomp.segment_composite_gather_plain)
    loss_w, g_w = step_grads(wrong_k7("no_transmittance"))
    torch.cuda.synchronize()

    # the splats start isotropic, so the rotation's gradient is zero up to
    # float noise: a leaf is held against a millionth of the step's
    # largest gradient where its own largest is smaller
    floor = 1e-6 * max(float(v.abs().max()) for v in g_p.values())

    def step_err(g):
        errs = {k: float((g[k] - g_p[k]).abs().max())
                / max(float(g_p[k].abs().max()), floor) for k in g_p}
        worst = max(errs, key=errs.get)
        return errs[worst], worst

    sound, sound_leaf = step_err(g_k)
    wrong, wrong_leaf = step_err(g_w)
    print(f"train step through K6/K7 against the plain compositor: loss "
          f"{float(loss_k):.7f} vs {float(loss_p):.7f}; gradients of "
          f"{len(g_p)} leaves (vgrad included), max rel err {sound:.3e} "
          f"({sound_leaf}; tol {STEP_GRAD_TOL:.0e}); wrong path (K7 without "
          f"the transmittance cotangent): {wrong:.3e} ({wrong_leaf})")
    if not sound <= STEP_GRAD_TOL < wrong:
        raise AssertionError(f"the step limit {STEP_GRAD_TOL:.0e} does not "
                             f"separate the kernel path ({sound:.3e}) from "
                             f"the wrong path ({wrong:.3e})")

    # one densification pass, as the stage-2 loop runs it
    alive_before = int(params.splats.alive.sum())
    alive_after, min_per_face = bapp.densify_pass(
        avatar, params, n_faces, aux, opt,
        torch.Generator(device=dev).manual_seed(0))
    print(f"densification: alive splats {alive_before} -> {alive_after} of "
          f"{params.splats.capacity}; fewest alive on a face {min_per_face}")
    if min_per_face < 1 or alive_after <= 0:
        raise AssertionError("densification left a face without a splat")

    # the loss falls through K7, and not through K7 with its colour rows
    # zeroed as far
    sound = descent(dev, raster)
    wrong = descent(dev, raster, wrong_k7("no_colour"))
    fall, fall_w = sound[0] - sound[-1], wrong[0] - wrong[-1]
    print(f"{LOSS_STEPS} steps toward the second seed's colours (opacity "
          f"frozen): L1 {sound[0]:.7e} -> {sound[-1]:.7e} "
          f"({[f'{v:.4e}' for v in sound[::5]]}); wrong path (K7 with its "
          f"colour rows zeroed): {wrong[0]:.7e} -> {wrong[-1]:.7e} "
          f"({[f'{v:.4e}' for v in wrong[::5]]})")
    if not fall > max(fall_w, 0.0):
        raise AssertionError(f"the L1 fell by {fall:.4e} through K7, not "
                             f"more than the wrong path's {fall_w:.4e}")
    return ms, launches


def wrong_k7(mode: str):
    """A segment_composite_gather whose backward is K7 made wrong: the
    transmittance cotangent dropped (``no_transmittance``) or the colour
    rows of its result zeroed (``no_colour``)."""
    import torch
    from mpmavatar_tpu_torch.ops import composite as kcomp

    class Wrong(torch.autograd.Function):
        @staticmethod
        def forward(ctx, packed, ids, pix0, n):
            ctx.save_for_backward(packed, ids, pix0)
            ctx.n = n
            return kcomp.segment_composite_gather(packed, ids, pix0, n)

        @staticmethod
        def backward(ctx, g):
            packed, ids, pix0 = ctx.saved_tensors
            n = ctx.n
            if mode == "no_transmittance":
                g = g.clone()
                g[:, n] = 0.0
            d = kcomp.segment_composite_gather_vjp(packed, ids, pix0, g, n)
            if mode == "no_colour":
                d[:, 5:5 + n] = 0.0
            return d, None, None, None

    return Wrong.apply


def descent(dev, raster, patch=None) -> list:
    """L1 over LOSS_STEPS train steps of the bench's scene toward the
    avatar rendered with a second seed's colours at the start's opacity,
    with the opacity group frozen (its regularizer's Adam sign steps move
    every opacity by 0.05 in logit per step, with no image gradient at
    all), through ``patch`` in place of segment_composite_gather if
    given."""
    import contextlib
    from unittest import mock
    import numpy as np
    import torch
    from mpmavatar_tpu_torch.data import OptimizationParams
    from mpmavatar_tpu_torch.render import rasterizer, rgb2sh
    from mpmavatar_tpu_torch.train import appearance as tapp
    from mpmavatar_tpu_torch.train import bench_appearance as bapp

    avatar, params, n_faces, cam, _, gt_msk, ao = bapp.build(dev)
    colours = np.random.default_rng(1).random((n_faces, 3)).astype(
        np.float32)
    dc = params.splats.features_dc.clone()
    dc[:n_faces, 0] = rgb2sh(torch.as_tensor(colours, device=dev))
    with torch.no_grad():
        gt, _ = tapp.render_avatar_frame(
            avatar, dataclasses.replace(params, splats=dataclasses.replace(
                params.splats, features_dc=dc)),
            avatar.select_verts(params, 0), ao, cam, 0, bapp.ACTIVE_SH,
            torch.zeros(3, device=dev), False, **raster)
    gt = torch.clamp(gt, 0.0, 1.0)
    opt = OptimizationParams()
    optimizer = tapp.make_optimizer(opt, bapp.EXTENT, params)
    for group in optimizer.param_groups:
        if group["name"] == "opacity":
            group["lr"] = 0.0
    step = tapp.make_train_step(avatar, opt, optimizer, bapp.ACTIVE_SH,
                                False, **raster)
    l1 = []
    with (mock.patch.object(rasterizer, "segment_composite_gather", patch)
          if patch else contextlib.nullcontext()):
        for _ in range(LOSS_STEPS):
            _, aux = step(params, 0, 0, cam[0], gt, gt_msk, ao, cam[1],
                          cam[2])
            l1.append(float(aux["l1"]))
    return l1


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
    from mpmavatar_tpu_torch.core import stepping
    from mpmavatar_tpu_torch.core.types import build_body_sphere
    from mpmavatar_tpu_torch.ops import grid_pipeline as gp
    from mpmavatar_tpu_torch.ops import splat as ksplat
    from mpmavatar_tpu_torch.ops import stress as kstress
    from mpmavatar_tpu_torch.ops import transfer as ktransfer
    from mpmavatar_tpu_torch.sim import bench_scene, cloth_drop

    dev = torch.device("cuda")
    smi = nvidia_smi_line()
    print(f"card: {smi}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")
    OUT.mkdir(exist_ok=True)
    t_start = time.perf_counter()

    # ---- 1. build -------------------------------------------------------
    t0 = time.perf_counter()
    _build.library()
    info = _build.build_info()
    print(f"build: {time.perf_counter() - t0:.2f} s "
          f"(cached={info.get('cached')}) -> {info.get('path')}")
    if info.get("log"):
        (OUT / "chip_smoke_build.log").write_text(info["log"])
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line or "Function" in line:
                print("  ptxas:", line.strip())
    from mpmavatar_tpu_torch.ops import composite as kcomp
    for chunk, n_c in ((32, 3), (128, 3), (512, 8)):
        print(f"  as built, at C = {chunk}, nc = {n_c}: " + "; ".join(
            f"{k} {v['registers']} registers/thread, {v['spill_bytes']} "
            f"spilled bytes/thread, {v['blocks_per_sm']} blocks (of 256 "
            f"threads) per SM" for k, v in kcomp.kernel_info(chunk,
                                                            n_c).items()))

    # ---- 2. the paths -------------------------------------------------
    per_sub = {"cloth_stress": 1, "p2g": 1, "grid_pipeline": 1, "g2p": 1}
    solver, state0, model = cloth_drop.build(NX, GRID, device=dev)
    cfg = solver.cfg
    E, P = cfg.n_elements, cfg.n_particles
    print(f"cloth drop: {NX}x{NX} cloth, E={E}, V={cfg.n_vertices}, P={P}, "
          f"G={GRID}^3, dt={DT}, {FRAMES}x{SUBSTEPS} substeps")
    y0 = float(state0.x[E:, 1].mean())
    state, t, launches, ms_sub = drive("cloth_drop", solver, state0, model,
                                       {}, FRAMES, SUBSTEPS, per_sub)
    n_sub = FRAMES * SUBSTEPS
    expect_fall = 9.8 * DT * DT * n_sub * (n_sub + 1) / 2.0
    fall = y0 - float(state.x[E:, 1].mean())
    if abs(fall / expect_fall - 1.0) > FALL_REL_TOL:
        raise AssertionError(f"cloth fell {fall:.6e}, expected "
                             f"{expect_fall:.6e}")
    print(f"cloth drop: fall {fall:.6e} vs g dt^2 n(n+1)/2 = "
          f"{expect_fall:.6e}")

    per_sub_a = dict(per_sub, splat=2)
    solver_a, state_a0, model_a, scene_a = bench_scene.build(GRID,
                                                             device=dev)
    cfg_a = solver_a.cfg
    pins = slice(cfg_a.n_no_vertices, cfg_a.n_no_vertices + cfg_a.num_joint_v)
    print(f"path A (bench_scene --grid {GRID}): P={cfg_a.n_particles}, "
          f"{len(solver_a.colliders.mesh_colliders[0].faces)} collider "
          f"faces, {cfg_a.num_joint_v} + {cfg_a.num_joint_f} joint points")
    state_a, t_a, launches_a, ms_a = drive(
        "path_A", solver_a, state_a0, model_a, scene_a, FRAMES, SUBSTEPS,
        per_sub_a)
    pin_move = float((state_a.x[pins] - state_a0.x[pins]).abs().max())
    if not pin_move <= PIN_TOL:
        raise AssertionError(f"pinned vertices moved {pin_move:.3e}")
    print(f"path A: the {cfg_a.num_joint_v} pinned vertices moved "
          f"{pin_move:.3e} (tol {PIN_TOL:.0e})")

    per_sub_b = dict(per_sub_a, sand_stress=1)
    solver_b, state_b0, model_b, scene_b = bench_scene.build(
        GRID_B, SAND_B, device=dev)
    cfg_b = solver_b.cfg
    sand = slice(cfg_b.n_elements, cfg_b.n_no_vertices)
    print(f"path B (bench_scene --grid {GRID_B} --sand {SAND_B}): "
          f"P={cfg_b.n_particles}")
    sand_y0 = float(state_b0.x[sand, 1].mean())
    state_b, t_b, launches_b, ms_b = drive(
        "path_B", solver_b, state_b0, model_b, scene_b, FRAMES, SUBSTEPS,
        per_sub_b)
    sand_fall = sand_y0 - float(state_b.x[sand, 1].mean())
    if abs(sand_fall / expect_fall - 1.0) > FALL_REL_TOL:
        raise AssertionError(f"sand fell {sand_fall:.6e}, expected "
                             f"{expect_fall:.6e}")
    print(f"path B: sand fall {sand_fall:.6e} vs g dt^2 n(n+1)/2 = "
          f"{expect_fall:.6e}")

    # ---- 3. the drape ---------------------------------------------------
    depth = {}
    for body in (True, False):
        s_d, st_d, m_d = cloth_drop.build(NX, GRID, device=dev, body=body)
        sc_d = cloth_drop.body_scene(dev) if body else {}
        t_d, t0 = 0.0, time.perf_counter()
        for _ in range(DRAPE_SUBSTEPS // SUBSTEPS):
            st_d, t_d = s_d.frame(st_d, m_d, DT, SUBSTEPS, t_d, **sc_d)
        s_d.check_finite(st_d, f"drape (body={body})")
        depth[body] = sphere_depth(st_d.x[s_d.cfg.n_elements:],
                                   cloth_drop.BODY_CENTER, cloth_drop.BODY_R)
        print(f"drape, {'with' if body else 'without'} the body collider: "
              f"{DRAPE_SUBSTEPS} substeps in {time.perf_counter() - t0:.2f}"
              f" s; deepest cloth vertex {depth[body]:.5f} inside the "
              f"sphere; cloth y range [{float(st_d.x[:, 1].min()):.4f}, "
              f"{float(st_d.x[:, 1].max()):.4f}]")
        if body:
            # one more grid phase from the draped state, K5 with and
            # without its mesh fields: the cells the mesh branch changed
            col = s_d.colliders.mesh_colliders[0]
            post = s_d.colliders.grid_post
            nd, nf, ny, stress_d, vf = stepping.compute_stress(
                s_d.cfg, st_d, m_d, DT)
            st1 = dataclasses.replace(st_d, d=nd, F=nf, yield_stress=ny)
            gv_in, gm = stepping.p2g(s_d.cfg, st1, m_d, stress_d, vf, DT)
            acc, mw = stepping.mesh_collider_fields(
                s_d.cfg, col, sc_d["mesh_x"], sc_d["mesh_v"])
            surf = gp.pack_surface_params(post)
            scal = (m_d.gravity, m_d.grid_v_damping_scale)
            with_mesh = gp.make_grid_pipeline(s_d.cfg, post, True, False)(
                gv_in, gm, acc, mw, None, None, *scal, col.friction, t_d,
                DT, surf)
            no_mesh = gp.make_grid_pipeline(s_d.cfg, post, False, False)(
                gv_in, gm, None, None, None, None, *scal, None, t_d, DT,
                surf)
            changed = int((with_mesh != no_mesh).any(dim=1).sum())
            covered = int((mw > 1e-15).sum())
            print(f"drape: K5's mesh branch changed the velocity of "
                  f"{changed} grid cells ({covered} cells covered by the "
                  f"collider splat)")
            if changed <= 0:
                raise AssertionError("the mesh branch changed no cell")
    if not depth[True] <= DRAPE_TOL < depth[False]:
        raise AssertionError(
            f"drape depth {depth[True]:.5f} (limit {DRAPE_TOL:.5f}) does "
            f"not separate from the run without a collider "
            f"({depth[False]:.5f})")

    # ---- 4. kernels against their plain versions -----------------------
    gen = torch.Generator(device=dev).manual_seed(0)
    rnd = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    st = dataclasses.replace(state, v=state.v + 0.05 * rnd(P, 3))
    d = st.d + 0.02 * rnd(E, 3, 3)
    d[:, :, 2] *= 0.5 + 1.1 * torch.rand((E, 1), generator=gen, device=dev)
    sel_e = (torch.rand((E,), generator=gen, device=dev) > 0.1).float()
    k1_in = (d, st.R_inv, st.vol[:E], sel_e, model.mu[:E], model.lam[:E],
             model.gamma[:E], model.kappa[:E], model.friction_coeff)
    results = {}

    # no single PyTorch call computes any of these functions: library_ms
    # stays null
    def check(name, outs, refs, source, replaces, run, run_plain, n_bytes,
              n_flops, launches_of, label=None, err=None, extra=None):
        torch.cuda.synchronize()
        if err is None:
            err_abs, err_rel = rel_err(outs, refs)
            ok = err_rel <= KERNEL_REL_TOL[name]
            verdict = (f"max_abs_err {err_abs:.3e}, max rel-to-max err "
                       f"{err_rel:.3e} (tol {KERNEL_REL_TOL[name]:.0e})")
        elif isinstance(err, float):      # a tolerance worked out here
            err_abs, err_rel = rel_err(outs, refs)
            ok = err_rel <= err
            verdict = (f"max_abs_err {err_abs:.3e}, max rel-to-max err "
                       f"{err_rel:.3e} (tol {err:.1e})")
        else:
            err_abs, ok, verdict = err
        ms, eager_ms = graph_ms(run), event_ms(run)
        plain_ms = event_ms(run_plain, reps=3, inner=5)
        b_ms, b_by = bound(n_bytes, n_flops)
        print(f"{label or name}: {verdict} {'ok' if ok else 'FAIL'}; "
              f"{ms:.4f} ms (eager {eager_ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms by {b_by}); "
              f"launches on the main path {launches_of.get(name, 0)}")
        if not ok:
            raise AssertionError(f"{label or name} disagrees with its plain "
                                 "version")
        entry = {"name": name, "route": "cuda", "source": CSRC + source,
                 "replaces": replaces,
                 "launches": launches_of.get(name, 0),
                 "max_abs_err": err_abs, "ms": ms, "eager_ms": eager_ms,
                 "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                 "library_ms": None, **(extra or {})}
        if name in results:     # a further shape of a kernel already listed
            results[name].setdefault("other_shapes", []).append(
                dict(entry, label=label))
        else:
            results[name] = entry

    k1 = kstress.cloth_stress(*k1_in)
    k1_ref = kstress.cloth_stress_plain(*k1_in)
    # bytes: 18 floats in + 27 out per element; ~310 FP32 operations per
    # element (QR 60, return map 30, stress + inverse + P 160, outputs 60)
    check("cloth_stress", k1, k1_ref, "stress.cu",
          "mpmavatar_tpu/ops/pallas_stress.py:160",
          lambda: kstress.cloth_stress(*k1_in),
          lambda: kstress.cloth_stress_plain(*k1_in),
          E * (18 + 27) * 4 + 4, E * 310.0, launches_a)

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
    check("p2g", k2, k2_ref, "transfer.cu",
          "mpmavatar_tpu/ops/pallas_transfer.py:225",
          lambda: ktransfer.p2g(*k2_in), lambda: ktransfer.p2g_plain(*k2_in),
          4 * (17 * P + 9 * E + 3 * cfg.n_vertices + 4 * n_cells),
          P * 1800.0, launches_a)

    # K4 at path A's and path B's shapes: the collider's faces (CH = 6)
    # and the joint points (CH = 3), from the paths' final states
    col_a = solver_a.colliders.mesh_colliders[0]
    face_pts, face_vals = stepping.mesh_face_values(
        col_a, scene_a["mesh_x"], scene_a["mesh_v"])
    joints = (scene_a["joint_verts_v"], scene_a["joint_faces_v"], None)
    joint_pts, joint_vals = stepping.mover_points(cfg_a, state_a, *joints)

    def splat_check(label, pts, vals, g, bounds_check=True):
        args = (pts, vals, g, g / 2.0, bounds_check)
        out = ksplat.splat(*args)
        ref = ksplat.splat_plain(*args)
        n_pts, ch = vals.shape
        fill = lambda: (torch.zeros((g ** 3, ch), device=dev),
                        torch.zeros((g ** 3,), device=dev))
        fill_ms = graph_ms(fill)
        # points per cell, by the kernel's own index rule
        base = torch.floor(pts * g / 2.0 - 0.5).long()
        flat = ktransfer.flat_indices(base, g)
        flat = torch.where(flat < 0, flat + g ** 3, flat)
        keep = (flat >= 0) & (flat < g ** 3)
        if bounds_check:
            keep &= torch.all((base >= 0) & (base < g - 3), dim=1)[:, None]
        n_max = int(torch.bincount(flat[keep]).max())
        tol = max(KERNEL_REL_TOL["splat"], n_max * 2.0 ** -23)
        # bytes: points and values in ((3 + CH) floats each), the dense
        # fields out ((CH + 1) floats per cell, written by the wrapper's
        # zero fill); ~30 + 27 x 2 (CH + 1) FP32 operations per point
        check("splat", out, ref, "splat.cu",
              "mpmavatar_tpu/ops/pallas_transfer.py:561",
              lambda: ksplat.splat(*args), lambda: ksplat.splat_plain(*args),
              4 * (n_pts * (3 + ch) + g ** 3 * (ch + 1)),
              n_pts * (30 + 54.0 * (ch + 1)), launches_a, label=label,
              err=tol, extra={"fill_ms": fill_ms, "points": n_pts,
                              "channels": ch, "grid": g})
        print(f"  {label}: {n_pts} points, CH={ch}, {g}^3; the wrapper's "
              f"zero fill alone {fill_ms:.4f} ms; "
              f"{int((ref[1] > 1e-15).sum())} cells covered, up to {n_max} "
              f"points on one cell")
        return out

    acc_a, mw_a = splat_check("splat (collider faces, 128^3)", face_pts,
                              face_vals, GRID)
    mv_a, mvw_a = splat_check("splat (joint points, 128^3)", joint_pts,
                              joint_vals, GRID)
    splat_check("splat (collider faces, 250^3)", face_pts, face_vals,
                GRID_B)
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
    edge_vals = rnd(20_000, 6)
    for bc in (True, False):
        splat_check(f"splat (random points with base G-3 and below 0, "
                    f"bounds_check={bc})", edge, edge_vals, GRID, bc)

    # K5 at path A's shapes, its mesh and mover branches on
    post_a = solver_a.colliders.grid_post
    pipeline = gp.make_grid_pipeline(cfg_a, post_a, has_mesh=True,
                                     has_mover=True)
    surf = gp.pack_surface_params(post_a)
    k5_in = (*k2, acc_a, mw_a, mv_a, mvw_a, model_a.gravity,
             model_a.grid_v_damping_scale, col_a.friction)
    k5_plain = lambda: gp.grid_pipeline_plain(
        *k5_in, surf, 0.01, DT, GRID, cfg.dx, (0,), False, 3)
    k5 = pipeline(*k5_in, 0.01, DT, surf)
    k5_ref = k5_plain()
    active = int((k2[1] > 1e-15).sum())
    covered = int((mw_a > 1e-15).sum())
    movered = int((mvw_a > 1e-15).sum())
    # bytes: grid_m, mesh_w, mover_w in and grid_v out (6 floats) per
    # cell; grid_v in (3 floats) per active cell, mesh_acc (6) per covered
    # cell and mover_v (3) per movered cell only; ~60 FP32 operations per
    # cell
    check("grid_pipeline", [k5], [k5_ref], "grid_pipeline.cu",
          "mpmavatar_tpu/ops/pallas_grid_pipeline.py:149",
          lambda: pipeline(*k5_in, 0.01, DT, surf), k5_plain,
          4 * (6 * n_cells + 3 * active + 6 * covered + 3 * movered),
          60.0 * n_cells, launches_a)
    print(f"grid_pipeline: {active} active, {covered} collider-covered and "
          f"{movered} mover-covered cells of {n_cells}")
    # every branch, on random fields: mesh, mover, sticky / slip /
    # frictional surfaces and the bounding box
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
    check("g2p", k3, k3_ref, "transfer.cu",
          "mpmavatar_tpu/ops/pallas_transfer.py:256",
          lambda: ktransfer.g2p(st.x, k5, GRID, cfg.inv_dx),
          lambda: ktransfer.g2p_plain(st.x, k5, GRID, cfg.inv_dx),
          4 * (24 * P + 3 * touched), P * 1900.0, launches_a)
    print(f"g2p: {touched} grid cells touched by the stencils")

    # K8: path B's sand after its run, and a tip / cone / reflected set
    sl_b = slice(cfg_b.n_elements, cfg_b.n_no_vertices)
    sand_b = (state_b.F_trial, state_b.F,
              (state_b.selection[sl_b] == 0).float(), model_b.mu[sl_b],
              model_b.lam[sl_b], model_b.alpha)
    g_cpu = torch.Generator().manual_seed(7)
    n_set = SAND_B
    f_set = torch.eye(3) + 0.15 * torch.randn((n_set, 3, 3), generator=g_cpu)
    f_set[: n_set // 8] *= 1.5                    # tr(eps) > 0: tip
    f_set[n_set // 8: n_set // 4] *= 0.5          # compression: cone
    f_set[n_set // 4: n_set // 4 + 100] = torch.diag(torch.tensor(
        [1.0, 1.0, -1.0])) @ f_set[n_set // 4: n_set // 4 + 100]
    sand_set = tuple(a.to(dev) for a in (
        f_set, torch.eye(3) + 0.05 * torch.randn((n_set, 3, 3),
                                                 generator=g_cpu),
        (torch.rand(n_set, generator=g_cpu) > 0.2).float(),
        torch.full((n_set,), 400.0), torch.full((n_set,), 600.0),
        torch.tensor(0.3)))

    def sand_check(label, args):
        f_new, st_k, br = kstress.sand_stress(*args, return_branch=True)
        f_ref, st_ref, br_ref = kstress.sand_stress_plain(
            *args, return_branch=True)
        torch.cuda.synchronize()
        mu = float(args[3].abs().max())
        flips = br != br_ref
        nan_same = bool(torch.equal(torch.isnan(st_k), torch.isnan(st_ref)))
        keep = ~flips & ~torch.isnan(st_ref).flatten(1).any(1)
        f_err = float((f_new - f_ref)[keep].abs().max())
        s_err = float((st_k - st_ref)[keep].abs().max())
        counts = torch.bincount(br_ref.long(), minlength=4).tolist()
        ok = nan_same and f_err <= SAND_F_TOL and \
            s_err / mu <= SAND_STRESS_TOL_MU
        verdict = (f"branches (unselected, elastic, cone, tip) {counts}, "
                   f"{int(flips.sum())} flipped between kernel and plain; "
                   f"on the rest F_new err {f_err:.3e} (tol "
                   f"{SAND_F_TOL:.0e}), stress err {s_err:.3e} = "
                   f"{s_err / mu:.3e} mu (tol {SAND_STRESS_TOL_MU:.0e} mu); "
                   f"NaN positions {'equal' if nan_same else 'DIFFER'};")
        n_t = args[0].shape[0]
        n_sel = int((args[2] > 0.5).sum())
        # bytes: F_trial, sel, mu, lam in (12 floats) and F_new, stress out
        # (18) per particle, F_prev in (9) per unselected particle only;
        # ~2,000 FP32 operations per selected particle (24 Givens rotations
        # of A and V ~1,700, U, log/exp, outputs)
        check("sand_stress", [f_new, st_k], [f_ref, st_ref], "sand.cu",
              "mpmavatar_tpu/ops/pallas_stress.py:378",
              lambda: kstress.sand_stress(*args),
              lambda: kstress.sand_stress_plain(*args),
              4 * (30 * n_t + 9 * (n_t - n_sel)) + 4, 2000.0 * n_sel,
              launches_b, label=label, err=(max(f_err, s_err), ok, verdict),
              extra={"branch_flips": int(flips.sum()), "particles": n_t,
                     "selected": n_sel})

    sand_check("sand_stress (path B's 100,000 sand particles)", sand_b)
    sand_check("sand_stress (tip / cone / reflected set)", sand_set)

    # ---- 5. kernel path vs plain path over several substeps ------------
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

    # the contact scene: outward-wound body (the bench's sphere winds
    # inward, and an inward-wound collider lets a falling cloth through)
    faces_out = build_body_sphere(
        center=CONTACT["body_center"],
        r=CONTACT["body_r"])[1][:, [0, 2, 1]]

    def contact(device, friction=0.5, mover=True):
        s, st_c, m, sc = bench_scene.build(device=device, **CONTACT)
        s.colliders = dataclasses.replace(s.colliders, mesh_colliders=(),
                                          use_particle_mover=mover)
        s.add_mesh_collider(faces_out, friction=friction)
        sc["mesh_v"] = torch.tensor(CONTACT_MESH_V, device=device).expand(
            sc["mesh_x"].shape).contiguous()
        return s, st_c, m, sc

    s_k, st_k0, m_k, sc_k = contact(dev)
    cpu_paths = {"plain": contact("cpu"),
                 "friction 0": contact("cpu", friction=0.0),
                 "no mover": contact("cpu", mover=False)}
    print(f"contact scene: P={s_k.cfg.n_particles}, "
          f"{CONTACT['grid']}^3, {CONTACT['sand']} sand, body top "
          f"{CONTACT['body_center'][1] + CONTACT['body_r']:.3f} under the "
          f"cloth at 1.300, rising at {CONTACT_MESH_V[1]} m/s")
    readings = {name: {"x": [], "v": []} for name in ("kernel", "friction 0",
                                                      "no mover")}
    for seed in PATH_SEEDS:
        g = torch.Generator(device=dev).manual_seed(2000 + seed)
        a0 = dataclasses.replace(st_k0, v=st_k0.v + 0.05 * torch.randn(
            st_k0.v.shape, generator=g, device=dev))
        a = s_k.frame(a0, m_k, DT, COMPARE_SUBSTEPS, 0.0, **sc_k)[0]
        outs = {name: s.frame(a0.to("cpu"), m, DT, COMPARE_SUBSTEPS, 0.0,
                              **sc)[0]
                for name, (s, _, m, sc) in cpu_paths.items()}
        b = outs["plain"]
        line = []
        for name, o in (("kernel", a), ("friction 0", outs["friction 0"]),
                        ("no mover", outs["no mover"])):
            for f in ("x", "v"):
                readings[name][f].append(
                    float((getattr(o, f).cpu() - getattr(b, f)).abs().max()))
            line.append(f"{name}: x {readings[name]['x'][-1]:.3e}, v "
                        f"{readings[name]['v'][-1]:.3e}")
        print(f"contact scene, seed {seed}, {COMPARE_SUBSTEPS} substeps "
              f"against the plain path: " + "; ".join(line))
    for f, tol in PATH_ATOL.items():
        if not max(readings["kernel"][f]) <= tol:
            raise AssertionError(f"contact scene: the kernel path disagrees "
                                 f"with the plain path in {f}")
    for name in ("friction 0", "no mover"):
        if not min(readings[name]["v"]) > PATH_ATOL["v"]:
            raise AssertionError(f"contact scene: the v limit does not "
                                 f"separate the wrong path ({name})")
    print(f"contact scene: the limits separate sound (x up to "
          f"{max(readings['kernel']['x']):.3e}, v up to "
          f"{max(readings['kernel']['v']):.3e}) from wrong (v from "
          f"{min(readings['friction 0']['v'] + readings['no mover']['v']):.3e})")

    # ---- 6. the render path -------------------------------------------
    render, big_call = render_path(dev, check)

    # ---- 7. the train path --------------------------------------------
    train_ms, train_launches = train_path(dev, check, big_call)

    print(f"paths: cloth drop {ms_sub:.4f}, path A {ms_a:.4f}, path B "
          f"{ms_b:.4f} ms/substep; render "
          + ", ".join(f"{name} {ms:.4f}" for name, (ms, _) in render.items())
          + f" ms/frame; train step {train_ms:.4f} ms on {smi}; chip_smoke ran "
          f"{time.perf_counter() - t_start:.1f} s after start-up")
    for entry in results.values():
        entry["launches_by_path"] = {
            "cloth_drop": launches.get(entry["name"], 0),
            "path_A": launches_a.get(entry["name"], 0),
            "path_B": launches_b.get(entry["name"], 0),
            **{f"render_{name}": counts.get(entry["name"], 0)
               for name, (_, counts) in render.items()},
            "train_step": train_launches.get(entry["name"], 0)}
    print(smi)
    print(json.dumps({"kernels": list(results.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
