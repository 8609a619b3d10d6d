#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one GPU and hold every kernel against
its plain PyTorch version.

    python3 chip_smoke.py

Phases (any failure exits nonzero; no phase carries on past its own):
  1. build the CUDA kernels of mpmavatar_tpu_torch/ops/csrc (timed), and
     print K1's, K2's, K3's, K4's, K6's, K7's and K8's registers, spills,
     shared memory and blocks per SM as built;
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
     beside its plain version's time and its memory/compute bound; K2
     and K3 also on the cloth drop's particles in a random order and on
     path B's state, with their blocks counted by branch (shared-memory
     tile, or straight into or from the grid); the backward of K1, K2,
     K5, K3 and K8
     (autograd over the plain version) timed at the same shapes, and K4's
     at the material trainer's mover (its 183 pinned points on 200^3); K4
     also at the posed body's 20,736 faces on 128^3 (phase 10's collider),
     in mesh order and shuffled, at a pole-free 20,480-face icosphere on
     the same torso in two face orders, and on stencil tails
     (``k4_shapes``), each with its warps counted by branch (shared-memory
     tile, or straight into the grid) and its output read as K5 reads it
     (``splat_coverage``: the covered cells, acc / w and the normal);
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
     more than through K7 with its colour rows zeroed;
  8. the differentiated substep: GRAD_SUBSTEPS substeps of the full-width
     cloth drop (stretched in its plane, d3 scaled to 0.9, off the return
     map's R33 = 1 branch point: ``stretched``) and the gradient of a
     seeded vertex loss w.r.t. mu, lam, mass and R_inv, with the launch
     counters reset just before and read just after (K1, K2, K5, K3 once
     per substep; the backward launches none);
     ms per differentiated substep, the backward's share, device busy and
     peak memory; the gradient against the same gradient through the
     plain path on the CPU, per leaf relative to its largest entry (the
     elements that cross R33 = 1 between the two counted and left out),
     beside a wrong path: the kernels' outputs detached, as before they
     had a backward;
  9. the material train step at full width (train/bench_material.py's
     production shape: the 183 x 183 hanging cloth, 99,737 particles,
     200^3, its top row of 183 vertices pinned by the mover, the 32 x 32
     body sphere; 2 frames x 10 substeps, dt = 1e-4), the tracked cloth
     turning about the vertical axis and the rest shape 10% shorter in y:
     one untimed warm-up step, then TRAIN_STEPS_M train steps with the
     launch counters reset just before and read just after (each
     substep's kernels three times: forward, the frame's recompute and
     its own), ms per step and per
     differentiated substep, peak memory and a profile of one more step;
     the loss finite and D, E, H moving; a finite-difference step whose
     probe-0 loss must equal the autodiff forward's at the same
     parameters; simulate for 2 frames (finite, the cloth moves); d/d(D,
     E, H) over MAT_GRAD_SUBSTEPS substeps against the CPU plain path,
     beside a wrong path (the kernels' outputs detached) and the reading
     with the mover's points detached; the same gradient with the body
     sphere raised into the cloth and rising (contact: the collider must
     move the gradient beyond the tolerance), against the CPU plain path
     beside the same wrong path;
 10. the posed body (sim/pose_playback.py at full width): a synthetic
     SMPL-X archive at SMPL-X's widths (55 joints, 400 shape and 486 pose
     directions, a closed 10,476-vertex, 20,736-face torso under the
     cloth) written as an npz and loaded by load_smplx_npz; three poses
     (the root turning, trans rising, seeded body-pose offsets), one per
     frame of 100 substeps; the bench cloth re-posed through them by
     deform_tracked_to_poses (k = 10), its first 256 vertices and 128
     faces pinned to the re-posed velocities, the posed body as the
     moving collider: smplx_forward's vertices, joints and transforms and
     the re-posed cloth on the card against the CPU (KNN ties counted),
     the posing time and the KNN's share of it; 2 frames x 100 substeps
     with the launch counters reset just before and read just after (K1,
     K2, K5, K3 once and K4 twice per substep), finite after each frame,
     the body moving, K5's mesh branch changing cells, a profile of 20
     more substeps and the peak memory; then the scene cut to a 48 x 48
     cloth and 64^3 with the body at full width, 10 substeps on the kernel
     path against the plain path on the CPU, beside two wrong paths (the
     body held still; collider friction 0);
 11. the stage-2 and stage-4 tools: data/make_synthetic_actorshq's
     capture at its defaults (9 ring cameras x 4 frames, 1500 x 1000, the
     50,244-face body, the teacher through K6), timed; the stage-2 CLI
     (train/train_appearance.py) on it for CLI_ITERS iterations with
     --work_cap 8192 and --preload_device, the last camera held out,
     load_mesh_avatar's 200,976 slots, one densification pass and test
     evaluations after the first and the last step, with the launch
     counters reset just before and read just after (2 K6 and 2 K7
     launches per step; the test views' tile path launches none): the
     losses finite, zero overflow, the densified avatar with a splat on
     every face, the held-out L1 falling and PSNR rising by more than
     through K7 with its colour rows zeroed; ms per step and per test
     view, peak memory; the saved checkpoint reloaded into a fresh avatar
     renders the trained avatar's test view; the host's ms per sample
     with and without --preload_device and a profile of a few steps; stage
     4 (train/evaluate.py::render_eval_sequence) on the capture's tracked
     meshes at AO 256^2 with the gray start and with the checkpoint, the
     bake's and the render's ms per frame and the bake's peak memory, the
     bake on the card against the CPU at AO_CUT^2; the CLI at a cut size
     (CUT) on the card against the CPU; the metrics CLI
     (train/eval_metrics.py) over both trees with seeded LPIPS weights,
     every metric finite and the checkpoint's PSNR above the gray start's;
 12. the zero-shot demo: data/make_demo_assets's assets (a 183 x 183
     skirt, 33,489 vertices and 66,612 faces, on a capsule body; the
     chair box and 2,000 chair gaussians; the 22-joint SMPL-X-width rig
     and its sit-down poses cut to DEMO_POSES; the tracked skirt avatar)
     through train/run_demo at 250^3 and 400 substeps a frame, one frame
     per pose and DEMO_EXTRA more (the sand reaching the body's top in
     the last, timed frames), 100,000 sand particles released from frame
     1, with the launch counters reset just before and read just after
     (K1, K2, K5, K3, K4 (the collider: no vertex is pinned, so no
     mover) and K8 once per substep; the bakes and the tile-path orbit
     renders launch none):
     the state finite after each frame; the release windows under the
     JAX package's semantics (the windows that close before they open
     counted, here and under the defaults' 160 frames; the sand, which
     starts above the grid's top with these assets, held by none; the
     pre-P2G modifier leaving a live window's particles at |v| <=
     RELEASE_STILL and the others untouched), the sand's median fall
     over frame FALL_FRAME (before it reaches the body) against g t, and
     the collider at full width: the body slowing some of the sand in
     the last frame, K5's mesh branch changing the velocity of some
     cells and no cloth vertex ending deeper than DRAPE_TOL inside the
     chair's box (the 12-triangle box acts only near its faces'
     centroids, in the JAX package alike, tests/test_torch_demo.py); the
     cut scene (DEMO_CUT: a 48 x 48 skirt, 3,000 sand lowered into the
     grid and held by live windows, the chair, the body widened against
     the skirt's top and moving, 64^3) on the kernel path against the
     plain path on the CPU over COMPARE_SUBSTEPS substeps, beside the
     release left out and the collider's friction 0, K5's mesh branch
     changing cells; K2, K4 and K8 at the demo's own shapes against
     their plain versions (phase 4's checks); every
     orbit frame of the run (AO bake and render at 1024^2) without
     overflow, ORBIT_CHECKS of them again with and without the sand, and
     at ORBIT_CUT^2 on the card against the CPU off the alpha cutoff's
     ties; ms per substep, per bake and per orbit frame, the release
     modifiers' share of the substep, peak memory and a profile of 20
     more substeps;
 13. stage-1 tracking: train/run_tracking on phase 11's capture (9
     cameras, 1500 x 1000, 50,244 faces, one gaussian each), TRACK_ITERS
     iterations on frames 0 and 1 through the worklist compositor
     (--work_cap TRACK_WORK_CAP), with the launch counters reset just
     before and read just after (K6 and K7 twice per iteration, nothing
     else): no overflow, the loss falling over frame 0, the
     params_{t}.npz files loading as an avatar; one iteration's gradient
     w.r.t. the vertices, colours and colour calibration through K6/K7
     against their plain versions on the card, beside K7's output
     detached; K6 and K7 against their plain versions on one more
     iteration's own worklists and cotangents (phases 6 and 7's checks);
     ms per iteration, peak memory and a profile of one more iteration;
 14. multi-device at world size 1, over a one-rank NCCL group in this
     process (the machine has one card, and NCCL refuses two ranks on
     one device; the cross-rank logic is held on the CPU over gloo by
     tests/test_torch_parallel.py and test_torch_appearance_dp.py): the
     sharded frame (parallel/sharded.py) on path B's scene at full
     width, the sphere as its (F, 3, 3) triangles, FRAMES x SUBSTEPS
     substeps with the launch counters reset just before and read just
     after (path B's: K1, K2, K3, K5, K8 once and K4 twice per
     substep), finite, its ms per substep beside MPMSolver.frame's on
     the same scene, a profile of 20 more substeps (device busy and
     idle, the collectives' share); over COMPARE_SUBSTEPS substeps
     against MPMSolver.frame on the card at PATH_ATOL, on path B's
     scene with the sphere wound outward, its top through the cloth and
     rising (MD_BODY_CENTER),
     beside the collider dropped; K5 on the second half of phase 4's
     128^3 grid from its first cell against its plain version (timed,
     with its bound) and against the whole grid's second half, and
     every branch on the slab; the sharded material step at phase 9's
     shape (MAT_FRAMES x MAT_SUBSTEPS substeps, each checkpointed):
     launches, ms per step, peak memory, each leaf's gradient against
     the single-device autograd of the same loss on the card beside
     K1's outputs detached; the data-parallel stage-2 step
     (parallel/appearance_dp.py) on phase 7's avatar with DP_SAMPLES
     samples (K6 and K7 twice each per sample): its gradients against
     the mean of the single-device ``make_loss_and_grads`` per leaf,
     beside the first sample's alone, ms per step and peak memory;
 15. the production recovery: train/stage3_production.py --recover at
     full width (the 158 x 158 hanging cloth, 74,262 particles, 200^3,
     1 x 400 substeps, REC_STEPS steps) with the launch counters reset
     just before and read just after: finite, the synthetic trajectory
     moving by more than 0.01, the loss falling over the steps, each
     parameter's move toward TRUTH or away printed; s per step and
     peak memory, the trace in the output directory;
 16. the drivers: train/bench_tracking.py at its defaults (the joint
     SMPL-X/VPoser fit: a 40,612-face mesh at 1500 x 1000, the
     10,475-vertex, 22-joint rig with VPoser decoding its body pose from
     the trainable latent, the cloth-body collision penalty, both Adams):
     BENCH_TRACK_ITERS iterations after 2 on the tile path (the JAX
     bench's: no kernel launches), then on the worklist compositor with
     the launch counters reset just before and read just after (K6 and K7
     twice per iteration, nothing else), ms per iteration, steps/s and the
     projected minutes per 3,000-iteration frame, the loss finite, no
     overflow, peak memory; K6 and K7 against their plain versions on one
     more iteration's own worklists and cotangents; a profile of one more
     iteration on each path (device busy and idle, kernels) and the
     collision penalty's device ms; one joint iteration's gradient w.r.t. the
     vertices, colours, VPoser latent and SMPL-X translation at a cut
     shape on the card against the CPU plain path, beside the SMPL-X
     geometry detached; then ``python -m mpmavatar_tpu_torch.bench
     --headline_only`` in this process, its last line parsed and its
     headline, 200^3, 250^3 + sand and render values finite and
     positive;
 17. the stage-level checks with the kernels on: tests/test_convergence.py's
     tracking scene (a 9 x 9 cloth toward a bumped target from 3 views,
     250 iterations through K6/K7) must cut the loss below half its
     first and the vertex error below 0.4 of its start, and its stage-2
     scene (the fake tracking assets' avatar, 120 steps through K6/K7)
     must raise the held-out PSNR by more than 3 dB; the launch counters
     reset before and read after each (K6 and K7 twice per iteration or
     step).
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

# the differentiated substep (phase 8): the card's gradient against the
# CPU plain path's, per leaf as max |a - b| over max |cpu|: float32 sums
# in other orders (K2's atomics among them) carried through
# GRAD_SUBSTEPS substeps forward and back
GRAD_SUBSTEPS = 3
SUBSTEP_GRAD_TOL = 1e-3

# the material train step (phase 9): bench_material's production shape
# (183 x 183 hanging cloth, 200^3, the pinned top row) cut in depth only,
# dt = 1 / (fps substeps) kept at 1e-4; the tracked cloth turns at
# MAT_OMEGA about the vertical axis (so the pinned row moves with a
# non-uniform velocity) with seeded noise on its free vertices, and the
# rest shape is 10% shorter in y than the start; TRAIN_STEPS_M counted
# steps after one warm-up step; the finite-difference step's probe-0
# loss against the autodiff forward at the same parameters (the same
# kernels, K2's atomics in another order); the gradient against the CPU
# plain path over MAT_GRAD_SUBSTEPS substeps, per leaf as |a - b| /
# |cpu|, at phase 8's tolerance
MAT_NX, MAT_GRID, MAT_FRAMES, MAT_SUBSTEPS = 183, 200, 2, 10
MAT_OMEGA, MAT_NOISE = 2.0, 1e-4
TRAIN_STEPS_M = 3
FD_LOSS_TOL = 1e-6
MAT_GRAD_GRID, MAT_GRAD_SUBSTEPS = 200, 3
SIM_MOVE_MIN = 1e-4
# C3, the gradient in contact: bench_material's sphere (its 32 x 32 UV
# sphere of radius 0.22, wound inward, as the JAX bench's) raised into the
# lower half of the hanging cloth and rising at 0.5 m/s, so that the cloth
# inside it crosses its lower surface
MAT_CONTACT_CENTER, MAT_CONTACT_V = (1.0, 0.95, 1.25), (0.0, 0.5, 0.0)
MAT_CONTACT_R = 0.22

# the posed body (phase 10): sim/pose_playback's scene at full width, one
# pose per frame; the avatar on the card against the CPU as max |a - b| /
# max |cpu| (float32 sums in other orders, and the blended 4x4s inverted
# by another LU), the CPU re-posing every POSE_CPU_EVERY-th cloth vertex;
# a KNN set may differ only where the CPU's k-th and (k+1)-th squared
# distances lie within KNN_TIE_REL of each other; the body must move by
# POSE_MOVE_MIN between poses; the cut scene for the kernel path against
# the plain path keeps the body at full width
POSE_FRAMES, POSE_CPU_EVERY = 2, 16
AVATAR_REL_TOL, KNN_TIE_REL, POSE_MOVE_MIN = 1e-5, 1e-5, 1e-3
POSE_CUT = dict(nx=48, grid=64)

# the stage-2 and stage-4 tools (phase 11): data/make_synthetic_actorshq's
# capture at its defaults, the stage-2 CLI on it for CLI_ITERS iterations
# with one densification pass (at CLI_DENSIFY) and test evaluations after
# the first and the last step (the pass at CLI_GRAD_THRESHOLD);
# CLI_WARM steps left out of the steady
# ms/step; the reloaded checkpoint's render within CKPT_TOL of the largest
# value (the same float32 arrays through the PLY); the bake on the card
# against the CPU at AO_CUT^2 per texel within AO_TOL (the same float32
# formulas, the occupancy counts exact); the CLI at CUT on the card against
# the CPU, its losses and test L1 and PSNR within CUT_TOL relative
CLI_ITERS, CLI_DENSIFY, CLI_WARM, CLI_PROFILE_STEPS = 30, 10, 2, 3
# the default threshold (2e-4) clones and splits nothing in 10 steps from
# the gray start (an H100 run): a tenth of it makes the pass act
CLI_GRAD_THRESHOLD = 2e-5
SAMPLE_REPS = 20
CKPT_TOL = 1e-6
AO_CUT, AO_TOL = 64, 1e-5
CUT = dict(n_frames=2, n_cams=3, width=96, height=64, mesh=(20, 18),
           work_cap=64)
CUT_ITERS, CUT_TOL = 4, 1e-5

# the zero-shot demo (phase 12): data/make_demo_assets's assets with the
# pose sequence cut to DEMO_POSES poses and DEMO_EXTRA frames after them,
# train/run_demo at 250^3 and 400 substeps a frame, the sand released
# from frame 1.  The sand starts above the grid's top; its first substep
# leaves it at the top (G2P's clamp), from where it falls as g t (its
# median fall over frame FALL_FRAME within FALL_REL_TOL) onto the body's
# top (the rig sits down over the poses, its top from sim y 1.875 to
# 1.676), which it reaches in frame 6: the last, timed frame and the
# profile after it run with the sand in contact (some of it slower than
# g t).  The pre-P2G modifier leaves a live window's particles at |v| <=
# RELEASE_STILL; K5's mesh branch changes some cells; the cut scene
# (DEMO_CUT) over COMPARE_SUBSTEPS substeps on the kernel path against
# the plain path on the CPU at PATH_ATOL, beside the release schedule
# left out; ORBIT_CHECKS orbit frames at 1024^2 with and
# without the sand, and at ORBIT_CUT^2 on the card against the CPU within
# FRAME_TOL off the alpha cutoff's ties
DEMO_POSES, DEMO_GRID, DEMO_SUBSTEPS, DEMO_RELEASE = 3, 250, 400, 1
DEMO_EXTRA, FALL_FRAME = 5, 2
RELEASE_STILL = 1e-6
DEMO_CUT = dict(grid=64, skirt=(48, 48), sand_res=(30, 5, 20),
                sand_center=(-0.4, 1.2, -0.1), release=(0.0, 0.05),
                body_r=0.25, body_v=(0.0, 0.0, 0.5))
ORBIT_CHECKS, ORBIT_CUT = 2, 256
# two splats that cover a pixel at depths within DEPTH_BAND (relative) of
# each other: the card's and the CPU's projections round the depth apart
# by a few ulps, so the sort may order them either way (the sand's
# colours differ by position); such pixels are counted like the alpha
# cutoff's ties
DEPTH_BAND = 1e-6

# stage-1 tracking (phase 13): train/run_tracking on phase 11's capture,
# TRACK_ITERS iterations on frame 0 and on frame 1, through the worklist
# compositor (TRACK_WORK_CAP); K6 and K7 twice per iteration; the steady
# ms per iteration is the median after TRACK_WARM; one iteration's
# gradient through K6/K7 against their plain versions on the card per
# leaf (TRACK_GRAD_TOL of the leaf's largest entry), beside K7's output
# detached
TRACK_ITERS, TRACK_WORK_CAP, TRACK_WARM = (30, 10), 8192, 2
TRACK_FACES = 50244
TRACK_GRAD_TOL = 1e-3
TRACK_LEAVES = ("vertices", "rgb_colors", "cam_m", "cam_c")

# multi-device at world size 1 (phase 14): the card's machine has one
# card and NCCL refuses two ranks on one device, so the sharded paths run
# over a one-rank NCCL group in this process (the cross-rank logic is held
# on the CPU over gloo, tests/test_torch_parallel.py).  The sharded frame
# on path B's scene (the sphere as (F, 3, 3) triangles), its launches per
# substep held to path B's; over COMPARE_SUBSTEPS substeps against
# MPMSolver.frame on the card at PATH_ATOL, on path B's scene with the
# sphere at MD_BODY_CENTER (so that the collider acts), beside the
# collider dropped; K5 on the
# second half of phase 4's 128^3 grid against its plain version; the
# sharded material step at phase 9's shape over MAT_FRAMES x MAT_SUBSTEPS
# substeps against the single-device autograd of the same loss per leaf
# (MD_GRAD_TOL of the leaf's magnitude, or of a millionth of the largest
# leaf's where a leaf's own is smaller), beside K1's outputs detached;
# the data-parallel stage-2 step on phase 7's avatar with DP_SAMPLES
# samples (K6 and K7 twice each per sample) against the mean of the
# single-device gradients per leaf at STEP_GRAD_TOL, beside the first
# sample's gradient alone, then DP_STEPS timed steps
MD_GRAD_TOL = 1e-3
# the comparison's contact: path B's sphere (r 0.25) wound outward, its
# top 0.01 above the cloth (at 250^3 a top 0.02 under the cloth, as
# CONTACT's at 64^3, lies 2.5 cells away and acts on no cloth node in 10
# substeps), rising at CONTACT_MESH_V
MD_BODY_CENTER = (1.0, 1.06, 1.0)
DP_SAMPLES, DP_STEPS = 2, 5
# the production recovery (phase 15): train/stage3_production.py
# --recover at full width (158^2 hanging cloth: 24,964 vertices, 49,298
# faces, 74,262 particles; 200^3; 1 x 400 substeps), REC_STEPS steps
REC_NX, REC_GRID, REC_SUBSTEP, REC_STEPS = 158, 200, 400, 2
# the drivers (phase 16): train/bench_tracking.py at its defaults (the
# 144 x 142 mesh, 40,612 faces, 1500 x 1000, the 10,475-vertex rig with
# VPoser in the graph): 2 warm-up iterations, then BENCH_TRACK_ITERS on
# the tile path (the JAX bench's; no kernel) and on the worklist
# compositor (BENCH_TRACK_WORK_CAP; K6 and K7 twice per iteration); one
# joint iteration's gradient w.r.t. BENCH_TRACK_LEAVES (the SMPL-X
# translation taken as a leaf for the check) at BENCH_TRACK_CUT on the
# card against the CPU plain path, per leaf at TRACK_GRAD_TOL of its
# largest entry, beside the SMPL-X geometry detached (the latent's and the
# translation's gradients then vanish); the collision loss's device ms;
# a profile of one tile-path iteration; then mpmavatar_tpu_torch.bench
# --headline_only in this process, whose BENCH_KEYS must be finite and
# positive
BENCH_TRACK_ITERS, BENCH_TRACK_WORK_CAP = 10, 8192
BENCH_TRACK_FACES = 40612
# the cut keeps f = 1400 and so the splats' footprint at a mesh near the
# bench's (a 48 x 46 mesh's splats span more than the rasterizer's 36
# tiles per gaussian at f = 1400, and overflow); its 1,655 phase-2 items
# fit the cut worklist (a CPU run)
BENCH_TRACK_CUT = dict(n_theta=96, n_phi=94, width=480, height=320)
BENCH_TRACK_CUT_CAP = 2048
BENCH_TRACK_LEAVES = ("vertices", "rgb_colors", "latent", "trans")
BENCH_KEYS = ("value", "grid200_substeps_per_sec",
              "grid250_100k_sand_substeps_per_sec", "render_fps_1080p_50k")
# the stage-level checks (phase 17), tests/test_convergence.py's scenes
# and bounds with the kernels on (tests/test_torch_stages.py runs the same
# functions on the CPU with the JAX test files' own builders): tracking
# over STAGE_TRACK_ITERS iterations must cut the loss below
# STAGE_LOSS_RATIO of its first and the mean vertex error below
# STAGE_ERR_RATIO of its start; STAGE_PSNR_ITERS stage-2 steps must raise
# the held-out PSNR by more than STAGE_PSNR_GAIN dB.  The 80 x 80 views
# have 25 tiles: phase 2 holds at most 25 x 7 items (tracking,
# tile_capacity 256) and 25 x 3 (stage 2, 128), under STAGE_WORK_CAP
STAGE_TRACK_ITERS, STAGE_LOSS_RATIO, STAGE_ERR_RATIO = 250, 0.5, 0.4
STAGE_PSNR_ITERS, STAGE_PSNR_GAIN = 120, 3.0
STAGE_WORK_CAP = 256

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


def profile_device(fn):
    """torch.profiler over one call of ``fn``: (device-busy seconds,
    profiled wall seconds, [(kernel name, device us, launches)] by device
    time).  Only the device-side kernel and copy entries are summed: an
    operator's entry repeats the time of the kernels it launched, and so
    does a user annotation's range on the device (the optimizer's
    ``Optimizer.step#Adam.step``), which also has a host-side entry of
    its name."""
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
    averages = prof.key_averages()
    host_keys = {e.key for e in averages if e.device_type != DeviceType.CUDA}
    rows = []
    for e in averages:
        if e.device_type != DeviceType.CUDA or e.key in host_keys or getattr(
                e, "is_user_annotation", False):
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


# the FP32 operations counted by plain_ops: each add, subtract, multiply,
# divide (a reciprocal too) and square root, log and exp, one each (the
# plain versions make no fused multiply-adds); abs, min, max, comparisons
# and selects are not counted
COUNTED_OPS = ("add", "sub", "mul", "div", "reciprocal", "sqrt", "rsqrt",
               "log", "exp")


def plain_ops(fn, args, n: int) -> float:
    """The FP32 operations that plain version ``fn`` makes per element on
    ``args`` (``n`` elements, CPU), counted from its aten calls.  A
    multiply by the literal 1.0 is not counted: it is how PyTorch
    computes ``1.0 / x`` (a reciprocal, then that multiply)."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    total = 0

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, f_args=(), kwargs=None):
            nonlocal total
            out = func(*f_args, **(kwargs or {}))
            name = func.overloadpacket.__name__
            by_one = name == "mul" and any(
                not torch.is_tensor(a) and a == 1.0 for a in f_args)
            if name in COUNTED_OPS and not by_one:
                total += out.numel()
            return out

    with Count():
        fn(*args)
    return total / n


# sand_stress_plain builds, for every particle, both recompositions of
# F_new, u diag(exp h) v^T and u diag(1) v^T (9 x (6 multiplies + 2 adds)
# = 72 operations each), and the log of the trial singular values (3); a
# particle needs of these, by its branch (elastic, cone, tip), the logs,
# the first recomposition, or u v^T (9 x (3 + 2) = 45)
SAND_RECOMPOSE_OPS, SAND_LOG_OPS = 72.0, 3.0
SAND_BRANCH_OPS = (SAND_LOG_OPS, SAND_RECOMPOSE_OPS, 45.0)


def sand_ops(plain_count: float, branches) -> float:
    """K8's FP32 operations on a set whose plain branch counts
    (unselected, elastic, cone, tip) are ``branches``, from the plain
    version's count per particle (``plain_ops``); an unselected particle
    needs none."""
    shared = plain_count - 2 * SAND_RECOMPOSE_OPS - SAND_LOG_OPS
    return sum(k * (shared + extra)
               for k, extra in zip(branches[1:], SAND_BRANCH_OPS))


def random_order(cfg):
    """A seeded random order of a cloth's particles: elements among
    elements, vertices among vertices (CPU int64)."""
    import torch
    g_perm = torch.Generator().manual_seed(11)
    nnv = cfg.n_no_vertices
    return torch.cat([torch.randperm(nnv, generator=g_perm),
                      nnv + torch.randperm(cfg.n_vertices,
                                           generator=g_perm)])


def drive(name, solver, state, model, scene, frames, substeps, expect,
          stats=None):
    """One path: ``frames`` x ``substeps`` substeps with the launch
    counters reset just before and read just after; each kernel in
    ``expect`` (name -> launches per substep) must have launched that
    many times and no other kernel at all; the state must be finite after
    each frame.  ``scene`` is the frame inputs, or a function of the frame
    index that gives them.  Then a profile of PROFILE_SUBSTEPS more (with
    the last frame's inputs), whose device busy ms, kernels per substep and
    idle share go into ``stats`` when given.  Returns (final state, time,
    launches, steady ms/substep)."""
    import torch
    from mpmavatar_tpu_torch.ops import _build
    inputs = scene if callable(scene) else (lambda f: scene)
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    t, frame_s = 0.0, []
    for f in range(frames):
        t_f = time.perf_counter()
        state, t = solver.frame(state, model, DT, substeps, t, **inputs(f))
        torch.cuda.synchronize()
        frame_s.append(time.perf_counter() - t_f)
        solver.check_finite(state, f"{name}, frame {f}")
    launches = _build.launch_counts()
    n_sub = frames * substeps
    want = {k: per * n_sub for k, per in expect.items()}
    if launches != want:
        raise AssertionError(f"{name}: launches {launches}, expected {want}")
    ms_sub = 1e3 * frame_s[-1] / substeps
    print(f"{name}: launches {launches} in {n_sub} substeps; frame wall "
          f"times {[round(s, 4) for s in frame_s]} s; steady frame "
          f"{ms_sub:.4f} ms/substep = {1e3 / ms_sub:.1f} substeps/s")

    busy_s, prof_wall, rows = profile_device(
        lambda: solver.frame(state, model, DT, PROFILE_SUBSTEPS, t,
                             **inputs(frames - 1)))
    n = PROFILE_SUBSTEPS
    table = "\n".join(f"{us:12.1f} us {calls:6d}x  {key}"
                      for key, us, calls in rows)
    (OUT / f"chip_smoke_profile_{name}.txt").write_text(table + "\n")
    if not rows:
        print(f"{name} profile: the profiler recorded no device time; "
              "device busy share not measured")
    else:
        idle = 100 * max(0.0, 1 - busy_s / n / (ms_sub * 1e-3))
        kernels = sum(r[2] for r in rows) / n
        print(f"{name} profile of {n} substeps: device busy "
              f"{1e3 * busy_s / n:.4f} ms/substep in "
              f"{kernels:.1f} kernels/substep, "
              f"{1e3 * prof_wall / n:.4f} ms/substep profiled wall; "
              f"against the unprofiled steady frame the device is idle "
              f"{idle:.1f}% of the time")
        if stats is not None:
            stats.update(busy_ms=1e3 * busy_s / n, kernels=kernels,
                         idle_pct=idle)
    for key, us, calls in rows[:12]:
        print(f"  {us / n:10.2f} us/substep {calls // n:4d}/substep  "
              f"{key[:90]}")
    return state, t, launches, ms_sub


def mesh_branch_cells(solver, state, model, scene, t) -> tuple:
    """One more grid phase from ``state``, K5 with and without its mesh
    fields: (the grid cells whose velocity the mesh branch changed, the
    cells the collider splat covers)."""
    from mpmavatar_tpu_torch.core import stepping
    from mpmavatar_tpu_torch.ops import grid_pipeline as gp
    cfg = solver.cfg
    col = solver.colliders.mesh_colliders[0]
    post = solver.colliders.grid_post
    nd, nf, ny, stress, vf = stepping.compute_stress(cfg, state, model, DT)
    st1 = dataclasses.replace(state, d=nd, F=nf, yield_stress=ny)
    gv_in, gm = stepping.p2g(cfg, st1, model, stress, vf, DT)
    acc, mw = stepping.mesh_collider_fields(cfg, col, scene["mesh_x"],
                                            scene["mesh_v"])
    surf = gp.pack_surface_params(post)
    scal = (model.gravity, model.grid_v_damping_scale)
    with_mesh = gp.make_grid_pipeline(cfg, post, True, False)(
        gv_in, gm, acc, mw, None, None, *scal, col.friction, t, DT, surf)
    no_mesh = gp.make_grid_pipeline(cfg, post, False, False)(
        gv_in, gm, None, None, None, None, *scal, None, t, DT, surf)
    return (int((with_mesh != no_mesh).any(dim=1).sum()),
            int((mw > 1e-15).sum()))


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


def g2p_inputs(run):
    """(x, grid_v) of the last K3 call that ``run`` makes: the positions
    and the grid velocities a path hands K3."""
    from unittest import mock
    from mpmavatar_tpu_torch.ops import transfer as ktransfer
    calls, real = [], ktransfer.g2p

    def record(x, grid_v, *args, **kw):
        calls.append((x, grid_v))
        return real(x, grid_v, *args, **kw)

    with mock.patch.object(ktransfer, "g2p", record):
        run()
    return calls[-1]


def live_slots(packed, ids, nc):
    """(W, C) bool: the slots that hold a gaussian of nonzero opacity (the
    sentinel row N has opacity 0, as have the dead splats)."""
    return packed[:, 5 + nc][ids] > 0


def composite_check(check, label, packed, ids, pix, nc, launches_of):
    """K6 against its gathered plain version on one worklist (the
    alpha-cutoff ties counted and left out), through ``check``."""
    from mpmavatar_tpu_torch.ops import composite as kcomp
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


def composite_bwd_check(check, label, packed, ids, pix, g, nc,
                        launches_of):
    """K7 against its plain version on one worklist and cotangent (the
    rows of tied items left out, a second run read), through
    ``check``."""
    import torch
    from mpmavatar_tpu_torch.ops import composite as kcomp
    dev = packed.device
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
          20.0 * live * 256 + 50.0 * n_pass, launches_of, label=label,
          err=(err_abs, ok, verdict),
          extra={"items": W, "chunk": C, "live_slots": live,
                 "live_items": live_items, "passing_evaluations": n_pass,
                 "near_cutoff_evaluations": n_near,
                 "tied_items": int(tied.sum()),
                 "rows_held": held, "rerun_rel": rerun,
                 **kcomp.kernel_info(C, nc)[kcomp.KERNEL_BWD]})


def composite_pair(check, label, run, launches_of):
    """K6 and K7 against their plain versions on the worklists and
    cotangents of one more differentiated ``run`` (its two compositing
    phases), through ``check``."""
    calls = composite_calls(run)
    if len(calls) != 2 or any(len(c) != 4 for c in calls):
        raise AssertionError(f"{label}: {len(calls)} compositor calls, not "
                             f"the two phases with their cotangents")
    for phase, (packed, ids, pix0, g) in zip((1, 2), calls):
        nc = packed.shape[1] - 6
        composite_check(check, f"composite ({label} phase {phase})", packed,
                        ids, pix0, nc, launches_of)
        composite_bwd_check(check, f"composite_bwd ({label} phase "
                            f"{phase})", packed, ids, pix0, g, nc,
                            launches_of)


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
        composite_check(check, label, packed, ids, pix, nc,
                        launches_of)

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
        composite_bwd_check(check, label, packed, ids, pix, g, nc,
                            launches)

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


def stretched(x, d):
    """The cloth stretched in its plane about (1, y, 1), x by 1.15 and z
    by 0.9, with d3 at 0.9: (x, d).  At rest mu and lam see only the
    strain the substeps make, near the positions' rounding, so the
    card's and the CPU's gradients w.r.t. them part by ~1e-2 of their
    largest; stretched, the strain stands well above it.  d3 at 0.9
    keeps every element on the return map's contact branch, away from
    R33 = 1."""
    import torch
    scale = torch.tensor([1.15, 1.0, 0.9], device=x.device)
    centre = torch.tensor([1.0, 0.0, 1.0], device=x.device)
    d = d * scale[:, None]              # row a of each column: axis a
    d[:, :, 2] *= 0.9
    return centre + (x - centre) * scale, d


def grad_path(dev, solver, state0, model, solver_cpu, model_cpu,
              per_sub) -> float:
    """Phase 8, the differentiated substep; returns its ms per substep."""
    import torch
    from mpmavatar_tpu_torch.core import linalg
    from mpmavatar_tpu_torch.ops import _autograd, _build
    cfg = solver.cfg
    E = cfg.n_elements
    gen = torch.Generator().manual_seed(3000)
    v0 = 0.05 * torch.randn((cfg.n_particles, 3), generator=gen)
    weights = torch.randn((cfg.n_vertices, 3), generator=gen)
    names = ("mu", "lam", "mass", "R_inv")

    def run(slv, st0, m0):
        """GRAD_SUBSTEPS substeps and the loss's gradient: (gradients,
        d after each substep, forward s, backward s)."""
        device = st0.x.device
        sync = torch.cuda.synchronize if device.type == "cuda" else (
            lambda: None)
        leaves = [a.detach().clone().requires_grad_(True)
                  for a in (m0.mu, m0.lam, st0.mass, st0.R_inv)]
        x, d = stretched(st0.x, st0.d)
        s = dataclasses.replace(st0, x=x, d=d, v=v0.to(device),
                                mass=leaves[2], R_inv=leaves[3])
        m = dataclasses.replace(m0, mu=leaves[0], lam=leaves[1])
        sync()
        t0, t, ds = time.perf_counter(), 0.0, []
        for _ in range(GRAD_SUBSTEPS):
            s, t = slv.frame(s, m, DT, 1, t)
            ds.append(s.d.detach())
        loss = (s.x[E:] * weights.to(device)).sum()
        sync()
        t1 = time.perf_counter()
        if loss.requires_grad:
            grads = torch.autograd.grad(loss, leaves)
        else:           # no path to a leaf: every one ran through a kernel
            grads = [torch.zeros_like(a) for a in leaves]
        sync()
        return grads, ds, t1 - t0, time.perf_counter() - t1

    run(solver, state0, model)                     # warm-up
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    grads, ds, fwd_s, bwd_s = run(solver, state0, model)
    launches = _build.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    want = {k: per * GRAD_SUBSTEPS for k, per in per_sub.items()}
    if launches != want:
        raise AssertionError(f"differentiated substep: launches {launches}, "
                             f"expected {want}")
    busy_s, prof_wall, rows = profile_device(
        lambda: run(solver, state0, model))
    ms = 1e3 * (fwd_s + bwd_s) / GRAD_SUBSTEPS
    print(f"differentiated substep (cloth drop, {GRAD_SUBSTEPS} substeps "
          f"forward and back): launches {launches}; {ms:.4f} ms per "
          f"differentiated substep (forward {1e3 * fwd_s / GRAD_SUBSTEPS:.4f},"
          f" backward {1e3 * bwd_s / GRAD_SUBSTEPS:.4f}: the backward's share "
          f"{100 * bwd_s / (fwd_s + bwd_s):.1f}%); peak allocated "
          f"{peak / 2 ** 30:.3f} GiB ({(peak - base) / 2 ** 30:.3f} GiB above "
          f"the {base / 2 ** 30:.3f} GiB held before)")
    table = "\n".join(f"{us:12.1f} us {calls:6d}x  {key}"
                      for key, us, calls in rows)
    (OUT / "chip_smoke_profile_grad_substep.txt").write_text(table + "\n")
    if rows:
        print(f"differentiated substep profile: device busy "
              f"{1e3 * busy_s / GRAD_SUBSTEPS:.4f} ms/substep in "
              f"{sum(r[2] for r in rows) / GRAD_SUBSTEPS:.1f} "
              f"kernels/substep, {1e3 * prof_wall / GRAD_SUBSTEPS:.4f} "
              f"ms/substep profiled wall; against the unprofiled run the "
              f"device is idle "
              f"{100 * max(0.0, 1 - busy_s * 1e3 / GRAD_SUBSTEPS / ms):.1f}% "
              f"of the time")
        for key, us, calls in rows[:8]:
            print(f"  {us / GRAD_SUBSTEPS:10.2f} us/substep "
                  f"{calls / GRAD_SUBSTEPS:6.1f}/substep  {key[:90]}")
    else:
        print("differentiated substep profile: the profiler recorded no "
              "device time; device busy not measured")

    grads_cpu, ds_cpu, fwd_c, bwd_c = run(solver_cpu, state0.to("cpu"),
                                          model_cpu)
    print(f"the plain path on the CPU: {1e3 * (fwd_c + bwd_c):.1f} ms for "
          f"{GRAD_SUBSTEPS} differentiated substeps (backward "
          f"{1e3 * bwd_c:.1f} ms)")
    # the kernels' outputs detached, as before they had a backward
    real_call = _autograd.call
    _autograd.call = lambda kernel, twin, *args: kernel(*args)
    try:
        wrong = run(solver, state0, model)[0]
    finally:
        _autograd.call = real_call

    r33 = lambda d: linalg.qr3_pos(d)[1][:, 2, 2].cpu()
    crossed = torch.zeros(E, dtype=torch.bool)
    for a, b in zip(ds, ds_cpu):
        crossed |= (r33(a) > 1.0) != (r33(b) > 1.0)
    # the crossed elements' own rows left out
    keep_p = torch.cat([~crossed, torch.ones(cfg.n_particles - E,
                                             dtype=torch.bool)])
    keep = {"mu": keep_p, "lam": keep_p, "mass": None, "R_inv": ~crossed}

    def err(name, a, b):
        a = a.cpu()
        if keep[name] is not None:
            a, b = a[keep[name]], b[keep[name]]
        return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)

    sound = {n: err(n, a, b) for n, a, b in zip(names, grads, grads_cpu)}
    bad = {n: err(n, a, b) for n, a, b in zip(names, wrong, grads_cpu)}
    print(f"differentiated substep against the plain path: "
          f"{int(crossed.sum())} of {E} elements crossed R33 = 1 between "
          f"them; per leaf max rel err "
          + ", ".join(f"{n} {e:.3e}" for n, e in sound.items())
          + f" (tol {SUBSTEP_GRAD_TOL:.0e}); largest |gradient| "
          + ", ".join(f"{n} {float(g.abs().max()):.3e}"
                      for n, g in zip(names, grads_cpu))
          + "; wrong path (the kernels' outputs detached): "
          + ", ".join(f"{n} {e:.3e}" for n, e in bad.items()))
    if not all(float(g.abs().max()) > 0 for g in grads_cpu):
        raise AssertionError("a leaf's gradient is zero on the plain path")
    if not max(sound.values()) <= SUBSTEP_GRAD_TOL:
        raise AssertionError("the differentiated substep disagrees with the "
                             "plain path")
    if not min(bad.values()) > SUBSTEP_GRAD_TOL:
        raise AssertionError("the gradient limit does not separate the "
                             "wrong path")
    return ms


def material_trainer(dev, grid, frames, substeps, seed=0, contact=False):
    """bench_material.make_trainer at full width on ``dev``: the hanging
    cloth turning at MAT_OMEGA (seeded noise of MAT_NOISE on the tracked
    free vertices), its rest shape 10% shorter in y, dt = 1e-4.  With
    ``contact`` the trainer's body sphere is raised to MAT_CONTACT_CENTER
    and rises at MAT_CONTACT_V.  Returns (trainer, tracked trajectory
    (F+1, V, 3), body sequence)."""
    import numpy as np
    from mpmavatar_tpu_torch.core.types import build_body_sphere
    from mpmavatar_tpu_torch.train import bench_material
    from mpmavatar_tpu_torch.train.material import MaterialTrainer
    fps = 1.0 / (DT * substeps)
    verts, _ = bench_material.hanging_cloth(MAT_NX, MAT_NX)
    x, z = verts[:, 0] - 1.0, verts[:, 2] - 1.0
    train = np.repeat(verts[None], frames + 1, 0)
    for i in range(frames + 1):
        a = MAT_OMEGA * i / fps
        train[i, :, 0] = 1.0 + np.cos(a) * x + np.sin(a) * z
        train[i, :, 2] = 1.0 - np.sin(a) * x + np.cos(a) * z
    rng = np.random.default_rng(seed)
    train[1:, MAT_NX:] += rng.normal(0, MAT_NOISE, train[1:, MAT_NX:].shape
                                     ).astype(np.float32)
    first = verts * np.float32([1.0, 0.9, 1.0])
    tr, _, faces, body_seq, body_faces = bench_material.make_trainer(
        MAT_NX, MAT_NX, grid, substeps, frames, iterations=10,
        train_verts=train, fps=fps, first_frame_verts=first, device=dev)
    if contact:
        bv, _ = build_body_sphere(n_theta=32, n_phi=32,
                                  center=MAT_CONTACT_CENTER, r=MAT_CONTACT_R)
        body_seq = np.stack([bv + np.float32(i / fps)
                             * np.float32(MAT_CONTACT_V)
                             for i in range(frames + 1)])
        tr = MaterialTrainer(tr.cfg, faces, first, train, body_seq,
                             body_faces, num_joint_v=MAT_NX, num_joint_f=0,
                             device=dev)
    return tr, train, body_seq


def material_path(dev, per_sub) -> tuple:
    """Phase 9, the material train step; returns (ms per step, launches
    per step)."""
    import numpy as np
    import torch
    from mpmavatar_tpu_torch.core import stepping
    from mpmavatar_tpu_torch.ops import _autograd, _build
    tr, train, body = material_trainer(dev, MAT_GRID, MAT_FRAMES,
                                       MAT_SUBSTEPS)
    cfg = tr.static
    n_sub = MAT_FRAMES * MAT_SUBSTEPS
    dt = (1.0 / tr.cfg.fps) / tr.cfg.substep
    print(f"material train step (bench_material at {MAT_NX}x{MAT_NX}, "
          f"{MAT_GRID}^3): P={cfg.n_particles}, {cfg.num_joint_v} pinned "
          f"vertices, {len(tr.smplx_faces)} collider faces, {MAT_FRAMES} "
          f"frames x {MAT_SUBSTEPS} substeps, dt={dt:.6g}")
    if not (cfg.n_particles == MAT_NX ** 2 + 2 * (MAT_NX - 1) ** 2
            and cfg.n_grid == MAT_GRID and cfg.num_joint_v == MAT_NX
            and abs(dt - DT) < 1e-12):
        raise AssertionError("material train step: not the production shape")

    def step_s():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, _ = tr.train_one_step()
        torch.cuda.synchronize()
        return time.perf_counter() - t0, loss

    # one untimed step first (the allocator's growth, each shape's first
    # use), as bench_material.run_bench does; the counted steps follow
    warm_ms = 1e3 * step_s()[0]
    init = tr._params_now()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    steps = [step_s() for _ in range(TRAIN_STEPS_M)]
    launches = _build.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    # each substep's kernels run in the forward, in its frame's recompute
    # and in its own recompute (frame and substep both checkpointed); the
    # backwards launch none
    want = {k: 3 * per * n_sub * TRAIN_STEPS_M for k, per in per_sub.items()}
    if launches != want:
        raise AssertionError(f"material train step: launches {launches}, "
                             f"expected {want}")
    ms = [1e3 * s for s, _ in steps]
    losses = [loss for _, loss in steps]
    params = tr._params_now()
    med = statistics.median(ms)
    print(f"material train step: launches {launches} in {TRAIN_STEPS_M} "
          f"steps (3 x per substep x {n_sub} substeps each); "
          f"{med:.4f} ms/step median ({min(ms):.4f}-{max(ms):.4f}; the "
          f"untimed warm-up step before them {warm_ms:.4f} ms), "
          f"{med / n_sub:.4f} ms per differentiated substep; losses "
          + ", ".join(f"{x:.6e}" for x in losses) + "; D, E, H "
          + ", ".join(f"{init[k]:.6f} -> {params[k]:.6f}" for k in "DEH")
          + f"; peak allocated {peak / 2 ** 30:.3f} GiB "
          f"({(peak - base) / 2 ** 30:.3f} GiB above the "
          f"{base / 2 ** 30:.3f} GiB held before)")
    if not all(np.isfinite(losses)) or not all(
            params[k] != init[k] for k in "DEH"):
        raise AssertionError("material train step: a loss is not finite or "
                             "a parameter did not move")
    # the step's parts, once more at the same parameters: the forward
    # under grad, then autograd (both recomputes and the twins'
    # backwards); and the forward alone, without grad
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss = tr.rollout_loss(tr.params)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    torch.autograd.grad(loss, [tr.params[k] for k in "DEH"])
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    with torch.no_grad():
        tr.rollout_loss(tr.params)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    fwd_ms, bwd_ms, plain_fwd_ms = (1e3 * (t1 - t0), 1e3 * (t2 - t1),
                                    1e3 * (t3 - t2))
    print(f"material train step parts: forward under grad {fwd_ms:.4f} ms, "
          f"autograd (two recomputes and the backwards) {bwd_ms:.4f} ms, "
          f"forward without grad {plain_fwd_ms:.4f} ms; grad/forward "
          f"{(fwd_ms + bwd_ms) / plain_fwd_ms:.2f}; the backwards alone, "
          f"taking each recompute as one forward under grad, "
          f"{100 * (bwd_ms - 2 * fwd_ms) / (fwd_ms + bwd_ms):.1f}% of the "
          f"step's rollout")
    busy_s, prof_wall, rows = profile_device(tr.train_one_step)
    table = "\n".join(f"{us:12.1f} us {calls:6d}x  {key}"
                      for key, us, calls in rows)
    (OUT / "chip_smoke_profile_material_step.txt").write_text(table + "\n")
    if rows:
        print(f"material train step profile: device busy "
              f"{1e3 * busy_s:.4f} ms/step in {sum(r[2] for r in rows)} "
              f"kernels/step, {1e3 * prof_wall:.4f} ms profiled wall; "
              f"against the unprofiled median the device is idle "
              f"{100 * max(0.0, 1 - 1e3 * busy_s / med):.1f}% of the time")
        for key, us, calls in rows[:8]:
            print(f"  {us / 1e3:10.4f} ms/step {calls:7d}/step  {key[:90]}")
    else:
        print("material train step profile: the profiler recorded no device "
              "time; device busy not measured")

    # the finite-difference step's probe 0 against the autodiff forward
    ad_loss = float(tr.rollout_loss(tr.params).detach())
    fd_loss, fd_params = tr.train_one_step_finite_diff()
    fd_rel = abs(fd_loss - ad_loss) / abs(ad_loss)
    print(f"finite-difference step: probe-0 loss {fd_loss:.9e} against the "
          f"autodiff forward {ad_loss:.9e}: rel {fd_rel:.3e} (tol "
          f"{FD_LOSS_TOL:.0e}); D, E, H after it "
          + ", ".join(f"{fd_params[k]:.6f}" for k in "DEH"))
    if not fd_rel <= FD_LOSS_TOL:
        raise AssertionError("the finite-difference step's loss disagrees "
                             "with the autodiff forward")

    # stage-4 simulate: the trained parameters, the pinned row turning
    jv = lambda i: (train[i + 1, :MAT_NX] - train[i, :MAT_NX]) * (
        1.0 / (DT * MAT_SUBSTEPS))
    t0 = time.perf_counter()
    frames = tr.simulate(train[0], np.zeros_like(train[0]), body,
                         np.zeros_like(body), MAT_FRAMES, joint_velo_fn=jv)
    move = float(np.abs(frames[-1] - train[0]).max())
    print(f"simulate: {MAT_FRAMES} frames in {time.perf_counter() - t0:.2f} "
          f"s, finite {all(np.isfinite(f).all() for f in frames)}, the "
          f"cloth moved up to {move:.3e} (at least {SIM_MOVE_MIN:.0e}), "
          f"the pinned row turning at {MAT_OMEGA} rad/s")
    if not all(np.isfinite(f).all() for f in frames) or not \
            move >= SIM_MOVE_MIN:
        raise AssertionError("simulate: not finite, or the cloth did not "
                             "move")

    # the gradient against the CPU plain path
    def grads(trainer):
        leaves = [trainer.params[k] for k in "DEH"]
        loss = trainer.rollout_loss(trainer.params)
        if not loss.requires_grad:      # every path ran through a kernel
            return [0.0, 0.0, 0.0]
        return [float(g) for g in torch.autograd.grad(loss, leaves)]

    g_card = grads(material_trainer(dev, MAT_GRAD_GRID, 1,
                                    MAT_GRAD_SUBSTEPS)[0])
    # a sound repeat: the same rollout again (K2's atomics add in another
    # order)
    g_again = grads(material_trainer(dev, MAT_GRAD_GRID, 1,
                                     MAT_GRAD_SUBSTEPS)[0])
    t0 = time.perf_counter()
    g_cpu = grads(material_trainer("cpu", MAT_GRAD_GRID, 1,
                                   MAT_GRAD_SUBSTEPS)[0])
    cpu_s = time.perf_counter() - t0
    real_call = _autograd.call
    _autograd.call = lambda kernel, twin, *args: kernel(*args)
    try:
        g_wrong = grads(material_trainer(dev, MAT_GRAD_GRID, 1,
                                         MAT_GRAD_SUBSTEPS)[0])
    finally:
        _autograd.call = real_call
    real_points = stepping.mover_points
    stepping.mover_points = lambda *a, **k: tuple(
        t.detach() for t in real_points(*a, **k))
    try:
        g_cut = grads(material_trainer(dev, MAT_GRAD_GRID, 1,
                                       MAT_GRAD_SUBSTEPS)[0])
    finally:
        stepping.mover_points = real_points
    rel = lambda a, b: [abs(x - y) / max(abs(y), 1e-30)
                        for x, y in zip(a, b)]
    sound, bad = rel(g_card, g_cpu), rel(g_wrong, g_cpu)
    share, repeat = rel(g_cut, g_card), rel(g_again, g_card)
    print(f"material gradient ({MAT_GRAD_SUBSTEPS} substeps at "
          f"{MAT_GRAD_GRID}^3) against the plain path on the CPU (its "
          f"rollout and backward {cpu_s:.1f} s): d/dD, d/dE, d/dH card "
          + ", ".join(f"{g:.6e}" for g in g_card) + ", cpu "
          + ", ".join(f"{g:.6e}" for g in g_cpu) + "; rel err "
          + ", ".join(f"{e:.3e}" for e in sound)
          + f" (tol {SUBSTEP_GRAD_TOL:.0e}); wrong path (the kernels' "
          f"outputs detached) "
          + ", ".join(f"{e:.3e}" for e in bad)
          + "; the mover's points detached: change "
          + ", ".join(f"{e:.3e}" for e in share)
          + "; the same rollout again: change "
          + ", ".join(f"{e:.3e}" for e in repeat))
    if not all(g != 0.0 for g in g_cpu):
        raise AssertionError("a material gradient is zero on the plain path")
    if not max(sound) <= SUBSTEP_GRAD_TOL:
        raise AssertionError("the material gradient disagrees with the plain "
                             "path")
    if not min(bad) > SUBSTEP_GRAD_TOL:
        raise AssertionError("the gradient limit does not separate the wrong "
                             "path")

    # C3: the same gradient with the body sphere in contact, raised into
    # the hanging cloth and rising, so that K5's mesh projection and its
    # twin backward act on it
    def with_contact(device):
        return material_trainer(device, MAT_GRAD_GRID, 1, MAT_GRAD_SUBSTEPS,
                                contact=True)[0]

    t_c3 = time.perf_counter()
    g_card_c = grads(with_contact(dev))
    t0 = time.perf_counter()
    g_cpu_c = grads(with_contact("cpu"))
    cpu_c_s = time.perf_counter() - t0
    _autograd.call = lambda kernel, twin, *args: kernel(*args)
    try:
        g_wrong_c = grads(with_contact(dev))
    finally:
        _autograd.call = real_call
    sound_c, bad_c = rel(g_card_c, g_cpu_c), rel(g_wrong_c, g_cpu_c)
    contact_c = rel(g_cpu_c, g_cpu)
    print(f"material gradient in contact (C3; the body sphere at "
          f"{MAT_CONTACT_CENTER}, r {MAT_CONTACT_R}, rising at "
          f"{MAT_CONTACT_V} m/s; {MAT_GRAD_SUBSTEPS} substeps at "
          f"{MAT_GRAD_GRID}^3; the CPU side {cpu_c_s:.1f} s): d/dD, d/dE, "
          f"d/dH card " + ", ".join(f"{g:.6e}" for g in g_card_c) + ", cpu "
          + ", ".join(f"{g:.6e}" for g in g_cpu_c) + "; rel err "
          + ", ".join(f"{e:.3e}" for e in sound_c)
          + f" (tol {SUBSTEP_GRAD_TOL:.0e}); wrong path (the kernels' "
          f"outputs detached) " + ", ".join(f"{e:.3e}" for e in bad_c)
          + "; the contact moved the CPU gradient by "
          + ", ".join(f"{e:.3e}" for e in contact_c)
          + f"; these readings took {time.perf_counter() - t_c3:.1f} s")
    if not min(contact_c) > SUBSTEP_GRAD_TOL:
        raise AssertionError("C3: the contact does not move the material "
                             "gradient beyond the tolerance")
    if not max(sound_c) <= SUBSTEP_GRAD_TOL:
        raise AssertionError("C3: the material gradient in contact disagrees "
                             "with the plain path")
    if not min(bad_c) > SUBSTEP_GRAD_TOL:
        raise AssertionError("C3: the gradient limit does not separate the "
                             "wrong path")
    per_step = {k: v // TRAIN_STEPS_M for k, v in launches.items()}
    return med, per_step


def timed_ms(fn, reps: int = 3) -> float:
    """Median host-clock ms of ``fn`` over ``reps`` calls, each ending in
    a synchronize."""
    import torch
    runs = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        runs.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(runs)


def posed_body_path(dev, smi, scene, body, body_cpu, per_sub) -> tuple:
    """Phase 10, the posed body: ``scene`` is sim/pose_playback's scene on
    the card, posed by ``body``; ``body_cpu`` is the same archive on the
    CPU.  Returns (steady ms per substep, launches)."""
    import numpy as np
    import torch
    from mpmavatar_tpu_torch.avatar import (deform_tracked_to_poses, lbs,
                                            smplx_forward)
    from mpmavatar_tpu_torch.core.types import build_cloth
    from mpmavatar_tpu_torch.sim import pose_playback as pp

    t_phase = time.perf_counter()
    n_verts, n_faces = body.v_template.shape[0], body.faces.shape[0]
    parents = body.parents
    print(f"posed body: the synthetic SMPL-X archive, {n_verts} vertices, "
          f"{n_faces} faces, {len(parents)} joints, "
          f"{body.shapedirs.shape[-1]} + {body.expr_dirs.shape[-1]} shape "
          f"directions, {body.posedirs.shape[0]} pose directions; "
          f"{scene.solver.cfg.n_particles} particles, {GRID}^3, "
          f"{POSE_FRAMES} frames x {SUBSTEPS} substeps, one pose per frame")
    if not (n_verts == 10_476 and n_faces == 20_736 and len(parents) == 55
            and parents[0] == -1
            and all(0 <= p < i for i, p in enumerate(parents) if i)
            and body.shapedirs.shape[-1] == 300
            and body.expr_dirs.shape[-1] == 100
            and body.posedirs.shape[0] == 486):
        raise AssertionError("posed body: not SMPL-X's widths")

    first, poses = pp.make_poses()
    on = lambda d, device: {k: torch.as_tensor(v, device=device)
                            for k, v in d.items()}
    first_d, poses_d = on(first, dev), on(poses, dev)
    first_c, poses_c = on(first, "cpu"), on(poses, "cpu")
    cloth_c = torch.as_tensor(build_cloth(NX, NX, y0=pp.CLOTH_Y)[0])
    cloth_d = cloth_c.to(dev)
    fps = 1.0 / (SUBSTEPS * DT)

    # posing the sequence on the card, and the KNN's share of it
    pose_ms = timed_ms(lambda: pp.prepare_pose_playback(
        body, first_d, poses_d, cloth_d, fps=fps))
    body0_d = smplx_forward(body, first_d).vertices[0]
    knn_ms = timed_ms(lambda: lbs.knn(cloth_d, body0_d, pp.KNN_K))

    # the avatar on the card against the CPU
    out_d, out_c = smplx_forward(body, poses_d), smplx_forward(body_cpu,
                                                               poses_c)
    errs = {f: rel_err([getattr(out_d, f).cpu()], [getattr(out_c, f)])[1]
            for f in ("vertices", "joints", "transform_mat")}
    sub = slice(None, None, POSE_CPU_EVERY)
    re_d = scene.playback["verts"][:, sub].cpu()
    re_c = deform_tracked_to_poses(body_cpu, cloth_c[sub], first_c, poses_c,
                                   k=pp.KNN_K)[0]
    # the KNN sets: a set may differ only where the k-th and (k+1)-th
    # distances tie within rounding
    body0_c = smplx_forward(body_cpu, first_c).vertices[0]
    idx_d = lbs.knn(cloth_d[sub], body0_d, pp.KNN_K)[1].cpu()
    d2_c, idx_c = lbs.knn(cloth_c[sub], body0_c, pp.KNN_K + 1)
    differ = (idx_d.sort(1).values != idx_c[:, :pp.KNN_K].sort(1).values
              ).any(1)
    k_th, next_d = d2_c[:, pp.KNN_K - 1], d2_c[:, pp.KNN_K]
    tie = (next_d - k_th) <= KNN_TIE_REL * next_d
    untied = int((differ & ~tie).sum())
    errs["re-posed cloth"] = rel_err([re_d[:, ~differ]], [re_c[:, ~differ]])[1]
    print(f"posed body, card against CPU (max |a - b| / max |cpu|, tol "
          f"{AVATAR_REL_TOL:.0e}): " + ", ".join(
              f"{k} {v:.3e}" for k, v in errs.items())
          + f" (the re-posed cloth on every {POSE_CPU_EVERY}th of its "
          f"{len(cloth_c)} vertices: {len(re_c[0])}); KNN sets that differ: "
          f"{int(differ.sum())}, of them not at a k-th/(k+1)-th tie "
          f"{untied}")
    if untied or not max(errs.values()) <= AVATAR_REL_TOL:
        raise AssertionError("posed body: the avatar on the card disagrees "
                             "with the CPU")

    # the frames through the kernels
    body_move = float((scene.playback["smplx"][1:]
                       - scene.playback["smplx"][:-1]).abs().max())
    speed = float(scene.playback["smplx_velo"].norm(dim=-1).max())
    stats = {}
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    state, t, launches, ms_sub = drive("posed_body", scene.solver,
                                       scene.state, scene.model, scene.inputs,
                                       POSE_FRAMES, SUBSTEPS, per_sub, stats)
    peak = torch.cuda.max_memory_allocated()
    changed, covered = mesh_branch_cells(scene.solver, state, scene.model,
                                         scene.inputs(POSE_FRAMES - 1), t)
    print(f"posed body: the body moved up to {body_move:.4e} between poses "
          f"(surface speed up to {speed:.3f} m/s); K5's mesh branch changed "
          f"the velocity of {changed} grid cells ({covered} covered by the "
          f"collider splat)")
    if not body_move >= POSE_MOVE_MIN or changed <= 0:
        raise AssertionError("posed body: the body did not move, or no "
                             "contact")

    # the cut scene: COMPARE_SUBSTEPS substeps on the kernel path against
    # the plain path on the CPU, the CPU fed the card's posed sequence;
    # wrong paths: the body held still, the collider's friction 0
    cut = pp.build(device=dev, body=body, **POSE_CUT)
    cpu_scenes = {"plain": pp.build(device="cpu", body=body_cpu, **POSE_CUT),
                  "friction 0": pp.build(device="cpu", body=body_cpu,
                                         friction=0.0, **POSE_CUT)}
    for s_c in cpu_scenes.values():
        s_c.playback = {k: v.cpu() for k, v in cut.playback.items()}
    plain, fric0 = cpu_scenes["plain"], cpu_scenes["friction 0"]
    still = dict(plain.inputs(0),
                 mesh_v=torch.zeros_like(plain.inputs(0)["mesh_v"]))
    wrong = {"body held still": (plain, still),
             "friction 0": (fric0, fric0.inputs(0))}
    readings = {name: {"x": [], "v": []} for name in ("kernel", *wrong)}
    for seed in PATH_SEEDS:
        g = torch.Generator(device=dev).manual_seed(3000 + seed)
        a0 = dataclasses.replace(cut.state, v=cut.state.v + 0.05 * torch.randn(
            cut.state.v.shape, generator=g, device=dev))
        outs = {"kernel": cut.solver.frame(a0, cut.model, DT,
                                           COMPARE_SUBSTEPS, 0.0,
                                           **cut.inputs(0))[0]}
        b = plain.solver.frame(a0.to("cpu"), plain.model, DT,
                               COMPARE_SUBSTEPS, 0.0, **plain.inputs(0))[0]
        for name, (s_c, inputs) in wrong.items():
            outs[name] = s_c.solver.frame(a0.to("cpu"), s_c.model, DT,
                                          COMPARE_SUBSTEPS, 0.0, **inputs)[0]
        for name, o in outs.items():
            for f in ("x", "v"):
                readings[name][f].append(
                    float((getattr(o, f).cpu() - getattr(b, f)).abs().max()))
        print(f"posed body, cut scene ({POSE_CUT}), seed {seed}, "
              f"{COMPARE_SUBSTEPS} substeps against the plain path: "
              + "; ".join(f"{name}: x {r['x'][-1]:.3e}, v {r['v'][-1]:.3e}"
                          for name, r in readings.items()))
    for f, tol in PATH_ATOL.items():
        if not max(readings["kernel"][f]) <= tol:
            raise AssertionError(f"posed body: the kernel path disagrees "
                                 f"with the plain path in {f}")
    for name in wrong:
        if not min(readings[name]["v"]) > PATH_ATOL["v"]:
            raise AssertionError(f"posed body: the v limit does not "
                                 f"separate the wrong path ({name})")
    print(f"posed body on {smi}: posing the {pp.N_POSES} poses "
          f"{pose_ms:.4f} ms (host clock, median of 3), of it the KNN "
          f"{knn_ms:.4f} ms ({100 * knn_ms / pose_ms:.1f}%); steady "
          f"{ms_sub:.4f} ms/substep; device busy "
          f"{stats.get('busy_ms', float('nan')):.4f} ms/substep in "
          f"{stats.get('kernels', float('nan')):.1f} kernels/substep, idle "
          f"{stats.get('idle_pct', float('nan')):.1f}%; peak allocated "
          f"{peak / 2 ** 30:.3f} GiB ({(peak - base) / 2 ** 30:.3f} GiB "
          f"above the {base / 2 ** 30:.3f} GiB held before); phase 10 took "
          f"{time.perf_counter() - t_phase:.1f} s")
    return ms_sub, launches


def cli_argv(cap, model_path, n_cams: int, n_frames: int, iterations: int,
             extra=()) -> list:
    """The stage-2 CLI's flags for the capture under ``cap``: its last
    camera held out, every frame in both windows."""
    return ["--dataset_dir", f"{cap}/dataset", "--trained_model_path",
            f"{cap}/tracked", "--uv_path", f"{cap}/tracked/uv.obj",
            "--model_path", str(model_path), "--test_camera_index",
            str(n_cams - 1), "--train_frame_start_num", "0", str(n_frames),
            "--test_frame_start_num", "0", str(n_frames), "--iterations",
            str(iterations), *extra]


def run_cli(device, argv, step_ms=None, view_ms=None, patch=None) -> dict:
    """The stage-2 CLI's loop (train/train_appearance.py::train) on
    ``device``; its log.  Given lists, each step's and each test view's
    host ms (between synchronizes) are appended; ``patch`` replaces
    segment_composite_gather."""
    import contextlib
    from unittest import mock
    import torch
    from mpmavatar_tpu_torch.render import rasterizer
    from mpmavatar_tpu_torch.train import train_appearance as tcli
    real_step, real_eval = tcli.make_train_step, tcli.evaluate_appearance

    def make_train_step(*a, **k):
        step = real_step(*a, **k)

        def timed(*args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = step(*args)
            torch.cuda.synchronize()
            step_ms.append(1e3 * (time.perf_counter() - t0))
            return out
        return timed

    def evaluate(avatar, params, ds, *a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real_eval(avatar, params, ds, *a, **k)
        torch.cuda.synchronize()
        view_ms.append(1e3 * (time.perf_counter() - t0)
                       / (len(ds.camera_list) * len(ds.frame_index)))
        return out

    with contextlib.ExitStack() as stack:
        if step_ms is not None:
            stack.enter_context(mock.patch.object(tcli, "make_train_step",
                                                  make_train_step))
        if view_ms is not None:
            stack.enter_context(mock.patch.object(
                tcli, "evaluate_appearance", evaluate))
        if patch is not None:
            stack.enter_context(mock.patch.object(
                rasterizer, "segment_composite_gather", patch))
        return tcli.train(tcli.parse_args(argv), device=device)


def random_lpips_npz(path) -> None:
    """LPIPS weights of the published shapes, seeded (the trained ones are
    not in the repository)."""
    import numpy as np
    from mpmavatar_tpu_torch.utils.lpips import expected_weight_schema
    rng = np.random.default_rng(0)
    arrays = {}
    for k, shape in expected_weight_schema().items():
        if k.startswith("lin"):
            arrays[k] = np.abs(rng.normal(0, 0.1, shape))
        elif k.endswith("_b"):
            arrays[k] = rng.normal(0, 0.05, shape)
        else:
            arrays[k] = rng.normal(0, 0.3 / np.sqrt(shape[1] * 9), shape)
    np.savez(path, **{k: v.astype(np.float32) for k, v in arrays.items()})


def stage24_path(dev, smi, work) -> tuple:
    """Phase 11, the stage-2 and stage-4 tools, in the git-ignored
    directory ``work`` (the caller removes it; phase 13 tracks its
    capture).  Returns (steady ms per CLI step, the CLI run's
    launches)."""
    import numpy as np
    import torch
    from mpmavatar_tpu_torch.data import OptimizationParams, Scene
    from mpmavatar_tpu_torch.data import make_synthetic_actorshq as synth
    from mpmavatar_tpu_torch.ops import _build
    from mpmavatar_tpu_torch.ops import composite as kcomp
    from mpmavatar_tpu_torch.render import camera_arrays
    from mpmavatar_tpu_torch.render import avatar_model as am
    from mpmavatar_tpu_torch.render.ao import bake_ao, load_uv_chart
    from mpmavatar_tpu_torch.train import appearance as tapp
    from mpmavatar_tpu_torch.train import eval_metrics
    from mpmavatar_tpu_torch.train import evaluate as teval
    from mpmavatar_tpu_torch.train import train_appearance as tcli
    from mpmavatar_tpu_torch.utils.io import write_obj

    t_phase = time.perf_counter()
    # (a) the capture
    cap = work / "capture"
    t0 = time.perf_counter()
    summary = synth.make_capture(str(cap), device=dev)
    n_cams, n_frames = summary["n_cams"], summary["n_frames"]
    width, height = summary["wh"]
    n_faces = summary["n_faces"]
    test_cam = n_cams - 1
    tracked, uv = cap / "tracked", str(cap / "tracked" / "uv.obj")
    print(f"capture: the synthetic capture ({n_cams} cameras x {n_frames} "
          f"frames, {width}x{height}, {n_faces} faces; the teacher's "
          f"renders up to {summary['max_items']} phase-2 items of "
          f"{synth.WORK_CAP}, no overflow) in {time.perf_counter() - t0:.2f} "
          f"s")
    if n_faces != 50244 or (width, height) != (1500, 1000):
        raise AssertionError(f"capture: {n_faces} faces at {width}x{height}")

    # (b) the stage-2 CLI: counted launches, timed steps and test views
    extra = ["--work_cap", str(synth.WORK_CAP), "--preload_device",
             "--test_iterations", "1", str(CLI_ITERS),
             "--densify_from_iter", "0", "--densification_interval",
             str(CLI_DENSIFY), "--densify_until_iter", str(CLI_DENSIFY + 1),
             "--densify_grad_threshold", str(CLI_GRAD_THRESHOLD)]
    argv = cli_argv(cap, work / "model", n_cams, n_frames, CLI_ITERS, extra)
    step_ms, view_ms = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    log = run_cli(dev, argv, step_ms, view_ms)
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    launches = _build.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    avatar, params = log["avatar"], log["params"]
    cap_slots = params.splats.capacity
    want = {kcomp.KERNEL: 2 * CLI_ITERS, kcomp.KERNEL_BWD: 2 * CLI_ITERS}
    if launches != want:
        raise AssertionError(f"stage-2 CLI: launches {launches}, expected "
                             f"{want} (the test views' tile path launches "
                             f"none)")
    if not np.isfinite(log["loss"]).all():
        raise AssertionError(f"stage-2 CLI: losses {log['loss']}")
    if log["big_overflow"] or log["work_overflow"]:
        raise AssertionError(f"stage-2 CLI: overflow big "
                             f"{log['big_overflow']} work "
                             f"{log['work_overflow']}")
    alive = params.splats.alive
    per_face = torch.bincount(params.splats.binding[alive],
                              minlength=n_faces)
    dens = log["densify"]
    if [d["iter"] for d in dens] != [CLI_DENSIFY] or \
            dens[0]["alive"] == n_faces or int(per_face.min()) < 1:
        raise AssertionError(f"stage-2 CLI: densification {dens}, fewest "
                             f"alive on a face {int(per_face.min())}")
    first, last = log["tests"]
    steady = step_ms[CLI_WARM:]
    ms_step = statistics.median(steady)
    print(f"stage-2 CLI ({CLI_ITERS} iterations, {cap_slots} splat slots, "
          f"work_cap {synth.WORK_CAP}, --preload_device, test camera "
          f"{test_cam}): launches {launches}; ms/step median {ms_step:.4f} "
          f"(range {min(steady):.4f}-{max(steady):.4f}, steps "
          f"{CLI_WARM + 1}-{CLI_ITERS}; the first two "
          f"{[round(v, 3) for v in step_ms[:CLI_WARM]]}); ms per test view "
          f"{[round(v, 3) for v in view_ms]} (the tile path); the loop "
          f"{cli_s:.2f} s; peak allocated {peak / 2 ** 30:.3f} GiB; "
          f"densification at iteration {CLI_DENSIFY}: alive {n_faces} -> "
          f"{dens[0]['alive']}, fewest alive on a face "
          f"{int(per_face.min())}; zero overflow")
    print(f"stage-2 CLI: L1 per step {[round(v, 5) for v in log['l1']]}; "
          f"held-out after step 1: L1 {first['l1']:.6f} PSNR "
          f"{first['psnr']:.4f}; after step {CLI_ITERS}: L1 "
          f"{last['l1']:.6f} PSNR {last['psnr']:.4f}")
    wrong = run_cli(dev, cli_argv(cap, work / "model_wrong", n_cams,
                                  n_frames, CLI_ITERS, extra),
                    patch=wrong_k7("no_colour"))
    gain = last["psnr"] - first["psnr"]
    w_first, w_last = wrong["tests"]
    gain_w = w_last["psnr"] - w_first["psnr"]
    print(f"stage-2 CLI: held-out PSNR gain {gain:.4f} dB, L1 "
          f"{first['l1'] - last['l1']:.6f} lower; wrong path (K7 with its "
          f"colour rows zeroed): PSNR gain {gain_w:.4f} dB")
    if not (gain > max(gain_w, 0.0) and last["l1"] < first["l1"]):
        raise AssertionError(f"stage-2 CLI: the held-out PSNR rose by "
                             f"{gain:.4f} dB, not beyond the wrong path's "
                             f"{gain_w:.4f}, or the L1 did not fall")

    # (c) the checkpoint: reloaded into a fresh avatar, one test view
    scene = Scene(tcli.extract_dataclass(tcli.parse_args(argv),
                                         tcli.ModelParams))
    avatar2, gray = am.load_mesh_avatar(str(tracked), uv, device=dev)
    loaded = am.load_avatar_checkpoint(log["checkpoints"][-1], gray)
    batch = scene.test_dataset.load_frame(0, 0)
    t_view = batch["frame_idx"]
    bg = torch.zeros(3, device=dev)

    @torch.no_grad()
    def view(av, p, sh=1):
        img, _ = tapp.render_avatar_frame(
            av, p, av.select_verts(p, t_view),
            av.tensor("ao_maps", dev)[t_view], batch["cam"], test_cam, sh,
            bg, False)
        return img

    a, b = view(avatar2, loaded), view(avatar, params)
    err = float((a - b).abs().max()) / float(b.abs().max())
    n_alive = int(loaded.splats.alive.sum())
    print(f"checkpoint {Path(log['checkpoints'][-1]).name}: {n_alive} "
          f"splats reloaded into a fresh avatar; its test view against the "
          f"trained avatar's: max |diff| / max = {err:.3e} (tol "
          f"{CKPT_TOL:.0e})")
    if not (err <= CKPT_TOL and n_alive == int(alive.sum())):
        raise AssertionError("checkpoint: the reloaded avatar renders "
                             "otherwise")

    # the host's ms per sample, with and without the device cache, and a
    # profile of a few steps at the CLI's shape
    ds = scene.train_dataset
    rng = np.random.default_rng(0)

    def per_sample(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(SAMPLE_REPS):
            fn()
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / SAMPLE_REPS

    plain_ms = per_sample(lambda: tcli.sample_batch(ds, rng, dev))
    cached = tcli.DeviceCachedDataset(ds, dev)
    for _ in range(300):
        cached.sample(rng)
    cached_ms = per_sample(lambda: cached.sample(rng))
    opt = OptimizationParams()
    step = tapp.make_train_step(
        avatar, opt, tapp.make_optimizer(opt, ds.scene_radius, params), 1,
        False, tile_capacity=512, work_cap=synth.WORK_CAP)
    b2 = cached.sample(rng)
    args = (b2["frame_idx"], b2["camera_idx"], camera_arrays(b2["cam"], dev),
            b2["rgb"], b2["msk"], avatar.tensor("ao_maps", dev)[
                b2["frame_idx"]], width, height)
    busy_s, prof_wall, rows = profile_device(
        lambda: [step(params, *args) for _ in range(CLI_PROFILE_STEPS)])
    (OUT / "chip_smoke_profile_stage2_cli.txt").write_text(
        "\n".join(f"{us:12.1f} us {calls:6d}x  {key}"
                  for key, us, calls in rows))
    print(f"stage-2 CLI: host ms per sample {plain_ms:.3f} (decode + copy "
          f"to the card) vs {cached_ms:.4f} with --preload_device; "
          f"{CLI_PROFILE_STEPS} profiled steps: device busy "
          f"{1e3 * busy_s / CLI_PROFILE_STEPS:.3f} ms/step of "
          f"{1e3 * prof_wall / CLI_PROFILE_STEPS:.3f}, idle "
          f"{100 * (1 - busy_s / prof_wall):.1f}%; top: "
          + "; ".join(f"{key[:60]} {us / 1e3:.3f} ms x{calls}"
                      for key, us, calls in rows[:6]))

    # (d) stage 4: the capture's tracked meshes, AO baked at 256^2, the
    # held-out camera rendered with the gray start and with the checkpoint
    faces = avatar2.tensor("faces", dev)
    verts = [np.load(tracked / f"params_{t}.npz")["vertices"]
             for t in range(n_frames)]
    chart = load_uv_chart(uv, resolution=256)
    vt = [torch.as_tensor(v, device=dev) for v in verts]
    bake_ao(vt[0], faces, chart.face_idx, chart.bary, chart.texel_ij)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    bake_ms = [timed_ms(lambda v=v: bake_ao(
        v, faces, chart.face_idx, chart.bary, chart.texel_ij), reps=1)
        for v in vt]
    bake_peak = torch.cuda.max_memory_allocated() - base
    aos = [bake_ao(v, faces, chart.face_idx, chart.bary, chart.texel_ij)
           for v in vt]

    @torch.no_grad()
    def frame(v, ao):
        img, _ = tapp.render_avatar_frame(avatar2, loaded, v, ao,
                                          batch["cam"], test_cam, 3, bg,
                                          False)
        return img

    render_ms = [timed_ms(lambda v=v, ao=ao: frame(v, ao))
                 for v, ao in zip(vt, aos)]
    trees = {}
    for name, p in (("gray", gray), ("final", loaded)):
        out = work / f"eval_{name}"
        (out / "uvmesh").mkdir(parents=True)
        for i, v in enumerate(verts):
            write_obj(str(out / "uvmesh" / f"{i:03d}.obj"), v,
                      avatar2.faces)
        t0 = time.perf_counter()
        teval.render_eval_sequence(avatar2, p, scene, str(out / "uvmesh"),
                                   str(out), uv, active_sh_degree=3,
                                   skip_video=name == "gray")
        trees[name] = (out, time.perf_counter() - t0)
    names = sorted(q.name for q in trees["final"][0].iterdir())
    if names != sorted(["aomap", "uvmesh", f"Cam{test_cam:03d}"]):
        raise AssertionError(f"stage 4: the tree holds {names}")
    chart_c = load_uv_chart(uv, resolution=AO_CUT)
    t0 = time.perf_counter()
    ao_cpu = bake_ao(torch.as_tensor(verts[0]), avatar2.faces,
                     chart_c.face_idx, chart_c.bary, chart_c.texel_ij,
                     resolution=AO_CUT)
    cpu_s = time.perf_counter() - t0
    ao_card = bake_ao(vt[0], faces, chart_c.face_idx, chart_c.bary,
                      chart_c.texel_ij, resolution=AO_CUT)
    ao_err = float((ao_card.cpu() - ao_cpu).abs().max())
    print(f"stage 4 ({n_frames} frames, AO 256^2 over "
          f"{len(chart.face_idx)} texel entries, camera {test_cam}): bake "
          f"ms per frame {[round(v, 3) for v in bake_ms]}, peak "
          f"{bake_peak / 2 ** 30:.3f} GiB above the "
          f"{base / 2 ** 30:.3f} GiB held; render ms per frame (tile path) "
          f"{[round(v, 3) for v in render_ms]}; render_eval_sequence "
          f"{trees['gray'][1]:.2f} s (gray start), {trees['final'][1]:.2f} "
          f"s (checkpoint, with the video step); the bake at {AO_CUT}^2 on "
          f"the card against the CPU ({cpu_s:.2f} s there): max |diff| "
          f"{ao_err:.3e} (tol {AO_TOL:.0e})")
    if not ao_err <= AO_TOL:
        raise AssertionError("stage 4: the bake on the card disagrees with "
                             "the CPU")

    # the CLI at a cut size on the card against the CPU
    cut = work / "cut"
    synth.make_capture(str(cut), device="cpu", **CUT)
    runs = {}
    for d in (dev, "cpu"):
        runs[str(d)] = run_cli(d, cli_argv(
            cut, work / f"cut_{torch.device(d).type}", CUT["n_cams"],
            CUT["n_frames"], CUT_ITERS,
            ["--work_cap", str(CUT["work_cap"]), "--test_iterations", "1",
             str(CUT_ITERS)]))
    card, cpu = runs[str(dev)], runs["cpu"]
    errs = [abs(x - y) / abs(y) for x, y in zip(card["loss"], cpu["loss"])]
    for ta, tb in zip(card["tests"], cpu["tests"]):
        errs += [abs(ta[k] - tb[k]) / abs(tb[k]) for k in ("l1", "psnr")]
    print(f"stage-2 CLI at {CUT['width']}x{CUT['height']} (mesh "
          f"{CUT['mesh'][0]}x{CUT['mesh'][1]}, {CUT_ITERS} iterations) on "
          f"the card against the CPU: losses {card['loss']} vs "
          f"{cpu['loss']}, tests {card['tests']} vs {cpu['tests']}; max "
          f"rel err {max(errs):.3e} (tol {CUT_TOL:.0e})")
    if not max(errs) <= CUT_TOL:
        raise AssertionError("the cut-size CLI on the card disagrees with "
                             "the CPU")

    # (e) the metrics CLI over both trees, seeded LPIPS weights
    weights = work / "lpips_random.npz"
    random_lpips_npz(weights)
    scores = {}
    for name, (out, _) in trees.items():
        t0 = time.perf_counter()
        eval_metrics.main([
            "--output_path", str(out), "--mesh_path", uv, "--data_path",
            str(cap / "dataset" / "ActorsHQ" / "Actor01" / "Sequence1" /
                "4x"), "--start_idx", "0", "--num_timesteps", str(n_frames),
            "--cameras", f"Cam{test_cam:03d}", "--lpips_weights",
            str(weights), "--device", dev.type])
        host_s = time.perf_counter() - t0
        m = {k: np.asarray(v) for f in ("geo_metric.npz", "app_metric.npz")
             for k, v in np.load(out / f).items()}
        scores[name] = m
        print(f"metrics CLI ({name}): "
              + ", ".join(f"{k} {float(v.mean()):.6f}"
                          for k, v in m.items())
              + f"; {host_s:.2f} s on the host")
        if sorted(m) != ["CD", "F-Score", "LPIPS", "PSNR", "SSIM"] or \
                not all(np.isfinite(v).all() for v in m.values()):
            raise AssertionError(f"metrics CLI ({name}): {m}")
    if not scores["final"]["PSNR"].mean() > scores["gray"]["PSNR"].mean():
        raise AssertionError("metrics CLI: the checkpoint's PSNR is not "
                             "above the gray start's")
    print(f"phase 11 took {time.perf_counter() - t_phase:.1f} s on {smi}")
    return ms_step, launches


def chair_depth(points, lo, hi):
    """(N,) how deep each point lies inside the box [lo, hi] (0 outside)."""
    import numpy as np
    d = np.minimum(points - lo, hi - points)
    return np.where((d > 0).all(1), d.min(1), 0.0)


def demo_gaussians(avatar, params, verts, sand, chair, cam):
    """(means2d, depth, conic, opacity) of every gaussian that
    ``render_demo_frame`` draws (the avatar, the sand, the chair), as
    the rasterizer projects them for ``cam``."""
    import torch
    from mpmavatar_tpu_torch.render import camera_arrays
    from mpmavatar_tpu_torch.render import gaussians as G
    from mpmavatar_tpu_torch.render.geometry import \
        covariance_from_scaling_rotation
    from mpmavatar_tpu_torch.render.rasterizer import project_gaussians
    from mpmavatar_tpu_torch.train import demo as tdemo
    frames = avatar.frames_for_verts(verts)
    xyz = [G.get_xyz(params.splats, frames)]
    cov = [G.get_covariance(params.splats, frames)]
    op = [G.get_opacity(params.splats)[:, 0] * params.splats.alive]
    n = sand.shape[0]
    rot = torch.zeros((n, 4), device=sand.device)
    rot[:, 0] = 1.0
    xyz.append(sand)
    cov.append(covariance_from_scaling_rotation(
        torch.full((n, 3), tdemo.SAND_SCALE, device=sand.device), 1.0, rot))
    op.append(torch.ones(n, device=sand.device))
    xyz.append(chair["xyz"])
    cov.append(covariance_from_scaling_rotation(chair["scale"], 1.0,
                                                chair["rotation"]))
    op.append(chair["opacity"].reshape(-1))
    ca = camera_arrays(cam, verts.device)
    m2d, depth, conic, _, vis = project_gaussians(
        torch.cat(xyz), torch.cat(cov), ca, cam.image_width,
        cam.image_height)
    return m2d, depth, conic, torch.cat(op) * vis


def _pixel_alpha(m2d, conic, opacity, chunk):
    """(K, N) each gaussian's alpha at the (x, y) pixels ``chunk``."""
    import torch
    dx = chunk[:, :1].float() - m2d[None, :, 0]
    dy = chunk[:, 1:].float() - m2d[None, :, 1]
    power = -0.5 * (conic[:, 0] * dx * dx + conic[:, 2] * dy * dy) \
        - conic[:, 1] * dx * dy
    return opacity * torch.exp(torch.clamp_max(power, 0.0))


def near_cutoff(m2d, conic, opacity, pixels, rel=CUTOFF_BAND):
    """(K,) bool: whether some gaussian's alpha at each (x, y) pixel of
    ``pixels`` (K, 2) lies within ``rel`` (relative) of the 1/255
    cutoff."""
    import torch
    out = [((_pixel_alpha(m2d, conic, opacity, chunk) - 1.0 / 255.0).abs()
            < rel / 255.0).any(dim=1) for chunk in pixels.split(256)]
    return torch.cat(out) if out else torch.zeros(0, dtype=torch.bool)


def depth_gap(m2d, depth, conic, opacity, pixels):
    """(K,) the smallest relative depth gap between two gaussians that
    cover each (x, y) pixel of ``pixels`` (alpha at or above the 1/255
    cutoff; inf with fewer than two), and (K,) how many cover it."""
    import torch
    gaps, counts = [], []
    for chunk in pixels.split(256):
        cover = _pixel_alpha(m2d, conic, opacity, chunk) >= 1.0 / 255.0
        for row in cover:
            d = depth[row].sort().values
            gap = (d[1:] - d[:-1]) / d[1:].abs().clamp_min(1e-12)
            gaps.append(float(gap.min()) if gap.numel() else float("inf"))
            counts.append(int(row.sum()))
    return torch.tensor(gaps, dtype=torch.float64), torch.tensor(counts)


def demo_path(dev, smi, kchecks, per_sub) -> tuple:
    """Phase 12, the zero-shot demo, in a git-ignored directory removed
    afterwards.  ``kchecks`` holds phase 4's K2, K4 and K8 checks.
    Returns (steady ms per substep, the run's launches)."""
    import shutil
    work = REPO / "output" / "chip_smoke_demo"
    shutil.rmtree(work, ignore_errors=True)
    try:
        return _demo(dev, smi, kchecks, per_sub, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)


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


def _demo(dev, smi, kchecks, per_sub, work) -> tuple:
    import numpy as np
    import torch
    from mpmavatar_tpu_torch.core import stepping
    from mpmavatar_tpu_torch.data import make_demo_assets as mda
    from mpmavatar_tpu_torch.ops import _build
    from mpmavatar_tpu_torch.render.ao import bake_ao, load_uv_chart
    from mpmavatar_tpu_torch.render.avatar_model import load_mesh_avatar
    from mpmavatar_tpu_torch.render.cameras import Camera
    from mpmavatar_tpu_torch.sim import SimTransform
    from mpmavatar_tpu_torch.train import demo as tdemo
    from mpmavatar_tpu_torch.train import run_demo
    from mpmavatar_tpu_torch.utils.io import read_obj

    t_phase = time.perf_counter()
    assets = work / "assets"
    t0 = time.perf_counter()
    mda.main(["--out", str(assets), "--n_poses", str(DEMO_POSES)])
    print(f"demo: make_demo_assets ({DEMO_POSES} poses) in "
          f"{time.perf_counter() - t0:.2f} s")
    a = lambda name: str(assets / name)
    out = work / "out"
    flags = ["--cloth_obj", a("cloth.obj"), "--body_obj", a("body.obj"),
             "--chair_obj", a("chair.obj"), "--chair_gs", a("chair_gs.npz"),
             "--smplx_model_npz", a("smplx_model.npz"),
             "--first_smplx_npz", a("first_smplx.npz"),
             "--pose_npz", a("pose_seq.npz"), "--extra_frames",
             str(DEMO_EXTRA),
             "--grid_size", str(DEMO_GRID), "--substep", str(DEMO_SUBSTEPS),
             "--sand_release_frame", str(DEMO_RELEASE), "--avatar_dir",
             a("tracked"), "--uv_path", a("uv.obj"), "--skip_video",
             "--out_dir", str(out), "--device", str(dev)]

    # (a) the CLI, its launches counted over the whole run
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    _build.reset_launch_counts()
    res = run_demo.main(flags, log=lambda line: print(f"  run_demo: {line}"))
    torch.cuda.synchronize()
    launches = _build.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    cfg, solver, state = res["cfg"], res["solver"], res["state"]
    model, dt, t_end = res["model"], res["dt"], res["time"]
    frames = len(res["frame_s"])
    n_sub = frames * DEMO_SUBSTEPS
    want = {k: per * n_sub for k, per in per_sub.items()}
    if frames != DEMO_POSES + DEMO_EXTRA or launches != want:
        raise AssertionError(f"demo: {frames} frames, launches {launches}, "
                             f"expected {want}")
    ms_sub = 1e3 * res["frame_s"][-1] / DEMO_SUBSTEPS
    e, n_t = cfg.n_elements, cfg.n_traditional
    print(f"demo: P={cfg.n_particles} ({e} elements, {n_t} sand, "
          f"{cfg.n_vertices} vertices), {DEMO_GRID}^3, {frames} x "
          f"{DEMO_SUBSTEPS} substeps (dt {dt:.2e}), "
          f"{len(solver.colliders.mesh_colliders[0].faces)} collider faces "
          f"(the posed rig and the chair), no pinned vertex; launches "
          f"{launches}; frame wall times "
          f"{[round(s, 4) for s in res['frame_s']]} s, steady "
          f"{ms_sub:.4f} ms/substep; stages: pose playback "
          f"{res['playback']:.2f} s, build and release masks "
          f"{res['build']:.2f} s, simulation with OBJs {res['sim']:.2f} s, "
          f"bakes and orbit renders {res['render']:.2f} s; peak "
          f"{(peak - held) / 2 ** 30:.3f} GiB above the "
          f"{held / 2 ** 30:.3f} GiB held before")

    # (b) the release under the JAX package's semantics
    sand = slice(e, e + n_t)
    mods = solver.colliders.velocity_modifiers
    t0_rel = DEMO_RELEASE / run_demo.FPS
    dead = sum(float(m.end_time) <= t0_rel for m in mods)
    held_sand = sum(int(m.mask[sand].sum()) for m in mods)
    held_cloth = int(mods[0].mask.sum()) - int(mods[0].mask[sand].sum())
    t_live = (DEMO_RELEASE + 0.5) / run_demo.FPS
    live = [m for m in mods
            if float(m.start_time) <= t_live < float(m.end_time)]
    sel = torch.zeros(cfg.n_particles, dtype=torch.bool, device=dev)
    for m in live:
        sel |= m.mask == 1
    v_mod = stepping._pre_p2g_velocity(solver.colliders, state, dt, t_live)
    still = float(v_mod[sel].abs().max()) if bool(sel.any()) else 0.0
    untouched = bool(torch.equal(v_mod[~sel], state.v[~sel]))
    # the fall over frame FALL_FRAME from the sand's OBJs: after its first
    # substep every grain falls as v_n = -g n dt, x_n = x_(n-1) + dt v_n
    tf = SimTransform.from_verts(read_obj(a("cloth.obj"))[0])
    sand_y = lambda i: tf.scale * torch.as_tensor(read_obj(str(
        out / "sand" / f"{i:03d}.obj"))[0][:, 1])
    n0, n1 = FALL_FRAME * DEMO_SUBSTEPS, (FALL_FRAME + 1) * DEMO_SUBSTEPS
    expect = -9.8 * dt * dt * (n1 * (n1 + 1) - n0 * (n0 + 1)) / 2
    drop = sand_y(FALL_FRAME) - sand_y(FALL_FRAME - 1)
    median = float(drop.median())
    off = int(((drop - expect).abs() > FALL_REL_TOL * abs(expect)).sum())
    # the last frame: the sand in the grid, some of it on the body's top
    vy = state.v[sand, 1]
    fall = -9.8 * t_end
    slowed = int((vy > fall * (1 - FALL_REL_TOL)).sum())
    y_last = state.x[sand, 1]
    y_before = sand_y(frames - 2) + float(tf.shift[1])
    # the modifiers' share: PROFILE_SUBSTEPS substeps with and without
    # them, from the same state, in turns
    with_mods = solver.colliders
    without = dataclasses.replace(with_mods, velocity_modifiers=())
    run_n = lambda: solver.frame(state, model, dt, PROFILE_SUBSTEPS, t_end,
                                 **res["inputs"])
    walls = {True: [], False: []}
    for mods_on in (True, False, False, True):
        solver.colliders = with_mods if mods_on else without
        walls[mods_on].append(timed_ms(run_n, reps=1) / PROFILE_SUBSTEPS)
    solver.colliders = with_mods
    mod_ms = min(walls[True]) - min(walls[False])
    default_frames = 30 + 130
    default_end = 100 / run_demo.FPS + (default_frames - 100) / run_demo.FPS
    default_dead = sum(default_end / len(mods) * (i + 1) <= 100 / run_demo.FPS
                       for i in range(len(mods)))
    print(f"demo release: {len(mods)} windows from t = {t0_rel:.3f} s, "
          f"{dead} of them closing before they open ({default_dead} of 50 "
          f"under the defaults' 160 frames); the windows hold {held_sand} "
          f"sand particles (the block starts above the grid's top) and the "
          f"largest {held_cloth} cloth particles in the sand's z range; at "
          f"t = {t_live:.3f} s {len(live)} windows are live over "
          f"{int(sel.sum())} particles, |v| after the modifier "
          f"{still:.3e} (limit {RELEASE_STILL:.0e}), the others untouched "
          f"{untouched}; over frame {FALL_FRAME} the sand's median fall "
          f"{median:.6f} against g t's {expect:.6f} (tol "
          f"{FALL_REL_TOL:.0%}), {off} of {n_t} off by more; in the last "
          f"frame the sand's sim y from [{float(y_before.min()):.4f}, "
          f"{float(y_before.max()):.4f}] to [{float(y_last.min()):.4f}, "
          f"{float(y_last.max()):.4f}], {slowed} of {n_t} grains slower "
          f"than g t by more than {FALL_REL_TOL:.0%} (the body's top); "
          f"{PROFILE_SUBSTEPS} substeps with the modifiers "
          f"{min(walls[True]):.4f} ms/substep, without "
          f"{min(walls[False]):.4f} (host clock, the best of two): the "
          f"modifiers {mod_ms:.4f} ms, {100 * mod_ms / min(walls[True]):.1f}% "
          f"of the substep")
    if not (live and bool(sel.any()) and still <= RELEASE_STILL
            and untouched):
        raise AssertionError("demo: the release windows do not hold their "
                             "particles still")
    if abs(median / expect - 1.0) > FALL_REL_TOL:
        raise AssertionError("demo: the free sand does not fall as g t")

    # (c) the collider at full width: the body slows the sand that lands
    # on it, K5's mesh branch changes the velocity of some cells, and no
    # cloth vertex that starts outside the chair's box ends deeper in it
    # than DRAPE_TOL.  Each collider face acts at its centroid (K4 splats
    # one point per face), so the 12-triangle chair can let cloth in away
    # from its 12 centroids, in the JAX package alike (tests/
    # test_torch_demo.py::test_chair_box_collides_only_near_its_face_
    # centroids): over the poses alone, with no extra frame, a vertex
    # ended 0.048 in
    changed, covered = mesh_branch_cells(solver, state, model,
                                         res["inputs"], t_end)
    chair_v, _ = read_obj(a("chair.obj"))
    lo, hi = chair_v.min(0), chair_v.max(0)
    cloth0, _ = read_obj(a("cloth.obj"))
    cloth1, _ = read_obj(str(out / "uvmesh" / f"{frames - 1:03d}.obj"))
    d0 = chair_depth(cloth0, lo, hi) * tf.scale
    d1 = chair_depth(cloth1, lo, hi) * tf.scale
    deepest = float(d1[d0 <= 0].max()) if (d0 <= 0).any() else 0.0
    print(f"demo collider: K5's mesh branch changed the velocity of "
          f"{changed} grid cells ({covered} covered by the collider "
          f"splat); the chair: {int((d0 > 0).sum())} cloth vertices start "
          f"inside its box (up to {float(d0.max()):.4f} deep, sim units), "
          f"{int((d1 > 0).sum())} end inside; of those that start outside "
          f"the deepest ends {deepest:.5f} in (phase 3's drape limit "
          f"{DRAPE_TOL:.5f})")
    if slowed == 0 or changed == 0 or deepest > DRAPE_TOL:
        raise AssertionError("demo collider: the body does not stop the "
                             "sand, K5's mesh branch changes no cell, or "
                             "the cloth ends too deep in the chair")

    # (d) the cut scene: the kernel path against the plain path on the CPU
    # beside the release schedule left out
    s_k, st_k, m_k, in_k = demo_cut_scene(dev, True)
    cpu = {"plain": demo_cut_scene("cpu", True),
           "no release": demo_cut_scene("cpu", False),
           "friction 0": demo_cut_scene("cpu", True, friction=0.0)}
    e_c = s_k.cfg.n_elements
    held_c = int(s_k.colliders.velocity_modifiers[0].mask[
        e_c:e_c + s_k.cfg.n_traditional].sum())
    g = torch.Generator(device=dev).manual_seed(3000)
    a0 = dataclasses.replace(st_k, v=st_k.v + 0.05 * torch.randn(
        st_k.v.shape, generator=g, device=dev))
    ka = s_k.frame(a0, m_k, DT, COMPARE_SUBSTEPS, 0.0, **in_k)[0]
    runs = {name: s_c.frame(a0.to("cpu"), m_c, DT, COMPARE_SUBSTEPS, 0.0,
                            **in_c)[0]
            for name, (s_c, _, m_c, in_c) in cpu.items()}
    errs = {name: {f: float((getattr(o, f).cpu()
                             - getattr(runs["plain"], f)).abs().max())
                   for f in ("x", "v")}
            for name, o in (("plain", ka), ("no release",
                                            runs["no release"]),
                            ("friction 0", runs["friction 0"]))}
    cut_changed, _ = mesh_branch_cells(s_k, ka, m_k, in_k,
                                       COMPARE_SUBSTEPS * DT)
    print(f"demo cut scene ({DEMO_CUT['skirt'][0]}x{DEMO_CUT['skirt'][1]} "
          f"skirt, {s_k.cfg.n_traditional} sand of which {held_c} held, "
          f"{DEMO_CUT['grid']}^3, {COMPARE_SUBSTEPS} substeps): kernel path "
          f"against the plain path x {errs['plain']['x']:.3e}, v "
          f"{errs['plain']['v']:.3e} (tol x {PATH_ATOL['x']:.0e}, v "
          f"{PATH_ATOL['v']:.0e}); wrong paths: the release left out x "
          f"{errs['no release']['x']:.3e}, v {errs['no release']['v']:.3e}; "
          f"collider friction 0 x {errs['friction 0']['x']:.3e}, v "
          f"{errs['friction 0']['v']:.3e}; K5's mesh branch then changes "
          f"{cut_changed} cells (the body against the skirt)")
    for f, tol in PATH_ATOL.items():
        if not errs["plain"][f] <= tol:
            raise AssertionError(f"demo cut scene: the kernel path disagrees "
                                 f"with the plain path in {f}")
    if not min(errs["no release"]["v"], errs["friction 0"]["v"]) > \
            PATH_ATOL["v"] or held_c == 0 or cut_changed <= 0:
        raise AssertionError("demo cut scene: not in contact, or the v "
                             "limit does not separate a wrong path")

    # (e) K2, K4 and K8 at the demo's shapes, from its final state
    _, _, _, stress_d, vf_d = stepping.compute_stress(cfg, state, model, dt)
    stress_d = torch.cat([stress_d[:e], state.vol[
        e:cfg.n_no_vertices, None, None] * stress_d[e:]])
    kchecks["p2g"](f"p2g (the demo's {cfg.n_particles} particles, "
                   f"{DEMO_GRID}^3)",
                   (state.x, state.v, state.C, state.mass,
                    (state.selection == 0).float(), dt * stress_d, dt * vf_d,
                    DEMO_GRID, cfg.inv_dx, cfg.dx), launches)
    pts, vals = stepping.mesh_face_values(
        solver.colliders.mesh_colliders[0], res["inputs"]["mesh_x"],
        res["inputs"]["mesh_v"])
    kchecks["splat"](f"splat (the demo's {len(pts)} rig and chair faces, "
                     f"{DEMO_GRID}^3)", pts, vals, DEMO_GRID, True,
                     launches_of=launches)
    kchecks["sand"](f"sand_stress (the demo's {n_t} sand particles)",
                    (state.F_trial, state.F,
                     (state.selection[sand] == 0).float(), model.mu[sand],
                     model.lam[sand], model.alpha), launches_of=launches)

    # (f) the orbit: every frame of the run without overflow; ORBIT_CHECKS
    # frames again with and without the sand, and at ORBIT_CUT^2 on the
    # card against the CPU
    orbit = res["orbit"]
    if len(orbit) != frames or any(r["big_overflow"] for r in orbit):
        raise AssertionError(f"demo orbit: {orbit}")
    bake_ms = [1e3 * r["bake_s"] for r in orbit]
    frame_ms = [1e3 * r["render_s"] for r in orbit]
    avatar, params = load_mesh_avatar(a("tracked"), a("uv.obj"), device=dev)
    avatar_c, params_c = load_mesh_avatar(a("tracked"), a("uv.obj"),
                                          device="cpu")
    chair, shs = tdemo.load_chair_gaussians(a("chair_gs.npz"), dev)
    chair_c, shs_c = tdemo.load_chair_gaussians(a("chair_gs.npz"), "cpu")
    chart = load_uv_chart(a("uv.obj"), resolution=256)
    faces = avatar.tensor("faces", dev)
    cams = {}
    for size in (1024, ORBIT_CUT):
        f = 1000.0 * size / 1024
        k = np.array([[f, 0, size / 2], [0, f, size / 2], [0, 0, 1]])
        cams[size] = tdemo.get_spherical_cam(
            Camera.from_kw2c("ref", size, size, k, np.eye(4)), frames)
    for i in sorted({0, frames - 1})[:ORBIT_CHECKS]:
        verts = torch.as_tensor(read_obj(str(out / "uvmesh" /
                                             f"{i:03d}.obj"))[0], device=dev)
        sand_x = torch.as_tensor(read_obj(str(out / "sand" /
                                              f"{i:03d}.obj"))[0], device=dev)
        ao = bake_ao(verts, faces, chart.face_idx, chart.bary, chart.texel_ij)
        img, o1 = tdemo.render_demo_frame(avatar, params, verts, ao,
                                          cams[1024][i], 0, sand_xyz=sand_x,
                                          chair=chair, chair_shs=shs)
        bare, o2 = tdemo.render_demo_frame(avatar, params, verts, ao,
                                           cams[1024][i], 0, chair=chair,
                                           chair_shs=shs)
        sand_diff = float((img - bare).abs().max())
        cut = cams[ORBIT_CUT][i]
        img_k, ok_ = tdemo.render_demo_frame(avatar, params, verts, ao, cut,
                                             0, sand_xyz=sand_x, chair=chair,
                                             chair_shs=shs)
        img_c, oc_ = tdemo.render_demo_frame(
            avatar_c, params_c, verts.cpu(), ao.cpu(), cut, 0,
            sand_xyz=sand_x.cpu(), chair=chair_c, chair_shs=shs_c)
        diff = (img_k.cpu() - img_c).abs().amax(0)
        bad = torch.nonzero(diff > FRAME_TOL)
        m2d, depth, conic, opac = demo_gaussians(avatar, params, verts,
                                                 sand_x, chair, cut)
        px = bad[:, [1, 0]].to(dev)
        cutoff_tie = near_cutoff(m2d, conic, opac, px).cpu()
        gaps, n_cover = depth_gap(m2d, depth, conic, opac, px)
        depth_tie = gaps <= DEPTH_BAND
        tied = cutoff_tie | depth_tie
        kept = diff[diff <= FRAME_TOL]
        overflow = sum(int(o["big_overflow"]) for o in (o1, o2, ok_, oc_))
        print(f"demo orbit frame {i}: 1024^2 with the sand against without "
              f"it, max diff {sand_diff:.4f}; at {ORBIT_CUT}^2 card against "
              f"CPU: {len(bad)} of {ORBIT_CUT ** 2} pixels over "
              f"{FRAME_TOL:.0e}, {int(cutoff_tie.sum())} of them by an "
              f"alpha within {CUTOFF_BAND:g} of the cutoff, "
              f"{int((depth_tie & ~cutoff_tie).sum())} more by two covering "
              f"splats within {DEPTH_BAND:g} in depth, the rest within "
              f"{float(kept.max()):.3e}; overflow {overflow}; the most "
              f"splats in one tile {int(oc_['tile_counts'].max())} (card "
              f"{int(ok_['tile_counts'].max())}; the tile path composites "
              f"the first 512)")
        for (y, x), g, n, c in list(zip(bad.tolist(), gaps.tolist(),
                                        n_cover.tolist(),
                                        cutoff_tie.tolist()))[:20]:
            print(f"  pixel ({x}, {y}): diff {float(diff[y, x]):.3e}, "
                  f"{n} covering splats, the smallest depth gap {g:.3e}, "
                  f"an alpha at the cutoff {c}")
        if sand_diff <= 0.01 or overflow or not bool(tied.all()) or \
                len(bad) > 0.01 * ORBIT_CUT ** 2:
            raise AssertionError(f"demo orbit frame {i} fails its checks")
    print(f"demo orbit: per frame AO bake "
          f"{[round(x, 2) for x in bake_ms]} ms, render and PNG data "
          f"{[round(x, 2) for x in frame_ms]} ms at 1024^2 "
          f"({len(orbit)} frames, no overflow)")

    # (g) a profile of PROFILE_SUBSTEPS more substeps
    n = PROFILE_SUBSTEPS
    busy_s, prof_wall, rows = profile_device(
        lambda: solver.frame(state, model, dt, n, t_end, **res["inputs"]))
    (OUT / "chip_smoke_profile_demo.txt").write_text("\n".join(
        f"{us:12.1f} us {calls:6d}x  {key}" for key, us, calls in rows) + "\n")
    if rows:
        idle = 100 * max(0.0, 1 - busy_s / n / (ms_sub * 1e-3))
        kernels = sum(r[2] for r in rows) / n
        print(f"demo profile of {n} substeps: device busy "
              f"{1e3 * busy_s / n:.4f} ms/substep in {kernels:.1f} "
              f"kernels/substep ({sum(per_sub.values())} of them the "
              f"port's), "
              f"{1e3 * prof_wall / n:.4f} ms/substep profiled wall; the "
              f"device idle {idle:.1f}% of the steady substep")
        for key, us, calls in rows[:10]:
            print(f"  {us / n:10.2f} us/substep {calls // n:4d}/substep  "
                  f"{key[:90]}")
    else:
        print("demo profile: the profiler recorded no device time; busy "
              "share not measured")
    print(f"phase 12 took {time.perf_counter() - t_phase:.1f} s on {smi}")
    return ms_sub, launches


def tracking_path(dev, smi, cap, work, check) -> tuple:
    """Phase 13, stage-1 tracking on phase 11's capture under ``cap``,
    written under ``work``; ``check`` is phase 4's kernel check.  Returns
    (steady ms per iteration, the run's launches)."""
    import contextlib
    import shutil
    from unittest import mock
    import numpy as np
    import torch
    from mpmavatar_tpu_torch.ops import _build
    from mpmavatar_tpu_torch.ops import composite as kcomp
    from mpmavatar_tpu_torch.render import rasterizer
    from mpmavatar_tpu_torch.render.avatar_model import load_mesh_avatar
    from mpmavatar_tpu_torch.train import run_tracking
    from mpmavatar_tpu_torch.train import tracking as tt

    t_phase = time.perf_counter()
    frames_dir = cap / "dataset" / "ActorsHQ" / "Actor01" / "Sequence1" / "4x"
    out = work / "tracking"
    flags = ["--dataset_dir", str(cap / "dataset"), "--template_obj",
             str(frames_dir / "meshes" / "Frame000000.obj"), "--out_dir",
             str(out), "--train_frame_start_num", "0", "2",
             "--iters_first", str(TRACK_ITERS[0]), "--iters_rest",
             str(TRACK_ITERS[1]), "--work_cap", str(TRACK_WORK_CAP),
             "--device", str(dev)]
    starts, trackers, stats = [], [], []
    real_step = tt.MeshTracker.step

    def timed_step(self, *args, **kw):
        if not trackers:
            trackers.append(self)
        starts.append(time.perf_counter())
        loss = real_step(self, *args, **kw)
        stats.append(torch.stack([self.stats["work_overflow"],
                                  self.stats["big_overflow"],
                                  self.stats["n_items"]]))
        return loss

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    _build.reset_launch_counts()
    with mock.patch.object(tt.MeshTracker, "step", timed_step):
        res = run_tracking.main(flags, log=lambda line: print(
            f"  run_tracking: {line}"))
    torch.cuda.synchronize()
    launches = _build.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    n_it = sum(TRACK_ITERS)
    want = {kcomp.KERNEL: 2 * n_it, kcomp.KERNEL_BWD: 2 * n_it}
    counts = torch.stack(stats).cpu()
    if launches != want or len(starts) != n_it:
        raise AssertionError(f"tracking: {len(starts)} iterations, launches "
                             f"{launches}, expected {want}")
    if int(counts[:, :2].sum()):
        raise AssertionError("tracking: the rasterizer overflowed")
    it_ms = [1e3 * (b - a) for a, b in zip(starts[:TRACK_ITERS[0] - 1],
                                           starts[1:TRACK_ITERS[0]])]
    steady = statistics.median(it_ms[TRACK_WARM:])
    losses = res[0]
    tracker = trackers[0]
    n_faces = int(tracker.variables["faces"].shape[0])
    print(f"tracking: {n_faces} faces (one gaussian each), "
          f"{len(tracker.params['cam_m'])} cameras, "
          f"{TRACK_ITERS[0]} + {TRACK_ITERS[1]} iterations, work_cap "
          f"{TRACK_WORK_CAP} (up to {int(counts[:, 2].max())} phase-2 items, "
          f"no overflow); launches {launches}; per iteration "
          f"{steady:.4f} ms median after {TRACK_WARM} (range "
          f"{min(it_ms[TRACK_WARM:]):.4f}-{max(it_ms[TRACK_WARM:]):.4f}); "
          f"frame wall {[round(s, 2) for s in res['seconds'].values()]} s "
          f"(the images' decode included); frame 0's loss "
          f"{losses[0]:.5f} -> {losses[-1]:.5f}; peak "
          f"{(peak - held) / 2 ** 30:.3f} GiB above the "
          f"{held / 2 ** 30:.3f} GiB held")
    if n_faces != TRACK_FACES or not losses[-1] < losses[0]:
        raise AssertionError("tracking: the loss did not fall over frame 0")

    # the params files load as the avatar
    (out / "aomap").mkdir(exist_ok=True)
    for t in (0, 1):
        shutil.copy(cap / "tracked" / "aomap" / f"mesh_cloth_{t}.png",
                    out / "aomap" / f"mesh_cloth_{t}.png")
    avatar, params = load_mesh_avatar(str(out), str(cap / "tracked" /
                                                    "uv.obj"), device=dev)
    saved = np.load(out / "params_1.npz")
    if avatar.num_timesteps != 2 or len(avatar.faces) != n_faces or \
            not np.array_equal(avatar.verts_orig[1], saved["vertices"]):
        raise AssertionError("tracking: params_*.npz do not load")
    print(f"tracking: params_0.npz and params_1.npz load as a "
          f"{avatar.num_timesteps}-frame avatar of {len(avatar.faces)} "
          f"faces")

    # one iteration's gradient through K6/K7 against their plain versions
    # on the card, beside K7's output detached
    from mpmavatar_tpu_torch.data import ModelParams, Scene
    cfg_m = ModelParams(dataset_dir=str(cap / "dataset"),
                        train_frame_start_num=[0, 2])
    batch = tracker._device_batches(
        [Scene(cfg_m).train_dataset.load_frame(0, 1)])[0]

    def grads(composite=None):
        leaves = [tracker.params[k] for k in TRACK_LEAVES]
        with (mock.patch.object(rasterizer, "segment_composite_gather",
                                composite) if composite else
              contextlib.nullcontext()):
            loss, _ = tt.tracking_loss(
                tracker.params, tracker.variables, batch["ca"], batch["w"],
                batch["h"], batch["cam_id"], batch["rgb"], batch["msk"],
                None, None, tracker.prev_col, False, tracker.cfg)
            return torch.autograd.grad(loss, leaves)

    detached = lambda packed, ids, pix0, nc: kcomp.segment_composite_gather(
        packed.detach(), ids, pix0, nc)
    g_k = grads()
    g_p = grads(kcomp.segment_composite_gather_plain)
    g_w = grads(detached)
    rel = lambda g: max(float((a - b).abs().max())
                        / max(float(b.abs().max()), 1e-30)
                        for a, b in zip(g, g_p))
    per_leaf = {k: float((a - b).abs().max()) / max(float(b.abs().max()),
                                                     1e-30)
                for k, a, b in zip(TRACK_LEAVES, g_k, g_p)}
    sound, wrong = rel(g_k), rel(g_w)
    print(f"tracking gradient d(loss)/d({', '.join(TRACK_LEAVES)}) of one "
          f"iteration at {batch['w']}x{batch['h']} through "
          f"K6/K7 against their plain versions, per leaf relative to its "
          f"largest entry: "
          + ", ".join(f"{k} {v:.3e}" for k, v in per_leaf.items())
          + f" (tol {TRACK_GRAD_TOL:.0e}); K7's output detached: {wrong:.3e}")
    if not sound <= TRACK_GRAD_TOL < wrong:
        raise AssertionError("tracking: the gradient through K6/K7 "
                             "disagrees with the plain versions' or the "
                             "limit does not separate the wrong path")

    # K6 and K7 on one more iteration's own worklists and cotangents
    composite_pair(check, "tracking",
                   lambda: tracker.step(batch, None, None, False), launches)

    # a profile of one more iteration
    busy_s, prof_wall, rows = profile_device(
        lambda: tracker.step(batch, None, None, False))
    (OUT / "chip_smoke_profile_tracking.txt").write_text("\n".join(
        f"{us:12.1f} us {calls:6d}x  {key}" for key, us, calls in rows) + "\n")
    if rows:
        busy = 1e3 * busy_s
        print(f"tracking profile of one iteration: device busy "
              f"{busy:.4f} ms in {sum(r[2] for r in rows)} kernels, "
              f"{1e3 * prof_wall:.4f} ms profiled wall; against the steady "
              f"iteration busy {100 * min(1.0, busy / steady):.1f}%, idle "
              f"{100 * max(0.0, 1 - busy / steady):.1f}%")
        for key, us, calls in rows[:8]:
            print(f"  {us:10.2f} us {calls:4d}x  {key[:90]}")
    else:
        print("tracking profile: no device time recorded; busy share not "
              "measured")
    print(f"phase 13 took {time.perf_counter() - t_phase:.1f} s on {smi}")
    return steady, launches


def free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def uniform_model(model, mesh_friction):
    """The sharded path's UniformModel of a uniform MPMModel."""
    from mpmavatar_tpu_torch.parallel import UniformModel
    return UniformModel(mu=model.mu[0], lam=model.lam[0],
                        gamma=model.gamma[0], kappa=model.kappa[0],
                        friction_coeff=model.friction_coeff,
                        gravity=model.gravity, mesh_friction=mesh_friction,
                        alpha=model.alpha)


def sharded_scene(solver, state, model, scene, group, substeps,
                  with_mesh=True):
    """A bench scene's single-device set-up as the sharded frame's at
    world size 1: (frame, state, um, inputs); the collider mesh as its
    (F, 3, 3) triangles."""
    from mpmavatar_tpu_torch.parallel import (make_sharded_cloth_state,
                                              make_sharded_frame)
    cfg = solver.cfg
    col = solver.colliders.mesh_colliders[0]
    frame = make_sharded_frame(
        cfg, group, substeps, DT, num_joint_v=cfg.num_joint_v,
        grid_post=solver.colliders.grid_post, with_mesh=with_mesh,
        with_joints=True, num_joint_f=cfg.num_joint_f)
    inputs = (scene["joint_verts_v"], scene["joint_faces_v"])
    if with_mesh:
        inputs = (scene["mesh_x"][col.faces], scene["mesh_v"][col.faces],
                  *inputs)
    return (frame, make_sharded_cloth_state(cfg, state, 1),
            uniform_model(model, col.friction), inputs)


def sharded_blocks(st):
    """(x, v) of a world-1 ShardedClothState in the MPMState layout."""
    import torch
    return (torch.cat([st.xe, st.xt, st.xv]),
            torch.cat([st.ve, st.vt, st.vv]))


def multi_device_path(dev, check, per_sub, k5) -> dict:
    """Phase 14: the sharded frame, K5 on a slab, the sharded material
    step and the data-parallel stage-2 step over a one-rank NCCL group.
    Returns {path: (ms, launches)}."""
    import torch
    import torch.distributed as dist
    if not dist.is_nccl_available():
        raise AssertionError("phase 14: NCCL is not available")
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{free_port()}", rank=0, world_size=1)
    try:
        group = dist.group.WORLD
        print(f"multi-device: NCCL {'.'.join(map(str, torch.cuda.nccl.version()))}"
              f", world size {dist.get_world_size(group)} (one card; NCCL "
              "refuses two ranks on one device)")
        out = {"sharded_frame": sharded_frame_path(dev, group, check,
                                                   per_sub, k5)}
        out["sharded_material_step"] = sharded_material_path(dev, group)
        out["dp_step"] = dp_step_path(dev, group)
        torch.cuda.synchronize()
        return out
    finally:
        dist.destroy_process_group()


def sharded_frame_path(dev, group, check, per_sub, k5) -> tuple:
    """The sharded frame on path B at full width, K5 on a slab; returns
    (steady ms/substep, launches)."""
    import torch
    from mpmavatar_tpu_torch.core.types import build_body_sphere
    from mpmavatar_tpu_torch.ops import _build
    from mpmavatar_tpu_torch.ops import grid_pipeline as gp
    from mpmavatar_tpu_torch.sim import bench_scene
    solver, state0, model, scene = bench_scene.build(GRID_B, SAND_B,
                                                     device=dev)
    cfg = solver.cfg
    frame, st, um, ins = sharded_scene(solver, state0, model, scene, group,
                                       SUBSTEPS)
    print(f"sharded frame (path B: {GRID_B}^3, P={cfg.n_particles}, "
          f"{ins[0].shape[0]} collider triangles, {cfg.num_joint_v} + "
          f"{cfg.num_joint_f} joint points), {FRAMES} x {SUBSTEPS} substeps")
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    frame_s = []
    for f in range(FRAMES):
        t0 = time.perf_counter()
        st = frame(st, um, *ins)
        torch.cuda.synchronize()
        frame_s.append(time.perf_counter() - t0)
        if not all(bool(torch.isfinite(getattr(st, k)).all())
                   for k in ("xe", "xv", "xt", "ve", "vv", "vt", "Ft", "d")):
            raise AssertionError(f"sharded frame {f}: non-finite state")
    launches = _build.launch_counts()
    want = {k: v * FRAMES * SUBSTEPS for k, v in per_sub.items()}
    if launches != want:
        raise AssertionError(f"sharded frame: launches {launches}, expected "
                             f"{want}")
    ms = 1e3 * frame_s[-1] / SUBSTEPS
    # MPMSolver.frame on the same scene, timed the same way
    s, t, single_s = state0, 0.0, []
    for f in range(FRAMES):
        t0 = time.perf_counter()
        s, t = solver.frame(s, model, DT, SUBSTEPS, t, **scene)
        torch.cuda.synchronize()
        single_s.append(time.perf_counter() - t0)
    ms_single = 1e3 * single_s[-1] / SUBSTEPS
    x_sh, v_sh = sharded_blocks(st)
    print(f"sharded frame: launches {launches} in {FRAMES * SUBSTEPS} "
          f"substeps; frame wall times {[round(x, 4) for x in frame_s]} s, "
          f"steady {ms:.4f} ms/substep; MPMSolver.frame on the same scene "
          f"{[round(x, 4) for x in single_s]} s, steady {ms_single:.4f} "
          f"ms/substep: the sharded frame's overhead "
          f"{100 * (ms / ms_single - 1):.1f}%; after {FRAMES * SUBSTEPS} "
          f"substeps the two differ by x "
          f"{float((x_sh - s.x).abs().max()):.3e}, v "
          f"{float((v_sh - s.v).abs().max()):.3e}")
    frame_p = sharded_scene(solver, state0, model, scene, group,
                            PROFILE_SUBSTEPS)[0]
    busy_s, prof_wall, rows = profile_device(lambda: frame_p(st, um, *ins))
    n = PROFILE_SUBSTEPS
    (OUT / "chip_smoke_profile_sharded_frame.txt").write_text("\n".join(
        f"{us:12.1f} us {calls:6d}x  {key}" for key, us, calls in rows) + "\n")
    if rows:
        # at one rank NCCL copies; the collectives' clones are copies too
        coll = sum(us for key, us, _ in rows if "nccl" in key.lower()
                   or "memcpy dtod" in key.lower())
        print(f"sharded frame profile of {n} substeps: device busy "
              f"{1e3 * busy_s / n:.4f} ms/substep in "
              f"{sum(r[2] for r in rows) / n:.1f} kernels/substep, idle "
              f"{100 * max(0.0, 1 - busy_s / n / (ms * 1e-3)):.1f}% against "
              f"the steady frame; the collectives (NCCL kernels and "
              f"device-to-device copies) "
              f"{coll / n / 1e3:.4f} ms/substep, "
              f"{100 * coll * 1e-6 / busy_s:.1f}% of the device time")
        for key, us, calls in rows[:12]:
            print(f"  {us / n:10.2f} us/substep {calls // n:4d}/substep  "
                  f"{key[:90]}")
    else:
        print("sharded frame profile: the profiler recorded no device time; "
              "device busy not measured")

    # against MPMSolver.frame over COMPARE_SUBSTEPS substeps, in contact
    faces_out = build_body_sphere(center=MD_BODY_CENTER,
                                  r=bench_scene.BODY_R)[1][:, [0, 2, 1]]
    s_c, st_c, m_c, sc_c = bench_scene.build(
        GRID_B, SAND_B, body_center=MD_BODY_CENTER, device=dev)
    s_c.colliders = dataclasses.replace(s_c.colliders, mesh_colliders=())
    s_c.add_mesh_collider(faces_out, friction=0.5)
    sc_c["mesh_v"] = torch.tensor(CONTACT_MESH_V, device=dev).expand(
        sc_c["mesh_x"].shape).contiguous()
    gen = torch.Generator(device=dev).manual_seed(4000)
    st_c = dataclasses.replace(st_c, v=st_c.v + 0.05 * torch.randn(
        st_c.v.shape, generator=gen, device=dev))
    ref = s_c.frame(st_c, m_c, DT, COMPARE_SUBSTEPS, 0.0, **sc_c)[0]
    errs = {}
    for name, with_mesh in (("sharded", True), ("collider dropped", False)):
        f_c, sh, um_c, ins_c = sharded_scene(s_c, st_c, m_c, sc_c, group,
                                             COMPARE_SUBSTEPS, with_mesh)
        x, v = sharded_blocks(f_c(sh, um_c, *ins_c))
        errs[name] = (float((x - ref.x).abs().max()),
                      float((v - ref.v).abs().max()))
    print(f"sharded frame against MPMSolver.frame over {COMPARE_SUBSTEPS} "
          f"substeps (path B, the sphere wound outward, its top 0.01 above "
          f"the cloth, rising at {CONTACT_MESH_V[1]} m/s): x "
          f"{errs['sharded'][0]:.3e} (tol {PATH_ATOL['x']:.0e}), v "
          f"{errs['sharded'][1]:.3e} (tol {PATH_ATOL['v']:.0e}); wrong path "
          f"(the collider dropped): x {errs['collider dropped'][0]:.3e}, v "
          f"{errs['collider dropped'][1]:.3e}")
    if not (errs["sharded"][0] <= PATH_ATOL["x"]
            and errs["sharded"][1] <= PATH_ATOL["v"]
            < errs["collider dropped"][1]):
        raise AssertionError("the sharded frame disagrees with MPMSolver."
                             "frame, or the limit does not separate the "
                             "wrong path")

    # K5 on the second half of phase 4's 128^3 grid (path A's fields)
    pipeline, k5_in, surf, cfg_a, full, full_in, full_surf = k5
    n_cells = GRID ** 3
    half = n_cells // 2
    sl = [a[half:] if torch.is_tensor(a) and a.dim() and a.shape[0] ==
          n_cells else a for a in k5_in]
    out = pipeline(*sl, 0.01, DT, surf, cell_start=half)
    plain = lambda: gp.grid_pipeline_plain(*sl, surf, 0.01, DT, GRID,
                                           cfg_a.dx, (0,), False, 3,
                                           cell_start=half)
    whole = pipeline(*k5_in, 0.01, DT, surf)
    if not torch.equal(out, whole[half:]):
        raise AssertionError("K5 on the slab differs from the whole grid's "
                             "second half")
    active = int((sl[1] > 1e-15).sum())
    covered = int((sl[3] > 1e-15).sum())
    movered = int((sl[5] > 1e-15).sum())
    check("grid_pipeline", [out], [plain()], "grid_pipeline.cu",
          "mpmavatar_tpu/ops/pallas_grid_pipeline.py:149",
          lambda: pipeline(*sl, 0.01, DT, surf, cell_start=half), plain,
          4 * (6 * half + 3 * active + 6 * covered + 3 * movered),
          60.0 * half, launches,
          label=f"grid_pipeline (a slab: the second half of {GRID}^3, path "
          f"A's fields, from cell {half})",
          extra={"cell_start": half, "cells": half})
    fl = [a[half:] if a.dim() and a.shape[0] == n_cells else a
          for a in full_in]
    e_abs, e_rel = rel_err(
        [full(*fl, 0.01, DT, full_surf, cell_start=half)],
        [gp.grid_pipeline_plain(*fl, full_surf, 0.01, DT, GRID, cfg_a.dx,
                                (0, 1, 2), True, 3, cell_start=half)])
    print(f"grid_pipeline on the slab, mesh+mover+sticky+slip+frictional+"
          f"bbox: max_abs_err {e_abs:.3e}, rel {e_rel:.3e}; the slab equals "
          f"the whole grid's second half exactly")
    if e_rel > KERNEL_REL_TOL["grid_pipeline"]:
        raise AssertionError("grid_pipeline on a slab (all branches) "
                             "disagrees")
    return ms, launches


def sharded_material_path(dev, group) -> tuple:
    """The sharded material step at phase 9's shape against the
    single-device autograd of the same loss; returns (ms/step,
    launches)."""
    from unittest import mock
    import torch
    from mpmavatar_tpu_torch.core.colliders import ColliderSet, MeshCollider
    from mpmavatar_tpu_torch.ops import _build
    from mpmavatar_tpu_torch.parallel import (make_sharded_cloth_state,
                                              make_sharded_material_step,
                                              sharded)
    from mpmavatar_tpu_torch.sim import MPMSolver, reset_density, set_E_nu
    tr, _, _ = material_trainer(dev, MAT_GRID, MAT_FRAMES, MAT_SUBSTEPS)
    cfg = tr.static
    n_sub = MAT_FRAMES * MAT_SUBSTEPS
    col = tr.solver.colliders.mesh_colliders[0]
    data = tr._rollout_data
    state = dataclasses.replace(
        reset_density(tr.base_state, 1.0),
        R_inv=tr._rest_dir_inv(torch.tensor(1.0, device=dev)))
    model = set_E_nu(tr.model0, E=100.0)
    mesh_x, mesh_v = data["smplx_sim"][0], data["smplx_velo_sim"][0]
    jv, target = data["joint_velo_sim"][0], data["target_sim"][-1]
    um = uniform_model(model, col.friction)
    step = make_sharded_material_step(cfg, group, n_sub, DT,
                                      num_joint_v=cfg.num_joint_v)
    sh = make_sharded_cloth_state(cfg, state, 1)
    args = (sh, um, mesh_x[col.faces], mesh_v[col.faces], jv, target)
    step(*args)                                   # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    loss, grads, _ = step(*args)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    launches = _build.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    # forward + each substep's recompute: the kernels twice per substep
    per = {"cloth_stress": 1, "p2g": 1, "grid_pipeline": 1, "g2p": 1,
           "splat": 2}
    want = {k: 2 * v * n_sub for k, v in per.items()}
    if launches != want:
        raise AssertionError(f"sharded material step: launches {launches}, "
                             f"expected {want}")

    # the same loss's gradient on one device: MPMSolver's substeps
    leaves = {f.name: getattr(um, f.name).detach().clone().requires_grad_(
        True) for f in dataclasses.fields(um)}
    P = cfg.n_particles
    model_l = dataclasses.replace(
        model, mu=leaves["mu"].expand(P), lam=leaves["lam"].expand(P),
        gamma=leaves["gamma"].expand(P), kappa=leaves["kappa"].expand(P),
        friction_coeff=leaves["friction_coeff"], gravity=leaves["gravity"],
        alpha=leaves["alpha"])
    solver = MPMSolver(cfg, device=dev)
    solver.colliders = ColliderSet(mesh_colliders=(MeshCollider(
        faces=col.faces, friction=leaves["mesh_friction"]),),
        use_particle_mover=True)
    t0 = time.perf_counter()
    out, _ = solver.frame(state, model_l, DT, n_sub, 0.0, mesh_x=mesh_x,
                          mesh_v=mesh_v, joint_verts_v=jv, remat=True)
    err = torch.sum((out.x[cfg.n_elements:] - target) ** 2)
    ref_loss = err / (3.0 * cfg.n_vertices)
    ref = torch.autograd.grad(ref_loss, list(leaves.values()),
                              allow_unused=True)
    torch.cuda.synchronize()
    ref_ms = 1e3 * (time.perf_counter() - t0)
    ref = {k: torch.zeros_like(leaves[k]) if g is None else g
           for k, g in zip(leaves, ref)}
    real = sharded._stress.cloth_stress
    with mock.patch.object(sharded._stress, "cloth_stress",
                           lambda *a: tuple(t.detach() for t in real(*a))):
        _, wrong, _ = step(*args)
    floor = 1e-6 * max(float(g.abs().max()) for g in ref.values())

    def leaf_errs(g):
        return {k: float((getattr(g, k) - r).abs().max())
                / max(float(r.abs().max()), floor) for k, r in ref.items()}

    sound, bad = leaf_errs(grads), leaf_errs(wrong)
    print(f"sharded material step (phase 9's shape, P={P}, {MAT_GRID}^3, "
          f"{n_sub} substeps, each checkpointed): {ms:.4f} ms/step (after "
          f"a warm-up step), peak allocated {peak / 2 ** 30:.3f} GiB; "
          f"launches {launches}; loss {float(loss):.9e} against the "
          f"single-device {float(ref_loss.detach()):.9e} ({ref_ms:.1f} ms with its "
          f"rollout); gradients per leaf "
          + ", ".join(f"{k} {float(ref[k].abs().max()):.3e}" for k in ref)
          + "; rel err " + ", ".join(f"{k} {e:.3e}" for k, e in sound.items())
          + f" (tol {MD_GRAD_TOL:.0e}); wrong path (K1's outputs detached): "
          + ", ".join(f"{k} {e:.3e}" for k, e in bad.items()))
    ref_loss = float(ref_loss.detach())
    if abs(float(loss) - ref_loss) > 1e-5 * abs(ref_loss):
        raise AssertionError("the sharded material loss disagrees")
    if not max(sound.values()) <= MD_GRAD_TOL < max(bad.values()):
        raise AssertionError("the sharded material gradient disagrees with "
                             "the single-device gradient, or the limit does "
                             "not separate the wrong path")
    return ms, launches


def dp_step_path(dev, group) -> tuple:
    """The data-parallel stage-2 step at world size 1 on phase 7's avatar
    with DP_SAMPLES local samples; returns (ms/step, launches per
    step)."""
    import numpy as np
    import torch
    from mpmavatar_tpu_torch.data import OptimizationParams
    from mpmavatar_tpu_torch.ops import _build
    from mpmavatar_tpu_torch.parallel import appearance_dp as dp
    from mpmavatar_tpu_torch.render import bench_render, camera_arrays
    from mpmavatar_tpu_torch.render import gaussians as G
    from mpmavatar_tpu_torch.train import appearance as tapp
    from mpmavatar_tpu_torch.train import bench_appearance as bapp
    raster = bench_render.AVATAR_RASTER
    avatar, params, _, cam, gt_rgb, gt_msk, _ = bapp.build(dev)
    W, H = cam[1], cam[2]
    a = bench_render.AVATAR
    # bench_appearance's camera, and one 0.1 farther back
    cams = [bench_render.look_down_z(W, H, a["focal"], a["cam_z"] + dz,
                                     a["near"], a["far"])
            for dz in (0.0, 0.1)]
    cam_b = dp.stack_camera_arrays(cams, dev)
    rng = np.random.default_rng(2)
    gt2 = torch.as_tensor(rng.random((3, H, W)).astype(np.float32),
                          device=dev)
    ts = list(range(DP_SAMPLES))
    batch = (cam_b, torch.tensor(ts, device=dev), torch.tensor(ts, device=dev),
             avatar.tensor("verts_orig", dev)[:DP_SAMPLES],
             avatar.tensor("ao_maps", dev)[:DP_SAMPLES],
             torch.stack([gt_rgb, gt2]), torch.stack([gt_msk, gt_msk]))
    opt = OptimizationParams()
    # the single-device gradients of each sample, before any update
    loss_and_grads = tapp.make_loss_and_grads(avatar, opt, bapp.ACTIVE_SH,
                                              False, **raster)
    per_sample = []
    for i, c in enumerate(cams):
        _, _, g = loss_and_grads(params, i, i, camera_arrays(c, dev),
                                 batch[5][i], batch[6][i], batch[4][i], W, H)
        per_sample.append({k: v.detach().clone() for k, v in g.items()})
    mean = {k: sum(g[k] for g in per_sample) / DP_SAMPLES
            for k in per_sample[0]}
    optimizer = tapp.make_optimizer(opt, bapp.EXTENT, params)
    step = dp.make_dp_appearance_step(avatar, opt, optimizer, group,
                                      bapp.ACTIVE_SH, False, W, H, **raster)
    seen = {}
    real = dp.apply_updates_float

    def spy(opt_, p, grads):
        seen.update({k: v.detach().clone() for k, v in grads.items()})
        return real(opt_, p, grads)

    ds = G.init_densify_state(params.splats.capacity, dev)
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    dp.apply_updates_float = spy
    try:
        ds, loss, metrics = step(params, ds, *batch)
    finally:
        dp.apply_updates_float = real
    torch.cuda.synchronize()
    launches = _build.launch_counts()
    want = {"composite": 2 * DP_SAMPLES, "composite_bwd": 2 * DP_SAMPLES}
    if launches != want:
        raise AssertionError(f"DP step: launches {launches}, expected {want}")
    floor = 1e-6 * max(float(v.abs().max()) for v in mean.values())

    def worst(g):
        errs = {k: float((g[k] - mean[k]).abs().max())
                / max(float(mean[k].abs().max()), floor) for k in mean}
        k = max(errs, key=errs.get)
        return errs[k], k

    sound, bad = worst(seen), worst(per_sample[0])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(DP_STEPS):
        t0 = time.perf_counter()
        ds, loss, metrics = step(params, ds, *batch)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    peak = torch.cuda.max_memory_allocated()
    med = statistics.median(times)
    print(f"DP stage-2 step (world size 1, {DP_SAMPLES} local samples of "
          f"phase 7's avatar, {W} x {H}): launches {launches} per step; "
          f"the gradients of {len(mean)} leaves against the mean of the "
          f"single-device make_loss_and_grads: max rel err {sound[0]:.3e} "
          f"({sound[1]}; tol {STEP_GRAD_TOL:.0e}); wrong path (the first "
          f"sample's alone): {bad[0]:.3e} ({bad[1]}); {DP_STEPS} steps "
          f"{med:.4f} ms/step median ({min(times):.4f}-{max(times):.4f}), "
          f"{med / DP_SAMPLES:.4f} ms per sample; loss {float(loss):.6f}, "
          f"overflow {int(metrics['work_overflow'])} / "
          f"{int(metrics['big_overflow'])}; densify denom max "
          f"{float(ds.denom.max()):.0f}; peak allocated "
          f"{peak / 2 ** 30:.3f} GiB")
    if not sound[0] <= STEP_GRAD_TOL < bad[0]:
        raise AssertionError("the DP step's gradient disagrees with the "
                             "single-device mean, or the limit does not "
                             "separate the wrong path")
    if int(metrics["work_overflow"]) or not np.isfinite(float(loss)):
        raise AssertionError("DP step: overflow or a non-finite loss")
    return med, launches


def recovery_path(dev, per_sub) -> tuple:
    """Phase 15: train/stage3_production.py --recover at full width;
    returns (s per step, launches)."""
    import json as _json
    import numpy as np
    import torch
    from mpmavatar_tpu_torch.ops import _build
    from mpmavatar_tpu_torch.train import stage3_production as S
    trace_path = OUT / "chip_smoke_recover.jsonl"
    args = S.parse_args(["--recover", "--nx", str(REC_NX), "--grid",
                         str(REC_GRID), "--substep", str(REC_SUBSTEP),
                         "--frames", "1", "--steps", str(REC_STEPS),
                         "--out", str(trace_path), "--device", str(dev)])
    traj = {}
    synthesize = S.synthesize

    def recorded(a):
        traj["t"] = synthesize(a)[1]
        return None, traj["t"]

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    S.synthesize = recorded
    t0 = time.perf_counter()
    try:
        summary = S.run_recover(args)
    finally:
        S.synthesize = synthesize
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _build.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    trace = [_json.loads(x) for x in trace_path.read_text().splitlines()]
    steps = trace[:-1]
    t = traj["t"]
    move = float(np.abs(t[-1] - t[0]).max())
    # synthesize: one forward per substep; each train step: the forward
    # and two recomputes (frame and substep checkpointed)
    want = {k: v * REC_SUBSTEP * (1 + 3 * REC_STEPS)
            for k, v in per_sub.items()}
    init = {"D": 1.0, "E": 1.0, "H": 1.0}
    toward = {k: abs(steps[-1][k] - S.TRUTH[k]) < abs(init[k] - S.TRUTH[k])
              for k in S.TRUTH}
    print(f"recovery (stage3_production --recover --nx {REC_NX} --grid "
          f"{REC_GRID} --substep {REC_SUBSTEP} --steps {REC_STEPS}): "
          f"{summary['particles']} particles, {len(t[0])} vertices; the "
          f"trajectory at {S.TRUTH} moves {move:.4f}; steps "
          + "; ".join(f"{r['step']}: loss {r['loss']:.9e}, {r['sec']} s, D "
                      f"{r['D']:.6f}, E {r['E']:.6f}, H {r['H']:.6f}"
                      for r in steps)
          + f"; toward TRUTH after the last step: {toward}; err "
          f"{summary['err']}; whole run {wall:.1f} s (steps "
          f"{summary['wall_sec']} s); peak allocated {peak / 2 ** 30:.3f} "
          f"GiB; launches {launches}")
    if launches != want:
        raise AssertionError(f"recovery: launches {launches}, expected "
                             f"{want}")
    if not (np.isfinite(t).all() and move > 0.01 and all(
            np.isfinite(r["loss"]) for r in steps)):
        raise AssertionError("recovery: not finite, or the trajectory does "
                             "not move")
    if not (summary["particles"] == REC_NX ** 2 + 2 * (REC_NX - 1) ** 2
            and steps[1]["loss"] < steps[0]["loss"]):
        raise AssertionError("recovery: not the full width, or the loss did "
                             "not fall")
    return statistics.median(r["sec"] for r in steps), launches


def joint_grads(tracker, batch, detach_body: bool = False):
    """One joint tracking iteration's gradient w.r.t. BENCH_TRACK_LEAVES:
    the mesh vertices, the colours, the VPoser latent and the SMPL-X
    translation (a leaf here only; the tracker holds it fixed).  With
    ``detach_body`` the SMPL-X geometry leaves the graph (a wrong path:
    the latent's and the translation's gradients vanish)."""
    import torch
    from mpmavatar_tpu_torch.train import tracking as tt
    fixed = dict(tracker.smplx_fixed)
    fixed["trans"] = fixed["trans"].detach().clone().requires_grad_(True)
    body_v, body_vn = tracker._smplx_geometry(tracker.smplx_train, fixed)
    if detach_body:
        body_v, body_vn = body_v.detach(), body_vn.detach()
    loss, _ = tt.tracking_loss(
        tracker.params, tracker.variables, batch["ca"], batch["w"],
        batch["h"], batch["cam_id"], batch["rgb"], batch["msk"], body_v,
        body_vn, tracker.prev_col, True, tracker.cfg, stats=tracker.stats)
    leaves = [tracker.params["vertices"], tracker.params["rgb_colors"],
              tracker.smplx_train["latent"], fixed["trans"]]
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return [torch.zeros_like(x) if g is None else g
            for g, x in zip(grads, leaves)]


def busy_share(label, busy_ms, timed_ms) -> None:
    """Print a profiled iteration's device busy time against a timed
    iteration's wall, unclamped; flag a busy time above the wall (the two
    are different iterations, so a share over 1 is their spread or a
    mismatched window, never an idle share)."""
    share = busy_ms / timed_ms
    print(f"  {label}: busy {busy_ms:.4f} ms against the timed iteration's "
          f"{timed_ms:.4f} ms: busy share {share:.4f}, idle share "
          f"{1 - share:.4f}")
    if share > 1:
        print(f"  FLAG {label}: the profiled iteration's device busy time "
              f"exceeds the timed iteration's wall by {busy_ms - timed_ms:.4f}"
              f" ms; no idle share is read from this pair")


def driver_launches(per_sub_a, per_sub_b) -> dict:
    """The launches of ``bench --headline_only``: the garment at 128^3 and
    200^3 (path A's kernels per substep) and at 250^3 with sand (path
    B's), 2 + 5 frames of 100 substeps each, and the two 1080p splat
    scenes' 1 + 10 frames, K6 twice per frame."""
    from mpmavatar_tpu_torch import bench
    from mpmavatar_tpu_torch.ops import composite as kcomp
    from mpmavatar_tpu_torch.sim import bench_scene
    n_sub = (bench_scene.WARM_FRAMES + bench_scene.TIMED_FRAMES) \
        * bench.FULL["sim"]["substeps"]
    want = {}
    for per in (per_sub_a, per_sub_a, per_sub_b):
        for k, v in per.items():
            want[k] = want.get(k, 0) + v * n_sub
    want[kcomp.KERNEL] = 2 * 2 * (1 + bench.FULL["render"]["frames"])
    return want


def drivers_path(dev, smi, check, per_sub_a, per_sub_b) -> tuple:
    """Phase 16: the tracking bench (tile path, then the worklist
    compositor with its launches, K6/K7 checks, profile and gradient
    check) and the one-line driver with its launches; ``check`` is phase
    4's kernel check, ``per_sub_a``/``per_sub_b`` paths A's and B's
    launches per substep.  Returns (tile-path ms per iteration, worklist
    ms per iteration, the worklist run's launches, the driver's
    launches)."""
    import contextlib
    import io
    import math
    import torch
    from mpmavatar_tpu_torch import bench
    from mpmavatar_tpu_torch.ops import _build
    from mpmavatar_tpu_torch.ops import composite as kcomp
    from mpmavatar_tpu_torch.train import bench_tracking as BT
    from mpmavatar_tpu_torch.utils.losses import collision_loss

    t_phase = time.perf_counter()
    # the JAX bench's tile path: plain tensor code, no kernel
    _build.reset_launch_counts()
    tile = BT.run(iters=BENCH_TRACK_ITERS, device=dev)
    tile_launches = _build.launch_counts()
    print(f"tracking bench, tile path (train/bench_tracking.py): "
          f"{tile['n_faces']} faces at 1500x1000, the 10,475-vertex rig and "
          f"VPoser in the graph, {BENCH_TRACK_ITERS} iterations after "
          f"{BT.WARMUP}: {tile['ms_per_iter']:.4f} ms per iteration, "
          f"{tile['value']:.4f} steps/s, projected "
          f"{tile['projected_min_per_frame_3k_iters']:.3f} min per "
          f"3,000-iteration frame and "
          f"{tile['projected_t0_hours_10k_iters']:.4f} h for the first "
          f"frame's 10,000; loss {tile['loss']:.6f}; peak allocated "
          f"{tile['peak_allocated_bytes'] / 2 ** 30:.3f} GiB; overflow "
          f"work {tile['work_overflow']}, big {tile['big_overflow']}; "
          f"launches {tile_launches}")
    if tile["n_faces"] != BENCH_TRACK_FACES or tile_launches or not \
            math.isfinite(tile["loss"]) or tile["big_overflow"]:
        raise AssertionError("tracking bench, tile path: not the bench's "
                             "mesh, a kernel launched, a non-finite loss "
                             "or overflow")

    # the worklist compositor: K6 and K7 twice per iteration, the
    # counters reset after the warm-up
    tracker, batches, n_faces = BT.build_tracking_problem(
        device=dev, work_cap=BENCH_TRACK_WORK_CAP)
    work = BT.timed(tracker, batches, n_faces, BENCH_TRACK_ITERS,
                    after_warmup=_build.reset_launch_counts)
    launches = _build.launch_counts()
    work_ms = work["ms_per_iter"]
    want = {kcomp.KERNEL: 2 * BENCH_TRACK_ITERS,
            kcomp.KERNEL_BWD: 2 * BENCH_TRACK_ITERS}
    stats = {k: int(v) for k, v in tracker.stats.items()}
    print(f"tracking bench, worklist compositor (--work_cap "
          f"{BENCH_TRACK_WORK_CAP}): {work_ms:.4f} ms per iteration, "
          f"{work['value']:.4f} steps/s "
          f"({work['projected_min_per_frame_3k_iters']:.3f} min per "
          f"3,000-iteration frame); loss {work['loss']:.6f}; the last "
          f"step's {stats}; peak allocated "
          f"{work['peak_allocated_bytes'] / 2 ** 30:.3f} GiB; launches "
          f"{launches}")
    if launches != want or stats["work_overflow"] or stats["big_overflow"]:
        raise AssertionError(f"tracking bench, worklist: launches "
                             f"{launches}, expected {want}, or overflow")

    # K6 and K7 on one more iteration's own worklists and cotangents
    batch = tracker._device_batches(batches)[0]
    composite_pair(check, "tracking bench",
                   lambda: tracker.step(batch, None, None, True), launches)

    # a profile of one more iteration, and the collision penalty alone
    busy_s, prof_wall, rows = profile_device(
        lambda: tracker.step(batch, None, None, True))
    (OUT / "chip_smoke_profile_tracking_bench.txt").write_text("\n".join(
        f"{us:12.1f} us {calls:6d}x  {key}" for key, us, calls in rows) + "\n")
    cloth = tracker.params["vertices"].detach()[
        tracker.variables["cloth_v_idx"]].requires_grad_(True)
    body_v, body_vn = (t.detach() for t in tracker._smplx_geometry(
        tracker.smplx_train, tracker.smplx_fixed))
    body_v.requires_grad_(True)
    coll_fwd = event_ms(lambda: collision_loss(cloth, body_v, body_vn),
                        reps=3, inner=5)
    coll_ms = event_ms(lambda: torch.autograd.grad(
        collision_loss(cloth, body_v, body_vn), [cloth, body_v]), reps=3,
        inner=5)
    if rows:
        print(f"tracking bench profile of one worklist iteration: device "
              f"busy {1e3 * busy_s:.4f} ms in {sum(r[2] for r in rows)} "
              f"kernels, {1e3 * prof_wall:.4f} ms profiled wall")
        busy_share("worklist iteration", 1e3 * busy_s, work_ms)
        for key, us, n in rows[:8]:
            print(f"  {us:10.2f} us {n:4d}x  {key[:90]}")
    else:
        print("tracking bench profile: no device time recorded; busy share "
              "not measured")
    print(f"tracking bench collision penalty ({cloth.shape[0]} cloth x "
          f"{body_v.shape[0]} body vertices, the full distance matrix "
          f"{4 * cloth.shape[0] * body_v.shape[0] / 2 ** 20:.1f} MiB): "
          f"forward {coll_fwd:.4f} ms, forward + backward {coll_ms:.4f} ms "
          f"(CUDA events)")

    # a profile of one tile-path iteration (after the worklist's timing:
    # the profiler slows the host's launches for the rest of the process)
    tracker, batches, _ = BT.build_tracking_problem(device=dev)
    batch = tracker._device_batches(batches)[0]
    tracker.step(batch, None, None, True)
    busy_s, prof_wall, rows = profile_device(
        lambda: tracker.step(batch, None, None, True))
    (OUT / "chip_smoke_profile_tracking_bench_tile.txt").write_text(
        "\n".join(f"{us:12.1f} us {n:6d}x  {key}" for key, us, n in rows)
        + "\n")
    del tracker, batches, batch
    if rows:
        print(f"tracking bench profile of one tile-path iteration: device "
              f"busy {1e3 * busy_s:.4f} ms in {sum(r[2] for r in rows)} "
              f"kernels, {1e3 * prof_wall:.4f} ms profiled wall")
        busy_share("tile-path iteration", 1e3 * busy_s, tile["ms_per_iter"])
        for key, us, n in rows[:8]:
            print(f"  {us:10.2f} us {n:4d}x  {key[:90]}")
    else:
        print("tracking bench tile-path profile: no device time recorded")

    # one joint iteration's gradient at a cut shape: the card against the
    # CPU plain path, beside the SMPL-X geometry detached
    def cut_grads(device, detach_body=False):
        tr, bt, _ = BT.build_tracking_problem(
            device=device, work_cap=BENCH_TRACK_CUT_CAP, **BENCH_TRACK_CUT)
        grads = joint_grads(tr, tr._device_batches(bt)[0], detach_body)
        if int(tr.stats["work_overflow"]) or int(tr.stats["big_overflow"]):
            raise AssertionError(f"tracking bench, cut shape on {device}: "
                                 f"the rasterizer overflowed")
        return [g.cpu() for g in grads]

    g_card, g_cpu = cut_grads(dev), cut_grads("cpu")
    g_wrong = cut_grads(dev, detach_body=True)
    per_leaf = lambda gs: {
        k: float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
        for k, a, b in zip(BENCH_TRACK_LEAVES, gs, g_cpu)}
    sound, wrong = per_leaf(g_card), per_leaf(g_wrong)
    print(f"tracking bench gradient of one joint iteration at "
          f"{BENCH_TRACK_CUT} (work_cap {BENCH_TRACK_CUT_CAP}), the card "
          f"against the CPU plain path per leaf relative to its largest "
          f"entry: " + ", ".join(f"{k} {v:.3e}" for k, v in sound.items())
          + f" (tol {TRACK_GRAD_TOL:.0e}); the SMPL-X geometry detached: "
          + ", ".join(f"{k} {v:.3e}" for k, v in wrong.items()))
    if not max(sound.values()) <= TRACK_GRAD_TOL < max(wrong.values()):
        raise AssertionError("tracking bench: the joint gradient on the "
                             "card disagrees with the CPU's, or the limit "
                             "does not separate the wrong path")

    # the one-line driver, in this process, with the counters reset just
    # before and read just after
    text = io.StringIO()
    _build.reset_launch_counts()
    with contextlib.redirect_stdout(text):
        bench.main(["--headline_only"])
    drv_launches = _build.launch_counts()
    out = text.getvalue().strip().splitlines()
    line = json.loads(out[-1])
    want = driver_launches(per_sub_a, per_sub_b)
    print(f"mpmavatar_tpu_torch.bench --headline_only: {out[-1]}; launches "
          f"{drv_launches}")
    if drv_launches != want:
        raise AssertionError(f"bench --headline_only: launches "
                             f"{drv_launches}, expected {want}")
    bad = [k for k in BENCH_KEYS
           if not (math.isfinite(line.get(k, math.nan)) and line[k] > 0)]
    if bad or line["metric"] != bench.METRIC:
        raise AssertionError(f"bench --headline_only: keys {bad} missing, "
                             f"not finite or not positive")
    print(f"phase 16 took {time.perf_counter() - t_phase:.1f} s on {smi}")
    return tile["ms_per_iter"], work_ms, launches, drv_launches


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


def stages_path(dev, smi, check) -> dict:
    """Phase 17: the two convergence checks on the card, through K6/K7,
    and K6/K7 against their plain versions on one more iteration's and
    one more step's own worklists and cotangents; ``check`` is phase 4's
    kernel check.  Returns the checks' launches."""
    import math
    import shutil
    from mpmavatar_tpu_torch.ops import _build
    from mpmavatar_tpu_torch.ops import composite as kcomp
    t_phase = time.perf_counter()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    losses, err0, err1, track_more = converge_tracking(
        stage_cloth, lookat_cams, dev, STAGE_WORK_CAP)
    track_s = time.perf_counter() - t0
    launches_t = _build.launch_counts()
    print(f"stage check, tracking converges (tests/test_convergence.py's "
          f"scene, {STAGE_TRACK_ITERS} iterations, work_cap "
          f"{STAGE_WORK_CAP}): loss {losses[0]:.6f} -> {losses[-1]:.6f} "
          f"({losses[-1] / losses[0]:.4f} of the first, bound "
          f"{STAGE_LOSS_RATIO}), mean vertex error {err0:.6f} -> {err1:.6f} "
          f"({err1 / err0:.4f}, bound {STAGE_ERR_RATIO}); {track_s:.2f} s; "
          f"launches {launches_t}")
    want = {kcomp.KERNEL: 2 * STAGE_TRACK_ITERS,
            kcomp.KERNEL_BWD: 2 * STAGE_TRACK_ITERS}
    if launches_t != want or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"stage check, tracking: launches "
                             f"{launches_t}, expected {want}, or a "
                             f"non-finite loss")
    if not (losses[-1] < STAGE_LOSS_RATIO * losses[0]
            and err1 < STAGE_ERR_RATIO * err0):
        raise AssertionError("stage check: tracking does not converge to "
                             "the target mesh")
    composite_pair(check, "stage tracking", track_more, launches_t)

    work = REPO / "output" / "chip_smoke_stages"
    shutil.rmtree(work, ignore_errors=True)
    try:
        fake_tracking_assets(work)
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        psnr0, psnr1, loss, app_more = heldout_psnr(work, lookat_cams, dev,
                                                    STAGE_WORK_CAP)
        app_s = time.perf_counter() - t0
        launches_a = _build.launch_counts()
        composite_pair(check, "stage-2", app_more, launches_a)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"stage check, held-out PSNR rises (tests/test_convergence.py's "
          f"scene, {STAGE_PSNR_ITERS} stage-2 steps, work_cap "
          f"{STAGE_WORK_CAP}): {psnr0:.4f} -> {psnr1:.4f} dB (+"
          f"{psnr1 - psnr0:.4f}, bound +{STAGE_PSNR_GAIN}); last loss "
          f"{loss:.6f}; {app_s:.2f} s; launches {launches_a}")
    want = {kcomp.KERNEL: 2 * STAGE_PSNR_ITERS,
            kcomp.KERNEL_BWD: 2 * STAGE_PSNR_ITERS}
    if launches_a != want or not math.isfinite(loss):
        raise AssertionError(f"stage check, stage 2: launches {launches_a}, "
                             f"expected {want}, or a non-finite loss")
    if not psnr1 > psnr0 + STAGE_PSNR_GAIN:
        raise AssertionError("stage check: stage 2 does not raise the "
                             "held-out PSNR")
    print(f"phase 17 took {time.perf_counter() - t_phase:.1f} s on {smi}")
    return {k: launches_t.get(k, 0) + launches_a.get(k, 0)
            for k in set(launches_t) | set(launches_a)}


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
    for name, v in {**kstress.kernel_info(), **ktransfer.kernel_info(),
                    **ksplat.kernel_info()}.items():
        print(f"  as built: {name} {v['registers']} registers/thread, "
              f"{v['spill_bytes']} spilled bytes/thread, "
              f"{v['shared_bytes']} shared bytes/block, "
              f"{v['blocks_per_sm']} blocks per SM")
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
            changed, covered = mesh_branch_cells(s_d, st_d, m_d, sc_d, t_d)
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

    # the posed body of phase 10, set up here: K4 runs at its shape in
    # phase 4
    from mpmavatar_tpu_torch.sim import pose_playback
    body_p, body_p_cpu = (pose_playback.load_body(device=d)
                          for d in (dev, "cpu"))
    scene_p = pose_playback.build(NX, GRID, body=body_p, device=dev)

    # ---- 4. kernels against their plain versions -----------------------
    gen = torch.Generator(device=dev).manual_seed(0)
    rnd = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    st = dataclasses.replace(state, v=state.v + 0.05 * rnd(P, 3))
    k1_in = k1_inputs(st, model, E, gen)
    results = {}
    # the floor under every graph_ms below: a 1-element fill per call
    floor_ms = graph_floor_ms(dev)
    print(f"graph replay floor (a 1-element fill per call): {floor_ms:.4f} "
          "ms")

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
                 "library_ms": None, "graph_floor_ms": floor_ms,
                 **(extra or {})}
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
          E * (18 + 27) * 4 + 4, E * 310.0, launches_a,
          extra=kstress.kernel_info()[kstress.KERNEL])

    _, stress_e, f1, f2, f3 = k1
    vforce = torch.zeros((cfg.n_vertices, 3), device=dev)
    faces = st.faces.long()
    for c, fc in enumerate((f1, f2, f3)):
        vforce.index_add_(0, faces[:, c], fc)
    c_eff = 0.5 * rnd(P, 3, 3)
    sel = (st.selection == 0).float()
    k2_in = (st.x, st.v, c_eff, st.mass, sel, DT * stress_e, DT * vforce,
             GRID, cfg.inv_dx, cfg.dx)
    n_cells = GRID ** 3

    def p2g_check(label, args, launches_of):
        counts = torch.zeros(2, dtype=torch.int32, device=dev)
        out = ktransfer.p2g(*args, branch_counts=counts)
        ref = ktransfer.p2g_plain(*args)
        tile, direct = counts.tolist()
        n_p, nnv, g = args[0].shape[0], args[5].shape[0], args[7]
        fill_ms = graph_ms(lambda: (torch.zeros((g ** 3, 3), device=dev),
                                    torch.zeros((g ** 3,), device=dev)))
        # bytes: x, v, C, mass, sel (17 floats) per particle, stress (9)
        # per non-vertex, vforce (3) per vertex, 4 floats out per cell;
        # ~1800 FP32 operations per particle (27 nodes x ~66, weights ~30)
        check("p2g", out, ref, "transfer.cu",
              "mpmavatar_tpu/ops/pallas_transfer.py:225",
              lambda: ktransfer.p2g(*args),
              lambda: ktransfer.p2g_plain(*args),
              4 * (17 * n_p + 9 * nnv + 3 * (n_p - nnv) + 4 * g ** 3),
              n_p * 1800.0, launches_of, label=label,
              extra={"fill_ms": fill_ms, "particles": n_p, "grid": g,
                     "tile_blocks": tile, "direct_blocks": direct})
        print(f"  {label or 'p2g'}: P={n_p}, {g}^3; {tile} blocks through "
              f"the shared-memory tile, {direct} straight into the grid; "
              f"the wrapper's two zero fills alone {fill_ms:.4f} ms")
        return out

    k2 = p2g_check(None, k2_in, launches_a)
    # the same particles in a random order (elements among elements,
    # vertices among vertices, each with its own stress or force)
    nnv = cfg.n_no_vertices
    perm = random_order(cfg).to(dev)
    p2g_check("p2g (the cloth drop's particles in a random order)",
              (*(a[perm] for a in k2_in[:5]), k2_in[5][perm[:nnv]],
               k2_in[6][perm[nnv:] - nnv], *k2_in[7:]), launches_a)
    # path B's state after its run: the cloth in mesh order, the sand in
    # the random order of its build
    _, _, _, stress_b, vf_b = stepping.compute_stress(cfg_b, state_b,
                                                      model_b, DT)
    e_b = cfg_b.n_elements
    stress_b = torch.cat([stress_b[:e_b], state_b.vol[
        e_b:cfg_b.n_no_vertices, None, None] * stress_b[e_b:]])
    p2g_check(f"p2g (path B, {GRID_B}^3)",
              (state_b.x, state_b.v, state_b.C, state_b.mass,
               (state_b.selection == 0).float(), DT * stress_b, DT * vf_b,
               GRID_B, cfg_b.inv_dx, cfg_b.dx), launches_b)

    # K4 at the main path's shapes and beside them (k4_shapes), its blocks
    # counted by branch and its output read as K5 reads it (splat_coverage)
    col_a = solver_a.colliders.mesh_colliders[0]

    def splat_check(label, pts, vals, g, bounds_check=True,
                    launches_of=None):
        launches_of = launches_a if launches_of is None else launches_of
        args = (pts, vals, g, g / 2.0, bounds_check)
        counts = torch.zeros(2, dtype=torch.int32, device=dev)
        out = ksplat.splat(*args, branch_counts=counts)
        ref = ksplat.splat_plain(*args)
        tile, direct = counts.tolist()
        n_pts, ch = vals.shape
        fill_ms = graph_ms(
            lambda: torch.zeros((g ** 3 * (ch + 1),), device=dev))
        n_max = splat_n_max(pts, g, bounds_check)
        tol = max(KERNEL_REL_TOL["splat"], n_max * 2.0 ** -23)
        cover = splat_coverage(out, ref, vals)
        print(f"  {label}: {n_pts} points, CH={ch}, {g}^3; {tile} warps "
              f"through their shared-memory tile, {direct} straight into "
              f"the grid; the wrapper's zero fill alone {fill_ms:.4f} ms; "
              f"{cover['covered']} cells covered, up to {n_max} points on "
              f"one cell; covered by one of kernel and plain only: "
              f"{cover['differ']} cells, {cover['threshold']} of them within "
              f"{COVER_BAND:g}x of {COVER_EPS:g}; on the cells both cover "
              f"acc / w err {cover['velocity']:.3e}, normal err "
              f"{cover['normal']:.3e} (tol {tol:.1e})")
        if cover["differ"] != cover["threshold"] or max(
                cover["velocity"], cover["normal"]) > tol:
            raise AssertionError(f"{label}: the kernel's coverage or acc / w "
                                 "disagrees with the plain version's")
        # bytes: points and values in ((3 + CH) floats each), the dense
        # fields out ((CH + 1) floats per cell, written by the wrapper's
        # zero fill); ~30 + 27 x 2 (CH + 1) FP32 operations per point
        check("splat", out, ref, "splat.cu",
              "mpmavatar_tpu/ops/pallas_transfer.py:561",
              lambda: ksplat.splat(*args), lambda: ksplat.splat_plain(*args),
              4 * (n_pts * (3 + ch) + g ** 3 * (ch + 1)),
              n_pts * (30 + 54.0 * (ch + 1)), launches_of, label=label,
              err=tol, extra={"fill_ms": fill_ms, "points": n_pts,
                              "channels": ch, "grid": g,
                              "tile_warps": tile, "direct_warps": direct,
                              "coverage": cover})
        return out, (tile, direct)

    shapes = k4_shapes(dev, gen, solver_a, state_a, scene_a, scene_p)
    k4_out = {}
    for key, shape in shapes.items():
        out, (tile, direct) = splat_check(*shape)
        if key in ("faces", "joints"):      # K5's inputs below
            k4_out[key] = out
        # the colliders in mesh order: most warps' boxes fit their tile
        if key in ("posed", "ico_in_place") and not tile > direct:
            raise AssertionError(f"{shape[0]}: {tile} warps through their "
                                 f"tile, {direct} straight into the grid")
    (acc_a, mw_a), (mv_a, mvw_a) = k4_out["faces"], k4_out["joints"]
    mover_label, mover_m = shapes["mover"][0], shapes["mover"][1:3]

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

    def g2p_check(label, x, grid_v, g, inv_dx, launches_of):
        counts = torch.zeros(2, dtype=torch.int32, device=dev)
        out = ktransfer.g2p(x, grid_v, g, inv_dx, branch_counts=counts)
        ref = ktransfer.g2p_plain(x, grid_v, g, inv_dx)
        tile, direct = counts.tolist()
        n_p = x.shape[0]
        base = torch.floor(x * inv_dx - 0.5).long()
        touched = torch.unique(torch.clamp(
            ktransfer.flat_indices(base, g), 0, g ** 3 - 1)).numel()
        # bytes: x in (3 floats), v, C, grad_v out (21) per particle, plus
        # the grid cells the stencils touch (3 floats each); ~1900 FP32
        # operations per particle (27 nodes x ~70)
        check("g2p", out, ref, "transfer.cu",
              "mpmavatar_tpu/ops/pallas_transfer.py:256",
              lambda: ktransfer.g2p(x, grid_v, g, inv_dx),
              lambda: ktransfer.g2p_plain(x, grid_v, g, inv_dx),
              4 * (24 * n_p + 3 * touched), n_p * 1900.0, launches_of,
              label=label,
              extra={"particles": n_p, "grid": g, "touched_cells": touched,
                     "tile_blocks": tile, "direct_blocks": direct,
                     **ktransfer.kernel_info()[ktransfer.G2P_KERNEL]})
        print(f"  {label or 'g2p'}: P={n_p}, {g}^3, {touched} grid cells "
              f"touched by the stencils; {tile} blocks gathered from the "
              f"shared-memory tile, {direct} straight from the grid")

    g2p_check(None, st.x, k5, GRID, cfg.inv_dx, launches_a)
    g2p_check("g2p (the cloth drop's particles in a random order)",
              st.x[perm], k5, GRID, cfg.inv_dx, launches_a)
    g2p_check(f"g2p (path B, {GRID_B}^3, one more substep's inputs)",
              *g2p_inputs(lambda: solver_b.frame(state_b, model_b, DT, 1,
                                                 t_b, **scene_b)),
              GRID_B, cfg_b.inv_dx, launches_b)

    # K8: path B's sand after its run, and a tip / cone / reflected set
    sl_b = slice(cfg_b.n_elements, cfg_b.n_no_vertices)
    sand_b = (state_b.F_trial, state_b.F,
              (state_b.selection[sl_b] == 0).float(), model_b.mu[sl_b],
              model_b.lam[sl_b], model_b.alpha)
    sand_ops_plain = plain_ops(kstress.sand_stress_plain,
                               sand_set(64, "cpu"), 64)
    print(f"sand_stress_plain: {sand_ops_plain:.0f} FP32 operations per "
          f"particle (plain_ops)")

    def sand_check(label, args, launches_of=None):
        launches_of = launches_b if launches_of is None else launches_of
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
        # the FP32 operations of each selected particle by its branch
        # (sand_ops: ~1,900-1,980)
        check("sand_stress", [f_new, st_k], [f_ref, st_ref], "sand.cu",
              "mpmavatar_tpu/ops/pallas_stress.py:378",
              lambda: kstress.sand_stress(*args),
              lambda: kstress.sand_stress_plain(*args),
              4 * (30 * n_t + 9 * (n_t - n_sel)) + 4,
              sand_ops(sand_ops_plain, counts), launches_of, label=label,
              err=(max(f_err, s_err), ok, verdict),
              extra={"branch_flips": int(flips.sum()), "particles": n_t,
                     "selected": n_sel,
                     **kstress.kernel_info()[kstress.SAND_KERNEL]})

    sand_check("sand_stress (path B's 100,000 sand particles)", sand_b)
    sand_check("sand_stress (tip / cone / reflected set)",
               sand_set(SAND_B, dev))

    # the backwards: autograd over each plain version through the
    # wrapper's autograd Function, at the shapes above, from seeded
    # cotangents (the backward launches no kernel)
    def backward_check(name, fn, args, wrt, label=None):
        leaves = [a.detach().clone().requires_grad_(i in wrt)
                  if torch.is_tensor(a) else a for i, a in enumerate(args)]
        outs = fn(*leaves)
        outs = [outs] if torch.is_tensor(outs) else list(outs)
        if not all(o.grad_fn is not None for o in outs):
            raise AssertionError(f"{name}: an output carries no grad_fn")
        g_cot = torch.Generator(device=dev).manual_seed(5)
        cots = [torch.randn(o.shape, generator=g_cot, device=dev)
                for o in outs]
        wrt_leaves = [leaves[i] for i in wrt]
        run = lambda: torch.autograd.grad(outs, wrt_leaves, cots,
                                          retain_graph=True)
        _build.reset_launch_counts()
        eager = event_ms(run, reps=3, inner=3)
        if _build.launch_counts():
            raise AssertionError(f"{name}: its backward launched "
                                 f"{_build.launch_counts()}")
        busy, _, rows = profile_device(run)
        # on the entry of the shape it ran at: the kernel's first, or the
        # further shape checked under ``label``
        entry = results[name] if label is None else next(
            e for e in results[name]["other_shapes"] if e["label"] == label)
        entry.update(bwd_ms=1e3 * busy, bwd_eager_ms=eager)
        print(f"{label or name} backward (autograd over the plain version): "
              f"device "
              f"{1e3 * busy:.4f} ms in {sum(r[2] for r in rows)} kernels, "
              f"eager {eager:.4f} ms")

    backward_check("cloth_stress", kstress.cloth_stress, k1_in,
                   (0, 1, 2, 4, 5, 6, 7, 8))
    backward_check("p2g", ktransfer.p2g, k2_in, tuple(range(7)))
    backward_check("grid_pipeline",
                   lambda *a: pipeline(*a, 0.01, DT, surf), k5_in,
                   tuple(range(9)))
    backward_check("g2p", ktransfer.g2p, (st.x, k5, GRID, cfg.inv_dx),
                   (0, 1))
    backward_check("sand_stress", kstress.sand_stress, sand_b,
                   (0, 1, 3, 4, 5))
    backward_check("splat", ksplat.splat,
                   (*mover_m, MAT_GRID, MAT_GRID / 2.0, True), (0, 1),
                   label=mover_label)

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

    # ---- 8. the differentiated substep ----------------------------------
    grad_ms = grad_path(dev, solver, state0, model, solver_cpu, model_cpu,
                        per_sub)

    # ---- 9. the material train step -------------------------------------
    mat_ms, mat_launches = material_path(dev, per_sub_a)

    # ---- 10. the posed body ---------------------------------------------
    pose_ms, pose_launches = posed_body_path(dev, smi, scene_p, body_p,
                                             body_p_cpu, per_sub_a)

    # ---- 11. the stage-2 and stage-4 tools ------------------------------
    import shutil
    work24 = REPO / "output" / "chip_smoke_stage24"
    shutil.rmtree(work24, ignore_errors=True)
    try:
        cli_ms, cli_launches = stage24_path(dev, smi, work24)

        # ---- 12. the zero-shot demo ------------------------------------
        per_sub_demo = dict(per_sub, splat=1, sand_stress=1)
        demo_ms, demo_launches = demo_path(
            dev, smi, {"p2g": p2g_check, "splat": splat_check,
                       "sand": sand_check}, per_sub_demo)

        # ---- 13. stage-1 tracking on phase 11's capture ----------------
        track_ms, track_launches = tracking_path(
            dev, smi, work24 / "capture", work24, check)
    finally:
        shutil.rmtree(work24, ignore_errors=True)

    # ---- 14. multi-device at world size 1 (one-rank NCCL group) --------
    md = multi_device_path(dev, check, per_sub_b,
                           (pipeline, k5_in, surf, cfg_a, full, full_in,
                            full_surf))

    # ---- 15. the production recovery ------------------------------------
    rec_s, rec_launches = recovery_path(dev, per_sub_a)

    # ---- 16. the drivers: the tracking bench, the one-line bench --------
    bench_tile_ms, bench_work_ms, bench_launches, drv_launches = \
        drivers_path(dev, smi, check, per_sub_a, per_sub_b)

    # ---- 17. the stage-level convergence checks -------------------------
    stage_launches = stages_path(dev, smi, check)

    print(f"paths: cloth drop {ms_sub:.4f}, path A {ms_a:.4f}, path B "
          f"{ms_b:.4f} ms/substep, differentiated cloth drop {grad_ms:.4f} "
          f"ms/substep; render "
          + ", ".join(f"{name} {ms:.4f}" for name, (ms, _) in render.items())
          + f" ms/frame; train step {train_ms:.4f} ms; material train step "
          f"{mat_ms:.4f} ms; posed body {pose_ms:.4f} ms/substep; stage-2 "
          f"CLI step {cli_ms:.4f} ms; demo {demo_ms:.4f} ms/substep; "
          f"tracking {track_ms:.4f} ms/iteration; sharded frame "
          f"{md['sharded_frame'][0]:.4f} ms/substep, sharded material step "
          f"{md['sharded_material_step'][0]:.4f} ms, DP stage-2 step "
          f"{md['dp_step'][0]:.4f} ms; recovery {rec_s:.2f} s/step; "
          f"tracking bench {bench_tile_ms:.4f} (tile path), "
          f"{bench_work_ms:.4f} (worklist) ms/iteration on {smi}; "
          f"chip_smoke ran "
          f"{time.perf_counter() - t_start:.1f} s after start-up")
    for entry in results.values():
        entry["launches_by_path"] = {
            "cloth_drop": launches.get(entry["name"], 0),
            "path_A": launches_a.get(entry["name"], 0),
            "path_B": launches_b.get(entry["name"], 0),
            **{f"render_{name}": counts.get(entry["name"], 0)
               for name, (_, counts) in render.items()},
            "train_step": train_launches.get(entry["name"], 0),
            "material_train_step": mat_launches.get(entry["name"], 0),
            "posed_body": pose_launches.get(entry["name"], 0),
            "stage2_cli": cli_launches.get(entry["name"], 0),
            "demo": demo_launches.get(entry["name"], 0),
            "tracking": track_launches.get(entry["name"], 0),
            **{path: counts.get(entry["name"], 0)
               for path, (_, counts) in md.items()},
            "recover": rec_launches.get(entry["name"], 0),
            "tracking_bench": bench_launches.get(entry["name"], 0),
            "driver": drv_launches.get(entry["name"], 0),
            "stages": stage_launches.get(entry["name"], 0)}
    print(smi)
    print(json.dumps({"kernels": list(results.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
