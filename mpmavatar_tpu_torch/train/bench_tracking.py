"""Stage-1 tracking benchmark: one joint tracking iteration at production
scale through the port (port of the JAX package's bench_tracking.py).

The shape, from bench_tracking.py: a 144 x 142 body-scale UV sphere
(20,448 vertices, 40,612 faces, one gaussian each) as the tracked mesh,
its upper half (y > 0) the cloth of the collision penalty; a synthetic
rig at SMPL-X's 10,475 vertices and 22 joints (``make_test_rig``) whose
body pose VPoser decodes from a trainable latent inside the graph; one
1500 x 1000 view at f = 1400 with the camera at z = 2.6 against a seeded
random image and a full mask; ``TrackingConfig(tile_capacity=512)``, 160
cameras' colour calibration, the full loss stack and both Adams (the
mesh's per-leaf groups and the SMPL-X latent and betas).

    python -m mpmavatar_tpu_torch.train.bench_tracking
    python -m mpmavatar_tpu_torch.train.bench_tracking --work_cap 8192

``--work_cap 0`` (the default) renders through the rasterizer's tile
path, as the JAX bench does, and launches no kernel; ``--work_cap N``
renders through the worklist compositor (K6 forward and K7 backward,
twice each per iteration on the card).  Runs 2 warm-up iterations, then
``--iters`` timed ones through ``MeshTracker.fit_frame`` (which reads
each iteration's loss on the host), ending in a synchronize.  The last
line is one JSON object with the JAX bench's keys (steps/s, the
projected minutes per 3,000-iteration frame and hours for the first
frame's 10,000) and the device, ms per iteration, peak allocated bytes
and the rasterizer's overflow counts.  Runs on the CUDA device unless
``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import math
import time

import numpy as np
import torch

from .. import resolve_device
from ..avatar.smplx import make_test_rig
from ..avatar.vposer import init_vposer
from ..render.bench_render import build_body_mesh, look_down_z
from .tracking import MeshTracker, TrackingConfig

WARMUP = 2
METRIC = "tracking_steps_per_sec_1500x1000_40kfaces"


def build_tracking_problem(n_theta=144, n_phi=142, width=1500, height=1000,
                           seed=0, device=None, work_cap=0, rig=None,
                           vposer=None):
    """(tracker, [batch], number of faces) of the bench's joint fit.
    ``rig`` and ``vposer`` replace the seeded rig and decoder (a test
    passes the JAX package's, carried across by ``convert``)."""
    device = resolve_device(device)
    verts, faces = build_body_mesh(n_theta=n_theta, n_phi=n_phi)
    cloth_v_idx = np.where(verts[:, 1] > 0.0)[0].astype(np.int32)
    if rig is None:
        rig = make_test_rig(n_joints=22, n_verts=10475, seed=seed,
                            device=device)
    if vposer is None:
        vposer = init_vposer(torch.Generator().manual_seed(seed),
                             device=device)
    tracker = MeshTracker(verts, faces,
                          TrackingConfig(tile_capacity=512,
                                         work_cap=work_cap),
                          cloth_v_idx=cloth_v_idx, smplx_model=rig,
                          vposer=vposer,
                          smplx_faces=rig.faces.cpu().numpy(),
                          max_cams=160, device=device)
    zeros = lambda n: np.zeros((1, n), np.float32)
    tracker.set_smplx_frame({"latent": zeros(32), "trans": zeros(3),
                             "beta": zeros(5)}, is_initial=True)
    cam = look_down_z(width, height, 1400.0, 2.6, 0.1, 20.0)
    rng = np.random.default_rng(seed + 1)
    batch = {"cam": cam, "camera_idx": 0,
             "rgb": rng.random((3, height, width)).astype(np.float32),
             "msk": np.ones((1, height, width), np.float32)}
    return tracker, [batch], len(faces)


def run(iters=20, work_cap=0, device=None, **problem) -> dict:
    """Build the problem (``problem``: build_tracking_problem's shape
    keywords) and time it (``timed``); the result dict."""
    tracker, batches, n_faces = build_tracking_problem(
        device=device, work_cap=work_cap, **problem)
    return timed(tracker, batches, n_faces, iters)


def timed(tracker, batches, n_faces, iters, after_warmup=None) -> dict:
    """WARMUP iterations, then ``after_warmup()`` when given (a caller
    that counts the timed iterations' launches resets its counters
    there), then ``iters`` timed ones; the result dict."""
    device = tracker.device
    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    losses = tracker.fit_frame(batches, is_initial=True, iters=WARMUP)
    if not all(math.isfinite(v) for v in losses):
        raise RuntimeError(f"tracking warm-up loss is not finite: {losses}")
    sync()
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    if after_warmup is not None:
        after_warmup()
    t0 = time.perf_counter()
    losses = tracker.fit_frame(batches, is_initial=True, iters=iters)
    sync()
    wall = time.perf_counter() - t0
    if not all(math.isfinite(v) for v in losses):
        raise RuntimeError(f"tracking loss is not finite: {losses}")
    sps = iters / wall
    return {
        "metric": METRIC, "value": sps, "unit": "steps/s",
        "n_faces": n_faces,
        "projected_min_per_frame_3k_iters": 3000 / sps / 60.0,
        "projected_t0_hours_10k_iters": 10_000 / sps / 3600.0,
        "loss": losses[-1],
        "device": (torch.cuda.get_device_name(device) if cuda else "cpu"),
        "ms_per_iter": 1e3 * wall / iters, "iters": iters,
        "work_cap": tracker.cfg.work_cap,
        "peak_allocated_bytes": (torch.cuda.max_memory_allocated(device)
                                 if cuda else None),
        "work_overflow": int(tracker.stats["work_overflow"]),
        "big_overflow": int(tracker.stats["big_overflow"])}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--work_cap", type=int, default=0,
                    help="0: the tile path (the JAX bench's); > 0: the "
                    "worklist compositor (K6/K7)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the plain PyTorch path)")
    args = ap.parse_args(argv)
    result = run(args.iters, args.work_cap, args.device)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
