"""The port's one-line benchmark (port of the JAX package's bench.py).

    python -m mpmavatar_tpu_torch.bench                    # every part
    python -m mpmavatar_tpu_torch.bench --headline_only    # sims + render
    python -m mpmavatar_tpu_torch.bench --grid 200 [--sand 100000]
    python -m mpmavatar_tpu_torch.bench --render

The default run prints, as its last line, one JSON object with the JAX
line's keys:
  metric, value, unit   mpm_substeps_per_sec_100k_particles_128grid: the
                        bench garment substep (sim/bench_scene.py: the
                        183 x 183 cloth, 99,737 particles, on the sphere
                        collider with the joint pin and the sticky floor)
                        at 128^3, timed by ``bench_scene.substeps_per_sec``
                        (2 warm-up frames, then 5 of 100 substeps);
  grid200_substeps_per_sec, grid250_100k_sand_substeps_per_sec
                        the same scene at 200^3, and at 250^3 with
                        100,000 sand particles;
  render_fps_1080p_50k  render/bench_render.py's ``splats`` scene (50,000
                        gaussians, 1920 x 1080): 1 warm-up frame, then 10;
  appearance_train_steps_per_sec_1500x1000_50k,
  projected_stage2_hours_30k_iters
                        train/bench_appearance.py at its shape: 1 warm-up
                        step, then 10;
  tracking_steps_per_sec, tracking_min_per_frame_3k_iters
                        train/bench_tracking.py at its defaults;
  material_grad_step_sec, material_grad_over_forward
                        train/stage3_production.py's bench (bench_material
                        at nx 183, 200^3, 1 frame x 400 substeps, a warm-up
                        step, then 2);
  peak_bytes            the largest allocated device memory of any part
                        (``torch.cuda.max_memory_allocated``; on the card
                        only).
``--headline_only`` skips the appearance, tracking and material parts;
``--grid G [--sand N]`` prints one line for that scene only; ``--render``
prints the render part's line (both 1080p scenes).  The parts' own JSON
lines come before the last.  Runs on the CUDA device unless ``--device``
names another.

Left out of the JAX line:
  vs_baseline   it divides by a speed target set for another accelerator;
                the port states no figure taken on or for one.
  --column_k, --row_cap, --radius, --no_auto_cap, --halo, --no_fused,
  --pallas      knobs of the JAX package's TPU layout (column bins, halo
                grid, adaptive row caps, fused Pallas kernels), which the
                port does not have: it runs its kernels on the dense grid.
  *_error keys  the JAX driver catches a part's failure and still exits 0;
                here a part that raises stops the run with a nonzero exit
                and prints no line.
"""

from __future__ import annotations

import argparse
import json

import torch

from . import resolve_device
from .render import bench_render
from .sim import bench_scene
from .train import bench_appearance, bench_tracking, stage3_production

METRIC = "mpm_substeps_per_sec_100k_particles_128grid"

# the shapes of every part; the CPU tests pass a cut copy to ``main``
FULL = {
    "sim": dict(nx=183, substeps=100),
    "grids": (128, 200, 250),
    "sand": 100_000,
    "render": dict(width=1920, height=1080, splats=50_000, frames=10),
    "appearance": dict(width=1500, height=1000, mesh="160x158",
                       work_cap=8192, steps=10),
    "tracking": dict(iters=20),
    "material": dict(nx=183, grid=200, substep=400, frames=1, reps=2),
}


def _rate(n: int, ms) -> float:
    """n per second over the times ``ms`` (milliseconds)."""
    return n / (sum(ms) / 1e3)


def render_part(device, shapes) -> dict:
    """Frames per second of the two 1080p splat scenes, after a warm-up
    frame each."""
    r = shapes["render"]
    fps = {}
    for scene in ("splats", "big_splats"):
        out = bench_render.main([
            "--scene", scene, "--frames", str(1 + r["frames"]),
            "--device", str(device), "--width", str(r["width"]),
            "--height", str(r["height"]), "--splats", str(r["splats"])])
        fps[scene] = _rate(r["frames"], out["frame_ms"][1:])
    return {"metric": "splat_render_fps_1080p_50k", "value": fps["splats"],
            "unit": "frames/s", "big_splat_fps": fps["big_splats"]}


def appearance_part(device, shapes) -> dict:
    a = shapes["appearance"]
    out = bench_appearance.main([
        "--steps", str(1 + a["steps"]), "--device", str(device),
        "--width", str(a["width"]), "--height", str(a["height"]),
        "--mesh", a["mesh"], "--work-cap", str(a["work_cap"])])
    sps = _rate(a["steps"], out["step_ms"][1:])
    return {"appearance_train_steps_per_sec_1500x1000_50k": sps,
            "projected_stage2_hours_30k_iters": 30_000 / sps / 3600.0}


def tracking_part(device, shapes) -> dict:
    out = bench_tracking.run(device=device, **shapes["tracking"])
    print(json.dumps(out))
    return {"tracking_steps_per_sec": out["value"],
            "tracking_min_per_frame_3k_iters":
                out["projected_min_per_frame_3k_iters"]}


def material_part(device, shapes) -> dict:
    out = stage3_production.run_bench(argparse.Namespace(
        device=device, **shapes["material"]))
    return {"material_grad_step_sec": out["ms_per_step"] / 1e3,
            "material_grad_over_forward": out["grad_over_forward"]}


def _peak(device) -> int:
    if device.type == "cuda":
        return torch.cuda.max_memory_allocated(device)
    return 0


def _device_keys(device) -> dict:
    if device.type == "cuda":
        return {"device": torch.cuda.get_device_name(device),
                "device_count": torch.cuda.device_count()}
    return {"device": "cpu", "device_count": 1}


def main(argv=None, shapes=FULL) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--grid", type=int, default=128,
                    help="grid resolution of a one-off sim line (200: "
                    "training, 250: the demo)")
    ap.add_argument("--sand", type=int, default=0,
                    help="sand particles of a one-off sim line")
    ap.add_argument("--render", action="store_true",
                    help="print the render part's line only")
    ap.add_argument("--headline_only", action="store_true",
                    help="skip the appearance, tracking and material parts")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the plain PyTorch path)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    if args.render:
        result = {**render_part(device, shapes), **_device_keys(device)}
    elif args.grid != 128 or args.sand:
        rate = bench_scene.substeps_per_sec(args.grid, args.sand, device,
                                            **shapes["sim"])
        result = {"metric": "mpm_substeps_per_sec_100k_particles_"
                  f"{args.grid}grid" + (f"_{args.sand}sand" if args.sand
                                        else ""),
                  "value": rate, "unit": "substeps/s",
                  **_device_keys(device)}
    else:
        g128, g200, g250 = shapes["grids"]
        sim = lambda g, s: bench_scene.substeps_per_sec(g, s, device,
                                                        **shapes["sim"])
        result = {"metric": METRIC, "value": sim(g128, 0),
                  "unit": "substeps/s",
                  "grid200_substeps_per_sec": sim(g200, 0),
                  "grid250_100k_sand_substeps_per_sec": sim(
                      g250, shapes["sand"]),
                  "render_fps_1080p_50k": render_part(device,
                                                      shapes)["value"]}
        # the tracking and material parts reset the peak to their own
        peak = _peak(device)
        if not args.headline_only:
            for part in (appearance_part, tracking_part, material_part):
                result.update(part(device, shapes))
                peak = max(peak, _peak(device))
        if device.type == "cuda":
            result["peak_bytes"] = peak
        result.update(_device_keys(device))
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
