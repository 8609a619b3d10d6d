"""Stage-2 appearance training from the command line, the port's
counterpart of scripts/train_appearance.py:

    python -m mpmavatar_tpu_torch.train.train_appearance \\
        --dataset_dir DATA --trained_model_path TRACKED --uv_path uv.obj \\
        --model_path OUT [--work_cap 8192] [--preload_device] \\
        [--lpips_weights lpips.npz] [--device cpu]

Every ModelParams, OptimizationParams and PipelineParams field is a flag,
as in the JAX script, plus ``--lpips_weights``, ``--test_iterations``,
``--tile_capacity``, ``--work_cap`` (0: the tile path; > 0: the worklist
compositor, K6 forward and K7 backward on the card) and
``--preload_device`` (each (camera, frame) image moved to the device
once, on first use).  The loop is the JAX script's: the active SH degree
raised every 1,000 iterations (with a rebuilt step), densification in its
window, opacity resets, a log line every 100 iterations with an overflow
warning, held-out evaluations at ``--test_iterations`` and checkpoints at
iteration 7,000 and at the last one, under
``<model_path>/point_cloud/timestep_%06d``.  The (camera, frame) draws come
from ``np.random.default_rng(seed)`` as in the JAX script, so both draw
the same sequence.  ``train`` runs the loop and returns its log.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from .. import resolve_device
from ..data import (ModelParams, OptimizationParams, PipelineParams, Scene,
                    add_dataclass_args, dump_config, extract_dataclass)
from ..render import camera_arrays
from ..render import gaussians as G
from ..render.avatar_model import load_mesh_avatar, save_avatar_checkpoint
from ..utils.lpips import make_lpips_fn
from .appearance import evaluate_appearance, make_optimizer, make_train_step

MIN_OPACITY = 0.005
CHECKPOINT_ITER = 7000


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_dataclass_args(parser, ModelParams)
    add_dataclass_args(parser, OptimizationParams)
    add_dataclass_args(parser, PipelineParams)
    parser.add_argument("--lpips_weights", type=str, default=None,
                        help="npz of LPIPS VGG weights; enables the "
                        "lambda_lpips term and the test LPIPS")
    parser.add_argument("--test_iterations", type=int, nargs="+",
                        default=[7000, 30000])
    parser.add_argument("--tile_capacity", type=int, default=512)
    parser.add_argument("--work_cap", type=int, default=0,
                        help="worklist-compositor capacity (0: the tile "
                        "path)")
    parser.add_argument("--preload_device", action="store_true",
                        help="keep each (camera, frame) image on the "
                        "device after its first draw")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA device)")
    return parser.parse_args(argv)


def _draw(ds, rng: np.random.Generator) -> tuple:
    """A (camera, frame) index pair, drawn as the datasets' ``sample``."""
    return (int(rng.integers(len(ds.camera_list))),
            int(rng.integers(len(ds.frame_index))))


def _load_on(ds, i: int, j: int, device) -> dict:
    b = dict(ds.load_frame(i, j))
    b["rgb"] = torch.as_tensor(b["rgb"], device=device)
    b["msk"] = torch.as_tensor(b["msk"], device=device)
    return b


def sample_batch(ds, rng: np.random.Generator, device) -> dict:
    """One (camera, frame) draw of ``ds`` with its rgb and mask on
    ``device``."""
    return _load_on(ds, *_draw(ds, rng), device)


class DeviceCachedDataset:
    """``sample`` with each (camera, frame)'s rgb and mask moved to the
    device once, on its first draw, and served from there after."""

    def __init__(self, base, device):
        self.base = base
        self.device = device
        self._cache = {}

    def sample(self, rng: np.random.Generator) -> dict:
        key = _draw(self.base, rng)
        if key not in self._cache:
            self._cache[key] = _load_on(self.base, *key, self.device)
        return self._cache[key]


def train(args, device=None) -> dict:
    """The stage-2 loop of the parsed flags ``args`` on ``device`` (the
    CUDA device unless given).

    Returns the log: ``draws`` [(camera_idx, frame_idx)] per iteration,
    ``loss`` and ``l1`` per iteration, ``logs`` (the lines printed every
    100 iterations, as dicts), ``tests`` (iteration and metrics of each
    held-out evaluation), ``densify`` (iteration and alive splats after
    each pass), ``checkpoints`` (paths), ``alive`` at the end, and the
    largest rasterizer overflows seen (``big_overflow``,
    ``work_overflow``), with ``avatar`` and ``params``."""
    device = resolve_device(device)
    cfg = extract_dataclass(args, ModelParams)
    opt = extract_dataclass(args, OptimizationParams)
    lpips_fn = make_lpips_fn(args.lpips_weights, device=device)

    scene = Scene(cfg, return_type="image")
    avatar, params = load_mesh_avatar(cfg.trained_model_path, cfg.uv_path,
                                      sh_degree=cfg.sh_degree, device=device)
    spatial_lr_scale = scene.train_dataset.scene_radius
    optimizer = make_optimizer(opt, spatial_lr_scale, params)

    os.makedirs(cfg.model_path, exist_ok=True)
    dump_config(os.path.join(cfg.model_path, "cfg_args.json"), cfg, opt)

    rng = np.random.default_rng(opt.seed)
    ds = scene.train_dataset
    if args.preload_device:
        ds = DeviceCachedDataset(ds, device)
    active_sh = 0
    step = None
    densify_state = G.init_densify_state(params.splats.capacity, device)
    num_faces = len(avatar.faces)
    log = {"draws": [], "loss": [], "l1": [], "logs": [], "tests": [],
           "densify": [], "checkpoints": [], "big_overflow": 0,
           "work_overflow": 0}
    overflow = torch.zeros(2, dtype=torch.int64, device=device)
    for it in range(opt.iterations):
        if it % 1000 == 0 and active_sh < cfg.sh_degree:
            active_sh += 1
            step = None
        if step is None:
            step = make_train_step(avatar, opt, optimizer, active_sh,
                                   cfg.white_bkgd, lpips_fn=lpips_fn,
                                   tile_capacity=args.tile_capacity,
                                   work_cap=args.work_cap)
        batch = ds.sample(rng) if args.preload_device else \
            sample_batch(ds, rng, device)
        cam = batch["cam"]
        t = batch["frame_idx"]
        log["draws"].append((batch["camera_idx"], t))
        loss, aux = step(params, t, batch["camera_idx"],
                         camera_arrays(cam, device), batch["rgb"],
                         batch["msk"], avatar.tensor("ao_maps", device)[t],
                         cam.image_width, cam.image_height)
        log["loss"].append(loss)
        log["l1"].append(aux["l1"])
        overflow = torch.maximum(overflow, torch.stack(
            [aux["big_overflow"], aux["work_overflow"]]).to(torch.int64))
        if opt.densify_from_iter <= it < opt.densify_until_iter:
            cap = params.splats.capacity
            with torch.no_grad():
                densify_state = G.add_densification_stats(
                    densify_state, aux["vgrad"], aux["radii"][:cap],
                    aux["visible"][:cap])
                if it % opt.densification_interval == 0 and it > 0:
                    # a 20 px screen-size threshold after the first
                    # opacity reset
                    size_thr = 20.0 if it > opt.opacity_reset_interval \
                        else None
                    frames = avatar.frames_for_verts(
                        avatar.select_verts(params, t))
                    splats, densify_state = G.densify_and_prune(
                        params.splats, densify_state, frames, num_faces,
                        opt.densify_grad_threshold, MIN_OPACITY,
                        scene.train_dataset.scene_radius,
                        percent_dense=opt.percent_dense,
                        generator=torch.Generator(device).manual_seed(it),
                        max_screen_size=size_thr)
                    G.copy_into(params.splats, splats)
                    log["densify"].append(
                        {"iter": it,
                         "alive": int(params.splats.alive.sum())})
                if (it % opt.opacity_reset_interval == 0 and it > 0) or (
                        cfg.white_bkgd and it == opt.densify_from_iter):
                    # white-background runs reset once more at the
                    # densification start
                    G.copy_into(params.splats,
                                G.reset_opacity(params.splats))
        if it % 100 == 0:
            line = {"iter": it, "loss": float(loss), "l1": float(aux["l1"]),
                    "lpips": float(aux["lpips"]),
                    "alive": int(params.splats.alive.sum()),
                    "big_overflow": int(aux["big_overflow"]),
                    "work_overflow": int(aux["work_overflow"])}
            log["logs"].append(line)
            msg = (f"iter {it} loss {line['loss']:.5f} l1 {line['l1']:.5f} "
                   f"lpips {line['lpips']:.5f} alive {line['alive']}")
            if line["big_overflow"] or line["work_overflow"]:
                msg += (f"  WARNING rasterizer overflow "
                        f"big={line['big_overflow']} "
                        f"work={line['work_overflow']} — raise capacities")
            print(msg, flush=True)
        if (it + 1) in args.test_iterations:
            metrics = evaluate_appearance(
                avatar, params, scene.test_dataset, scene.test_camera_index,
                active_sh, cfg.white_bkgd, lpips_fn=lpips_fn)
            log["tests"].append({"iter": it + 1, **metrics})
            print(f"[iter {it + 1}] test "
                  + " ".join(f"{k} {v:.5f}" for k, v in metrics.items()),
                  flush=True)
        if it in (CHECKPOINT_ITER, opt.iterations - 1):
            out = os.path.join(cfg.model_path, "point_cloud",
                               f"timestep_{it:06d}")
            save_avatar_checkpoint(out, params, avatar)
            log["checkpoints"].append(out)
            print("saved", out, flush=True)
    if log["loss"]:
        log["loss"] = torch.stack(log["loss"]).tolist()
        log["l1"] = torch.stack(log["l1"]).tolist()
    log["big_overflow"], log["work_overflow"] = overflow.tolist()
    log["alive"] = int(params.splats.alive.sum())
    log["avatar"], log["params"] = avatar, params
    return log


def main(argv=None) -> int:
    args = parse_args(argv)
    train(args, device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
