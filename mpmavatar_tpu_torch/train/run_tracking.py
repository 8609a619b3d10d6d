"""Stage-1 mesh tracking CLI, port of scripts/run_tracking.py: fits the
template mesh to every frame of a multi-view capture read by
``data.Scene`` and writes params_{t}.npz per frame (the layout
``render/avatar_model.py::load_mesh_avatar`` reads).

``--work_cap`` > 0 renders through the worklist compositor (K6 and K7 on
the card); 0 (the default) is the JAX script's tile path.  Runs on the
CUDA device; ``--device cpu`` runs the plain PyTorch path.

    python -m mpmavatar_tpu_torch.train.run_tracking \\
        --dataset_dir CAPTURE --template_obj CAPTURE/meshes/Frame000000.obj \\
        --out_dir output/tracking --work_cap 8192
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

from .. import resolve_device
from ..data.config import ModelParams, add_dataclass_args, extract_dataclass
from ..data.datasets import Scene
from ..utils.io import read_obj
from ..utils.metrics import sample_mesh_surface
from .tracking import MeshTracker, TrackingConfig


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    add_dataclass_args(parser, ModelParams)
    parser.add_argument("--template_obj", required=True)
    parser.add_argument("--cloth_obj", default=None)
    parser.add_argument("--out_dir", required=True)
    parser.add_argument("--iters_first", type=int, default=10000)
    parser.add_argument("--iters_rest", type=int, default=3000)
    parser.add_argument("--cams_per_iter", type=int, default=1)
    parser.add_argument("--resume", action="store_true",
                        help="resume from params_{resume_t}.npz in out_dir")
    parser.add_argument("--resume_t", type=int, default=0)
    parser.add_argument("--smplx_model_npz", default=None,
                        help="fit SMPL-X jointly through the collision "
                        "penalty (VPoser latent per frame, betas at t0)")
    parser.add_argument("--smplx_param_dir", default=None,
                        help="per-frame initial SMPL-X fits ({t:06d}.npz)")
    parser.add_argument("--vposer_ckpt", default=None,
                        help="VPoser TR00_E096.pt checkpoint")
    parser.add_argument("--work_cap", type=int, default=0,
                        help="phase-2 worklist capacity of the rasterizer "
                        "(0: the tile path)")
    parser.add_argument("--device", default=None,
                        help="default: the CUDA device")
    return parser


def main(argv=None, log=print) -> dict:
    """Run the CLI; returns {t: the frame's losses} and the per-frame
    wall times (s) under "seconds"."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    cfg = extract_dataclass(args, ModelParams)

    ds = Scene(cfg, return_type="image").train_dataset
    verts, faces = read_obj(args.template_obj)
    cloth_v_idx = None
    if args.cloth_obj and os.path.exists(args.cloth_obj):
        _, cloth_faces = read_obj(args.cloth_obj)
        cloth_v_idx = np.unique(cloth_faces.reshape(-1))

    smplx_model = vposer = smplx_faces = None
    if args.smplx_model_npz:
        from ..avatar.smplx import load_smplx_npz
        smplx_model = load_smplx_npz(args.smplx_model_npz, device=device)
        smplx_faces = smplx_model.faces.cpu().numpy()
        if args.vposer_ckpt:
            from ..avatar.vposer import load_vposer_torch
            vposer = load_vposer_torch(args.vposer_ckpt, device=device)

    tcfg = TrackingConfig(iters_first=args.iters_first,
                          iters_rest=args.iters_rest, work_cap=args.work_cap)
    tracker = MeshTracker(verts, faces, tcfg, cloth_v_idx=cloth_v_idx,
                          max_cams=len(ds.camera_list),
                          scene_radius=ds.scene_radius,
                          smplx_model=smplx_model, vposer=vposer,
                          smplx_faces=smplx_faces, device=device)
    os.makedirs(args.out_dir, exist_ok=True)

    start_t = args.resume_t if args.resume else 0
    if args.resume:
        tracker.resume(args.out_dir, 0, args.resume_t)
        log(f"resumed from timestep {args.resume_t}")

    def load_smplx_param(t):
        path = os.path.join(args.smplx_param_dir, f"{t:06d}.npz")
        return dict(np.load(path))

    result = {"seconds": {}}
    prev_smplx_param = None
    for t in range(start_t, len(ds.frame_index)):
        t0 = time.perf_counter()
        batches = [ds.load_frame(ci, t) for ci in range(len(ds.camera_list))]
        is_initial = t == start_t
        if not is_initial:
            tracker.initialize_per_timestep()
        if smplx_model is not None and args.smplx_param_dir:
            param_t = load_smplx_param(t)
            if prev_smplx_param is not None:
                tracker.repose_human(prev_smplx_param, param_t)
            tracker.set_smplx_frame(param_t, is_initial)
            losses = tracker.fit_frame(batches, is_initial=is_initial)
            prev_smplx_param = tracker.finish_smplx_frame(is_initial)
            np.savez(os.path.join(args.out_dir, f"smplx_{t:06d}.npz"),
                     **{k: v.detach().cpu().numpy()
                        for k, v in prev_smplx_param.items()})
        else:
            # the body surface for the collision penalty: the current
            # template, without an SMPL-X fit
            body_pts, body_normals = sample_mesh_surface(
                tracker.params["vertices"].detach().cpu().numpy(), faces,
                count=4096, seed=t)
            losses = tracker.fit_frame(batches, body_pts, body_normals,
                                       is_initial=is_initial)
        tracker.save_frame(os.path.join(args.out_dir, f"params_{t}.npz"), t)
        result[t] = losses
        result["seconds"][t] = time.perf_counter() - t0
        overflow = {k: int(v) for k, v in tracker.stats.items()
                    if k.endswith("overflow")}
        log(f"frame {t}: loss {losses[-1]:.5f}"
            + (f", overflow {overflow}" if any(overflow.values()) else ""))
    return result


if __name__ == "__main__":
    main()
