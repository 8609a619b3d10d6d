"""Stage-3 material estimation and the stage-4 evaluation from the
command line (scripts/train_material.py):

    python -m mpmavatar_tpu_torch.train.train_material \\
        --tracked_verts_npz train.npz [--config cfg.json] [--device cpu]
    python -m mpmavatar_tpu_torch.train.train_material \\
        --tracked_verts_npz train.npz --run_eval [--skip_sim] \\
        [--skip_render] [--skip_video] --dataset_dir DATA \\
        --trained_model_path TRACKED --uv_path uv.obj --model_path AVATAR

The npz holds train_verts (F+1, V, 3), smplx_verts (F+1, Vb, 3),
smplx_faces, cloth_faces, first_frame_verts, num_joint_v and
num_joint_f.  ``--config`` names a JSON file whose values become the
flags' defaults (explicit flags still override).  Each step prints its
loss and parameters; every ``--log_iters`` steps the best and last
parameters are written to ``--output_dir`` (default
./output/material).

With ``--run_eval`` it trains nothing: it simulates the test sequence
(the npz named like ``--tracked_verts_npz`` with "train" replaced by
"test") at the trainer's parameters into ``<output_dir>/uvmesh/%03d.obj``
(merged with the tracked human layer when the npz has ``human_verts``,
``cloth_v_idx`` and ``human_v_idx``), then bakes AO and renders the
held-out cameras with the newest avatar checkpoint under
``<model_path>/point_cloud`` (``train/evaluate.py::render_eval_sequence``)
into ``<output_dir>``, the tree that ``train/eval_metrics.py`` reads.
``--skip_sim`` reuses the meshes, ``--skip_render`` stops after them,
``--skip_video`` writes no videos.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from ..data import (ModelParams, OptimizationParams, add_dataclass_args,
                    extract_dataclass)
from .material import MaterialTrainer, MaterialTrainerConfig


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_dataclass_args(parser, ModelParams)
    add_dataclass_args(parser, OptimizationParams)
    parser.add_argument("--config", type=str, default=None,
                        help="JSON file whose values become flag defaults")
    parser.add_argument("--run_eval", action="store_true")
    parser.add_argument("--skip_sim", action="store_true",
                        help="eval: reuse the existing uvmesh/*.obj")
    parser.add_argument("--skip_render", action="store_true",
                        help="eval: stop after the simulation")
    parser.add_argument("--skip_video", action="store_true")
    parser.add_argument("--tracked_verts_npz", type=str, required=True)
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA device)")
    pre, _ = parser.parse_known_args(argv)
    if pre.config:
        with open(pre.config) as f:
            overrides = json.load(f)
        known = {a.dest for a in parser._actions}
        bad = sorted(set(overrides) - known)
        if bad:
            parser.error(f"unknown config keys in {pre.config}: {bad}")
        parser.set_defaults(**overrides)
    return parser.parse_args(argv)


def run_eval(args, cfg, trainer, cloth_faces, out_dir: str) -> None:
    """The stage-4 evaluation of ``--run_eval`` (see the module
    docstring) on the trainer's device."""
    from ..utils.io import write_obj
    mesh_dir = os.path.join(out_dir, "uvmesh")
    with np.load(args.tracked_verts_npz.replace("train", "test")) as f:
        test = {k: f[k] for k in f.files}
    if not args.skip_sim:
        verts0 = test["train_verts"][0]
        velo0 = (test["train_verts"][1] - test["train_verts"][0]) * 25.0
        smplx = test["smplx_verts"]
        smplx_velo = (smplx[1:] - smplx[:-1]) * 25.0
        frames = trainer.simulate(verts0, velo0, smplx[:-1], smplx_velo,
                                  n_frames=len(smplx) - 1)
        frames = [test["train_verts"][0]] + frames
        os.makedirs(mesh_dir, exist_ok=True)
        layered = "human_verts" in test and "cloth_v_idx" in test
        for i, v in enumerate(frames):
            if layered:
                full = np.zeros((len(test["cloth_v_idx"])
                                 + len(test["human_v_idx"]), 3), np.float32)
                full[np.asarray(test["cloth_v_idx"])] = v
                full[np.asarray(test["human_v_idx"])] = \
                    test["human_verts"][i]
                v = full
            write_obj(os.path.join(mesh_dir, f"{i:03d}.obj"), v,
                      cloth_faces)
        print(f"wrote {len(frames)} simulated meshes to {mesh_dir}",
              flush=True)
    if args.skip_render:
        return
    from ..data import Scene
    from ..render.avatar_model import (load_avatar_checkpoint,
                                       load_mesh_avatar)
    from .evaluate import render_eval_sequence
    scene = Scene(cfg, return_type="image")
    avatar, params = load_mesh_avatar(cfg.trained_model_path, cfg.uv_path,
                                      sh_degree=cfg.sh_degree,
                                      device=trainer.device)
    ckpt = os.path.join(cfg.model_path, "point_cloud")
    if os.path.isdir(ckpt):
        latest = sorted(os.listdir(ckpt))[-1]
        params = load_avatar_checkpoint(os.path.join(ckpt, latest), params)
    render_eval_sequence(avatar, params, scene, mesh_dir, out_dir,
                         cfg.uv_path, active_sh_degree=cfg.sh_degree,
                         skip_video=args.skip_video)
    print(f"eval renders written under {out_dir}", flush=True)


def main(argv=None) -> int:
    args = parse_args(argv)
    cfg = extract_dataclass(args, ModelParams)
    opt = extract_dataclass(args, OptimizationParams)
    data = np.load(args.tracked_verts_npz)
    mt_cfg = MaterialTrainerConfig(
        grid_size=cfg.grid_size, substep=cfg.substep,
        init_D=cfg.init_D, init_E=cfg.init_E, init_nu=cfg.init_nu,
        init_gamma=cfg.init_gamma, init_kappa=cfg.init_kappa,
        friction_angle=cfg.friction_angle,
        mesh_friction_coeff=cfg.mesh_friction_coeff,
        min_D=cfg.min_D, max_D=cfg.max_D, min_E=cfg.min_E, max_E=cfg.max_E,
        min_H=cfg.min_H, max_H=cfg.max_H,
        lr_D=opt.lr_D, lr_E=opt.lr_E, lr_H=opt.lr_H,
        iterations=opt.iterations)
    trainer = MaterialTrainer(
        mt_cfg, data["cloth_faces"], data["first_frame_verts"],
        data["train_verts"], data["smplx_verts"], data["smplx_faces"],
        int(data["num_joint_v"]), int(data["num_joint_f"]),
        device=args.device)
    out_dir = cfg.output_dir or "./output/material"
    if args.run_eval:
        run_eval(args, cfg, trainer, data["cloth_faces"], out_dir)
        return 0
    for it in range(opt.iterations):
        loss, p = trainer.train_one_step()
        print(f"step {it} loss {loss:.6f} D {p['D']:.3f} "
              f"E {p['E'] * 100:.1f} H {p['H']:.3f}", flush=True)
        if it % opt.log_iters == opt.log_iters - 1:
            trainer.save(out_dir)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

