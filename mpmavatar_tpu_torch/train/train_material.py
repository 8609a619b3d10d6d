"""Stage-3 material estimation from the command line (the training path of
scripts/train_material.py):

    python -m mpmavatar_tpu_torch.train.train_material \\
        --tracked_verts_npz train.npz [--config cfg.json] [--device cpu]

The npz holds train_verts (F+1, V, 3), smplx_verts (F+1, Vb, 3),
smplx_faces, cloth_faces, first_frame_verts, num_joint_v and
num_joint_f.  ``--config`` names a JSON file whose values become the
flags' defaults (explicit flags still override).  Each step prints its
loss and parameters; every ``--log_iters`` steps the best and last
parameters are written to ``--output_dir`` (default
./output/material).
"""

from __future__ import annotations

import argparse
import json

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
    for it in range(opt.iterations):
        loss, p = trainer.train_one_step()
        print(f"step {it} loss {loss:.6f} D {p['D']:.3f} "
              f"E {p['E'] * 100:.1f} H {p['H']:.3f}", flush=True)
        if it % opt.log_iters == opt.log_iters - 1:
            trainer.save(out_dir)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
