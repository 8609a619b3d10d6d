"""Configuration of the port: the JAX package's ModelParams,
PipelineParams and OptimizationParams (mpmavatar_tpu/data/config.py),
with the same fields, names and defaults, reflected into argparse flags
as the JAX package reflects them (a bool is a ``store_true`` flag, a list
takes ``nargs="+"``).  A run's config is dumped to ``cfg_args.json``;
either package's file loads in the other.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from typing import List


@dataclasses.dataclass
class ModelParams:
    sh_degree: int = 3
    source_path: str = ""
    model_path: str = "./model/a1_s1"
    images: str = "images"
    resolution: int = -1
    camera_path: str = ""
    image_path: str = ""
    param_path: str = ""
    mesh_path: str = ""
    cloth_mesh_path: str = ""
    uv_path: str = "./data/a1_s1/a1s1_uv.obj"
    white_bkgd: bool = False
    smplx_gender: str = "neutral"
    eval: bool = False
    dataset_dir: str = "./data"
    dataset_type: str = "actorshq"
    actor: int = 1
    sequence: int = 1
    subject: int = 170
    train_take: int = 1
    test_take: int = 5
    image_downscale_ratio: float = 1.0
    test_camera_index: List[int] = dataclasses.field(
        default_factory=lambda: [6, 126])
    train_frame_start_num: List[int] = dataclasses.field(
        default_factory=lambda: [460, 1])
    test_frame_start_num: List[int] = dataclasses.field(
        default_factory=lambda: [460, 1])
    trained_model_path: str = "./output/tracking/a1_s1_460_200"
    verts_start_idx: int = 460
    init_params_path: str = ""
    random_init_params: bool = False
    init_D: float = 1.0
    init_E: float = 100.0
    min_D: float = 0.1
    max_D: float = 3.0
    min_E: float = 0.5
    max_E: float = 20.0
    min_H: float = 0.8
    max_H: float = 1.2
    split_idx_path: str = "./data/a1_s1/split_idx.npz"
    lbs_w: str = "optimized_weights"
    init_nu: float = 0.3
    init_gamma: float = 500.0
    init_kappa: float = 500.0
    mesh_friction_coeff: float = 0.5
    friction_angle: float = 40.0
    grid_size: int = 200
    substep: int = 400
    output_dir: str = ""


@dataclasses.dataclass
class PipelineParams:
    convert_SHs_python: bool = False
    compute_cov3D_python: bool = False
    debug: bool = False


@dataclasses.dataclass
class OptimizationParams:
    iterations: int = 30_000
    position_lr_init: float = 0.00004
    position_lr_final: float = 0.00004
    position_lr_delay_mult: float = 0.01
    position_lr_max_steps: int = 30_000
    verts_lr_init: float = 0.0
    verts_lr_final: float = 0.0
    verts_lr_delay_mult: float = 0.01
    verts_lr_max_steps: int = 30_000
    feature_lr: float = 0.0025
    opacity_lr: float = 0.05
    scaling_lr: float = 0.005
    rotation_lr: float = 0.001
    percent_dense: float = 0.01
    lambda_dssim: float = 0.2
    lambda_lpips: float = 0.2
    densification_interval: int = 100
    opacity_reset_interval: int = 3000
    densify_from_iter: int = 500
    densify_until_iter: int = 15_000
    densify_grad_threshold: float = 0.0002
    random_background: bool = False
    threshold_xyz: float = 1.0
    threshold_scale: float = 0.6
    laplacian_type: int = 1
    first_frame_verts_opt: bool = False
    lr: float = 1e-1
    lr_D: float = 1e-2
    lr_E: float = 3e-1
    lr_H: float = 1e-2
    log_iters: int = 1
    video_iters: int = 1
    visualize: bool = False
    seed: int = 0
    use_wandb: bool = False
    wandb_entity: str = "xxxx"
    wandb_project: str = "MPMAvatar"
    wandb_iters: int = 1
    wandb_name: str = ""
    save_name: str = ""


def add_dataclass_args(parser: argparse.ArgumentParser, cls, prefix=""):
    """One flag per field of ``cls``, ``--<prefix><name>``, defaulted as
    the field: a bool is a ``store_true`` flag, a list takes one or more
    values of its first element's type, anything else one value of the
    default's type."""
    for f in dataclasses.fields(cls):
        name = f"--{prefix}{f.name}"
        default = f.default if f.default is not dataclasses.MISSING else \
            f.default_factory()
        if isinstance(default, bool):
            parser.add_argument(name, action="store_true", default=default)
        elif isinstance(default, list):
            parser.add_argument(name, nargs="+",
                                type=type(default[0]) if default else int,
                                default=default)
        else:
            parser.add_argument(name, type=type(default), default=default)


def extract_dataclass(args: argparse.Namespace, cls, prefix=""):
    """``cls`` from the parsed flags of ``add_dataclass_args``."""
    return cls(**{f.name: getattr(args, f"{prefix}{f.name}")
                  for f in dataclasses.fields(cls)})


def dump_config(path: str, *cfgs):
    """The fields of ``cfgs``, merged, as one JSON object at ``path``."""
    merged = {}
    for c in cfgs:
        merged.update(dataclasses.asdict(c))
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(merged, f, indent=2)


def load_config(path: str, cls):
    """``cls`` from the JSON object at ``path`` (keys of other classes
    ignored, missing ones defaulted)."""
    with open(path) as f:
        data = json.load(f)
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in data.items() if k in names})
