"""Configuration of the port's training stages: the fields of
mpmavatar_tpu/data/config.py's ModelParams and OptimizationParams that
stage-2 appearance training (the train step, the optimizer and the
densification loop) and stage-3 material training read, with the same
names and defaults (``lambda_lpips`` is left out with the LPIPS term),
and the same reflection of a dataclass into argparse flags."""

from __future__ import annotations

import argparse
import dataclasses


@dataclasses.dataclass
class ModelParams:
    init_D: float = 1.0
    init_E: float = 100.0
    min_D: float = 0.1
    max_D: float = 3.0
    min_E: float = 0.5
    max_E: float = 20.0
    min_H: float = 0.8
    max_H: float = 1.2
    init_nu: float = 0.3
    init_gamma: float = 500.0
    init_kappa: float = 500.0
    mesh_friction_coeff: float = 0.5
    friction_angle: float = 40.0
    grid_size: int = 200
    substep: int = 400
    output_dir: str = ""


@dataclasses.dataclass
class OptimizationParams:
    iterations: int = 30_000
    position_lr_init: float = 0.00004
    verts_lr_init: float = 0.0
    feature_lr: float = 0.0025
    opacity_lr: float = 0.05
    scaling_lr: float = 0.005
    rotation_lr: float = 0.001
    percent_dense: float = 0.01
    lambda_dssim: float = 0.2
    densification_interval: int = 100
    opacity_reset_interval: int = 3000
    densify_from_iter: int = 500
    densify_until_iter: int = 15_000
    densify_grad_threshold: float = 0.0002
    threshold_xyz: float = 1.0
    threshold_scale: float = 0.6
    lr_D: float = 1e-2
    lr_E: float = 3e-1
    lr_H: float = 1e-2
    log_iters: int = 1


def add_dataclass_args(parser: argparse.ArgumentParser, cls, prefix=""):
    """One flag per field of ``cls``, ``--<prefix><name>``, typed and
    defaulted as the field."""
    for f in dataclasses.fields(cls):
        parser.add_argument(f"--{prefix}{f.name}", type=type(f.default),
                            default=f.default)


def extract_dataclass(args: argparse.Namespace, cls, prefix=""):
    """``cls`` from the parsed flags of ``add_dataclass_args``."""
    return cls(**{f.name: getattr(args, f"{prefix}{f.name}")
                  for f in dataclasses.fields(cls)})
