"""Optimization knobs of stage-2 appearance training, the port's copy of
the fields of mpmavatar_tpu/data/config.py::OptimizationParams that the
train step, the optimizer and the densification loop read (same names and
defaults; ``lambda_lpips`` is left out with the LPIPS term)."""

from __future__ import annotations

import dataclasses


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
