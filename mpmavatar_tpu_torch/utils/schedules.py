"""Learning-rate schedules (the port's copy of
mpmavatar_tpu/utils/schedules.py::cosine_lr)."""

from __future__ import annotations

import numpy as np


def cosine_lr(lr_init, total_steps, eta_min=0.0):
    """CosineAnnealingLR: step -> eta_min + (lr_init - eta_min) (1 +
    cos(pi t)) / 2, t = step / total_steps clipped to [0, 1]."""

    def helper(step):
        t = np.clip(step / max(total_steps, 1), 0.0, 1.0)
        return eta_min + (lr_init - eta_min) * 0.5 * (1 + np.cos(np.pi * t))

    return helper
