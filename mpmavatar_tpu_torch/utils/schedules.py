"""Learning-rate schedules (the port's copy of
mpmavatar_tpu/utils/schedules.py; the reference's
utils/general_utils.py:31-100)."""

from __future__ import annotations

import numpy as np


def expon_lr_func(lr_init, lr_final, lr_delay_steps=0, lr_delay_mult=1.0,
                  max_steps=1000000):
    """Log-linear decay from lr_init to lr_final over max_steps, with an
    optional delayed warm start (Plenoxels)."""

    def helper(step):
        if step < 0 or (lr_init == 0.0 and lr_final == 0.0):
            return 0.0
        if lr_delay_steps > 0:
            delay_rate = lr_delay_mult + (1 - lr_delay_mult) * np.sin(
                0.5 * np.pi * np.clip(step / lr_delay_steps, 0, 1))
        else:
            delay_rate = 1.0
        t = np.clip(step / max_steps, 0, 1)
        log_lerp = np.exp(np.log(lr_init) * (1 - t) + np.log(lr_final) * t)
        return delay_rate * log_lerp

    return helper


def cosine_lr(lr_init, total_steps, eta_min=0.0):
    """CosineAnnealingLR: step -> eta_min + (lr_init - eta_min) (1 +
    cos(pi t)) / 2, t = step / total_steps clipped to [0, 1]."""

    def helper(step):
        t = np.clip(step / max(total_steps, 1), 0.0, 1.0)
        return eta_min + (lr_init - eta_min) * 0.5 * (1 + np.cos(np.pi * t))

    return helper
