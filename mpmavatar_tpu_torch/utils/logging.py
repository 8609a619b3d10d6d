"""Experiment logging: JSONL always, TensorBoard when
``torch.utils.tensorboard`` imports (port of
mpmavatar_tpu/utils/logging.py).

Replaces the reference's wandb/tensorboard plumbing
(train_appearance.py:171-240, train_material_params.py:684-712) with a
local JSONL log plus optional local TensorBoard summaries."""

from __future__ import annotations

import json
import os
import time
from typing import Dict


class RunLogger:
    def __init__(self, log_dir: str, use_tensorboard: bool = True):
        os.makedirs(log_dir, exist_ok=True)
        self.log_dir = log_dir
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        self._tb = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
                self._tb = SummaryWriter(log_dir)
            except ImportError:     # tensorboard is not installed
                self._tb = None

    def log(self, step: int, scalars: Dict[str, float],
            prefix: str = ""):
        rec = {"step": step, "time": time.time()}
        for k, v in scalars.items():
            name = f"{prefix}{k}"
            rec[name] = float(v)
            if self._tb is not None:
                self._tb.add_scalar(name, float(v), step)
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()

    def log_image(self, step: int, name: str, img):
        """img: (3, H, W) or (H, W) float in [0, 1], numpy or a tensor."""
        if self._tb is not None:
            import numpy as np
            if hasattr(img, "detach"):
                img = img.detach().cpu().numpy()
            arr = np.asarray(img)
            if arr.ndim == 2:
                arr = arr[None]
            self._tb.add_image(name, np.clip(arr, 0, 1), step)

    def close(self):
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
