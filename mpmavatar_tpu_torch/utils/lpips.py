"""LPIPS perceptual distance (VGG16 backbone + linear heads), the port's
counterpart of mpmavatar_tpu/utils/lpips_jax.py.

The distance of the lpipsPyTorch modules: the inputs z-scored with the
published shift and scale, the relu outputs of VGG16's five stages
(relu1_2, relu2_2, relu3_3, relu4_3, relu5_3) each divided by its channel
norm plus 1e-10 (an additive eps, not a clamp), squared differences
weighted by bias-free 1x1 linear heads, averaged over the pixels and
summed over the stages, then averaged over the batch.

The backbone and head weights are trained artifacts that the repository
does not hold: ``load_weights_npz`` reads them from an npz in
``export_weights_npz``'s layout (13 convs ``conv{i}_w``/``conv{i}_b``,
5 heads ``lin{i}_w``), checked against ``expected_weight_schema``.
Without weights, ``make_lpips_fn`` warns and returns None, and callers
leave the LPIPS term out.  The convolutions are ``F.conv2d`` in full
float32 (the package turns TF32 off).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import resolve_device

# VGG16's convolutions up to relu5_3 ("M": a 2x2 max pool); the relu
# output of each conv index in _STAGE_ENDS is tapped
_VGG_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
            512, 512, 512, "M", 512, 512, 512]
_STAGE_ENDS = (1, 3, 6, 9, 12)

_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


def expected_weight_schema() -> Dict[str, tuple]:
    """Name -> shape of every array of the weights npz: 13 VGG16 convs
    (3x3, the channel ladder of _VGG_CFG) and 5 linear heads sized to the
    tapped stages."""
    schema = {}
    c_in = 3
    ci = 0
    stage_ch = {}
    for item in _VGG_CFG:
        if item == "M":
            continue
        schema[f"conv{ci}_w"] = (item, c_in, 3, 3)
        schema[f"conv{ci}_b"] = (item,)
        if ci in _STAGE_ENDS:
            stage_ch[ci] = item
        c_in = item
        ci += 1
    for i, end in enumerate(_STAGE_ENDS):
        schema[f"lin{i}_w"] = (1, stage_ch[end], 1, 1)
    return schema


def check_weights(arrays: Dict[str, np.ndarray], origin: str) -> None:
    """Raise ValueError naming ``origin`` when ``arrays`` has missing or
    extra keys, or a shape other than the schema's."""
    schema = expected_weight_schema()
    missing = sorted(set(schema) - set(arrays))
    extra = sorted(set(arrays) - set(schema))
    if missing or extra:
        raise ValueError(
            f"LPIPS weights npz {origin!r} does not match the expected "
            f"schema (export_weights_npz layout): missing={missing} "
            f"unexpected={extra}")
    bad = [f"{k}: got {tuple(arrays[k].shape)}, want {schema[k]}"
           for k in schema if tuple(arrays[k].shape) != schema[k]]
    if bad:
        raise ValueError(f"LPIPS weights npz {origin!r} has wrong shapes: "
                         + "; ".join(bad))


def load_weights_npz(path: str) -> Dict[str, np.ndarray]:
    """The arrays of a weights npz, checked against the schema (a
    mismatched file fails here, not inside the first forward)."""
    with np.load(path) as data:
        arrays = {k: data[k] for k in data.files}
    check_weights(arrays, path)
    return arrays


def export_weights_npz(out_path: str, vgg_state: Dict, lin_state: Dict):
    """Convert torch state dicts (torchvision's vgg16.features, keys
    ``<layer>.weight``/``<layer>.bias``, and the lpips linear heads) to
    the npz layout."""
    out = {}
    ci = 0
    for k in sorted(vgg_state, key=lambda s: int(s.split(".")[0])):
        if k.endswith("weight"):
            out[f"conv{ci}_w"] = np.asarray(vgg_state[k])
        elif k.endswith("bias"):
            out[f"conv{ci}_b"] = np.asarray(vgg_state[k])
            ci += 1
    for i, k in enumerate(sorted(lin_state)):
        out[f"lin{i}_w"] = np.asarray(lin_state[k]).reshape(1, -1, 1, 1)
    np.savez(out_path, **out)


class LPIPS(nn.Module):
    """``lpips(x, y)``: the LPIPS distance of two (B, 3, H, W) batches in
    [0, 1], a scalar (the mean over the batch).  The weights are buffers
    named as the npz keys; the distance is differentiable in x and y."""

    def __init__(self, arrays: Dict[str, np.ndarray], device=None):
        super().__init__()
        check_weights(arrays, "<arrays>")
        device = resolve_device(device)
        for k in expected_weight_schema():
            self.register_buffer(k, torch.as_tensor(
                np.asarray(arrays[k], np.float32), device=device))
        self.register_buffer("shift", torch.tensor(
            _SHIFT, device=device).reshape(1, 3, 1, 1))
        self.register_buffer("scale", torch.tensor(
            _SCALE, device=device).reshape(1, 3, 1, 1))

    def features(self, x):
        """The five tapped relu outputs of the z-scored ``x``."""
        x = (x - self.shift) / self.scale
        feats = []
        ci = 0
        for item in _VGG_CFG:
            if item == "M":
                x = F.max_pool2d(x, 2, 2)
            else:
                x = F.relu(F.conv2d(x, getattr(self, f"conv{ci}_w"),
                                    getattr(self, f"conv{ci}_b"),
                                    padding=1))
                if ci in _STAGE_ENDS:
                    feats.append(x)
                ci += 1
        return feats

    def forward(self, x, y):
        total = 0.0
        for i, (a, b) in enumerate(zip(self.features(x),
                                       self.features(y))):
            a = a / (torch.linalg.vector_norm(a, dim=1, keepdim=True)
                     + 1e-10)
            b = b / (torch.linalg.vector_norm(b, dim=1, keepdim=True)
                     + 1e-10)
            d = (a - b) ** 2
            w = getattr(self, f"lin{i}_w")
            total = total + torch.mean(torch.sum(d * w, dim=1),
                                       dim=(-1, -2))
        return torch.mean(total)


def make_lpips_fn(weights_path: Optional[str] = None, quiet: bool = False,
                  device=None) -> Optional[LPIPS]:
    """An LPIPS module on ``device`` (the CUDA device by default) from a
    weights npz, or None when no path is given.  The None case warns
    unless ``quiet``: the reference recipe trains with lambda_lpips *
    LPIPS, so running without it changes the objective."""
    if weights_path is None:
        if not quiet:
            import warnings
            warnings.warn(
                "LPIPS weights not supplied — the lambda_lpips term is "
                "DISABLED and the training/eval objective differs from "
                "the reference recipe. Supply --lpips_weights "
                "(export_weights_npz) to enable; PSNR/SSIM are "
                "unaffected.", stacklevel=2)
        return None
    return LPIPS(load_weights_npz(weights_path), device=device)
