"""Quasi-shadow UNet, port of mpmavatar_tpu/render/shadow.py.

Maps (AO map - mean AO) to a sigmoid shadow map in UV space through
weight-normalised 3x3 convolutions with untied biases (``n_dims=4`` for
the avatar).  Parameters are a dict of tensors with the JAX package's
names and layouts (OIHW kernels, NCHW activations), so ``convert.py``
carries them across as they are.

Resizing is half-pixel-centre bilinear, as ``jax.image.resize`` computes
it: antialiased when it shrinks (the encoder's 2x steps), plain bilinear
when it grows (``F.interpolate`` with ``antialias=True`` is both).
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from .. import resolve_device


def _conv2d(x, w):
    """NCHW conv, 3x3, stride 1, SAME padding."""
    return F.conv2d(x, w, padding=1)


def _wn(params, name):
    """Weight-normalised kernel: g * v / ||v||."""
    v = params[f"{name}_v"]
    g = params[f"{name}_g"]
    norm = torch.sqrt(torch.sum(v * v, dim=(1, 2, 3), keepdim=True) + 1e-12)
    return v * (g / norm)


def _leaky(x, slope=0.2):
    return torch.where(x >= 0, x, slope * x)


def _resize(x, hw):
    return F.interpolate(x, size=tuple(hw), mode="bilinear",
                         align_corners=False, antialias=True)


def init_shadow_unet(seed: int, ao_mean: np.ndarray, uv_size: int = 256,
                     shadow_size: int = 256, n_dims: int = 4,
                     lrelu_slope: float = 0.2, beta: float = 1.0,
                     device=None) -> Dict:
    """The parameter dict: Kaiming-uniform v with the lrelu gain, g =
    ||v|| per output channel, untied biases zero.  The weights come from
    a ``torch.Generator`` seeded with ``seed`` (not the JAX package's
    draws: carry those across with ``convert.py``)."""
    device = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    sizes = [shadow_size // (2 ** i) for i in range(4)]
    enc_dims = [(1, n_dims)] + [(n_dims, n_dims)] * 3
    dec_dims = [(n_dims, n_dims)] + [(n_dims * 2, n_dims)] * 3

    ao = torch.as_tensor(np.asarray(ao_mean, np.float32))
    params = {"ao_mean": ao.reshape(1, 1, *ao.shape[-2:]),
              "beta": torch.tensor(beta, dtype=torch.float32)}
    if params["ao_mean"].shape[-2:] != (shadow_size, shadow_size):
        params["ao_mean"] = _resize(params["ao_mean"],
                                    (shadow_size, shadow_size))

    def init_conv(name, n_in, n_out, size, gain_slope, untied_bias=True):
        fan_in = n_in * 9
        gain = math.sqrt(2.0 / (1.0 + gain_slope ** 2))
        bound = gain * math.sqrt(3.0 / fan_in)
        v = (torch.rand((n_out, n_in, 3, 3), generator=gen) * 2.0 - 1.0) \
            * bound
        params[f"{name}_v"] = v
        params[f"{name}_g"] = torch.sqrt(torch.sum(v * v, dim=(1, 2, 3),
                                                   keepdim=True))
        bias_hw = (size, size) if untied_bias else (1, 1)
        params[f"{name}_b"] = torch.zeros((1, n_out, *bias_hw))

    for i, (n_in, n_out) in enumerate(enc_dims):
        init_conv(f"enc{i}", n_in, n_out, sizes[i], lrelu_slope)
    for i, (n_in, n_out) in enumerate(dec_dims):
        init_conv(f"dec{i}", n_in, n_out, sizes[-i - 1], lrelu_slope)
    init_conv("pred", n_dims, 1, sizes[0], 1.0, untied_bias=False)
    return {k: v.to(device) for k, v in params.items()}


def shadow_unet_apply(params: Dict, ao_map, lrelu_slope: float = 0.2,
                      uv_size: int = 256) -> Dict:
    """Forward pass.  ao_map: (B, 1, H, W); the shadow size is that of
    the stored mean-AO buffer."""
    shadow_size = params["ao_mean"].shape[-1]
    sizes = [shadow_size // (2 ** i) for i in range(4)]

    if ao_map.shape[-2:] != (shadow_size, shadow_size):
        ao_map = _resize(ao_map, (shadow_size, shadow_size))
    x = ao_map - params["ao_mean"]

    enc_acts = []
    for i in range(4):
        x = _leaky(_conv2d(x, _wn(params, f"enc{i}")) + params[f"enc{i}_b"],
                   lrelu_slope)
        enc_acts.append(x)
        if i < 3:
            x = _resize(x, (sizes[i + 1], sizes[i + 1]))

    for i in range(4):
        if i > 0:
            x_prev = enc_acts[-i - 1]
            x = _resize(x, x_prev.shape[-2:])
            x = torch.cat([x, x_prev], dim=1)
        x = _leaky(_conv2d(x, _wn(params, f"dec{i}")) + params[f"dec{i}_b"],
                   lrelu_slope)

    low = torch.sigmoid(_conv2d(x, _wn(params, "pred")) + params["pred_b"]
                        + params["beta"])
    shadow_map = _resize(low, (uv_size, uv_size))
    return {"shadow_map": shadow_map, "ao_map": ao_map,
            "shadow_map_lowres": low}


def grid_sample_bilinear(img, uv):
    """F.grid_sample(align_corners=False, bilinear, zeros padding) for UV
    lookups, written out as the JAX package writes it.

    img: (C, H, W); uv: (N, 2) in [-1, 1].  Returns (N, C)."""
    _, h, w = img.shape
    x = ((uv[:, 0] + 1.0) * w - 1.0) * 0.5
    y = ((uv[:, 1] + 1.0) * h - 1.0) * 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx = x - x0
    wy = y - y0

    def tap(ix, iy):
        inb = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
        ixc = torch.clamp(ix, 0, w - 1).to(torch.int64)
        iyc = torch.clamp(iy, 0, h - 1).to(torch.int64)
        return torch.where(inb[None, :], img[:, iyc, ixc], 0.0)   # (C, N)

    v = (tap(x0, y0) * ((1 - wx) * (1 - wy))[None]
         + tap(x0 + 1, y0) * (wx * (1 - wy))[None]
         + tap(x0, y0 + 1) * ((1 - wx) * wy)[None]
         + tap(x0 + 1, y0 + 1) * (wx * wy)[None])
    return v.T
