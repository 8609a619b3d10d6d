"""Functional layer library (weight-normalised, untied-bias and
equalized-learning-rate layers), port of mpmavatar_tpu/render/layers.py.

Each layer is an (init, apply) pair over a plain dict of tensors with the
JAX package's names and layouts: linear weights (n_in, n_out), conv
kernels OIHW, activations NCHW, so ``convert.py`` carries parameters
across as they are.  The package pins float32 matmuls and convolutions at
full precision (``mpmavatar_tpu_torch/__init__.py``), as the JAX package
pins "highest".

Padding follows XLA's "SAME" rule (the low side gets the smaller half,
so a stride-2, 3-tap conv pads (0, 1)); a transposed conv is XLA's
``conv_transpose``: the input dilated by the stride and correlated with
the kernel as stored, which ``F.conv_transpose2d`` computes with the
kernel flipped.  Resizing is ``jax.image.resize`` bilinear (half-pixel
centres, antialiased when it shrinks), which ``F.interpolate`` with
``antialias=True`` computes in both directions.

Initializers draw from an explicit ``torch.Generator``; they match the
JAX initializers' distributions, not their draws.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F


def _kaiming_uniform(gen, shape, fan_in, gain):
    bound = gain * math.sqrt(3.0 / fan_in)
    return (torch.rand(shape, generator=gen) * 2.0 - 1.0) * bound


def lrelu_gain(slope=0.2):
    return math.sqrt(2.0 / (1.0 + slope ** 2))


def glorot(gen, shape, fan_in, fan_out, gain=1.0):
    """Glorot-normal initializer."""
    std = gain * math.sqrt(2.0 / (fan_in + fan_out))
    return std * torch.randn(shape, generator=gen)


def resize(x, hw):
    """(N, C, H, W) -> (N, C, *hw), as ``jax.image.resize(...,
    "bilinear")``."""
    if tuple(x.shape[-2:]) == tuple(hw):
        return x
    return F.interpolate(x, size=tuple(hw), mode="bilinear",
                         align_corners=False, antialias=True)


def _same_pad(x, k: int, stride: int):
    """Pad (N, C, H, W) as XLA's "SAME" does for a k-tap, stride-s conv."""
    pads = []
    for n in (x.shape[-1], x.shape[-2]):
        out = -(-n // stride)
        total = max((out - 1) * stride + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


def conv2d(x, w, stride=1, padding="SAME", groups=1):
    """XLA's ``conv_general_dilated`` in NCHW / OIHW, "SAME" or "VALID"."""
    if padding == "SAME":
        x = _same_pad(x, w.shape[-1], stride)
    elif padding != "VALID":
        raise ValueError(f"padding {padding!r}: 'SAME' or 'VALID'")
    return F.conv2d(x, w, stride=stride, groups=groups)


def conv_transpose2d(x, w, stride=1, padding="SAME"):
    """XLA's ``conv_transpose`` of an OIHW kernel ``w`` (O = the output
    channels): the input dilated by ``stride``, padded as XLA pads it,
    correlated with ``w``."""
    k = w.shape[-1]
    if padding == "SAME":
        pad_len = k + stride - 2
        pad_a = k - 1 if stride > k - 1 else -(-pad_len // 2)
    elif padding == "VALID":
        pad_len = k + stride - 2 + max(k - stride, 0)
        pad_a = k - 1
    else:
        raise ValueError(f"padding {padding!r}: 'SAME' or 'VALID'")
    pad_b = pad_len - pad_a
    # with no padding F.conv_transpose2d pads the dilated input by k - 1
    # on both sides (and flips the kernel); F.pad crops or zero-pads the
    # difference
    y = F.conv_transpose2d(x, torch.flip(w, (2, 3)).transpose(0, 1),
                           stride=stride)
    lo, hi = pad_a - (k - 1), pad_b - (k - 1)
    return F.pad(y, [lo, hi, lo, hi])


# ----------------------------------------------------------------------
# weight-normalised layers
# ----------------------------------------------------------------------
def linear_wn_init(gen, n_in, n_out, gain=1.0) -> Dict:
    v = _kaiming_uniform(gen, (n_in, n_out), n_in, gain)
    return {"v": v, "g": torch.sqrt(torch.sum(v * v, 0, keepdim=True)),
            "b": torch.zeros((n_out,))}


def linear_wn_apply(p: Dict, x):
    v, g = p["v"], p["g"]
    w = v * g / torch.sqrt(torch.sum(v * v, 0, keepdim=True) + 1e-12)
    return x @ w + p["b"]


def conv2d_wn_init(gen, n_in, n_out, k=3, gain=1.0, height=None,
                   width=None) -> Dict:
    """Conv2dWN; pass height/width for the untied-bias variant."""
    v = _kaiming_uniform(gen, (n_out, n_in, k, k), n_in * k * k, gain)
    p = {"v": v, "g": torch.sqrt(torch.sum(v * v, (1, 2, 3), keepdim=True))}
    if height is not None:
        p["b"] = torch.zeros((1, n_out, height, width or height))
    else:
        p["b"] = torch.zeros((1, n_out, 1, 1))
    return p


def conv2d_wn_apply(p: Dict, x, stride=1, padding="SAME",
                    transpose=False):
    v, g = p["v"], p["g"]
    w = v * g / torch.sqrt(torch.sum(v * v, (1, 2, 3), keepdim=True)
                           + 1e-12)
    if transpose:
        y = conv_transpose2d(x, w, stride, padding)
    else:
        y = conv2d(x, w, stride, padding)
    return y + p["b"]


# ----------------------------------------------------------------------
# equalized-learning-rate layers
# ----------------------------------------------------------------------
def linear_elr_init(gen, n_in, n_out, gain=None) -> Dict:
    gain = gain if gain is not None else math.sqrt(2.0)
    return {"w": torch.randn((n_in, n_out), generator=gen),
            "b": torch.zeros((n_out,)),
            "scale": torch.tensor(gain / math.sqrt(n_in))}


def linear_elr_apply(p: Dict, x):
    return x @ (p["w"] * p["scale"]) + p["b"]


def conv2d_elr_init(gen, n_in, n_out, k=3, gain=None) -> Dict:
    gain = gain if gain is not None else math.sqrt(2.0)
    return {"w": torch.randn((n_out, n_in, k, k), generator=gen),
            "b": torch.zeros((1, n_out, 1, 1)),
            "scale": torch.tensor(gain / math.sqrt(n_in * k * k))}


def conv2d_elr_apply(p: Dict, x, stride=1, padding="SAME"):
    return conv2d(x, p["w"] * p["scale"], stride, padding) + p["b"]


# ----------------------------------------------------------------------
# resampling
# ----------------------------------------------------------------------
def upconv2d(p: Dict, x, scale=2):
    """Bilinear upsample, then a weight-normalised conv."""
    n, c, h, w = x.shape
    return conv2d_wn_apply(p, resize(x, (h * scale, w * scale)))


_BLUR3 = torch.outer(torch.tensor([1.0, 2.0, 1.0]),
                     torch.tensor([1.0, 2.0, 1.0])) / 16.0


def downsample_aa(x, factor=2):
    """Antialiased downsample: 3x3 binomial blur, then the stride."""
    c = x.shape[1]
    kern = _BLUR3.to(x)[None, None].expand(c, 1, 3, 3)
    return conv2d(x, kern, factor, "SAME", groups=c)


def concat_pyramid(levels):
    """Resize every level to the first's resolution, concat on channels."""
    target = tuple(levels[0].shape[-2:])
    return torch.cat([levels[0]] + [resize(lv, target)
                                    for lv in levels[1:]], 1)


def tile2d(x, size: int):
    """(N, C) -> (N, C, size, size)."""
    return x[:, :, None, None].expand(*x.shape, size, size)
