"""The other quasi-shadow networks, port of
mpmavatar_tpu/render/shadow_variants.py:

* ``FloorShadowDecoder``: a strided conv encoder and a transposed-conv
  decoder with additive skips; the floor shadow from the AO map as
  ``(tanh(up4(x) + ao) + 1) / 2``;
* ``ShadowUNet_PoseCond``: the shadow UNet with a root-pose code
  conv-encoded at the bottleneck;
* ``PoseToShadow``: a pose vector through a linear layer and five
  transposed convs to a sigmoid shadow map;
* ``DistMapShadowUNet``: the UNet over per-joint distance maps, with a
  tied- or untied-bias head.

Each is an (init, apply) pair over a nested dict of tensors with the JAX
package's names and layouts (``convert.shadow_variant_params_from_numpy``
carries JAX parameters across); the layers and the resize are
``render/layers.py``'s.  Initializers draw from a ``torch.Generator``
seeded with ``seed``, not the JAX package's draws.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .. import resolve_device
from .layers import (conv2d_wn_apply, conv2d_wn_init, linear_wn_apply,
                     linear_wn_init, lrelu_gain, resize, tile2d)


def _leaky(x, slope=0.2):
    return torch.where(x >= 0, x, slope * x)


def _to(params, device):
    if isinstance(params, dict):
        return {k: _to(v, device) for k, v in params.items()}
    return params.to(device)


# ----------------------------------------------------------------------
# FloorShadowDecoder
# ----------------------------------------------------------------------
def init_floor_shadow_decoder(seed: int, uv_size: int = 512,
                              beta: float = 1.0, device=None) -> Dict:
    """Channels 1-64-64-128-256-512 down, mirrored up, k = 4, stride 2;
    untied biases; the last layer's gain 1, the others lrelu(0.2)'s."""
    gen = torch.Generator().manual_seed(seed)
    downs = [(1, 64), (64, 64), (64, 128), (128, 256), (256, 512)]
    ups = [(512, 256), (256, 128), (128, 64), (64, 64), (64, 1)]
    g = lrelu_gain(0.2)
    p: Dict = {"beta": torch.tensor(beta)}
    size = uv_size
    for i, (ci, co) in enumerate(downs):
        size //= 2
        p[f"down{i}"] = conv2d_wn_init(gen, ci, co, k=4, gain=g, height=size)
    for i, (ci, co) in enumerate(ups):
        size *= 2
        p[f"up{i}"] = conv2d_wn_init(gen, ci, co, k=4,
                                     gain=(1.0 if i == 4 else g),
                                     height=size)
    return _to(p, resolve_device(device))


def apply_floor_shadow_decoder(p: Dict, ao_map, uv_size: int = 512) -> Dict:
    """ao_map (B, 1, H, W) -> {"shadow_map"} at uv_size (5 halvings down,
    5 doublings back up)."""
    ao = resize(ao_map, (uv_size, uv_size))
    acts = [None] * 5
    x = ao - 0.5
    for i in range(5):
        x = _leaky(conv2d_wn_apply(p[f"down{i}"], x, stride=2))
        acts[i] = x
    for i in range(4):
        x = _leaky(conv2d_wn_apply(p[f"up{i}"], x, stride=2,
                                   transpose=True))
        x = x + acts[3 - i]
    x = conv2d_wn_apply(p["up4"], x, stride=2, transpose=True)
    # the residual against the (resized) input AO map
    return {"shadow_map": (torch.tanh(x + resize(ao, x.shape[-2:]))
                           + 1.0) / 2.0}


# ----------------------------------------------------------------------
# ShadowUNet_PoseCond
# ----------------------------------------------------------------------
def init_shadow_unet_posecond(seed: int, ao_mean: np.ndarray,
                              uv_size: int = 256, shadow_size: int = 256,
                              n_dims: int = 64, n_pose_dims: int = 6,
                              n_pose_enc_dims: int = 32,
                              lrelu_slope: float = 0.2, beta: float = 1.0,
                              device=None) -> Dict:
    gen = torch.Generator().manual_seed(seed)
    sizes = [shadow_size // (2 ** i) for i in range(4)]
    enc_dims = [(1, n_dims)] + [(n_dims, n_dims)] * 3
    dec_dims = [(n_dims + n_pose_enc_dims, n_dims)] + \
        [(n_dims * 2, n_dims)] * 3
    g = lrelu_gain(lrelu_slope)
    ao = np.asarray(ao_mean, np.float32)
    p: Dict = {"beta": torch.tensor(beta),
               "ao_mean": torch.as_tensor(ao).reshape(1, 1, *ao.shape[-2:])}
    for i, (ci, co) in enumerate(enc_dims):
        p[f"enc{i}"] = conv2d_wn_init(gen, ci, co, k=3, gain=g,
                                      height=sizes[i])
    for i, (ci, co) in enumerate(dec_dims):
        p[f"dec{i}"] = conv2d_wn_init(gen, ci, co, k=3, gain=g,
                                      height=sizes[-i - 1])
    p["pose_conv"] = conv2d_wn_init(gen, n_pose_dims, n_pose_enc_dims, k=3,
                                    gain=g, height=sizes[-1])
    p["pred"] = conv2d_wn_init(gen, n_dims, 1, k=3, gain=1.0,
                               height=sizes[0])
    return _to(p, resolve_device(device))


def _unet(p: Dict, x, sizes, lrelu_slope, bottleneck=None):
    """The shared encoder / decoder of the two UNets, through the head's
    sigmoid."""
    enc_acts = []
    for i in range(4):
        x = _leaky(conv2d_wn_apply(p[f"enc{i}"], x), lrelu_slope)
        enc_acts.append(x)
        if i < 3:
            x = resize(x, (sizes[i + 1], sizes[i + 1]))
    if bottleneck is not None:
        x = torch.cat([x, bottleneck], 1)
    for i in range(4):
        if i > 0:
            prev = enc_acts[-i - 1]
            x = torch.cat([resize(x, prev.shape[-2:]), prev], 1)
        x = _leaky(conv2d_wn_apply(p[f"dec{i}"], x), lrelu_slope)
    return torch.sigmoid(conv2d_wn_apply(p["pred"], x) + p["beta"])


def apply_shadow_unet_posecond(p: Dict, ao_map, pose_vec,
                               lrelu_slope: float = 0.2,
                               uv_size: int = 256) -> Dict:
    """ao_map (B, 1, H, W); pose_vec (B, n_pose)."""
    shadow_size = p["enc0"]["b"].shape[-1]
    sizes = [shadow_size // (2 ** i) for i in range(4)]
    x = resize(ao_map - p["ao_mean"], (shadow_size, shadow_size))
    pose_enc = conv2d_wn_apply(p["pose_conv"], tile2d(pose_vec, sizes[-1]))
    low = _unet(p, x, sizes, lrelu_slope, pose_enc)
    return {"shadow_map": resize(low, (uv_size, uv_size)),
            "ao_map": ao_map}


# ----------------------------------------------------------------------
# PoseToShadow
# ----------------------------------------------------------------------
def init_pose_to_shadow(seed: int, n_pose_dims: int, uv_size: int = 256,
                        beta: float = 1.0, device=None) -> Dict:
    gen = torch.Generator().manual_seed(seed)
    convs = [(256, 256), (256, 128), (128, 128), (128, 64), (64, 1)]
    g = lrelu_gain(0.2)
    p: Dict = {"beta": torch.tensor(beta),
               "fc": linear_wn_init(gen, n_pose_dims, 256 * 4 * 4, gain=g)}
    size = 4
    for i, (ci, co) in enumerate(convs):
        size *= 2
        p[f"conv{i}"] = conv2d_wn_init(gen, ci, co, k=4,
                                       gain=(1.0 if i == 4 else g),
                                       height=size)
    return _to(p, resolve_device(device))


def apply_pose_to_shadow(p: Dict, pose, uv_size: int = 256) -> Dict:
    """pose (B, n_pose_dims) -> a 128^2 map resized to uv_size."""
    x = _leaky(linear_wn_apply(p["fc"], pose)).reshape(-1, 256, 4, 4)
    for i in range(5):
        x = conv2d_wn_apply(p[f"conv{i}"], x, stride=2, transpose=True)
        if i < 4:
            x = _leaky(x)
    low = torch.sigmoid(x + p["beta"])
    return {"shadow_map": resize(low, (uv_size, uv_size))}


# ----------------------------------------------------------------------
# DistMapShadowUNet
# ----------------------------------------------------------------------
def init_distmap_shadow_unet(seed: int, n_dist_joints: int,
                             uv_size: int = 256, shadow_size: int = 256,
                             n_dims: int = 64, lrelu_slope: float = 0.2,
                             beta: float = 1.0, biases: bool = True,
                             device=None) -> Dict:
    gen = torch.Generator().manual_seed(seed)
    sizes = [shadow_size // (2 ** i) for i in range(4)]
    enc_dims = [(n_dist_joints, n_dims)] + [(n_dims, n_dims)] * 3
    dec_dims = [(n_dims, n_dims)] + [(n_dims * 2, n_dims)] * 3
    g = lrelu_gain(lrelu_slope)
    p: Dict = {"beta": torch.tensor(beta)}
    for i, (ci, co) in enumerate(enc_dims):
        p[f"enc{i}"] = conv2d_wn_init(gen, ci, co, k=3, gain=g,
                                      height=sizes[i])
    for i, (ci, co) in enumerate(dec_dims):
        p[f"dec{i}"] = conv2d_wn_init(gen, ci, co, k=3, gain=g,
                                      height=sizes[-i - 1])
    # biases=True: the untied-bias head; else one bias per channel
    p["pred"] = conv2d_wn_init(gen, n_dims, 1, k=3, gain=1.0,
                               height=(sizes[0] if biases else None))
    return _to(p, resolve_device(device))


def apply_distmap_shadow_unet(p: Dict, dist_map, lrelu_slope: float = 0.2,
                              uv_size: int = 256) -> Dict:
    """dist_map (B, n_dist_joints, H, W)."""
    shadow_size = p["enc0"]["b"].shape[-1]
    sizes = [shadow_size // (2 ** i) for i in range(4)]
    x = resize(dist_map, (shadow_size, shadow_size))
    low = _unet(p, x, sizes, lrelu_slope)
    return {"shadow_map": resize(low, (uv_size, uv_size)),
            "shadow_map_lowres": low}
