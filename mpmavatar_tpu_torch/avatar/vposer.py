"""VPoser v1 body-pose prior decoder (port of
mpmavatar_tpu/avatar/vposer.py).

The decoder of human_body_prior's ``VPoser(512, 32, [3, 21])``: latent(32)
-> fc(512) -> lrelu -> fc(512) -> lrelu -> fc(21*6) -> continuous 6D ->
rotation matrices, as an ``nn.Module``.  ``load_vposer_torch`` reads the
official ``TR00_E096.pt`` checkpoint.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .. import resolve_device


def _leaky(x, slope=0.2):
    return torch.where(x >= 0, x, slope * x)


class VPoserDecoder(nn.Module):
    """latent (B, latent_dim) -> body-pose rotations (B, n_joints, 3, 3)."""

    def __init__(self, num_neurons=512, latent_dim=32, n_joints=21):
        super().__init__()
        self.fc1 = nn.Linear(latent_dim, num_neurons)
        self.fc2 = nn.Linear(num_neurons, num_neurons)
        self.out = nn.Linear(num_neurons, n_joints * 6)

    def forward(self, latent: torch.Tensor) -> torch.Tensor:
        x = _leaky(self.fc1(latent))
        x = _leaky(self.fc2(x))
        x = self.out(x)
        n = self.out.out_features // 6
        return rot6d_to_matrix(x.reshape(latent.shape[0], n, 6))


def init_vposer(generator: torch.Generator, num_neurons=512, latent_dim=32,
                n_joints=21, device=None) -> VPoserDecoder:
    """A decoder with weights uniform in +-1/sqrt(fan_in) drawn from
    ``generator`` (a CPU generator) and zero biases, as the JAX package
    initialises its decoder."""
    dec = VPoserDecoder(num_neurons, latent_dim, n_joints)
    with torch.no_grad():
        for layer in (dec.fc1, dec.fc2, dec.out):
            bound = 1.0 / np.sqrt(layer.in_features)
            layer.weight.uniform_(-bound, bound, generator=generator)
            layer.bias.zero_()
    return dec.to(resolve_device(device))


_DECODER_SHAPES = {  # official VPoser(512, 32, [3, 21]) decoder
    "bodyprior_dec_fc1.weight": (512, 32),
    "bodyprior_dec_fc1.bias": (512,),
    "bodyprior_dec_fc2.weight": (512, 512),
    "bodyprior_dec_fc2.bias": (512,),
    "bodyprior_dec_out.weight": (126, 512),
    "bodyprior_dec_out.bias": (126,),
}


def load_vposer_torch(path: str, device=None) -> VPoserDecoder:
    """The decoder of the official ``TR00_E096.pt`` checkpoint on
    ``device`` (default: the CUDA device).

    The file is a plain ``state_dict`` of the full VAE (encoder BN/fc
    layers + decoder) saved by human_body_prior.  Only the decoder weights
    matter for pose decoding; encoder keys are ignored.  Fails loudly on
    missing or mis-shaped decoder keys, and accepts the ``state_dict`` and
    ``vp_model.`` wrappings some re-exports use."""
    device = resolve_device(device)
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd and not any(
            k.startswith("bodyprior_dec") for k in sd):
        sd = sd["state_dict"]
    sd = {k[len("vp_model."):] if k.startswith("vp_model.") else k: v
          for k, v in sd.items()}
    missing = [k for k in _DECODER_SHAPES if k not in sd]
    if missing:
        raise ValueError(
            f"VPoser checkpoint {path!r} lacks decoder keys {missing}; "
            f"found {sorted(sd)[:8]}...")
    bad = [f"{k}: {tuple(sd[k].shape)} != {s}"
           for k, s in _DECODER_SHAPES.items()
           if tuple(sd[k].shape) != s]
    if bad:
        raise ValueError(f"VPoser checkpoint {path!r} decoder shape "
                         f"mismatch: {bad}")
    dec = VPoserDecoder()
    dec.load_state_dict({
        f"{name}.{p}": sd[f"bodyprior_dec_{name}.{p}"].float()
        for name in ("fc1", "fc2", "out") for p in ("weight", "bias")})
    return dec.to(device)


def rot6d_to_matrix(x: torch.Tensor) -> torch.Tensor:
    """Continuous 6D rotation representation (..., 6) -> (..., 3, 3).

    As human_body_prior's ``ContinousRotReprDecoder``, which the official
    decoder head was trained against: the 6 outputs per joint are
    ``view(-1, 3, 2)``, so the two raw basis vectors are the interleaved
    strides ``x[..., 0::2]`` / ``x[..., 1::2]``, and the orthonormal frame
    is stacked as columns."""
    a1 = x[..., 0::2]
    a2 = x[..., 1::2]
    # sqrt(sum^2 + eps^2) norms: torch.linalg.norm has a NaN gradient at
    # a zero vector, which an untrained decoder head emits
    n1 = torch.sqrt(torch.sum(a1 * a1, -1, keepdim=True) + 1e-16)
    b1 = a1 / n1
    b2 = a2 - torch.sum(b1 * a2, -1, keepdim=True) * b1
    n2 = torch.sqrt(torch.sum(b2 * b2, -1, keepdim=True) + 1e-16)
    b2 = b2 / n2
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=-1)


def matrix_to_axis_angle(r: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> (..., 3) rotation vectors (for SMPL-X body_pose).

    The atan2 form: arccos((trace - 1) / 2) has an infinite gradient at
    the identity, the rest pose.  Values match arccos on [0, pi].  The
    clip is a max then a min, which give a tie half the gradient as the
    JAX package's clip does."""
    trace = r[..., 0, 0] + r[..., 1, 1] + r[..., 2, 2]
    one = torch.ones_like(trace)
    cos = torch.minimum(torch.maximum((trace - 1.0) / 2.0, -one), one)
    axis_raw = torch.stack([r[..., 2, 1] - r[..., 1, 2],
                            r[..., 0, 2] - r[..., 2, 0],
                            r[..., 1, 0] - r[..., 0, 1]], -1)  # 2 sin axis
    # a gradient-safe |sin|: sqrt(x + eps) never differentiates 1/sqrt(0)
    sin = 0.5 * torch.sqrt(torch.sum(axis_raw * axis_raw, -1) + 1e-16)
    angle = torch.atan2(sin, cos)
    safe = sin > 1e-6
    fallback = torch.tensor([1.0, 0.0, 0.0], dtype=r.dtype,
                            device=r.device).expand(axis_raw.shape)
    axis = torch.where(
        safe[..., None],
        axis_raw / torch.where(safe, 2.0 * sin, 1.0)[..., None], fallback)
    return axis * angle[..., None]
