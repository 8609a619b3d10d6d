"""3D Gaussian parameter store and mesh binding, port of
mpmavatar_tpu/render/gaussians.py (the parameters, ``init_from_mesh``,
the face frames and the world-space views).

The gaussian set lives in capacity-padded tensors with an ``alive`` mask,
as in the JAX package, so the render shapes stay fixed while the set
grows or shrinks.  Densification, pruning and ``init_from_pcd`` belong to
the stage-2 training slice and are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .. import resolve_device
from ..core.types import _Tensors
from . import geometry
from .sh import rgb2sh


@dataclasses.dataclass(frozen=True)
class GaussianParams(_Tensors):
    """Learnable splat parameters, capacity-padded (N = capacity).

    Activations: scaling = exp(scaling), opacity = sigmoid(opacity),
    rotation = normalize(rotation) [wxyz].  ``binding`` maps each gaussian
    to a mesh face (mesh-bound avatar mode); local xyz is expressed in the
    face frame."""
    xyz: torch.Tensor            # (N, 3) local (or world if unbound)
    features_dc: torch.Tensor    # (N, 1, 3)
    features_rest: torch.Tensor  # (N, (deg+1)^2-1, 3)
    scaling: torch.Tensor        # (N, 3) log-scale
    rotation: torch.Tensor       # (N, 4) wxyz (unnormalized)
    opacity: torch.Tensor        # (N, 1) logit
    binding: torch.Tensor        # (N,) int64 face index
    alive: torch.Tensor          # (N,) bool

    @property
    def capacity(self):
        return self.xyz.shape[0]


def init_from_mesh(num_faces: int, sh_degree: int,
                   rgb: Optional[np.ndarray] = None,
                   capacity: Optional[int] = None,
                   device=None) -> GaussianParams:
    """One gaussian per face, identity local frame."""
    device = resolve_device(device)
    cap = capacity or num_faces
    n_rest = (sh_degree + 1) ** 2 - 1
    f32 = dict(dtype=torch.float32, device=device)
    dc = torch.zeros((cap, 1, 3), **f32)
    if rgb is not None:
        dc[:num_faces, 0] = rgb2sh(torch.as_tensor(np.asarray(rgb), **f32))
    rotation = torch.zeros((cap, 4), **f32)
    rotation[:, 0] = 1.0
    binding = torch.zeros((cap,), dtype=torch.int64, device=device)
    binding[:num_faces] = torch.arange(num_faces, device=device)
    return GaussianParams(
        xyz=torch.zeros((cap, 3), **f32),
        features_dc=dc,
        features_rest=torch.zeros((cap, n_rest, 3), **f32),
        scaling=torch.full((cap, 3), float(np.log(0.1)), **f32),
        rotation=rotation,
        opacity=torch.full((cap, 1), float(np.log(0.1 / 0.9)), **f32),
        binding=binding,
        alive=torch.arange(cap, device=device) < num_faces)


@dataclasses.dataclass(frozen=True)
class FaceFrames(_Tensors):
    """Per-face world-space frames from the posed mesh."""
    center: torch.Tensor      # (F, 3)
    orien_mat: torch.Tensor   # (F, 3, 3)
    orien_quat: torch.Tensor  # (F, 4) wxyz
    scaling: torch.Tensor     # (F, 1)


def face_frames_from_verts(verts, faces) -> FaceFrames:
    tri = verts[faces]
    center = tri.mean(dim=-2)
    orien, scale = geometry.compute_face_orientation(verts, faces)
    return FaceFrames(center=center, orien_mat=orien,
                      orien_quat=geometry.rotmat_to_quat(orien),
                      scaling=scale)


# ----------------------------------------------------------------------
# world-space views
# ----------------------------------------------------------------------
def get_xyz(g: GaussianParams, frames: Optional[FaceFrames] = None):
    if frames is None:
        return g.xyz
    om = frames.orien_mat[g.binding]
    xyz = torch.sum(om * g.xyz[:, None, :], -1)
    return xyz * frames.scaling[g.binding] + frames.center[g.binding]


def get_scaling(g: GaussianParams, frames: Optional[FaceFrames] = None):
    s = torch.exp(g.scaling)
    if frames is None:
        return s
    return s * frames.scaling[g.binding]


def get_rotation(g: GaussianParams, frames: Optional[FaceFrames] = None):
    q = geometry.quat_normalize(g.rotation)
    if frames is None:
        return q
    fq = geometry.quat_normalize(frames.orien_quat[g.binding])
    return geometry.quat_multiply(fq, q)


def get_opacity(g: GaussianParams):
    return torch.sigmoid(g.opacity)


def get_features(g: GaussianParams):
    """(N, (deg+1)^2, 3) SH coefficients."""
    return torch.cat([g.features_dc, g.features_rest], dim=1)


def get_covariance(g: GaussianParams, frames: Optional[FaceFrames] = None,
                   scaling_modifier=1.0):
    return geometry.covariance_from_scaling_rotation(
        get_scaling(g, frames), scaling_modifier, get_rotation(g, frames))
