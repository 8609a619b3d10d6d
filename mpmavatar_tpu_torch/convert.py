"""Carry simulation state, parameters and scene inputs across as numpy
arrays.

``state_from_numpy`` / ``model_from_numpy`` build the port's MPMState /
MPMModel from dicts of arrays keyed by field name (for example every
field of a JAX ``MPMState`` after ``np.asarray``); ``to_numpy`` converts
back.  ``mesh_collider_from_numpy`` carries a body-mesh collider's faces
and friction, ``scene_from_numpy`` the per-rollout collider mesh and
joint velocities (``mesh_x``, ``mesh_v``, ``joint_*_v``).  Tests use these
so both packages start from identical data.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import resolve_device
from .core.colliders import MeshCollider
from .core.types import MPMModel, MPMState

_INT_FIELDS = ("selection", "faces")


def _from_numpy(cls, arrays: dict, device):
    device = resolve_device(device)
    kw = {}
    for f in dataclasses.fields(cls):
        a = np.asarray(arrays[f.name])
        dtype = torch.int32 if f.name in _INT_FIELDS else torch.float32
        kw[f.name] = torch.as_tensor(a, device=device).to(dtype)
    return cls(**kw)


def state_from_numpy(arrays: dict, device=None) -> MPMState:
    return _from_numpy(MPMState, arrays, device)


def model_from_numpy(arrays: dict, device=None) -> MPMModel:
    return _from_numpy(MPMModel, arrays, device)


def mesh_collider_from_numpy(faces, friction, device=None) -> MeshCollider:
    """A body-mesh collider of these faces (as int64) and friction."""
    device = resolve_device(device)
    return MeshCollider(
        faces=torch.as_tensor(np.array(faces, np.int64), device=device),
        friction=torch.as_tensor(np.float32(friction), device=device))


def scene_from_numpy(arrays: dict, device=None) -> dict:
    """Name -> float32 tensor for the scene inputs of ``p2g2p`` /
    ``MPMSolver.frame`` (entries that are None stay None)."""
    device = resolve_device(device)
    return {k: None if a is None else torch.as_tensor(
        np.asarray(a, np.float32), device=device) for k, a in arrays.items()}


def to_numpy(obj) -> dict:
    """Field name -> numpy array for an MPMState or MPMModel."""
    return {f.name: getattr(obj, f.name).detach().cpu().numpy()
            for f in dataclasses.fields(obj)}
