"""Carry simulation state and parameters across as numpy arrays.

``state_from_numpy`` / ``model_from_numpy`` build the port's MPMState /
MPMModel from dicts of arrays keyed by field name (for example every
field of a JAX ``MPMState`` after ``np.asarray``); ``to_numpy`` converts
back.  Tests use these so both packages start from identical data.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import resolve_device
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


def to_numpy(obj) -> dict:
    """Field name -> numpy array for an MPMState or MPMModel."""
    return {f.name: getattr(obj, f.name).detach().cpu().numpy()
            for f in dataclasses.fields(obj)}
