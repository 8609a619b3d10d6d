"""Carry simulation state, parameters and scene inputs across as numpy
arrays.

``state_from_numpy`` / ``model_from_numpy`` build the port's MPMState /
MPMModel from dicts of arrays keyed by field name (for example every
field of a JAX ``MPMState`` after ``np.asarray``); ``to_numpy`` converts
back.  ``mesh_collider_from_numpy`` carries a body-mesh collider's faces
and friction, ``scene_from_numpy`` the per-rollout collider mesh and
joint velocities (``mesh_x``, ``mesh_v``, ``joint_*_v``).
``gaussians_from_numpy``, ``avatar_params_from_numpy``,
``mesh_avatar_from_numpy`` and ``camera_arrays_from_numpy`` carry the
render inputs (splats, the avatar's learnables with its shadow UNet, its
static assets, a device camera); ``densify_state_from_numpy`` the
densification statistics (``to_numpy`` takes them back), and
``float_grads_to_numpy`` the train step's gradients, nested as the JAX
package's AvatarParams pytree.  ``material_params_from_numpy`` sets a
material trainer's D, E, H and its Adam state (optax's ``mu``, ``nu``,
``count``).  ``smplx_model_from_numpy`` and ``vposer_from_numpy`` carry
the avatar's SMPL-X model and VPoser decoder, ``lpips_params_from_numpy``
the LPIPS network's weights, ``shadow_variant_params_from_numpy`` any
nested layer dict of ``render/layers.py`` (the shadow variants), and
``tracking_params_from_numpy`` the tracker's parameters;
``sharded_state_from_numpy`` and ``uniform_model_from_numpy`` the
multi-device state and material (the JAX package's ShardedClothState and
UniformModel pytrees as arrays by field name).  Tests use
these so both
packages start from identical data.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import resolve_device
from .avatar.smplx import SMPLXModel
from .avatar.vposer import VPoserDecoder
from .core.colliders import MeshCollider
from .core.types import MPMModel, MPMState
from .parallel.sharded import ShardedClothState, UniformModel
from .render.avatar_model import AvatarParams, MeshAvatar
from .render.gaussians import DensifyState, GaussianParams
from .render.rasterizer import CameraArrays
from .utils.lpips import LPIPS

_INT_FIELDS = ("selection", "faces")
_DTYPES = {"binding": torch.int64, "alive": torch.bool}


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


def sharded_state_from_numpy(arrays: dict, device=None) -> ShardedClothState:
    """ShardedClothState from field name -> array (faces as int32): the
    whole padded state, or one rank's block of it."""
    return _from_numpy(ShardedClothState, arrays, device)


def uniform_model_from_numpy(arrays: dict, device=None) -> UniformModel:
    """UniformModel from field name -> array (float32; 0-d for a uniform
    scalar, or a block of per-element values)."""
    return _from_numpy(UniformModel, arrays, device)


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
    """Field name -> numpy array for a dataclass of tensors (MPMState,
    MPMModel, GaussianParams, DensifyState)."""
    return {f.name: getattr(obj, f.name).detach().cpu().numpy()
            for f in dataclasses.fields(obj)}


def _tensors(cls, arrays: dict, device):
    device = resolve_device(device)
    return cls(**{f.name: torch.tensor(np.asarray(arrays[f.name])).to(
        device=device, dtype=_DTYPES.get(f.name, torch.float32))
        for f in dataclasses.fields(cls)})


def gaussians_from_numpy(arrays: dict, device=None) -> GaussianParams:
    """GaussianParams from field name -> array (binding as int64, alive
    as bool, the rest float32)."""
    return _tensors(GaussianParams, arrays, device)


def camera_arrays_from_numpy(arrays: dict, device=None) -> CameraArrays:
    return _tensors(CameraArrays, arrays, device)


def avatar_params_from_numpy(splats: dict, verts_offset, cam_m, cam_c,
                             shadow: dict, device=None) -> AvatarParams:
    """AvatarParams from the splats' and the shadow UNet's arrays by name
    and the offset and calibration arrays."""
    device = resolve_device(device)
    f32 = lambda a: torch.tensor(np.asarray(a, np.float32), device=device)
    return AvatarParams(splats=gaussians_from_numpy(splats, device),
                        verts_offset=f32(verts_offset), cam_m=f32(cam_m),
                        cam_c=f32(cam_c),
                        shadow={k: f32(v) for k, v in shadow.items()})


def mesh_avatar_from_numpy(arrays: dict) -> MeshAvatar:
    """MeshAvatar from its fields by name (arrays stay numpy)."""
    return MeshAvatar(**{f.name: arrays[f.name]
                         for f in dataclasses.fields(MeshAvatar)
                         if not f.name.startswith("_")})


def densify_state_from_numpy(arrays: dict, device=None) -> DensifyState:
    return _tensors(DensifyState, arrays, device)


def float_grads_to_numpy(grads: dict) -> dict:
    """The train step's gradients (name -> tensor, names as
    ``train.appearance.float_leaves`` gives them) as nested numpy dicts:
    {"splats": {...}, "verts_offset": ..., "cam_m": ..., "cam_c": ...,
    "shadow": {...}}."""
    out: dict = {}
    for name, g in grads.items():
        *path, leaf = name.split(".")
        node = out
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = g.detach().cpu().numpy()
    return out


def material_params_from_numpy(trainer, params: dict, mu=None, nu=None,
                               count=None) -> None:
    """Set ``trainer``'s (a ``train.material.MaterialTrainer``) D, E
    (stored /100) and H to ``params[name]`` and, when ``mu``, ``nu`` and
    ``count`` are given (optax's ScaleByAdamState per parameter: name ->
    first and second moment, name -> step count), its Adam state, so that
    its next step continues an optax Adam run."""
    with torch.no_grad():
        for name, p in trainer.params.items():
            p.copy_(torch.as_tensor(np.float32(params[name])))
    if mu is None:
        return
    for name, p in trainer.params.items():
        trainer.optimizer.state[p] = {
            "step": torch.tensor(float(count[name]), dtype=torch.float32),
            "exp_avg": torch.as_tensor(np.float32(mu[name]),
                                       device=p.device).clone(),
            "exp_avg_sq": torch.as_tensor(np.float32(nu[name]),
                                          device=p.device).clone()}


def smplx_model_from_numpy(arrays: dict, parents, device=None) -> SMPLXModel:
    """SMPLXModel from its array fields by name (faces as int32, the rest
    float32; a missing or None entry stays None) and ``parents``."""
    device = resolve_device(device)
    kw = {}
    for f in dataclasses.fields(SMPLXModel):
        if f.name == "parents" or arrays.get(f.name) is None:
            continue
        dtype = torch.int32 if f.name == "faces" else torch.float32
        kw[f.name] = torch.tensor(np.asarray(arrays[f.name]),
                                  device=device).to(dtype)
    return SMPLXModel(parents=tuple(int(p) for p in parents), **kw)


def vposer_from_numpy(params: dict, device=None) -> VPoserDecoder:
    """The decoder of a JAX VPoser parameter dict ({"fc1", "fc2", "out"}
    each {"w" (in, out), "b" (out,)}): ``nn.Linear`` keeps w as
    (out, in)."""
    w = {k: np.asarray(params[k]["w"], np.float32)
         for k in ("fc1", "fc2", "out")}
    dec = VPoserDecoder(num_neurons=w["fc1"].shape[1],
                        latent_dim=w["fc1"].shape[0],
                        n_joints=w["out"].shape[1] // 6)
    dec.load_state_dict({
        f"{k}.{p}": torch.tensor(
            w[k].T if p == "weight"
            else np.asarray(params[k]["b"], np.float32))
        for k in w for p in ("weight", "bias")})
    return dec.to(resolve_device(device))


def lpips_params_from_numpy(params: dict, device=None) -> LPIPS:
    """The LPIPS network with the weights ``params`` (the npz layout of
    ``utils/lpips.py``: conv{i}_w/conv{i}_b, lin{i}_w)."""
    return LPIPS({k: np.asarray(v) for k, v in params.items()},
                 device=device)


def shadow_variant_params_from_numpy(params, device=None):
    """A nested parameter dict (``render/layers.py``'s layers, the shadow
    variants of ``render/shadow_variants.py``) with every leaf a float32
    tensor on ``device``; the names and layouts are the JAX package's."""
    device = resolve_device(device)
    if isinstance(params, dict):
        return {k: shadow_variant_params_from_numpy(v, device)
                for k, v in params.items()}
    return torch.tensor(np.asarray(params, np.float32), device=device)


def tracking_params_from_numpy(params: dict, device=None) -> dict:
    """The stage-1 tracker's parameter dict (vertices, rgb_colors,
    logit_opacities, log_scales, cam_m, cam_c) as float32 tensors."""
    device = resolve_device(device)
    return {k: torch.tensor(np.asarray(v, np.float32), device=device)
            for k, v in params.items()}
