"""3D Gaussian parameter store, mesh binding and densification, port of
mpmavatar_tpu/render/gaussians.py (the parameters, ``init_from_mesh``,
the face frames, the world-space views, the densification statistics,
``densify_and_prune`` and ``reset_opacity``).

The gaussian set lives in capacity-padded tensors with an ``alive`` mask,
as in the JAX package, so the render shapes stay fixed while the set
grows or shrinks: prune masks slots off, clone and split write into free
slots.  ``init_from_pcd`` takes its scales from the native KD-tree
(``native/``), or from dense distances where that library is missing.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .. import resolve_device
from ..core.types import _Tensors
from ..utils import profiling
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
def bound_rows(table, binding):
    """``table[binding]``: a per-face table's row for each slot (the
    binding gathers), counted into ``binding.gathered_slots``."""
    profiling.count("binding.gathered_slots", binding.shape[0])
    return table[binding]


def get_xyz(g: GaussianParams, frames: Optional[FaceFrames] = None):
    if frames is None:
        return g.xyz
    om = bound_rows(frames.orien_mat, g.binding)
    xyz = torch.sum(om * g.xyz[:, None, :], -1)
    return xyz * bound_rows(frames.scaling, g.binding) \
        + bound_rows(frames.center, g.binding)


def get_scaling(g: GaussianParams, frames: Optional[FaceFrames] = None):
    s = torch.exp(g.scaling)
    if frames is None:
        return s
    return s * bound_rows(frames.scaling, g.binding)


def get_rotation(g: GaussianParams, frames: Optional[FaceFrames] = None):
    q = geometry.quat_normalize(g.rotation)
    if frames is None:
        return q
    fq = geometry.quat_normalize(bound_rows(frames.orien_quat, g.binding))
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


def inverse_sigmoid(x):
    return torch.log(x / (1 - x))


# ----------------------------------------------------------------------
# densification on padded capacity
# ----------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class DensifyState(_Tensors):
    xyz_gradient_accum: torch.Tensor  # (N, 1)
    denom: torch.Tensor               # (N, 1)
    max_radii2d: torch.Tensor         # (N,)


def init_densify_state(capacity: int, device=None) -> DensifyState:
    device = resolve_device(device)
    return DensifyState(torch.zeros((capacity, 1), device=device),
                        torch.zeros((capacity, 1), device=device),
                        torch.zeros((capacity,), device=device))


def add_densification_stats(ds: DensifyState, viewspace_grad, radii,
                            visible) -> DensifyState:
    """Accumulate the view-space gradient norm and the largest 2D radius
    of the visible gaussians."""
    v = viewspace_grad[:, :2]
    gn = torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True))
    return DensifyState(
        xyz_gradient_accum=ds.xyz_gradient_accum + torch.where(
            visible[:, None], gn, 0.0),
        denom=ds.denom + visible[:, None].to(ds.denom.dtype),
        max_radii2d=torch.maximum(ds.max_radii2d,
                                  torch.where(visible, radii, 0.0)))


def _binding_counter(g: GaussianParams, num_faces: int):
    """Alive gaussians per face."""
    return torch.zeros((num_faces,), dtype=torch.int64,
                       device=g.binding.device).index_add_(
        0, g.binding, g.alive.to(torch.int64))


def densify_and_prune(g: GaussianParams, ds: DensifyState,
                      frames: FaceFrames, num_faces: int, max_grad: float,
                      min_opacity: float, extent: float,
                      percent_dense: float = 0.01, generator=None,
                      n_split: int = 2,
                      max_screen_size: Optional[float] = None,
                      normals=None):
    """Clone + split + prune in padded capacity.  Free slots are consumed
    in order (clones first, then the split copies); when capacity runs
    out the lowest-priority new points are dropped.  ``max_screen_size``
    prunes gaussians whose accumulated max 2D radius exceeds it (and
    those larger than a tenth of ``extent``).  Each face keeps at least
    one gaussian.

    The split offsets are ``normals`` (capacity * n_split, 3) standard
    normals when given (a test hands in JAX's draws), else drawn from
    ``generator``.  Returns (params, fresh stats)."""
    cap = g.capacity
    dev = g.xyz.device
    grads = torch.nan_to_num((ds.xyz_gradient_accum / torch.clamp_min(
        ds.denom, 1e-12))[:, 0])
    max_scale = torch.amax(get_scaling(g, frames), dim=1)

    # clone: small gaussians with a high view-space gradient; split: large
    clone_mask = g.alive & (grads >= max_grad) & \
        (max_scale <= percent_dense * extent)
    split_mask = g.alive & (grads >= max_grad) & \
        (max_scale > percent_dense * extent)

    free = ~g.alive
    n_free = free.sum()
    arange = torch.arange(cap, device=dev)
    # slot of the r-th free slot (cap past the last)
    slot_of_rank = torch.full((cap,), cap, dtype=torch.int64, device=dev)
    slot_of_rank[(torch.cumsum(free.to(torch.int64), 0) - 1)[free]] = \
        arange[free]

    def alloc_slots(want_mask, copies, start_rank):
        """Rank the requested copies into free slots."""
        want = torch.repeat_interleave(want_mask, copies)
        src = torch.repeat_interleave(arange, copies)
        rank = torch.cumsum(want.to(torch.int64), 0) - 1 + start_rank
        ok = want & (rank < n_free)
        dst = torch.where(ok, slot_of_rank[torch.clamp(rank, 0, cap - 1)],
                          cap)
        return src, dst, ok, start_rank + want.sum()

    src_c, dst_c, ok_c, next_rank = alloc_slots(clone_mask, 1, 0)
    src_s, dst_s, ok_s, _ = alloc_slots(split_mask, n_split, next_rank)

    def scatter_copy(arr, dst, ok, vals):
        out = arr.clone()
        out[dst[ok]] = vals[ok]
        return out

    fields = ("xyz", "features_dc", "features_rest", "scaling", "rotation",
              "opacity", "binding")
    # clones copy verbatim
    new = {f: scatter_copy(getattr(g, f), dst_c, ok_c, getattr(g, f)[src_c])
           for f in fields}
    # splits sample offsets in the gaussian and shrink
    stds = torch.exp(g.scaling)[src_s]
    if normals is None:
        normals = torch.randn(stds.shape, generator=generator,
                              device=generator.device if generator
                              is not None else dev)
    samples = normals.to(dev) * stds
    rots = geometry.quat_to_rotmat(g.rotation[src_s])
    split_vals = {f: getattr(g, f)[src_s] for f in fields}
    split_vals["xyz"] = torch.sum(rots * samples[:, None, :], -1) \
        + g.xyz[src_s]
    split_vals["scaling"] = torch.log(torch.exp(g.scaling[src_s])
                                      / (0.8 * n_split))
    new = {f: scatter_copy(new[f], dst_s, ok_s, split_vals[f])
           for f in fields}

    alive = g.alive.clone()
    alive[dst_c[ok_c]] = True
    alive[dst_s[ok_s]] = True
    out = GaussianParams(**new, alive=alive)

    # prune: originals that were split (only when BOTH children landed in
    # free slots); low opacity; oversized
    split_ordinal = torch.cumsum(split_mask.to(torch.int64), 0) - 1
    prune = split_mask & (next_rank + n_split * split_ordinal
                          + (n_split - 1) < n_free)
    prune = prune | (get_opacity(out)[:, 0] < min_opacity)
    if max_screen_size is not None:
        prune = prune | (ds.max_radii2d > max_screen_size)
        prune = prune | (torch.amax(get_scaling(out, frames), dim=1)
                         > 0.1 * extent)
    prune = prune & alive

    # keep >= 1 gaussian per face
    counter = _binding_counter(out, num_faces)
    to_prune = torch.zeros_like(counter).index_add_(
        0, out.binding, prune.to(torch.int64))
    prune = prune & ((counter - to_prune) > 0)[out.binding]
    out = dataclasses.replace(out, alive=alive & ~prune)
    return out, init_densify_state(cap, dev)


@torch.no_grad()
def copy_into(dst: GaussianParams, src: GaussianParams) -> None:
    """Write ``src``'s fields into ``dst``'s tensors in place, so that an
    optimizer holding ``dst``'s leaves keeps them (and its per-slot
    moments, as the JAX loop keeps its optax state across densification)."""
    for f in dataclasses.fields(GaussianParams):
        getattr(dst, f.name).copy_(getattr(src, f.name))


def reset_opacity(g: GaussianParams, ceiling: float = 0.01) -> GaussianParams:
    """Cap every opacity at ``ceiling``."""
    top = inverse_sigmoid(torch.tensor(ceiling, device=g.opacity.device))
    return dataclasses.replace(g, opacity=torch.minimum(g.opacity, top))


def init_from_pcd(points, colors, sh_degree: int,
                  capacity: Optional[int] = None,
                  device=None) -> GaussianParams:
    """Unbound 3DGS init from a point cloud: each scale from the mean
    squared distance to the 3 nearest other points (the native KD-tree;
    without it the dense O(N^2) distances, as the JAX package falls
    back)."""
    device = resolve_device(device)
    points = np.asarray(points, np.float32)
    n = len(points)
    cap = capacity or n
    n_rest = (sh_degree + 1) ** 2 - 1
    try:
        from ..native import knn
        dist2 = np.maximum(knn.mean_dist2_3nn(points), 1e-7)
    except Exception:
        d2 = np.sum((points[:, None] - points[None]) ** 2, -1)
        np.fill_diagonal(d2, np.inf)
        dist2 = np.maximum(np.sort(d2, 1)[:, :3].mean(1), 1e-7)
    scales = np.log(np.sqrt(dist2))[:, None].repeat(3, 1)
    f32 = dict(dtype=torch.float32, device=device)
    xyz = torch.zeros((cap, 3), **f32)
    xyz[:n] = torch.as_tensor(points, **f32)
    dc = torch.zeros((cap, 1, 3), **f32)
    dc[:n, 0] = rgb2sh(torch.as_tensor(np.asarray(colors, np.float32),
                                       **f32))
    scaling = torch.zeros((cap, 3), **f32)
    scaling[:n] = torch.as_tensor(scales.astype(np.float32), **f32)
    rotation = torch.zeros((cap, 4), **f32)
    rotation[:, 0] = 1.0
    return GaussianParams(
        xyz=xyz, features_dc=dc,
        features_rest=torch.zeros((cap, n_rest, 3), **f32),
        scaling=scaling, rotation=rotation,
        opacity=torch.full((cap, 1), float(np.log(0.1 / 0.9)), **f32),
        binding=torch.zeros((cap,), dtype=torch.int64, device=device),
        alive=torch.arange(cap, device=device) < n)
