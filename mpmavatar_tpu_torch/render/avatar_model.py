"""Mesh-bound Gaussian avatar, port of mpmavatar_tpu/render/avatar_model.py
(the parameters, mesh posing, the regularizer losses and the asset
loaders).

``AvatarParams`` holds the learnables of the appearance stage (splats,
per-frame vertex offsets, per-camera colour calibration, the shadow UNet);
``MeshAvatar`` the static assets.  ``save_avatar_checkpoint`` and
``load_avatar_checkpoint`` write and read the JAX package's checkpoint
files, so either package loads the other's.
"""

from __future__ import annotations

import dataclasses
import os
from glob import glob

import numpy as np
import torch

from .. import resolve_device
from ..core.linalg import cross, safe_norm
from . import gaussians as G
from .geometry import find_adjacent_faces
from .shadow import init_shadow_unet


@dataclasses.dataclass(frozen=True)
class AvatarParams:
    """All learnables of the appearance stage."""
    splats: G.GaussianParams
    verts_offset: torch.Tensor   # (T, V, 3)
    cam_m: torch.Tensor          # (n_cams, 3) log colour gain
    cam_c: torch.Tensor          # (n_cams, 3) colour bias
    shadow: dict                 # shadow UNet params


@dataclasses.dataclass
class MeshAvatar:
    """Static (non-learned) avatar assets, as numpy arrays; ``tensor``
    keeps one device copy of each."""
    faces: np.ndarray            # (F, 3)
    verts_orig: np.ndarray       # (T, V, 3)
    ao_maps: np.ndarray          # (T, 1, H, W)
    uv_coord: np.ndarray         # (F, 2) in [-1, 1] (y flipped)
    face_neighbors: np.ndarray   # (F, 3)
    neighbor_weight: np.ndarray  # (F, 3)
    neighbor_dist: np.ndarray    # (F, 3)
    num_timesteps: int
    sh_degree: int
    _on_device: dict = dataclasses.field(default_factory=dict, repr=False,
                                         compare=False)

    def tensor(self, name: str, device):
        """The asset ``name`` on ``device`` (int64 for faces and
        neighbours, float32 otherwise), copied there once."""
        device = torch.device(device)
        key = (name, str(device))
        if key not in self._on_device:
            a = np.asarray(getattr(self, name))
            dtype = torch.int64 if name in ("faces", "face_neighbors") \
                else torch.float32
            self._on_device[key] = torch.as_tensor(a).to(device=device,
                                                         dtype=dtype)
        return self._on_device[key]

    def select_verts(self, params: AvatarParams, timestep: int,
                     add_offset=True):
        """Frame ``timestep``'s vertices (plus the learned offsets)."""
        v = self.tensor("verts_orig", params.verts_offset.device)[timestep]
        if add_offset:
            v = v + params.verts_offset[timestep]
        return v

    def frames_for_verts(self, verts):
        """Mesh posing -> face frames."""
        return G.face_frames_from_verts(verts,
                                        self.tensor("faces", verts.device))

    # ---- regularizers ------------------------------------------------
    def normal_loss(self, verts):
        """Mean |n . n_neighbour - 1| over each face's three neighbours."""
        vf = verts[self.tensor("faces", verts.device)]
        d3 = cross(vf[:, 1] - vf[:, 0], vf[:, 2] - vf[:, 0])
        n = d3 / torch.clamp_min(safe_norm(d3, dim=1, keepdim=True), 1e-12)
        nn = n[self.tensor("face_neighbors", verts.device)]
        dot = torch.sum(n[:, None] * nn, -1).mean(-1)
        return torch.mean(torch.abs(dot - 1.0))

    def opacity_loss(self, params: AvatarParams):
        alive = params.splats.alive
        op = G.get_opacity(params.splats)[:, 0]
        return torch.sum((1.0 - op) * alive) / torch.clamp_min(
            torch.sum(alive), 1)

    def iso_loss(self, verts):
        """Face-centre distances to the neighbours against their rest
        lengths, weighted.  Boundary faces list themselves as padding
        neighbours; those rows are masked out, as the JAX package masks
        them (a self offset is zero, and an ulp of it would be amplified
        by d|off|/d off = off/|off|)."""
        dev = verts.device
        nbr = self.tensor("face_neighbors", dev)
        self_mask = nbr == torch.arange(len(self.faces), device=dev)[:, None]
        xyz = verts[self.tensor("faces", dev)].mean(1)
        off = xyz[nbr] - xyz[:, None]
        mag = torch.sqrt(torch.sum(off ** 2, -1) + 1e-20)
        diff = (mag - self.tensor("neighbor_dist", dev)) ** 2
        val = torch.where(self_mask, 0.0,
                          diff * self.tensor("neighbor_weight", dev))
        return torch.mean(torch.sqrt(val + 1e-20))

    def area_loss(self, verts):
        """Mean |area - mean area| over the faces."""
        vf = verts[self.tensor("faces", verts.device)]
        area = 0.5 * safe_norm(cross(vf[:, 1] - vf[:, 0],
                                     vf[:, 2] - vf[:, 0]), dim=1)
        return torch.mean(torch.abs(area - torch.mean(area)))


def load_uv_coords(uv_path: str):
    """Per-face UV centroids in grid_sample coordinates."""
    vt, fuv = [], []
    with open(uv_path) as f:
        for line in f:
            if line[:2] == "vt":
                vt.append([float(x) for x in line[2:].split()])
            elif line[:2] == "f ":
                fuv.append([int(p.split("/")[1]) - 1
                            for p in line[2:].split()])
    uv = np.asarray(vt, np.float32)[np.asarray(fuv)].mean(1) * 2.0 - 1.0
    uv[:, 1] *= -1
    return uv


def load_mesh_avatar(trained_model_path: str, uv_path: str,
                     sh_degree: int = 3, capacity_factor: float = 4.0,
                     shadow_seed: int = 0, device=None):
    """The tracking stage's ``params_*.npz`` + AO maps + UV template ->
    (MeshAvatar, AvatarParams)."""
    from PIL import Image
    device = resolve_device(device)

    sort_key = lambda p: int(p[:-4].split("_")[-1])
    params_files = sorted(glob(os.path.join(trained_model_path,
                                            "params_*.npz")), key=sort_key)
    if not params_files:
        raise FileNotFoundError(f"no params_*.npz under {trained_model_path}")

    verts_orig, rgb_list, ao_maps = [], [], []
    faces = cam_m = cam_c = None
    for idx, pf in enumerate(params_files):
        data = dict(np.load(pf))
        ao_file = pf.replace("params_", "aomap/mesh_cloth_").replace(
            ".npz", ".png")
        with Image.open(ao_file) as im:
            ao = np.array(im.convert("L"), np.float32) / 255.0
        if idx == 0:
            cam_m = data["cam_m"].astype(np.float32)
            cam_c = data["cam_c"].astype(np.float32)
            faces = data["faces"].astype(np.int32)
        rgb_list.append(np.clip(data["rgb_colors"], 0, 1))
        verts_orig.append(data["vertices"].astype(np.float32))
        ao_maps.append(ao)

    verts_orig = np.stack(verts_orig)
    ao_maps = np.stack(ao_maps)[:, None]
    num_faces = len(faces)
    rgb = np.mean(np.stack(rgb_list), axis=0).astype(np.float32)

    face_neighbors = find_adjacent_faces(faces)
    centers = verts_orig[0][faces].mean(1)
    nb = centers[face_neighbors]
    sq = np.sum((nb - centers[:, None]) ** 2, -1)

    avatar = MeshAvatar(
        faces=faces, verts_orig=verts_orig, ao_maps=ao_maps,
        uv_coord=load_uv_coords(uv_path),
        face_neighbors=face_neighbors,
        neighbor_weight=np.exp(-2000 * sq).astype(np.float32),
        neighbor_dist=np.sqrt(sq).astype(np.float32),
        num_timesteps=len(params_files), sh_degree=sh_degree)

    splats = G.init_from_mesh(num_faces, sh_degree, rgb=rgb,
                              capacity=int(num_faces * capacity_factor),
                              device=device)
    shadow = init_shadow_unet(shadow_seed, ao_maps.mean(axis=0), uv_size=256,
                              shadow_size=256, n_dims=4, device=device)
    params = AvatarParams(
        splats=splats,
        verts_offset=torch.zeros(verts_orig.shape, device=device),
        cam_m=torch.as_tensor(cam_m, device=device),
        cam_c=torch.as_tensor(cam_c, device=device),
        shadow=shadow)
    return avatar, params


def save_avatar_checkpoint(path: str, params: AvatarParams,
                           avatar: MeshAvatar):
    """The checkpoint directory of the JAX package's
    ``save_avatar_checkpoint``: ``point_cloud.ply`` (the alive splats in
    the 3DGS layout, with ``binding_0``), ``verts_offset.npy``,
    ``cams.npz`` (cam_m, cam_c) and ``shadow_net.npz`` (the UNet's
    arrays under their names).  ``avatar`` is unused, as in the JAX
    package."""
    from ..utils.io import as_numpy, write_ply_gaussians
    os.makedirs(path, exist_ok=True)
    s = params.splats
    alive = as_numpy(s.alive)
    write_ply_gaussians(
        os.path.join(path, "point_cloud.ply"),
        as_numpy(s.xyz)[alive], as_numpy(s.features_dc)[alive],
        as_numpy(s.features_rest)[alive], as_numpy(s.opacity)[alive],
        as_numpy(s.scaling)[alive], as_numpy(s.rotation)[alive],
        binding=as_numpy(s.binding)[alive])
    np.save(os.path.join(path, "verts_offset.npy"),
            as_numpy(params.verts_offset))
    np.savez(os.path.join(path, "cams.npz"), cam_m=as_numpy(params.cam_m),
             cam_c=as_numpy(params.cam_c))
    np.savez(os.path.join(path, "shadow_net.npz"),
             **{k: as_numpy(v) for k, v in params.shadow.items()})


def load_avatar_checkpoint(path: str, params: AvatarParams) -> AvatarParams:
    """``params`` with a checkpoint's splats in its first n slots
    (``alive = arange(capacity) < n``; the other slots keep their
    values), and its offsets, colour calibration and shadow UNet, on the
    device of ``params``."""
    from ..utils.io import read_ply_gaussians
    ply = read_ply_gaussians(os.path.join(path, "point_cloud.ply"))
    n = len(ply["xyz"])
    s = params.splats
    dev = s.xyz.device
    if n > s.capacity:
        raise ValueError(f"{path}: {n} splats do not fit a capacity of "
                         f"{s.capacity}")

    def put(arr, new):
        out = arr.detach().clone()
        out[:n] = torch.as_tensor(np.array(new).reshape(
            (n,) + tuple(arr.shape[1:])), dtype=arr.dtype, device=dev)
        return out

    splats = G.GaussianParams(
        xyz=put(s.xyz, ply["xyz"]),
        features_dc=put(s.features_dc, ply["features_dc"]),
        features_rest=put(s.features_rest, ply["features_rest"]),
        scaling=put(s.scaling, ply["scaling"]),
        rotation=put(s.rotation, ply["rotation"]),
        opacity=put(s.opacity, ply["opacity"]),
        binding=put(s.binding, ply["binding"]),
        alive=torch.arange(s.capacity, device=dev) < n)
    with np.load(os.path.join(path, "cams.npz")) as cams, \
            np.load(os.path.join(path, "shadow_net.npz")) as shadow:
        cam_m, cam_c = cams["cam_m"], cams["cam_c"]
        shadow = {k: torch.as_tensor(shadow[k], device=dev)
                  for k in shadow.files}
    return AvatarParams(
        splats=splats,
        verts_offset=torch.as_tensor(
            np.load(os.path.join(path, "verts_offset.npy")), device=dev),
        cam_m=torch.as_tensor(cam_m, device=dev),
        cam_c=torch.as_tensor(cam_c, device=dev),
        shadow=shadow)
