"""Stage-1 photometric mesh tracking (per-timestep mesh fitting), port of
mpmavatar_tpu/train/tracking.py.

One gaussian per face at the barycentre, with the face frame's rotation
and a flattened scale; per timestep the mesh vertices, per-face colours,
opacities and scales and per-camera colour calibration are fitted to the
multi-view images under the mesh regularizers and the cloth-body
collision penalty, warm-started by the previous frame's motion.  With an
SMPL-X model the body fit (VPoser latent or body pose every frame, betas
at the first) is optimized jointly through the collision penalty by a
second Adam.

optax's per-label Adam becomes one ``torch.optim.Adam`` with a parameter
group per leaf (the same learning rates, eps 1e-15, bias correction and
step count; optax's ``eps_root`` is 0, so the two agree).

``TrackingConfig.work_cap`` > 0 renders through the rasterizer's worklist
compositor (K6 forward, K7 backward on the card; the gradient w.r.t. the
mesh vertices reaches the splats through the face frames); 0 keeps the
JAX package's tile path, which calls ``rasterize`` without a work cap.
Each footprint tier of the rasterizer admits every splat, where the JAX
call keeps the default capacities and drops coverage past them.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional

import numpy as np
import torch

from .. import resolve_device
from ..core.linalg import cross, safe_norm, safe_normalize
from ..render import camera_arrays, rasterize
from ..render.geometry import (compute_face_orientation,
                               covariance_from_scaling_rotation,
                               find_adjacent_faces, rotmat_to_quat,
                               vertex_normals)
from ..utils.losses import collision_loss, ssim

PARAM_KEYS = ("vertices", "rgb_colors", "logit_opacities", "log_scales",
              "cam_m", "cam_c")


@dataclasses.dataclass
class TrackingConfig:
    """Loss weights and learning rates (the JAX package's defaults), and
    the rasterizer's capacities: ``work_cap`` > 0 selects the worklist
    compositor."""
    img_weight: float = 1.0
    iso_weight: float = 4000.0
    normal_weight: float = 0.05
    opacity_weight: float = 0.05
    area_weight: float = 10.0
    eq_faces_weight: float = 10.0
    soft_color_weight: float = 0.02
    collision_weight: float = 100.0
    lr_means3d: float = 0.00016
    lr_colors: float = 0.0025
    iters_first: int = 10000
    iters_rest: int = 3000
    tile_capacity: int = 512
    work_cap: int = 0


def init_tracking_params(verts, faces, max_cams=160, device=None) -> Dict:
    """The fitted parameters: the mesh, per-face colours (0), opacity
    logits (0) and log scales (the mean distance to the 3 nearest face
    centres, the normal axis flattened to exp(-100)), per-camera colour
    calibration."""
    from ..native import knn
    device = resolve_device(device)
    verts = np.asarray(verts, np.float32)
    faces = np.asarray(faces, np.int32)
    bary = verts[faces].mean(1)
    d2, _ = knn.query(bary, bary, 4)
    mean3 = np.clip(d2[:, 1:].mean(-1), 1e-7, None)
    scales = np.tile(np.log(np.sqrt(mean3))[:, None], (1, 3))
    scales[:, 2] = -100.0
    # copies: the leaves are updated in place
    f32 = lambda a: torch.tensor(np.asarray(a, np.float32), device=device)
    return {"vertices": f32(verts),
            "rgb_colors": f32(np.zeros((len(faces), 3))),
            "logit_opacities": f32(np.zeros((len(faces), 1))),
            "log_scales": f32(scales),
            "cam_m": f32(np.zeros((max_cams, 3))),
            "cam_c": f32(np.zeros((max_cams, 3)))}


def init_tracking_variables(verts, faces, cloth_v_idx=None,
                            device=None) -> Dict:
    """The fixed tensors: faces, each face's 3 edge neighbours, their rest
    distances and weights, and the cloth's vertex indices (or None)."""
    device = resolve_device(device)
    faces = np.asarray(faces)
    bary = np.asarray(verts)[faces].mean(1)
    nb = find_adjacent_faces(faces)
    sq = np.sum((bary[nb] - bary[:, None]) ** 2, -1)
    i64 = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=device)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    return {"faces": i64(faces), "face_neighbors": i64(nb),
            "neighbor_weight": f32(np.exp(-2000 * sq)),
            "neighbor_dist": f32(np.sqrt(sq)),
            "cloth_v_idx": (i64(cloth_v_idx) if cloth_v_idx is not None
                            else None)}


def params2rendervar(params: Dict, faces) -> Dict:
    """A gaussian per face: the barycentre, the face frame's quaternion,
    sigmoid opacity and exp scale."""
    verts = params["vertices"]
    orien, _ = compute_face_orientation(verts, faces)
    return {"means3d": verts[faces].mean(1),
            "colors": params["rgb_colors"],
            "rotations": rotmat_to_quat(orien),
            "opacities": torch.sigmoid(params["logit_opacities"])[:, 0],
            "scales": torch.exp(params["log_scales"])}


def _tensors(params: Dict, device) -> Dict:
    """A parameter dict of arrays or tensors as float32 tensors on
    ``device`` (arrays copied)."""
    return {k: (v.to(device=device, dtype=torch.float32)
                if isinstance(v, torch.Tensor)
                else torch.tensor(np.asarray(v, np.float32), device=device))
            for k, v in params.items()}


def _abs(x):
    """|x| with JAX's gradient at 0 (+1; ``torch.abs`` gives 0): the soft
    colour term starts every frame at its kink (the colours equal the
    previous frame's), where the two conventions step differently."""
    return torch.where(x >= 0, x, -x)


def _l1(a, b):
    return torch.mean(_abs(a - b))


def _face_normals(verts, faces):
    vf = verts[faces]
    return safe_normalize(cross(vf[:, 1] - vf[:, 0], vf[:, 2] - vf[:, 0]))


def tracking_loss(params: Dict, variables: Dict, ca, width, height, cam_id,
                  gt_im, gt_msk, smplx_v, smplx_vn, prev_col,
                  is_initial: bool, cfg: TrackingConfig, stats=None):
    """The weighted loss terms and their sum: (loss, parts).  ``stats``,
    when a dict, receives the rasterizer's overflow counts and phase-2
    items."""
    faces = variables["faces"]
    rv = params2rendervar(params, faces)
    cov3d = covariance_from_scaling_rotation(rv["scales"], 1.0,
                                             rv["rotations"])
    verts = params["vertices"]
    # every splat admitted to each footprint tier: one splat per face,
    # scaled to the nearest face centres, spans more than 2 tiles at
    # 1500 x 1000 for most faces, past the rasterizer's default tiers (a
    # quarter and a sixteenth of the splats, which the JAX package's call
    # keeps and overflows: the splats past them lose coverage)
    n = faces.shape[0]
    out = rasterize(rv["means3d"], rv["colors"], rv["opacities"], cov3d, ca,
                    torch.zeros(3, device=verts.device), width=width,
                    height=height, tile_capacity=cfg.tile_capacity,
                    work_cap=cfg.work_cap, mid_capacity=n, big_capacity=n)
    if stats is not None:
        stats.update({k: out[k] for k in ("big_overflow", "work_overflow",
                                          "n_items")})
    im = torch.exp(params["cam_m"][cam_id])[:, None, None] * out["render"] \
        + params["cam_c"][cam_id][:, None, None]

    losses = {}
    losses["im"] = cfg.img_weight * (
        0.8 * _l1(im, gt_im) + 0.2 * (1.0 - ssim(im, gt_im)))
    losses["msk"] = _l1(out["alpha"], gt_msk)
    losses["scale"] = torch.mean(rv["scales"][:, -1])

    fn = _face_normals(verts, faces)
    nb = variables["face_neighbors"]
    ndot = torch.sum(fn[:, None] * fn[nb], -1).mean(-1)
    losses["normal"] = cfg.normal_weight * torch.mean(_abs(ndot - 1.0))
    losses["opacity"] = cfg.opacity_weight * torch.mean(
        1.0 - rv["opacities"])

    bary = rv["means3d"]
    off = bary[nb] - bary[:, None]
    mag = torch.sqrt(torch.sum(off ** 2, -1) + 1e-20)
    losses["iso"] = cfg.iso_weight * torch.mean(
        variables["neighbor_weight"] * (mag - variables["neighbor_dist"])
        ** 2)

    vf = verts[faces]
    area = 0.5 * safe_norm(cross(vf[:, 1] - vf[:, 0], vf[:, 2] - vf[:, 0]),
                           dim=1)
    g_area = rv["scales"][:, 0] * rv["scales"][:, 1] * np.pi
    losses["area"] = cfg.area_weight * torch.mean(_abs(area - g_area))
    losses["eq_faces"] = cfg.eq_faces_weight * torch.mean(
        _abs(area - torch.mean(area)))

    if variables.get("cloth_v_idx") is not None:
        losses["collision"] = cfg.collision_weight * collision_loss(
            verts[variables["cloth_v_idx"]], smplx_v, smplx_vn)

    if not is_initial and prev_col is not None:
        losses["soft_col"] = cfg.soft_color_weight * _l1(
            params["rgb_colors"], prev_col)

    return sum(losses.values()), losses


class MeshTracker:
    """The per-timestep tracking loop.  Parameters and optimizer state
    live on ``device`` (default: the CUDA device); ``fit_frame`` takes
    numpy batches ({"cam", "camera_idx", "rgb", "msk"}) and returns the
    per-iteration losses.

    With ``smplx_model`` (an SMPLXModel on ``device``; ``vposer`` a
    VPoserDecoder) each timestep also fits the SMPL-X body through the
    collision penalty with its own Adam (``set_smplx_frame``,
    ``finish_smplx_frame``)."""

    def __init__(self, verts0, faces, cfg: TrackingConfig = None,
                 cloth_v_idx=None, max_cams=160, scene_radius=1.0,
                 smplx_model=None, vposer=None, smplx_faces=None,
                 lr_smplx: float = 1e-4, device=None):
        self.device = resolve_device(device)
        self.cfg = cfg or TrackingConfig()
        self.params = init_tracking_params(verts0, faces, max_cams,
                                           self.device)
        self.variables = init_tracking_variables(verts0, faces, cloth_v_idx,
                                                 self.device)
        self.prev_col = None
        self.prev_verts = [self.params["vertices"].clone()]
        self.lrs = {"vertices": self.cfg.lr_means3d * scene_radius,
                    "rgb_colors": self.cfg.lr_colors,
                    "logit_opacities": 0.05, "log_scales": 0.001,
                    "cam_m": 1e-4, "cam_c": 1e-4}
        self._init_optimizer()
        self.smplx_model = smplx_model
        self.vposer = vposer
        self.smplx_faces = (torch.tensor(np.asarray(smplx_faces),
                                         dtype=torch.int64,
                                         device=self.device)
                            if smplx_faces is not None else None)
        self.lr_smplx = lr_smplx
        self.smplx_train = None      # trainable SMPL-X leaves
        self.smplx_fixed = None      # frozen SMPL-X parameters
        self.beta = None             # locked after the first timestep
        self.stats = {}              # the last step's rasterizer counts

    def _init_optimizer(self):
        for k in PARAM_KEYS:
            self.params[k] = self.params[k].detach().requires_grad_(True)
        self.optimizer = torch.optim.Adam(
            [{"params": [self.params[k]], "lr": lr, "name": k}
             for k, lr in self.lrs.items()], eps=1e-15)

    # ---- joint SMPL-X fitting ---------------------------------------
    def _smplx_geometry(self, train, fixed):
        """Trainable SMPL-X leaves -> (vertices (Vs, 3), outward normals)."""
        from ..avatar.smplx import smplx_forward
        from ..avatar.vposer import matrix_to_axis_angle
        p = dict(fixed)
        if "latent" in train:
            p["body_pose"] = matrix_to_axis_angle(
                self.vposer(train["latent"])).reshape(1, -1)
        elif "body_pose" in train:
            p["body_pose"] = train["body_pose"]
        if "beta" in train:
            p["beta"] = train["beta"]
        v = smplx_forward(self.smplx_model, p).vertices[0]
        return v, vertex_normals(v, self.smplx_faces)

    def set_smplx_frame(self, smplx_param: Dict, is_initial: bool):
        """Split this timestep's SMPL-X parameters into trainable leaves
        (the latent with a VPoser, else the body pose; beta at the first
        timestep) and frozen ones; a fresh Adam for the trainable ones."""
        assert self.smplx_model is not None
        p = _tensors(smplx_param, self.device)
        keys = ["latent"] if ("latent" in p and self.vposer is not None) \
            else ["body_pose"]
        if is_initial:
            keys.append("beta")
        self.smplx_train = {k: p[k].detach().clone().requires_grad_(True)
                            for k in keys if k in p}
        self.smplx_fixed = {k: v for k, v in p.items()
                            if k not in self.smplx_train}
        if not is_initial and self.beta is not None:
            self.smplx_fixed["beta"] = self.beta
        self.smplx_optimizer = torch.optim.Adam(
            list(self.smplx_train.values()), lr=self.lr_smplx, eps=1e-8)

    def finish_smplx_frame(self, is_initial: bool) -> Dict:
        """Lock betas after the first timestep; the fitted parameters."""
        full = {**self.smplx_fixed,
                **{k: v.detach() for k, v in self.smplx_train.items()}}
        if is_initial and "beta" in self.smplx_train:
            self.beta = self.smplx_train["beta"].detach()
        return full

    def _device_batches(self, batches):
        out = []
        for b in batches:
            out.append({"ca": camera_arrays(b["cam"], self.device),
                        "w": b["cam"].image_width,
                        "h": b["cam"].image_height,
                        "cam_id": int(b["camera_idx"]),
                        "rgb": torch.as_tensor(np.asarray(b["rgb"]),
                                               device=self.device),
                        "msk": torch.as_tensor(np.asarray(b["msk"]),
                                               device=self.device)})
        return out

    def step(self, b, smplx_v, smplx_vn, is_initial: bool):
        """One optimization step on the device batch ``b``; returns the
        loss tensor (not synchronized)."""
        joint = self.smplx_train is not None
        self.optimizer.zero_grad(set_to_none=True)
        if joint:
            self.smplx_optimizer.zero_grad(set_to_none=True)
            smplx_v, smplx_vn = self._smplx_geometry(self.smplx_train,
                                                     self.smplx_fixed)
        loss, _ = tracking_loss(self.params, self.variables, b["ca"],
                                b["w"], b["h"], b["cam_id"], b["rgb"],
                                b["msk"], smplx_v, smplx_vn, self.prev_col,
                                is_initial, self.cfg, stats=self.stats)
        loss.backward()
        self.optimizer.step()
        if joint:
            self.smplx_optimizer.step()
        return loss.detach()

    def fit_frame(self, batches, smplx_v=None, smplx_vn=None,
                  is_initial: bool = False, iters: Optional[int] = None):
        """``iters`` steps over the batches, cycled; returns the losses.
        With an SMPL-X frame set the body is recomputed from its
        trainable fit every step, else the given static smplx_v / smplx_vn
        feed the collision penalty."""
        cfg = self.cfg
        iters = iters or (cfg.iters_first if is_initial else cfg.iters_rest)
        dev = self._device_batches(batches)
        as_dev = lambda a: None if a is None else torch.as_tensor(
            np.asarray(a, np.float32), device=self.device)
        smplx_v, smplx_vn = as_dev(smplx_v), as_dev(smplx_vn)
        losses = []
        for it in range(iters):
            losses.append(float(self.step(dev[it % len(dev)], smplx_v,
                                          smplx_vn, is_initial)))
        self.prev_verts.append(self.params["vertices"].detach().clone())
        self.prev_verts = self.prev_verts[-2:]
        return losses

    @torch.no_grad()
    def initialize_per_timestep(self):
        """Inertia warm start: extrapolate the vertices by the previous
        frame's motion."""
        if len(self.prev_verts) >= 2:
            self.params["vertices"].add_(self.prev_verts[-1]
                                         - self.prev_verts[-2])
        self.prev_col = self.params["rgb_colors"].detach().clone()

    @torch.no_grad()
    def repose_human(self, smplx_param_t: Dict, smplx_param_t1: Dict):
        """Re-pose the non-cloth vertices from pose t to pose t+1 (inverse
        LBS out of t, forward LBS into t+1); cloth vertices keep the
        warm start."""
        from ..avatar import lbs
        from ..avatar.smplx import smplx_forward
        assert self.smplx_model is not None
        cloth_idx = self.variables.get("cloth_v_idx")
        if cloth_idx is None:
            return
        verts = self.params["vertices"]
        mask = torch.ones(verts.shape[0], dtype=torch.bool,
                          device=self.device)
        mask[cloth_idx] = False
        hidx = torch.nonzero(mask)[:, 0]
        if hidx.numel() == 0:
            return
        p0 = _tensors(smplx_param_t, self.device)
        p1 = _tensors(smplx_param_t1, self.device)
        if self.beta is not None:
            p0["beta"] = p1["beta"] = self.beta
        out0 = smplx_forward(self.smplx_model, p0)
        out1 = smplx_forward(self.smplx_model, p1)
        first = lambda p, k: None if p.get(k) is None else p[k][0]
        scalar = lambda p: None if p.get("scale") is None else \
            p["scale"].reshape(-1)[0]
        t_v, _, w = lbs.transform_to_t_pose(
            verts[hidx], out0.vertices[0], out0.transform_mat[0],
            lbs_weights_packed=self.smplx_model.lbs_weights,
            global_transl=first(p0, "trans"), scale=scalar(p0))
        v1, _ = lbs.transform_to_pose(t_v, w, out1.transform_mat[0],
                                      global_transl=first(p1, "trans"),
                                      scale=scalar(p1))
        verts[hidx] = v1

    def resume(self, save_dir: str, start_idx: int, resume_t: int):
        """Resume mid-sequence: params_{resume_t}.npz over
        params_{start_idx}.npz, the inertia history reset to the resumed
        frame, a fresh optimizer."""
        ori = dict(np.load(os.path.join(save_dir,
                                        f"params_{start_idx}.npz")))
        ori.update(dict(np.load(os.path.join(save_dir,
                                             f"params_{resume_t}.npz"))))
        for k in PARAM_KEYS:
            if k in ori:
                self.params[k] = torch.as_tensor(
                    np.asarray(ori[k], np.float32), device=self.device)
        self._init_optimizer()
        self.prev_verts = [self.params["vertices"].detach().clone()]
        self.prev_col = self.params["rgb_colors"].detach().clone()

    def save_frame(self, path, t, cam_count=None):
        """params_{t}.npz in the layout ``load_mesh_avatar`` reads."""
        arr = lambda k: self.params[k].detach().cpu().numpy()
        np.savez(path, vertices=arr("vertices"),
                 faces=self.variables["faces"].cpu().numpy().astype(np.int32),
                 rgb_colors=arr("rgb_colors"), log_scales=arr("log_scales"),
                 logit_opacities=arr("logit_opacities"), cam_m=arr("cam_m"),
                 cam_c=arr("cam_c"))
