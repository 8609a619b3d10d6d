"""The zero-shot interaction demo's building blocks, port of
mpmavatar_tpu/train/demo.py: the avatar sits on a chair while a block of
sand is poured onto it and released layer by layer; everything is
rendered with extra gaussians (sand, chair) along a 360-degree orbit.
The simulation mixes the anisotropic cloth elements with a
``traditional`` sand block (Drucker-Prager, K8 on the card).

``build_demo_sim`` takes the JAX function's physics; its TPU knobs
(``column_k``, ``mesh_column_k``, ``column_c_cap``, ``column_radius``,
``rebin_auto``) and the cap calibration they need are not ported: the
port's kernels work on the dense grid.  ``prepare_pose_playback`` is
``sim/pose_playback.py``'s, re-exported under the JAX module's name.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import resolve_device
from ..core import types
from ..render import camera_arrays, convert_sh_colors, render
from ..render import gaussians as G
from ..render.cameras import Camera
from ..render.geometry import covariance_from_scaling_rotation
from ..sim.pose_playback import prepare_pose_playback  # noqa: F401
from ..sim.solver import (MPMSolver, SimTransform, reset_density,
                          set_parameters_dict)
from .appearance import shaded_colors

SAND_SCALE = 0.3 * 0.2 / 50


def get_sand(center=(-0.4, 1.8, -0.1), length=(0.8, 0.04, 0.2),
             res=(200, 10, 50), noise=0.01, seed=0):
    """The sand block: a jittered lattice of res[0] x res[1] x res[2]
    points (numpy ``default_rng(seed)``).  Returns (positions (N, 3),
    per-particle volume (N,)) as float32 numpy arrays."""
    rng = np.random.default_rng(seed)
    g = np.stack(np.meshgrid(np.arange(res[1]), np.arange(res[2]),
                             np.arange(res[0]), indexing="ij"),
                 -1).reshape(-1, 3).astype(np.float32)[:, [2, 0, 1]]
    g /= np.array([[res[0] - 1, res[1] - 1, res[2] - 1]], np.float32)
    g *= np.array([length], np.float32)
    g += np.array([center], np.float32)
    g += rng.normal(0, noise, g.shape).astype(np.float32)
    n = res[0] * res[1] * res[2]
    vol = (length[0] * length[1] * length[2] / n) * np.ones(n, np.float32)
    return g, vol


def _trans_xyz(x, y, z):
    m = np.eye(4)
    m[:3, 3] = [x, y, z]
    return m


def _rot_phi(phi):
    m = np.eye(4)
    c, s = np.cos(phi), np.sin(phi)
    m[1, 1], m[1, 2], m[2, 1], m[2, 2] = c, -s, s, c
    return m


def _rot_theta(th):
    m = np.eye(4)
    c, s = np.cos(th), np.sin(th)
    m[0, 0], m[0, 2], m[2, 0], m[2, 2] = c, -s, s, c
    return m


def pose_spherical(theta, phi, x, y, z):
    """A camera-to-world matrix on the orbit."""
    c2w = _trans_xyz(x, y, z)
    c2w = _rot_phi(phi / 180.0 * np.pi) @ c2w
    return _rot_theta(theta / 180.0 * np.pi) @ c2w


def get_spherical_cam(ref_cam: Camera, num_frames: int):
    """``num_frames`` cameras on a 360-degree orbit with ``ref_cam``'s
    size and focal lengths."""
    w, h = ref_cam.image_width, ref_cam.image_height
    k = np.array([[ref_cam.fx, 0.0, 0.5 * w], [0.0, ref_cam.fy, 0.5 * h],
                  [0.0, 0.0, 1.0]])
    c2ws = np.stack([pose_spherical(a, -10.0, 0.0, 1.1, 3.0)
                     for a in np.linspace(0, 360, num_frames + 1)[:-1]], 0)
    c2ws[:, :3, 1:3] *= -1
    return [Camera.from_kw2c("MovingCam", w, h, k, w2c)
            for w2c in np.linalg.inv(c2ws)]


def _sand_color(sand_xyz):
    lo = sand_xyz.min(dim=0, keepdim=True).values
    hi = sand_xyz.max(dim=0, keepdim=True).values
    return (sand_xyz - lo) / torch.clamp_min(hi - lo, 1e-8) * 0.5 + 0.25


def _identity_rotations(n, like):
    rot = torch.zeros((n, 4), dtype=like.dtype, device=like.device)
    rot[:, 0] = 1.0
    return rot


def get_extra_attr(chair: dict, chair_color, sand_xyz):
    """The extra gaussians' attribute packs (xyz, colour, opacity, scale,
    rotation): sand and chair together, the chair alone, and the sand's
    position colours."""
    n = sand_xyz.shape[0]
    sand_color = _sand_color(sand_xyz)
    ones = torch.ones((n, 1), dtype=sand_xyz.dtype, device=sand_xyz.device)
    sand = (sand_xyz, sand_color, ones, SAND_SCALE * ones.expand(n, 3),
            _identity_rotations(n, sand_xyz))
    extra_chair = (chair["xyz"], chair_color, chair["opacity"],
                   chair["scale"], chair["rotation"])
    extra_all = tuple(torch.cat([a, b], 0) for a, b in zip(sand,
                                                            extra_chair))
    return extra_all, extra_chair, sand_color


def prune_faces_opacity(splats: G.GaussianParams, prune_f_idx):
    """Silence the gaussians bound to the given faces (opacity logit
    -100)."""
    idx = torch.as_tensor(np.asarray(prune_f_idx),
                          device=splats.binding.device)
    mask = torch.isin(splats.binding, idx)
    return dataclasses.replace(splats, opacity=torch.where(
        mask[:, None], torch.full_like(splats.opacity, -100.0),
        splats.opacity))


def build_demo_sim(cloth_verts0, cloth_faces, sand_xyz, sand_vol,
                   collider_verts, collider_faces, tf: SimTransform,
                   grid_size=250, num_joint_v=0, num_joint_f=0,
                   mesh_friction=0.5, friction_angle=40.0, density=1.0,
                   E=200.0, nu=0.3, gamma=500.0, kappa=500.0, device=None):
    """The mixed cloth + sand simulation: elements and vertices from the
    garment, the sand as the traditional block (material ``sand``), the
    sticky floor at y = 0.1, the body (+ chair) mesh collider of friction
    ``mesh_friction`` and the particle mover.  ``collider_verts`` is
    accepted for the JAX function's signature (it sized the TPU caps).
    Returns (cfg, state, model, solver) on ``device``."""
    device = resolve_device(device)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    faces = np.asarray(cloth_faces, np.int32)
    sand_sim = tf.wld2sim(f32(sand_xyz))
    sim_verts = tf.wld2sim(f32(cloth_verts0))
    cfg = types.MPMStaticConfig(
        n_elements=len(faces), n_traditional=len(sand_xyz),
        n_vertices=len(sim_verts), n_grid=grid_size, grid_lim=2.0,
        material=2, num_joint_v=num_joint_v, num_joint_f=num_joint_f)
    faces_t = torch.as_tensor(faces, device=device)
    d, r_inv, evol, vvol = types.cloth_geometry(sim_verts, faces_t)
    x = torch.cat([sim_verts[faces_t.long()].mean(1), sand_sim, sim_verts],
                  0)
    vol = torch.cat([evol, f32(sand_vol) * np.float32(tf.scale ** 3), vvol],
                    0)
    state = types.make_state(cfg, x, faces=faces_t, d=d, R_inv=r_inv,
                             vol=vol, device=device)
    model = types.make_model(cfg.n_particles, E=E, nu=nu, gamma=gamma,
                             kappa=kappa, friction_angle=friction_angle,
                             device=device)
    cfg, model, state = set_parameters_dict(cfg, model, state, {
        "material": "sand", "g": [0.0, -9.8, 0.0],
        "friction_angle": friction_angle})
    state = reset_density(state, density)
    solver = MPMSolver(cfg, device=device)
    solver.add_surface_collider([0.0, 0.1, 0.0], [0.0, 1.0, 0.0])
    solver.add_mesh_collider(collider_faces, friction=mesh_friction)
    solver.add_particle_mover()
    return cfg, state, model, solver


def sand_release_schedule(solver, state, cfg, normal=(0.0, 0.0, 1.0),
                          start_position=0.0, end_position=1.0,
                          start_time=0.0, end_time=1.0, num_layers=50):
    """The gradual sand release: ``num_layers`` shrinking pin regions
    along ``normal`` (``MPMSolver.release_particles_sequentially``)."""
    solver.release_particles_sequentially(
        state, normal, start_position, end_position, start_time, end_time,
        num_layers=num_layers)


def render_demo_frame(avatar, params, verts, ao_map, cam, camera_idx,
                      sand_xyz=None, chair=None, chair_shs=None,
                      active_sh_degree: int = 3, tile_capacity: int = 512,
                      tile_capacity_lo: int = 64, hot_tiles: int = 1024):
    """One orbit frame: the avatar (shadowed SH colours), the chair (SH
    toward the camera) and the sand (position colours) on a white
    background, colour-calibrated, on the device of ``verts``.  Sand and
    chair are independent overlays.  Returns (image (3, H, W) in [0, 1],
    the rasterizer's outputs)."""
    frames = avatar.frames_for_verts(verts)
    ca = camera_arrays(cam, verts.device)
    xyz = G.get_xyz(params.splats, frames)
    colors, _ = shaded_colors(avatar, params, frames, ao_map, ca.cam_center,
                              xyz, active_sh_degree)
    packs = []
    if sand_xyz is not None:
        n = sand_xyz.shape[0]
        ones = torch.ones((n,), dtype=sand_xyz.dtype, device=sand_xyz.device)
        cov = covariance_from_scaling_rotation(
            SAND_SCALE * ones[:, None].expand(n, 3), 1.0,
            _identity_rotations(n, sand_xyz))
        packs.append((sand_xyz, _sand_color(sand_xyz), ones, cov))
    if chair is not None:
        need = (active_sh_degree + 1) ** 2
        if chair_shs.shape[1] < need:
            # coefficients past the chair's own read its last one, as the
            # JAX package's gather clamps their index
            chair_shs = torch.cat([chair_shs, chair_shs[:, -1:].expand(
                -1, need - chair_shs.shape[1], -1)], 1)
        chair_color = convert_sh_colors(chair_shs, chair["xyz"],
                                        ca.cam_center, active_sh_degree)
        cov = covariance_from_scaling_rotation(chair["scale"], 1.0,
                                               chair["rotation"])
        packs.append((chair["xyz"], chair_color, chair["opacity"].reshape(-1),
                      cov))
    extra = tuple(torch.cat([p[i] for p in packs], 0)
                  for i in range(4)) if packs else None
    out = render(cam, params.splats, frames,
                 bg_color=torch.ones(3, device=verts.device),
                 active_sh_degree=active_sh_degree, override_color=colors,
                 extra=extra, tile_capacity=tile_capacity,
                 tile_capacity_lo=tile_capacity_lo, hot_tiles=hot_tiles)
    img = out["render"] * torch.exp(params.cam_m[camera_idx])[:, None, None] \
        + params.cam_c[camera_idx][:, None, None]
    img = img * out["mask"] + (1.0 - out["mask"])
    return torch.clamp(img, 0.0, 1.0), out


def load_chair_gaussians(path: str, device=None):
    """The chair's gaussians: an npz of {xyz, shs, opacity, scale,
    rotation} (activated values) or a 3DGS checkpoint PLY (raw, activated
    here).  Returns (chair dict, SH coefficients (N, K, 3)) on
    ``device``."""
    device = resolve_device(device)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    if path.endswith(".npz"):
        d = dict(np.load(path))
        chair = {"xyz": f32(d["xyz"]),
                 "opacity": f32(d["opacity"]).reshape(-1, 1),
                 "scale": f32(d["scale"]), "rotation": f32(d["rotation"])}
        return chair, f32(d["shs"])
    from ..utils.io import read_ply_gaussians
    d = read_ply_gaussians(path)
    chair = {"xyz": f32(d["xyz"]),
             "opacity": torch.sigmoid(f32(d["opacity"]).reshape(-1, 1)),
             "scale": torch.exp(f32(d["scaling"])),
             "rotation": f32(d["rotation"])}
    return chair, torch.cat([f32(d["features_dc"]),
                             f32(d["features_rest"])], 1)
