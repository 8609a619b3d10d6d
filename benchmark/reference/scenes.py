"""The reference's own set-up of each configuration's simulation, from
the raw inputs of ``benchmark/scenes.py`` alone: the particles, their
rest metric, volumes, masses and materials, the colliders, the release
windows, and per frame the posed body and the pinned vertices'
velocities."""

from __future__ import annotations

import numpy as np
import torch

from . import mpm, posing
from .arith import Arith


def _static(cfg: dict, E: int, T: int, V: int, faces, r_inv, vol, E_mod,
            nu, collider_faces, dev, **kw) -> mpm.Scene:
    mu, lam = mpm.lame(torch.full((E + T + V,), float(E_mod), device=dev),
                       torch.full((E + T + V,), float(nu), device=dev))
    angle = cfg["friction_angle"]
    return mpm.Scene(
        E=E, T=T, V=V, G=cfg["grid_size"], lim=cfg["grid_lim"],
        faces=faces.long(), r_inv=r_inv, vol=vol, mass=vol.clone(), mu=mu,
        lam=lam, gamma=float(cfg["gamma"]), kappa=float(cfg["kappa"]),
        friction=float(np.float32(np.tan(angle / 180.0 * 3.14159265))),
        alpha=float(np.float32(mpm.drucker_prager_alpha(angle))),
        gravity=torch.tensor([0.0, -9.8, 0.0], device=dev),
        collider_faces=collider_faces.long(),
        collider_friction=float(cfg["mesh_friction_coeff"]), **kw)


def _floor(cfg: dict, dev):
    fl = cfg.get("floor")
    if fl is None:
        return None
    return mpm.below_plane(cfg["grid_size"], cfg["grid_lim"] / cfg[
        "grid_size"], fl["point"], fl["normal"], dev)


def _start(x, T: int, E: int, d):
    dev = x.device
    eye = torch.eye(3, device=dev).expand(T, 3, 3).clone()
    return {"x": x, "v": torch.zeros_like(x),
            "C": torch.zeros((x.shape[0], 3, 3), device=dev), "F": eye,
            "F_trial": eye.clone(), "d": d}


def garment(raw: dict, cfg: dict, ar: Arith):
    """(scene, first state, inputs(frame) -> (mesh_x, mesh_v, joint_v,
    joint_f)) of the garment played through the walk."""
    verts, faces, dev = raw["verts"], raw["faces"].long(), raw["verts"].device
    d, r_inv, evol, vvol = mpm.cloth_geometry(verts, faces)
    E, V = faces.shape[0], verts.shape[0]
    pins = cfg["pins"]
    sc = _static(cfg, E, 0, V, faces, r_inv, torch.cat([evol, vvol]),
                 cfg["cloth"]["E"], cfg["cloth"]["nu"], raw["body"]["faces"],
                 dev, floor=_floor(cfg, dev), joint_v=pins["num_joint_v"],
                 joint_f=pins["num_joint_f"])
    x0 = torch.cat([verts[faces].mean(1), verts])
    cloth, bodies = posing.repose(raw["body"], raw["first"], raw["poses"],
                                  verts, cfg["knn_k"], ar)
    fps = raw["fps"]
    cloth_v, body_v = (cloth[1:] - cloth[:-1]) * fps, \
        (bodies[1:] - bodies[:-1]) * fps
    jf_idx = faces[:sc.joint_f].clamp(max=sc.joint_v - 1)
    n = bodies.shape[0]

    def inputs(i: int):
        moving = i < n - 1
        bx = bodies[min(i, n - 1)]
        bv = body_v[i] if moving else torch.zeros_like(bx)
        vv = cloth_v[i] if moving else torch.zeros_like(verts)
        jv = vv[:sc.joint_v]
        return bx, bv, jv, jv[jf_idx].mean(1)

    return sc, _start(x0, 0, E, d), inputs


def sim_transform(verts):
    """The world -> sim map of the garment: its bounding box scaled to
    unit extent and centred on (1, 1, 1).  (scale, shift (3,))."""
    v = verts.detach().cpu().numpy()
    lo, hi = v.min(0), v.max(0)
    scale = 1.0 / float((hi - lo).max())
    shift = (np.ones(3) - (lo + hi) / 2.0 * scale).astype(np.float32)
    return scale, torch.as_tensor(shift, device=verts.device)


def release_until(x0, normal_axis: int, z_hi: float, z_lo: float,
                  end_time: float, layers: int):
    """Per particle the end of the last release window that holds it
    (-inf: none).  Window i holds the particles within half (layers - i)
    of z_lo along the axis and within 1 of the centre (1, 1) on the
    other two axes, tested in float64 from the first positions; it ends
    at end_time / layers (i + 1)."""
    x = x0.detach().double()
    half = abs(z_hi - z_lo) / layers
    others = [a for a in range(3) if a != normal_axis]
    across = ((x[:, others] - 1.0).abs() < 1.0).all(-1)
    dist = (x[:, normal_axis] - z_lo).abs()
    until = torch.full((x.shape[0],), -np.inf, dtype=torch.float32,
                       device=x0.device)
    portion = end_time / layers
    for i in range(layers):
        inside = across & (dist < half * (layers - i))
        end = torch.tensor(np.float32(portion * (i + 1)), device=x0.device)
        until = torch.where(inside, torch.maximum(until, end), until)
    return until


def demo(raw: dict, cfg: dict, ar: Arith):
    """(scene, first state, inputs(frame)) of the sand demo."""
    verts, faces, dev = raw["verts"], raw["faces"].long(), raw["verts"].device
    scale, shift = sim_transform(verts)
    to_sim = lambda p: p * scale + shift
    sim_v = to_sim(verts)
    d, r_inv, evol, vvol = mpm.cloth_geometry(sim_v, faces)
    sand = to_sim(raw["sand"])
    E, T, V = faces.shape[0], sand.shape[0], verts.shape[0]
    vol = torch.cat([evol, raw["sand_vol"] * np.float32(scale ** 3), vvol])
    x0 = torch.cat([sim_v[faces].mean(1), sand, sim_v])
    cloth, bodies = posing.repose(raw["body"], raw["first"], raw["poses"],
                                  verts, cfg["knn_k"], ar)
    n_body = bodies.shape[1]
    collider = torch.cat([raw["body_faces"].long(),
                          raw["chair_faces"].long() + n_body])
    rel = cfg["release"]
    fps = raw["fps"]
    t0 = rel["start_frame"] / fps
    sand_z = sand[:, 2]
    until = release_until(x0, 2, float(sand_z.max()), float(sand_z.min()),
                          t0 + rel["span_frames"] / fps, rel["layers"])
    sc = _static(cfg, E, T, V, faces, r_inv, vol, cfg["E"], cfg["nu"],
                 collider, dev, floor=_floor(cfg, dev), pin_until=until,
                 pin_start=float(np.float32(t0)))
    body_v = (bodies[1:] - bodies[:-1]) * fps
    chair = to_sim(raw["chair_verts"])
    n = bodies.shape[0]

    def inputs(i: int):
        moving = i < n - 1
        bx = bodies[min(i, n - 1)]
        bv = body_v[i] if moving else torch.zeros_like(bx)
        return (torch.cat([to_sim(bx), chair]),
                torch.cat([bv * scale, torch.zeros_like(chair)]), None, None)

    return sc, _start(x0, T, E, d), inputs
