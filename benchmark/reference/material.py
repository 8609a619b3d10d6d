"""Plain stage-3 material steps: the garment's rollout loss against a
tracked trajectory, its gradient with respect to (D, E / 100, H) by
autograd through checkpointed substeps, the cosine-scaled gradient, Adam
and the clip to each parameter's range (MPMAvatar's
``train_material_params.py`` with autodiff gradients, as the ports
train)."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import mpm
from .arith import Arith
from .scenes import _static, sim_transform

NAMES = ("D", "E", "H")


class Rollout:
    """The loss of one set of parameters over the trajectory
    ``train_verts`` (F+1, V, 3) with the body ``bodies`` (F+1, Vb, 3),
    world space; ``rest`` (V, 3) is the rest shape H scales."""

    def __init__(self, cfg: dict, train: dict, faces, rest, train_verts,
                 bodies, body_faces, ar: Arith):
        self.cfg, self.train, self.ar = cfg, train, ar
        dev = train_verts.device
        self.faces = faces.long()
        scale, shift = sim_transform(train_verts[0])
        to_sim = lambda p: p * scale + shift
        v0 = to_sim(train_verts[0])
        d, _, evol, vvol = mpm.cloth_geometry(v0, self.faces)
        E, V = self.faces.shape[0], v0.shape[0]
        pins = cfg["pins"]
        self.sc = _static(cfg, E, 0, V, self.faces,
                          torch.zeros((E, 3), device=dev),
                          torch.cat([evol, vvol]), 1.0, cfg["init_nu"],
                          body_faces, dev, joint_v=pins["num_joint_v"],
                          joint_f=pins["num_joint_f"])
        self.start = {"x": torch.cat([v0[self.faces].mean(1), v0]),
                      "v": torch.zeros((E + V, 3), device=dev),
                      "C": torch.zeros((E + V, 3, 3), device=dev),
                      "F": torch.zeros((0, 3, 3), device=dev),
                      "F_trial": torch.zeros((0, 3, 3), device=dev), "d": d}
        self.rest = to_sim(rest)
        fps = float(train["fps"])
        tv, bv = train_verts.cpu().numpy(), bodies.cpu().numpy()
        f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32),
                                        device=dev)
        n = tv.shape[0] - 1
        self.body_x = to_sim(bodies)[:n]
        self.body_v = f32((bv[1:] - bv[:-1]) * np.float32(fps)) * scale
        self.target = to_sim(train_verts)[1:]
        self.joint_v = f32((tv[1:] - tv[:-1])[:, :pins["num_joint_v"]]
                           * np.float32(fps)) * scale
        self.faces_j = self.faces[:pins["num_joint_f"]].clamp(
            max=pins["num_joint_v"] - 1)

    def loss(self, D, E100, H):
        sc, P = self.sc, self.sc.E + self.sc.V
        mu, lam = mpm.lame((E100 * 100.0).expand(P),
                           torch.full((P,), float(self.cfg["init_nu"]),
                                      device=D.device))
        rest = torch.stack([self.rest[:, 0], self.rest[:, 1] * H,
                            self.rest[:, 2]], 1)
        sc = dataclasses.replace(sc, mu=mu, lam=lam, mass=D.expand(P) * sc.vol,
                                 r_inv=mpm.rest_metric(rest, self.faces))
        st, t = self.start, 0.0
        dt = (1.0 / self.train["fps"]) / self.train["substep"]
        losses = []
        for i in range(self.target.shape[0]):
            jv = self.joint_v[i]
            st, t = mpm.frame(sc, st, t, dt, self.train["substep"],
                              self.body_x[i], self.body_v[i], jv,
                              jv[self.faces_j].mean(1), self.ar,
                              checkpoint=True)
            losses.append(((st["x"][sc.E:] - self.target[i]) ** 2).mean())
        return torch.stack(losses).mean()


def adam_step(rollout: Rollout, p0: dict, m0: dict, v0: dict, n0: int,
              sched: int):
    """One step from the parameters ``p0`` {D, E (/100), H}, Adam's
    moments ``m0``, ``v0`` after ``n0`` updates, at the cosine schedule's
    step ``sched``: (the loss at ``p0``, the gradient as Adam got it, the
    parameters after the step and the clip, and the moments after it)."""
    tr = rollout.train
    dev = rollout.start["x"].device
    f32 = lambda a: torch.tensor(np.float32(a), device=dev)
    leaves = {k: f32(p0[k]).requires_grad_(True) for k in NAMES}
    loss = rollout.loss(leaves["D"], leaves["E"], leaves["H"])
    grads = torch.autograd.grad(loss, [leaves[k] for k in NAMES])
    t = np.clip(sched / max(tr["iterations"], 1), 0.0, 1.0)
    scale = float(0.5 * (1 + np.cos(np.pi * t)))
    b1, b2, eps = 0.9, 0.999, 1e-8
    n = n0 + 1
    got, after, m1, v1 = {}, {}, {}, {}
    for k, g in zip(NAMES, grads):
        g = g * scale
        got[k] = float(g)
        m = b1 * f32(m0[k]) + (1 - b1) * g
        v = b2 * f32(v0[k]) + (1 - b2) * g * g
        denom = (v.sqrt() / np.sqrt(1 - b2 ** n)) + eps
        p = f32(p0[k]) - (tr[f"lr_{k}"] / (1 - b1 ** n)) * m / denom
        lo, hi = tr["bounds"][k]
        after[k] = float(p.clamp(lo, hi))
        m1[k], v1[k] = float(m), float(v)
    return float(loss.detach()), got, after, (m1, v1)


def train(rollout: Rollout, init: dict, steps: int) -> dict:
    """``steps`` steps from ``init`` {D, E (/100), H}: the loss before
    each step, the gradient as Adam got it in each, and the parameters
    after each."""
    p = dict(init)
    m = dict.fromkeys(NAMES, 0.0)
    v = dict.fromkeys(NAMES, 0.0)
    out = {"loss": [], "grad": [], "params": []}
    for step in range(steps):
        loss, got, p, (m, v) = adam_step(rollout, p, m, v, step, step)
        out["loss"].append(loss)
        out["grad"].append(got)
        out["params"].append(dict(p))
    return out
