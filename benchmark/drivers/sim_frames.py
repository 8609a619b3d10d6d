"""Forward animation in whole frames, as a user animates an avatar or
runs the demo: per frame the scene's host work (the posed body, the
pinned vertices' velocities), then ``MPMSolver.frame`` of ``substep``
substeps, then a synchronize.

The configuration's ``scene`` picks the set-up: ``garment`` builds
``sim/pose_playback.py``'s scene (the cloth, the posed body as the
collider, the pinned prefix driven by the re-posed cloth) over the
benchmark's walk; ``demo`` builds ``train/run_demo.py``'s (the skirt,
the rig and chair as the collider, the sand and its release windows).
"""

from __future__ import annotations

import dataclasses
import random

import numpy as np
import torch

from mpmavatar_tpu_torch.avatar import SMPLXModel
from mpmavatar_tpu_torch.core.types import cloth_scene
from mpmavatar_tpu_torch.sim.pose_playback import (PosePlayback,
                                                   prepare_pose_playback)
from mpmavatar_tpu_torch.sim.solver import MPMSolver, SimTransform
from mpmavatar_tpu_torch.train.demo import build_demo_sim

from .. import roofline, scenes
from ..reference import scenes as ref_scenes
from ..reference.mpm import frame as ref_frame

FIELDS = ("x", "v", "C", "F", "F_trial", "d")


def smplx_model(body: dict) -> SMPLXModel:
    """The program's body model holding the benchmark's arrays."""
    return SMPLXModel(**body)


def fields(state) -> dict:
    return {k: getattr(state, k) for k in FIELDS}


class Driver:
    unit = "substep"
    kind = "sim"

    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        self.cfg, self.traffic, self.device = cfg, traffic, device
        self.fps, self.substeps = float(cfg["fps"]), int(cfg["substep"])
        self.dt = (1.0 / self.fps) / self.substeps
        build = {"garment": self._garment, "demo": self._demo}[cfg["scene"]]
        build(seed)
        self.t, self.index = 0.0, 0
        self.rng = random.Random(seed)
        self.window_frames = 0
        self.kept = {}          # "start": frame 0; "sample": a window frame
        for _ in range(int(traffic["warmup_frames"])):
            self.run_unit()
        self.window_start = (self.state.x, self.inputs(self.index)["mesh_x"])

    # ------------------------------------------------------------------
    def _garment(self, seed):
        cfg, dev = self.cfg, self.device
        raw = scenes.garment_inputs(cfg, seed, dev, int(self.traffic["poses"]),
                                    self.fps)
        body = smplx_model(raw["body"])
        playback = prepare_pose_playback(body, raw["first"], raw["poses"],
                                         raw["verts"], fps=self.fps,
                                         k=cfg["knn_k"])
        mcfg, state, model = cloth_scene(raw["verts"].cpu().numpy(),
                                         raw["faces"].cpu().numpy(),
                                         cfg["grid_size"],
                                         E=cfg["cloth"]["E"],
                                         nu=cfg["cloth"]["nu"], device=dev)
        pins = cfg["pins"]
        mcfg = dataclasses.replace(mcfg, num_joint_v=pins["num_joint_v"],
                                   num_joint_f=pins["num_joint_f"])
        solver = MPMSolver(mcfg, device=dev)
        floor = cfg["floor"]
        solver.add_surface_collider(floor["point"], floor["normal"])
        solver.add_mesh_collider(body.faces.cpu().numpy(),
                                 friction=cfg["mesh_friction_coeff"])
        solver.add_particle_mover()
        scene = PosePlayback(solver, state, model, playback)
        self.raw, self.solver, self.state, self.model = raw, solver, state, \
            model
        self.inputs = scene.inputs
        self.collider_faces = raw["body"]["faces"].long()
        self.blocks = (mcfg.n_elements, 0, mcfg.n_vertices, pins[
            "num_joint_v"], pins["num_joint_f"])

    def _demo(self, seed):
        cfg, dev = self.cfg, self.device
        raw = scenes.demo_inputs(cfg, seed, dev)
        body = smplx_model(raw["body"])
        playback = prepare_pose_playback(body, raw["first"], raw["poses"],
                                         raw["verts"], fps=self.fps,
                                         k=cfg["knn_k"])
        cloth_v = raw["verts"].cpu().numpy()
        body_v = playback["smplx"][0].cpu().numpy()
        n_body = len(body_v)
        body_f = np.concatenate([raw["body_faces"].cpu().numpy(),
                                 raw["chair_faces"].cpu().numpy() + n_body])
        chair_v = raw["chair_verts"].cpu().numpy()
        tf = SimTransform.from_verts(cloth_v)
        sand = raw["sand"].cpu().numpy()
        mcfg, state, model, solver = build_demo_sim(
            cloth_v, raw["faces"].cpu().numpy(), sand,
            raw["sand_vol"].cpu().numpy(), np.concatenate([body_v, chair_v]),
            body_f, tf, grid_size=cfg["grid_size"], E=cfg["E"], nu=cfg["nu"],
            device=dev)
        rel = cfg["release"]
        t0 = rel["start_frame"] / self.fps
        sand_z = tf.wld2sim(sand)[:, 2]
        solver.release_particles_sequentially(
            state, [0.0, 0.0, 1.0], float(sand_z.max()), float(sand_z.min()),
            start_time=t0, end_time=t0 + rel["span_frames"] / self.fps,
            num_layers=rel["layers"])
        chair_sim = tf.wld2sim(torch.as_tensor(chair_v, device=dev))
        zeros_chair = torch.zeros_like(chair_sim)
        n_pose = playback["smplx"].shape[0]

        def inputs(i):
            # train/run_demo.py's frame inputs, no pinned vertices
            moving = i < n_pose - 1
            bx = playback["smplx"][min(i, n_pose - 1)]
            bv = playback["smplx_velo"][i] if moving else \
                torch.zeros_like(bx)
            return {"mesh_x": torch.cat([tf.wld2sim(bx), chair_sim], 0),
                    "mesh_v": torch.cat([bv * tf.scale, zeros_chair], 0),
                    "joint_verts_v": None, "joint_faces_v": None}

        self.raw, self.solver, self.state, self.model = raw, solver, state, \
            model
        self.inputs = inputs
        self.collider_faces = torch.as_tensor(body_f, device=dev).long()
        self.blocks = (mcfg.n_elements, mcfg.n_traditional, mcfg.n_vertices,
                       0, 0)

    # ------------------------------------------------------------------
    def run_unit(self) -> int:
        """One frame; returns its substeps."""
        i, start = self.index, self.state
        self.state, self.t = self.solver.frame(
            self.state, self.model, self.dt, self.substeps, self.t,
            **self.inputs(i))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.index += 1
        if i == 0:
            self.kept["start"] = (0, None, fields(self.state))
        elif i >= int(self.traffic["warmup_frames"]):
            # one window frame, uniformly, whatever the window's length
            self.window_frames += 1
            if self.rng.random() * self.window_frames < 1.0:
                self.kept["sample"] = (i, fields(start), fields(self.state))
        return self.substeps

    def least_seconds(self) -> float:
        """The least time of a frame on the window's first state."""
        (x, mesh_x), (E, T, V, jv, jf) = self.window_start, self.blocks
        pinned = torch.cat([x[E + T:E + T + jv], x[:jf]])
        shape = roofline.shape_of(
            x, E, T, V, self.cfg["grid_size"], self.cfg["grid_lim"],
            mesh_x[self.collider_faces].mean(1), pinned)
        return roofline.frame_seconds(shape, self.substeps)

    def failed(self, attempted: int) -> int:
        """Every frame of the window, when its last state is not
        finite (each frame starts from the one before)."""
        ok = all(bool(torch.isfinite(getattr(self.state, k)).all())
                 for k in FIELDS)
        return 0 if ok else attempted

    def release(self):
        """Drop the program's objects; the kept states stay."""
        self.solver = self.model = self.inputs = self.state = None
        self.window_start = None

    # ------------------------------------------------------------------
    def frame_time(self, k: int) -> float:
        """The time at frame k's start, in float32 steps of dt."""
        t, dt = np.float32(0.0), np.float32(self.dt)
        for _ in range(k * self.substeps):
            t = np.float32(t + dt)
        return float(t)

    def reference(self, ar):
        """The reference's scene for this configuration, and a function
        that runs one frame of it from a start state."""
        build = {"garment": ref_scenes.garment, "demo": ref_scenes.demo}[
            self.cfg["scene"]]
        with torch.no_grad():
            sc, first, inputs = build(self.raw, self.cfg, ar)

        def run(k, start):
            with torch.no_grad():
                out, _ = ref_frame(sc, first if start is None else start,
                                   self.frame_time(k), self.dt,
                                   self.substeps, *inputs(k), ar)
            return out
        return run
