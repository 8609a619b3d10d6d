"""Stage-3 inverse material estimation and stage-4 simulation (port of
mpmavatar_tpu/train/material.py).

The material parameters (D = density, E = Young's modulus stored /100,
H = the rest shape's vertical scale) are fitted to a tracked garment
trajectory with gradients from autograd through the MPM rollout: on the
card the substep's kernels run forward, and their backwards are autograd
over their plain versions (ops/_autograd.py).  The rollout is
checkpointed at two levels, as the JAX trainer's: each frame, and each
substep inside it (``MPMSolver.frame(remat=True)``), so the backward
keeps one state per frame and, while it runs back through a frame, one
per substep of that frame.  ``train_one_step_finite_diff`` keeps the
reference's four-rollout finite-difference step for comparison.

The JAX trainer's column-bin knobs and cap calibration size the TPU's
transfer layout; the port works on the dense grid, which drops nothing,
so there is no overflow to size or check.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from .. import resolve_device
from ..core import types
from ..sim import MPMSolver, SimTransform, reset_density, set_E_nu
from ..utils.schedules import cosine_lr

NAMES = ("D", "E", "H")
# the finite-difference step's probes of D, E (stored /100) and H
FD_STEPS = (0.05, 0.05, 0.005)


@dataclasses.dataclass
class MaterialTrainerConfig:
    """The ModelParams / OptimizationParams knobs the trainer reads."""
    grid_size: int = 200
    grid_lim: float = 2.0
    substep: int = 400
    fps: float = 25.0
    init_D: float = 1.0
    init_E: float = 100.0   # stored /100 like the reference's E knob
    init_nu: float = 0.3
    init_gamma: float = 500.0
    init_kappa: float = 500.0
    friction_angle: float = 40.0
    mesh_friction_coeff: float = 0.5
    min_D: float = 0.1
    max_D: float = 3.0
    min_E: float = 0.5
    max_E: float = 20.0
    min_H: float = 0.8
    max_H: float = 1.2
    lr_D: float = 1e-2
    lr_E: float = 3e-1
    lr_H: float = 1e-2
    iterations: int = 200
    thickness: float = 1e-5


class MaterialTrainer:
    """Owns the simulation set-up of a garment and fits (D, E, H).

    Inputs (world-space numpy arrays):
      cloth_faces (E, 3)
      first_frame_verts (V, 3) the garment at tracking frame 0 (the rest
                              shape that H scales)
      train_verts (F+1, V, 3) the tracked trajectory (the supervision)
      smplx_verts (F+1, Vb, 3) the body collider's trajectory
      smplx_faces (Fb, 3)
      num_joint_v, num_joint_f: the pinned vertex and face prefixes.
    Runs on CUDA unless ``device="cpu"``.
    """

    def __init__(self, cfg: MaterialTrainerConfig, cloth_faces,
                 first_frame_verts, train_verts, smplx_verts, smplx_faces,
                 num_joint_v: int, num_joint_f: int, device=None):
        self.cfg = cfg
        self.device = dev = resolve_device(device)
        self.faces = np.asarray(cloth_faces, np.int32)
        self.train_verts = np.asarray(train_verts, np.float32)
        self.smplx_verts = np.asarray(smplx_verts, np.float32)
        self.smplx_faces = np.asarray(smplx_faces, np.int32)
        verts0 = self.train_verts[0]

        self.tf = SimTransform.from_verts(verts0)
        E, V = len(self.faces), len(verts0)
        self.static = types.MPMStaticConfig(
            n_elements=E, n_traditional=0, n_vertices=V,
            n_grid=cfg.grid_size, grid_lim=cfg.grid_lim, material=7,
            num_joint_v=num_joint_v, num_joint_f=num_joint_f)
        self._faces = torch.as_tensor(self.faces.astype(np.int64),
                                      device=dev)

        sim_verts0 = self.tf.wld2sim(verts0, dev)
        d, _, evol, vvol = types.cloth_geometry(sim_verts0, self._faces,
                                                thickness=cfg.thickness)
        x0 = torch.cat([sim_verts0[self._faces].mean(1), sim_verts0], 0)
        self.base_state = types.make_state(
            self.static, x0, faces=self.faces, d=d,
            R_inv=torch.zeros((E, 3)), vol=torch.cat([evol, vvol]),
            device=dev)
        self.vertices_init_sim = self.tf.wld2sim(first_frame_verts, dev)
        self.model0 = types.make_model(
            self.static.n_particles, E=cfg.init_E,  # set per rollout
            nu=cfg.init_nu, gamma=cfg.init_gamma, kappa=cfg.init_kappa,
            friction_angle=cfg.friction_angle, device=dev)

        self.solver = MPMSolver(self.static, device=dev)
        self.solver.add_mesh_collider(self.smplx_faces,
                                      friction=cfg.mesh_friction_coeff)
        self.solver.add_particle_mover()

        # per-frame kinematics, world units per second
        fps = cfg.fps
        self.train_verts_velo = (self.train_verts[1:]
                                 - self.train_verts[:-1]) * fps
        self.smplx_velo = (self.smplx_verts[1:]
                           - self.smplx_verts[:-1]) * fps
        n_frames = len(self.train_verts) - 1
        f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)
        self._rollout_data = {
            "smplx_sim": self.tf.wld2sim(self.smplx_verts, dev)[:n_frames],
            "smplx_velo_sim": f32(self.smplx_velo) * self.tf.scale,
            "target_sim": self.tf.wld2sim(self.train_verts, dev)[1:],
            "joint_velo_sim": f32(self.train_verts_velo[:, :num_joint_v])
            * self.tf.scale,
            # a pinned face may name a vertex past the pinned prefix:
            # JAX's gather clamps the index to the last pinned vertex
            "faces_j": self._faces[:num_joint_f].clamp(
                max=max(num_joint_v - 1, 0)),
        }

        init = {"D": cfg.init_D, "E": cfg.init_E / 100.0, "H": 1.0}
        self.params = {k: torch.tensor(np.float32(v), device=dev,
                                       requires_grad=True)
                       for k, v in init.items()}
        # optax.adam's defaults, one learning rate per parameter
        self.optimizer = torch.optim.Adam(
            [{"params": [self.params[k]], "lr": getattr(cfg, f"lr_{k}")}
             for k in NAMES], betas=(0.9, 0.999), eps=1e-8)
        self.lr_schedule = cosine_lr(1.0, cfg.iterations)
        self.step = 0
        self.best = {"loss": np.inf,
                     "params": {k: np.float32(v) for k, v in init.items()}}

    def _rest_dir_inv(self, h):
        """The rest metric of the first frame's vertices, y scaled by h."""
        v = self.vertices_init_sim
        scaled = torch.stack([v[:, 0], v[:, 1] * h, v[:, 2]], 1)
        return types.rest_dir_inv_from_vf(scaled, self._faces)

    def _frame_loss(self, state, model, t: float, i: int):
        """Frame i of the rollout from (state, t): (state, t, the mean
        squared cloth-vertex error against the tracked frame)."""
        cfg, data = self.cfg, self._rollout_data
        jv = data["joint_velo_sim"][i]
        state, t = self.solver.frame(
            state, model, (1.0 / cfg.fps) / cfg.substep, cfg.substep, t,
            mesh_x=data["smplx_sim"][i], mesh_v=data["smplx_velo_sim"][i],
            joint_verts_v=jv, joint_faces_v=jv[data["faces_j"]].mean(1),
            remat=True)
        cloth = state.x[self.static.n_elements:]
        return state, t, torch.mean((cloth - data["target_sim"][i]) ** 2)

    def rollout_loss(self, params: dict) -> torch.Tensor:
        """The mean over frames of the frame losses at ``params`` (0-d
        tensors D, E / 100, H), differentiable w.r.t. them under grad."""
        model = set_E_nu(self.model0, E=params["E"] * 100.0)
        state = reset_density(self.base_state, params["D"])
        state = dataclasses.replace(state,
                                    R_inv=self._rest_dir_inv(params["H"]))
        t, losses = 0.0, []
        for i in range(len(self._rollout_data["target_sim"])):
            # the frame checkpointed around its checkpointed substeps; the
            # rollout draws no random numbers
            state, t, floss = checkpoint(self._frame_loss, state, model, t,
                                         i, use_reentrant=False,
                                         preserve_rng_state=False)
            losses.append(floss)
        return torch.stack(losses).mean()

    def _apply(self, grads):
        """One Adam step on ``grads`` (D, E, H order), then the clip to
        each parameter's range."""
        for k, g in zip(NAMES, grads):
            self.params[k].grad = g
        self.optimizer.step()
        cfg = self.cfg
        with torch.no_grad():
            for k in NAMES:
                self.params[k].clamp_(getattr(cfg, f"min_{k}"),
                                      getattr(cfg, f"max_{k}"))
        self.step += 1

    def _params_now(self) -> dict:
        return {k: float(v.detach()) for k, v in self.params.items()}

    def train_one_step(self):
        """One optimization step with autodiff gradients, scaled by the
        cosine schedule before Adam.  Returns (the loss before the step,
        the parameters after it)."""
        loss = self.rollout_loss(self.params)
        grads = torch.autograd.grad(loss, [self.params[k] for k in NAMES])
        lr_scale = float(self.lr_schedule(self.step))
        self._apply([g * lr_scale for g in grads])
        loss_f = float(loss.detach())
        params = self._params_now()
        if loss_f < self.best["loss"]:
            self.best = {"loss": loss_f, "params": params}
        return loss_f, params

    def train_one_step_finite_diff(self):
        """The reference's four-rollout finite-difference step (no
        schedule scaling): the unprobed parameters, then each of
        ``FD_STEPS`` on its own axis.  Returns (the loss at the unprobed
        parameters, the parameters after the step)."""
        probes = [(0.0, 0.0, 0.0)] + [
            tuple(step if j == i else 0.0 for j in range(3))
            for i, step in enumerate(FD_STEPS)]
        losses = []
        with torch.no_grad():
            for probe in probes:
                p = {k: self.params[k] + dp for k, dp in zip(NAMES, probe)}
                losses.append(float(self.rollout_loss(p)))
        self._apply([torch.tensor(np.float32((losses[i + 1] - losses[0])
                                             / step), device=self.device)
                     for i, step in enumerate(FD_STEPS)])
        return losses[0], self._params_now()

    def save(self, out_dir: str):
        """The best and the last parameters as npz (E in its own units)."""
        os.makedirs(out_dir, exist_ok=True)
        best = self.best["params"]
        np.savez(os.path.join(out_dir, f"best_param_{self.step:05d}.npz"),
                 D=best["D"], E=best["E"] * 100.0, H=best["H"],
                 loss=self.best["loss"], step=self.step)
        last = self._params_now()
        np.savez(os.path.join(out_dir, f"last_param_{self.step:05d}.npz"),
                 D=last["D"], E=last["E"] * 100.0, H=last["H"],
                 step=self.step)

    def simulate(self, test_verts0, test_verts_velo0, test_smplx,
                 test_smplx_velo, n_frames: int, joint_velo_fn=None):
        """Stage-4 rollout on test poses at the current parameters: the
        cloth vertices of each frame in world space (numpy)."""
        cfg, static, dev = self.cfg, self.static, self.device
        dt = (1.0 / cfg.fps) / cfg.substep
        scale = self.tf.scale
        f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32),
                                        device=dev)
        outs = []
        with torch.no_grad():
            model = set_E_nu(self.model0, E=self.params["E"] * 100.0)
            sim_v0 = self.tf.wld2sim(test_verts0, dev)
            dmat, _, evol, vvol = types.cloth_geometry(
                sim_v0, self._faces, thickness=cfg.thickness)
            init_velo = f32(test_verts_velo0) * scale
            x0 = torch.cat([sim_v0[self._faces].mean(1), sim_v0], 0)
            v0 = torch.cat([init_velo[self._faces].mean(1), init_velo], 0)
            state = types.make_state(
                static, x0, faces=self.faces, d=dmat,
                R_inv=self._rest_dir_inv(self.params["H"]),
                vol=torch.cat([evol, vvol]), v=v0, device=dev)
            state = reset_density(state, self.params["D"])
            t = 0.0
            for i in range(n_frames):
                jv = jf = None
                if joint_velo_fn is not None:
                    jv = f32(joint_velo_fn(i)) * scale
                    jf = jv[self._rollout_data["faces_j"]].mean(1)
                state, t = self.solver.frame(
                    state, model, dt, cfg.substep, t,
                    mesh_x=self.tf.wld2sim(test_smplx[i], dev),
                    mesh_v=f32(test_smplx_velo[i]) * scale,
                    joint_verts_v=jv, joint_faces_v=jf)
                self.solver.check_finite(state, context=f"simulate frame {i}")
                cloth = self.tf.sim2wld(state.x[static.n_elements:])
                outs.append(cloth.cpu().numpy())
        return outs
