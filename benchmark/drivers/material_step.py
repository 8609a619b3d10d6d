"""Stage-3 material training: ``MaterialTrainer.train_one_step`` on the
garment, its body and grid, with D, E and H differentiated through the
checkpointed rollout, each step ending with the loss read back.

The tracked trajectory is the cloth re-posed through the walk at the
rollout's frame rate, the body the posed torso over the same poses.  The
rest shape that H scales is the first cloth turned and shrunk
(``scenes.tilted_rest``): it has vertical extent, so H moves the rest
metric, and the first cloth is stretched against it, so D and E move
the cloth; every parameter's gradient then stands far above round-off.
The seed draws the walk and the first D, E, H inside the
configuration's box.  Set-up builds one trainer and runs its first
``setup_steps`` steps through the same call the window makes; their
losses, the first step's gradient (from Adam's first moment) and the
parameters after them are what the reference is held against.  One step
of the window, drawn from the seed, is kept too: the parameters and Adam
state before it and after it, and its loss, which the reference replays
from the same state.
"""

from __future__ import annotations

import math
import random

import torch

from mpmavatar_tpu_torch.sim.pose_playback import prepare_pose_playback
from mpmavatar_tpu_torch.train.material import (NAMES, MaterialTrainer,
                                                MaterialTrainerConfig)

from .. import roofline, scenes
from ..reference import material as ref_material
from ..reference import posing
from .sim_frames import smplx_model

BETA1 = 0.9


class Driver:
    unit = "step"
    kind = "train"

    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        self.cfg, self.traffic, self.device = cfg, traffic, device
        tr = cfg["train"]
        self.train = tr
        self.raw = scenes.garment_inputs(cfg, seed, device, tr["frames"] + 1,
                                         float(tr["fps"]))
        raw = self.raw
        self.rest = scenes.tilted_rest(raw["verts"], tr["rest"]["tilt_deg"],
                                       tr["rest"]["shrink"])
        body = smplx_model(raw["body"])
        pb = prepare_pose_playback(body, raw["first"], raw["poses"],
                                   raw["verts"], fps=float(tr["fps"]),
                                   k=cfg["knn_k"])
        box = tr["init_box"]
        self.init = {k: scenes.uniform(seed, *box[k], i)
                     for i, k in enumerate(NAMES)}
        bounds = tr["bounds"]
        mcfg = MaterialTrainerConfig(
            grid_size=cfg["grid_size"], grid_lim=cfg["grid_lim"],
            substep=tr["substep"], fps=float(tr["fps"]),
            init_D=self.init["D"], init_E=self.init["E"] * 100.0,
            init_nu=cfg["init_nu"], init_gamma=cfg["gamma"],
            init_kappa=cfg["kappa"], friction_angle=cfg["friction_angle"],
            mesh_friction_coeff=cfg["mesh_friction_coeff"],
            min_D=bounds["D"][0], max_D=bounds["D"][1],
            min_E=bounds["E"][0], max_E=bounds["E"][1],
            min_H=bounds["H"][0], max_H=bounds["H"][1],
            lr_D=tr["lr_D"], lr_E=tr["lr_E"], lr_H=tr["lr_H"],
            iterations=tr["iterations"])
        pins = cfg["pins"]
        self.trainer = MaterialTrainer(
            mcfg, raw["faces"].cpu().numpy(),
            first_frame_verts=self.rest.cpu().numpy(),
            train_verts=pb["verts"].cpu().numpy(),
            smplx_verts=pb["smplx"].cpu().numpy(),
            smplx_faces=body.faces.cpu().numpy(),
            num_joint_v=pins["num_joint_v"], num_joint_f=pins["num_joint_f"],
            device=device)
        with torch.no_grad():
            self.trainer.params["H"].fill_(self.init["H"])
        # the steps the reference follows, through the window's own call
        self.losses, self.grad = [], None
        self.rng, self.window_steps, self.sample = random.Random(seed), 0, None
        self.sampling = False
        for step in range(int(traffic["setup_steps"])):
            self.run_unit()
            if step == 0:
                # the gradient as Adam got it, from its first moment (none
                # where no update was made)
                state = self._state()
                self.grad = {k: float(state[k]["m"]) / (1.0 - BETA1)
                             for k in NAMES}
        self.setup_losses = list(self.losses)
        self.params = {k: float(v) for k, v in
                       self.trainer._params_now().items()}
        self.losses = []
        self.sampling = True

    def _state(self) -> dict:
        """Copies of each parameter and its Adam moments and count (zeros
        where Adam has made no update)."""
        tr = self.trainer
        out = {}
        for k in NAMES:
            p = tr.params[k].detach()
            st = tr.optimizer.state.get(tr.params[k], {})
            zero = torch.zeros_like(p)
            out[k] = {"p": p.clone(), "m": st.get("exp_avg", zero).clone(),
                      "v": st.get("exp_avg_sq", zero).clone(),
                      "n": st.get("step", zero).clone()}
        return out

    def run_unit(self) -> int:
        keep = False
        if self.sampling:
            # one window step, uniformly, whatever the window's length
            self.window_steps += 1
            keep = self.rng.random() * self.window_steps < 1.0
        before = self._state() if keep else None
        sched = self.trainer.step
        loss, _ = self.trainer.train_one_step()
        self.losses.append(loss)
        if keep:
            self.sample = {"index": self.window_steps, "sched": sched,
                           "before": before, "after": self._state(),
                           "loss": loss}
        return 1

    def least_seconds(self) -> float:
        """The least time of a step on the trainer's first state."""
        tr, pins = self.trainer, self.cfg["pins"]
        x, E = tr.base_state.x, tr.static.n_elements
        faces = torch.as_tensor(tr.smplx_faces, device=x.device).long()
        body = tr._rollout_data["smplx_sim"][0]
        pinned = torch.cat([x[E:E + pins["num_joint_v"]],
                            x[:pins["num_joint_f"]]])
        shape = roofline.shape_of(x, E, 0, tr.static.n_vertices,
                                  self.cfg["grid_size"], self.cfg["grid_lim"],
                                  body[faces].mean(1), pinned)
        return roofline.train_step_seconds(shape, self.train["frames"],
                                           self.train["substep"])

    def failed(self, attempted: int) -> int:
        return sum(not math.isfinite(v) for v in self.losses[-attempted:])

    def release(self):
        self.trainer = None

    def _window(self) -> dict | None:
        """The kept window step as numbers: the state it started from,
        and the program's loss, gradient as Adam got it (from the change
        of its first moment) and the parameters after it."""
        s = self.sample
        if s is None:
            return None
        num = lambda side, what: {k: float(s[side][k][what]) for k in NAMES}
        m0, m1 = num("before", "m"), num("after", "m")
        return {"index": s["index"], "sched": s["sched"],
                "p0": num("before", "p"), "m0": m0,
                "v0": num("before", "v"),
                "n0": int(float(s["before"][NAMES[0]]["n"])),
                "loss": s["loss"], "p1": num("after", "p"),
                "grad": {k: (m1[k] - BETA1 * m0[k]) / (1.0 - BETA1)
                         for k in NAMES}}

    def program(self) -> dict:
        """What the program's first steps and its kept window step
        produced."""
        return {"loss": self.setup_losses, "grad": self.grad,
                "params": self.params, "init": self.init,
                "window": self._window()}

    def reference(self, ar) -> dict:
        """The reference's first steps from the raw inputs and the same
        first parameters, and its replay of the kept window step from the
        state the program started it from."""
        raw, tr = self.raw, self.train
        cloth, bodies = posing.repose(raw["body"], raw["first"], raw["poses"],
                                      raw["verts"], self.cfg["knn_k"], ar)
        roll = ref_material.Rollout(self.cfg, tr, raw["faces"], self.rest,
                                    cloth, bodies, raw["body"]["faces"], ar)
        out = ref_material.train(roll, self.init,
                                 int(self.traffic["setup_steps"]))
        win = self._window()
        if win is not None:
            loss, grad, p1, _ = ref_material.adam_step(
                roll, win["p0"], win["m0"], win["v0"], win["n0"],
                win["sched"])
            win = dict(win, loss=loss, grad=grad, p1=p1)
        return {"loss": out["loss"], "grad": out["grad"][0],
                "params": out["params"][-1], "init": self.init,
                "window": win}
