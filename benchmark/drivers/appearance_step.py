"""Stage-2 appearance training: ``train/appearance.py``'s
``make_optimizer`` and ``make_train_step`` on the avatar of
``avatar_scene.py``, through ``render/rasterizer.py``'s worklist path (K6
forward, K7 backward on the card), LPIPS-VGG16 on seeded weights, each
step ending with its loss and the rasterizer's overflow counts read back.

Step i renders camera i mod ``views`` at a frame drawn from the seed,
against that (camera, frame)'s seeded ground truth.  Set-up builds the
program from the seed's assets and loads the first state that
``avatar_scene.first_state`` draws (the reference starts from the same
state, so nothing of it comes from the program), runs its first ``setup_steps`` steps
through the same call the window makes (their losses, the first step's
gradient from Adam's first moment, and the parameters after them are what
the reference is held against), then one step on each view.  One window
step among the first ``keep_within``, drawn from the seed, is kept: the
leaves and Adam's state before it, and the program's loss, gradient and
leaves after it, which the reference replays.  The last two warm-up
steps keep their states the same way, so that the window's kept step
finds the device memory as set-up left it and the run's peak is set-up's.

The harness wants one number per leaf: each leaf x of the program and
of the reference is read as its signed projection sum(r * x) /
sqrt(numel), r a fixed N(0, 1) tensor of the leaf's shape drawn from the
seed, the same on both sides.
"""

from __future__ import annotations

import math
import random

import torch

from mpmavatar_tpu_torch.data import OptimizationParams
from mpmavatar_tpu_torch.render import camera_arrays
from mpmavatar_tpu_torch.render import gaussians as G
from mpmavatar_tpu_torch.render.avatar_model import AvatarParams, MeshAvatar
from mpmavatar_tpu_torch.render.cameras import Camera
from mpmavatar_tpu_torch.train import appearance
from mpmavatar_tpu_torch.utils.lpips import LPIPS

from .. import avatar_scene, roofline_appearance
from ..reference import appearance as ref_appearance

BETA1 = 0.9
FROZEN = tuple(f"shadow.{k}" for k in appearance.FROZEN_SHADOW)


class Driver:
    unit = "step"
    kind = "train"

    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        self.cfg, self.traffic, self.seed, self.device = (cfg, traffic, seed,
                                                          device)
        raw = self.raw = avatar_scene.inputs(cfg, seed)
        im = cfg["image"]
        self.width, self.height = im["width"], im["height"]
        self.avatar = MeshAvatar(
            faces=raw["faces"].astype("int32"), verts_orig=raw["verts"],
            ao_maps=raw["ao"], uv_coord=raw["uv"],
            face_neighbors=raw["face_neighbors"],
            neighbor_weight=raw["neighbor_weight"],
            neighbor_dist=raw["neighbor_dist"],
            num_timesteps=cfg["frames"], sh_degree=cfg["sh_degree"])
        first = avatar_scene.first_state(cfg, raw, seed)
        t = lambda k: first[k].to(device, copy=True)
        self.params = AvatarParams(
            splats=G.GaussianParams(**{
                f: t(f"splats.{f}") for f in (*appearance.SPLAT_FLOATS,
                                              "binding", "alive")}),
            verts_offset=t("verts_offset"), cam_m=t("cam_m"),
            cam_c=t("cam_c"),
            shadow={k.split(".", 1)[1]: t(k) for k in first
                    if k.startswith("shadow.")})
        o, w = cfg["optimization"], cfg["loss_weights"]
        opt = OptimizationParams(
            position_lr_init=o["position_lr_init"],
            verts_lr_init=o["verts_lr_init"], feature_lr=o["feature_lr"],
            opacity_lr=o["opacity_lr"], scaling_lr=o["scaling_lr"],
            rotation_lr=o["rotation_lr"], lambda_dssim=w["dssim"],
            lambda_lpips=w["lpips"], threshold_xyz=w["threshold_xyz"],
            threshold_scale=w["threshold_scale"])
        self.optimizer = appearance.make_optimizer(
            opt, raw["spatial_lr_scale"], self.params)
        lpips = LPIPS(raw["lpips"], device=device) if w["lpips"] else None
        self.train_step = appearance.make_train_step(
            self.avatar, opt, self.optimizer, cfg["active_sh_degree"],
            cfg["white_bkgd"], weights=appearance.AppearanceLossWeights(**w),
            lpips_fn=lpips, **cfg["raster"])
        self.cams = [camera_arrays(Camera.from_kw2c(
            f"ring{i:02d}", self.width, self.height, k, w2c, near=im["near"],
            far=im["far"]), device) for i, (k, w2c) in enumerate(raw["cams"])]
        self.ao = self.avatar.tensor("ao_maps", device)
        leaves = appearance.float_leaves(self.params)
        self.names = [k for k in leaves if k not in FROZEN]
        # the first state as the benchmark drew it, for the reference
        self.init = {k: t(k) for k in leaves}
        self.alive0, self.binding0 = t("splats.alive"), t("splats.binding")

        self.rng = random.Random(seed)
        self.keep_at = self.rng.randint(1, int(traffic["keep_within"]))
        self.views = int(traffic["views"])
        self.steps, self.draws, self.losses, self.bad = 0, [], [], []
        self.sampling, self.window_steps = False, 0
        self.sample = self.held = None
        for step in range(int(traffic["setup_steps"])):
            self.run_unit()
            if step == 0:
                # the gradient as Adam got it, from its first moment
                self.grad = self.project(
                    {k: v["m"] / (1.0 - BETA1)
                     for k, v in self._state().items()})
        self.setup_draws = list(self.draws)
        self.setup_losses = list(self.losses)
        leaves = appearance.float_leaves(self.params)
        self.params_after = self.project({k: leaves[k].detach()
                                          for k in self.names})
        self.init_proj = self.project(self.init)
        for j in range(self.views):
            self.run_unit(keep=j >= self.views - 2)
        self.losses, self.bad = [], []
        self.sampling = True

    # ---- the numbers the harness compares -----------------------------
    def project(self, tensors: dict) -> dict:
        """name -> sum(r * x) / sqrt(numel), r drawn from the seed and the
        leaf's place among the leaves."""
        out = {}
        for i, name in enumerate(self.names):
            x = tensors[name]
            gen = torch.Generator(x.device).manual_seed(
                (self.seed * 7_919 + i) % 2 ** 63)
            r = torch.randn(x.shape, generator=gen, device=x.device)
            out[name] = float((r.double() * x.double()).sum()) \
                / math.sqrt(x.numel())
        return out

    def _state(self) -> dict:
        """Copies of each held leaf and its Adam moments and count."""
        leaves = appearance.float_leaves(self.params)
        out = {}
        for k in self.names:
            p = leaves[k].detach()
            st = self.optimizer.state.get(leaves[k], {})
            zero = torch.zeros_like(p)
            out[k] = {"p": p.clone(), "m": st.get("exp_avg", zero).clone(),
                      "v": st.get("exp_avg_sq", zero).clone(),
                      "n": int(st.get("step", 0))}
        return out

    def run_unit(self, keep: bool = False) -> int:
        if self.sampling:
            self.window_steps += 1
            keep = self.window_steps == self.keep_at
        camera, frame = self.steps % self.views, self.rng.randrange(
            self.cfg["frames"])
        self.steps += 1
        self.draws.append((camera, frame))
        gt_rgb, gt_msk = avatar_scene.ground_truth(
            self.cfg, self.seed, camera, frame, self.device)
        before = self._state() if keep else None
        loss, aux = self.train_step(
            self.params, frame, camera, self.cams[camera], gt_rgb, gt_msk,
            self.ao[frame], self.width, self.height)
        loss, over = torch.stack([
            loss.float(), (aux["big_overflow"] + aux["work_overflow"]
                           + aux["tile_overflow"]).float()]).tolist()
        self.losses.append(loss)
        self.bad.append(not math.isfinite(loss) or over > 0)
        if keep:
            kept = {"index": self.window_steps, "draw": (camera, frame),
                    "before": before, "after": self._state(), "loss": loss}
            if self.sampling:
                self.sample, self.held = kept, None
            else:
                self.held = kept
        return 1

    def least_seconds(self) -> float:
        """The least time of a step on the first state, over the views."""
        return roofline_appearance.step_seconds(
            self.cfg, self.raw, self.init, self.alive0, self.binding0,
            self.views, self.device)

    def failed(self, attempted: int) -> int:
        return sum(self.bad[-attempted:])

    def release(self):
        self.params = self.optimizer = self.train_step = self.avatar = None
        self.held = None

    def _gt(self, draw):
        return avatar_scene.ground_truth(self.cfg, self.seed, *draw,
                                         self.device)

    def _window(self) -> dict | None:
        s = self.sample
        if s is None:
            return None
        side = lambda where, what: {k: s[where][k][what] for k in self.names}
        m0, m1 = side("before", "m"), side("after", "m")
        return {"index": s["index"], "loss": s["loss"],
                "p0": self.project(side("before", "p")),
                "p1": self.project(side("after", "p")),
                "grad": self.project({k: (m1[k] - BETA1 * m0[k])
                                      / (1.0 - BETA1) for k in self.names})}

    def program(self) -> dict:
        """What the program's first steps and its kept window step
        produced, each leaf as its projection."""
        return {"loss": self.setup_losses, "grad": self.grad,
                "params": self.params_after, "init": self.init_proj,
                "window": self._window()}

    def reference(self, ar) -> dict:
        """The reference's first steps from the same first leaves and
        draws, and its replay of the kept window step from the state the
        program started it from."""
        ref = ref_appearance.Appearance(self.cfg, self.raw, self.alive0,
                                        self.binding0, self.device, ar)
        out = ref.train(self.init, self.setup_draws,
                        [self._gt(d) for d in self.setup_draws])
        got = {"loss": out["loss"], "grad": self.project(out["grad"]),
               "params": self.project(out["params"]),
               "init": self.init_proj, "window": None}
        s = self.sample
        if s is not None:
            st = s["before"]
            p0 = dict(self.init, **{k: st[k]["p"] for k in self.names})
            loss, grads, p1, _ = ref.adam_step(
                p0, {k: st[k]["m"] for k in self.names},
                {k: st[k]["v"] for k in self.names},
                st[self.names[0]]["n"], *s["draw"], self._gt(s["draw"]))
            got["window"] = {"index": s["index"], "loss": loss,
                             "p0": self.project(p0),
                             "p1": self.project(p1),
                             "grad": self.project(grads)}
        return got
