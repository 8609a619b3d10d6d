"""Faults planted under the timed path, to show that ``correct`` catches
them (``benchmark/tests``, and ``benchmark.control`` on the chip).

Each is a context manager that patches the program while it is active:

- ``unchanged``: a step returns its state unchanged (a substep, or a
  training step that applies no update);
- ``half``: half of the batch left out, the mean taken over the rest (a
  substep that moves only the first half of the particles; a loss over
  the first half of the rollout's frames);
- ``altered``: an answer altered where it is produced (each frame's end
  positions moved by a quarter of a cell; the loss scaled by 1.01).

A run on one chip has no exchange between chips to leave out.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch

from mpmavatar_tpu_torch.core import stepping
from mpmavatar_tpu_torch.sim import solver as solver_mod
from mpmavatar_tpu_torch.train import material

FAULTS = ("unchanged", "half", "altered")


@contextlib.contextmanager
def _patched(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def sim_fault(name: str):
    real = stepping.p2g2p
    if name == "unchanged":
        return _patched(stepping, "p2g2p", lambda cfg, cols, state, *a,
                        **k: state)
    if name == "half":
        def half(cfg, cols, state, *a, **k):
            new = real(cfg, cols, state, *a, **k)
            n = state.x.shape[0] // 2
            keep = lambda f: torch.cat([getattr(new, f)[:n],
                                        getattr(state, f)[n:]])
            return dataclasses.replace(new, x=keep("x"), v=keep("v"),
                                       C=keep("C"))
        return _patched(stepping, "p2g2p", half)
    if name == "altered":
        frame = solver_mod.MPMSolver.frame

        def altered(self, *a, **k):
            state, t = frame(self, *a, **k)
            return dataclasses.replace(state, x=state.x
                                       + 0.25 * self.cfg.dx), t
        return _patched(solver_mod.MPMSolver, "frame", altered)
    raise KeyError(name)


def train_fault(name: str):
    trainer = material.MaterialTrainer
    if name == "unchanged":
        def no_update(self, grads):
            self.step += 1
        return _patched(trainer, "_apply", no_update)
    if name == "half":
        def half_loss(self, params):
            n = len(self._rollout_data["target_sim"])
            keep = self._rollout_data
            cut = dict(keep, target_sim=keep["target_sim"][:max(n // 2, 1)])
            self._rollout_data = cut
            try:
                return rollout(self, params)
            finally:
                self._rollout_data = keep
        rollout = trainer.rollout_loss
        return _patched(trainer, "rollout_loss", half_loss)
    if name == "altered":
        step = trainer.train_one_step

        def scaled(self):
            loss, params = step(self)
            return loss * 1.01, params
        return _patched(trainer, "train_one_step", scaled)
    raise KeyError(name)


def plant(kind: str, name: str):
    """The fault ``name`` for a cell of ``kind`` ("sim" or "train")."""
    return sim_fault(name) if kind == "sim" else train_fault(name)
