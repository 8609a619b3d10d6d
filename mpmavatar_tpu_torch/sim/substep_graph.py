"""The forward substep as one captured CUDA graph.

``MPMSolver.frame`` replays a :class:`SubstepGraph` for each substep where
:func:`graphable` holds: the state on CUDA, ``remat`` off, and autograd
recording nothing.  Elsewhere (the CPU, the material step's checkpointed
rollout, anything differentiated) it runs ``core/stepping.py::p2g2p``
eagerly.  The graph's body *is* ``p2g2p``: the same kernels (K1-K5, K8,
the release windows) and the same PyTorch glue in the same order, launched
by one replay instead of ~100 calls from Python.

A capture bakes in the addresses and shapes it saw, so a graph is keyed
(:func:`graph_key`) on the state's and the inputs' shapes and dtypes (and
which inputs are None), dt, the static config, the collider set (a new
one at each registration, so it fixes the mover and the windows too) and
the model's tensors; the graph keeps the collider set and the model, so
their ids stay theirs.  What changes between replays lives in static
buffers that the body reads and writes:

- the state's fields, loaded at a frame's start; the body copies the
  fields a substep writes back onto them, so the next replay reads them;
- the frame's mesh_x, mesh_v and joint velocities, loaded at its start;
- the clock (:class:`Clock`): the substep's time and index as float32
  device scalars, advanced at the body's end.  K5 and the windows kernel
  read the time through a pointer, and the collider mesh is ``mesh_x +
  (s dt) mesh_v``: single float32 round-to-nearest operations, as the
  eager loop's ``np.float32`` sequence, so both routes see the same times
  and collider positions bit for bit.

``run`` replays the body, each replay a ``substep`` span that counts one
``substep.graphed`` and the release windows, and adds the body's launch
counts to ``ops/_build.py``'s; the capture records no span or count.
``output`` returns clones: the next replay overwrites the buffers.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core import stepping
from ..core.types import MPMModel, MPMState
from ..ops import _build
from ..utils import profiling

STATE_FIELDS = tuple(f.name for f in dataclasses.fields(MPMState))
MODEL_FIELDS = tuple(f.name for f in dataclasses.fields(MPMModel))


class Clock:
    """A substep's time ``t`` and index ``s`` as float32 0-d tensors on
    ``device``.  ``advance`` steps them as ``MPMSolver.frame``'s eager loop
    steps its host copies (``t = np.float32(t + dt)``, ``s + 1``)."""

    def __init__(self, device):
        self.t = torch.zeros((), dtype=torch.float32, device=device)
        self.s = torch.zeros((), dtype=torch.float32, device=device)

    def set(self, t, s: int) -> None:
        self.t.fill_(float(t))
        self.s.fill_(float(s))

    def advance(self, dt: float) -> None:
        self.t.add_(dt)
        self.s.add_(1.0)

    def mesh_x(self, mesh_x, mesh_v, dt: float):
        """The collider mesh at substep ``s``: the eager loop's ``mesh_x +
        float(np.float32(s) * dt) * mesh_v``."""
        return mesh_x + (self.s * dt) * mesh_v


def _tensors(state, model, inputs):
    yield from (getattr(state, f) for f in STATE_FIELDS)
    yield from (getattr(model, f) for f in MODEL_FIELDS)
    yield from (t for t in inputs if t is not None)


def graphable(state: MPMState, model: MPMModel, inputs, remat: bool) -> bool:
    """Whether ``frame`` replays a graph: the state on CUDA, ``remat`` off,
    and autograd recording nothing (grad mode off, or no tensor of the
    state, the model or ``inputs`` requiring grad)."""
    if remat or not state.x.is_cuda:
        return False
    return not torch.is_grad_enabled() or not any(
        t.requires_grad for t in _tensors(state, model, inputs))


def _signature(t):
    return None if t is None else (tuple(t.shape), t.dtype, t.device)


def graph_key(cfg, colliders, state: MPMState, model: MPMModel, dt: float,
              inputs) -> tuple:
    """Everything a capture bakes in (``inputs``: mesh_x, mesh_v,
    joint_verts_v, joint_faces_v, each a tensor or None)."""
    return (cfg, id(colliders), float(dt),
            tuple(_signature(getattr(state, f)) for f in STATE_FIELDS),
            tuple(_signature(t) for t in inputs),
            tuple(id(getattr(model, f)) for f in MODEL_FIELDS))


def _buffer(t):
    return None if t is None else torch.empty_like(
        t, memory_format=torch.contiguous_format)


class SubstepGraph:
    """``p2g2p`` captured once on static buffers shaped as ``state`` and
    ``inputs``.  The capture runs no kernel: the caller runs one substep
    eagerly first (a capture needs every lazy set-up done: the kernels'
    library, the windows' pack).  ``launches`` counts the body's kernel
    launches (``ops/_build.py``), which ``run`` adds once per replay."""

    def __init__(self, key, cfg, colliders, grid_stage, model: MPMModel,
                 state: MPMState, dt: float, inputs):
        dev, dt = state.x.device, float(dt)
        self.key, self.dt = key, dt
        # the key's ids stay the collider set's and the model's; the body
        # reads the model on the device, converted here once
        self.colliders, self.model = colliders, model
        body_model = model.to(dev)
        self.state = MPMState(**{f: _buffer(getattr(state, f))
                                 for f in STATE_FIELDS})
        self.inputs = tuple(_buffer(t) for t in inputs)
        self.clock = Clock(dev)
        mesh_x, mesh_v, joint_verts_v, joint_faces_v = self.inputs
        self.cuda_graph = torch.cuda.CUDAGraph()
        with _build.counted_apart() as self.launches, profiling.paused(), \
                torch.cuda.graph(self.cuda_graph):
            mx = None if mesh_x is None else \
                self.clock.mesh_x(mesh_x, mesh_v, dt)
            out = stepping.p2g2p(cfg, colliders, self.state, body_model,
                                 dt, self.clock.t, mesh_x=mx,
                                 mesh_v=mesh_v, joint_verts_v=joint_verts_v,
                                 joint_faces_v=joint_faces_v,
                                 grid_stage=grid_stage)
            # the fields the substep writes (the rest pass through)
            self.written = tuple(f for f in STATE_FIELDS
                                 if getattr(out, f) is not
                                 getattr(self.state, f))
            for f in self.written:
                getattr(self.state, f).copy_(getattr(out, f))
            self.clock.advance(dt)

    def load(self, state: MPMState, inputs, t, s: int) -> None:
        """Copy ``state`` and ``inputs`` into the buffers and set the clock
        to substep ``s`` at time ``t``."""
        for f in STATE_FIELDS:
            getattr(self.state, f).copy_(getattr(state, f))
        for buf, t_in in zip(self.inputs, inputs):
            if buf is not None:
                buf.copy_(t_in)
        self.clock.set(t, s)

    def run(self, n: int, t):
        """Replay the body ``n`` times from the loaded substep, whose time
        is ``t`` on the host; returns the time after them (float32)."""
        dt32 = np.float32(self.dt)
        for _ in range(n):
            with profiling.span("substep"):
                self.cuda_graph.replay()
            if profiling.on():
                profiling.count("substep.graphed")
                stepping.count_windows(self.colliders, float(t), True)
            t = np.float32(t + dt32)
        _build.add_launch_counts(self.launches, n)
        return t

    def output(self, state: MPMState) -> MPMState:
        """``state`` with the fields the substep writes taken from the
        buffers, as clones."""
        return dataclasses.replace(state, **{
            f: getattr(self.state, f).clone() for f in self.written})
