"""The least time the chip needs for a substep, a frame or a training
step, counted from the cell's shapes and state, never from the program.

Peaks: NVIDIA's published H100 SXM figures, 3.35 TB/s of HBM and 67
TFLOP/s of FP32 outside the tensor cores (rates at 700 W; the run prints
the card's power limit beside them).  Per-particle and per-element work
is the port's kernels' (K1-K5, K8) as ``chip_smoke.py`` counts it, each
input byte read once and each output byte written once.  Grid traffic
counts only the cells the inputs need: the union of the particles'
3 x 3 x 3 stencils, the collider faces' and the pinned points'
footprints, from the state at the window's start.  A grid that stores
only those cells, a fused kernel or a kernel taken out does the same
work by this count, so no honest change reads over 100%.  The glue
between kernels (scatters of corner forces, the element update, the
release windows) is work a fused substep would not need and is not
counted.  The least time is the larger of all bytes over the bandwidth
and all operations over the FP32 peak.
"""

from __future__ import annotations

import dataclasses

import torch

PEAK_BYTES = 3.35e12
PEAK_FP32 = 67e12
F32 = 4


@dataclasses.dataclass
class Work:
    bytes: float = 0.0
    flops: float = 0.0

    def __add__(self, other):
        return Work(self.bytes + other.bytes, self.flops + other.flops)

    def __mul__(self, k):
        return Work(self.bytes * k, self.flops * k)

    def seconds(self) -> float:
        return max(self.bytes / PEAK_BYTES, self.flops / PEAK_FP32)


def stencil_cells(points, G: int, inv_dx: float, bounds_check: bool):
    """The flat grid cells of the points' stencils (a tensor of unique
    indices); with ``bounds_check`` only points whose stencil base lies in
    [0, G - 3) on every axis, as the splats take them."""
    if points.shape[0] == 0:
        return points.new_zeros((0,), dtype=torch.int64)
    base = torch.floor(points * inv_dx - 0.5).long()
    if bounds_check:
        base = base[((base >= 0) & (base < G - 3)).all(-1)]
    off = torch.stack(torch.meshgrid(*[torch.arange(3, device=points.device)]
                                     * 3, indexing="ij"), -1).reshape(-1, 3)
    node = (base[:, None, :] + off[None]).clamp(0, G - 1)
    return torch.unique(((node[..., 0] * G + node[..., 1]) * G
                         + node[..., 2]).reshape(-1))


@dataclasses.dataclass
class SubstepShape:
    """What a substep works on."""
    E: int             # cloth elements
    T: int             # sand particles
    V: int             # cloth vertices
    faces: int         # collider faces
    pinned: int        # mover points
    cells: int         # cells of the particles' stencils
    collider_cells: int
    pinned_cells: int

    @property
    def P(self):
        return self.E + self.T + self.V


def substep_work(s: SubstepShape) -> Work:
    """One forward substep's kernels."""
    nnv = s.E + s.T
    w = Work(s.E * (18 + 27) * F32, s.E * 310.0)                 # K1
    w += Work(30 * s.T * F32, 2000.0 * s.T)                       # K8
    w += Work(F32 * (17 * s.P + 9 * nnv + 3 * s.V + 4 * s.cells),
              1800.0 * s.P)                                       # K2
    w += Work(F32 * (9 * s.faces + 7 * s.collider_cells),
              s.faces * (30 + 54.0 * 7))                          # K4
    w += Work(F32 * (6 * s.pinned + 4 * s.pinned_cells),
              s.pinned * (30 + 54.0 * 4))                         # K4
    w += Work(F32 * (7 * s.cells + 7 * s.collider_cells
                     + 4 * s.pinned_cells), 60.0 * s.cells)       # K5
    w += Work(F32 * (24 * s.P + 3 * s.cells), 1900.0 * s.P)      # K3
    return w


def shape_of(x, E: int, T: int, V: int, G: int, lim: float, collider_pts,
             pinned_pts) -> SubstepShape:
    """A substep's shape from positions: all particles ``x``, the
    collider's face centroids and the pinned points."""
    inv_dx = G / lim
    return SubstepShape(
        E=E, T=T, V=V, faces=collider_pts.shape[0],
        pinned=pinned_pts.shape[0],
        cells=stencil_cells(x, G, inv_dx, False).numel(),
        collider_cells=stencil_cells(collider_pts, G, inv_dx, True).numel(),
        pinned_cells=stencil_cells(pinned_pts, G, inv_dx, True).numel())


def frame_seconds(shape: SubstepShape, substeps: int) -> float:
    return (substep_work(shape) * substeps).seconds()


def train_step_seconds(shape: SubstepShape, frames: int,
                       substeps: int) -> float:
    """A training step: each differentiated substep twice (the forward,
    and a backward that reads what the forward wrote and writes what it
    read; the checkpoints' recompute is not counted), the loss over the
    cloth vertices per frame, Adam on three numbers."""
    n = frames * substeps
    w = substep_work(shape) * (2 * n)
    w += Work(frames * shape.V * 6 * F32, frames * shape.V * 9.0)
    w += Work(3 * 4 * F32, 3 * 20.0)
    return w.seconds()
