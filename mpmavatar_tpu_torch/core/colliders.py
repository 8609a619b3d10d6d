"""Boundary conditions / colliders as data (port of
mpmavatar_tpu/core/colliders.py).

Each BC is a frozen dataclass of tensors plus static ints (surface type,
reset flag, padding).  Grid-level BCs run after grid normalization and
before G2P, in registration order.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

# surface types
STICKY = 0
SLIP = 1
FRICTIONAL = 2
CUT = 11


@dataclasses.dataclass(frozen=True)
class SurfaceCollider:
    """Half-space collider."""
    point: torch.Tensor        # (3,)
    normal: torch.Tensor       # (3,) unit
    friction: torch.Tensor     # scalar
    start_time: torch.Tensor   # scalar
    end_time: torch.Tensor     # scalar
    surface_type: int = STICKY


@dataclasses.dataclass(frozen=True)
class CuboidCollider:
    """Moving-cuboid Dirichlet velocity; the active point is
    point + (clamp(t) - start) * velocity."""
    point: torch.Tensor
    size: torch.Tensor
    velocity: torch.Tensor
    start_time: torch.Tensor
    end_time: torch.Tensor
    reset: int = 0


@dataclasses.dataclass(frozen=True)
class BoundingBoxCollider:
    """Grid-boundary no-outflow BC."""
    start_time: torch.Tensor
    end_time: torch.Tensor
    padding: int = 3


@dataclasses.dataclass(frozen=True)
class GridMaskCollider:
    """Zero grid velocity where mask >= 1."""
    mask: torch.Tensor  # (G, G, G) int


class _Window:
    """A pre-P2G window: ``start_s``/``end_s`` are its interval as
    registered, on the host (tracing's ``windows.live`` reads them; the
    step compares the device scalars ``start_time``/``end_time``)."""

    def live_at(self, time: float) -> bool:
        """Whether the interval holds ``time``; a window built without
        the host's interval counts as live."""
        return self.start_s is None or self.start_s <= time < self.end_s


@dataclasses.dataclass(frozen=True)
class ParticleImpulse(_Window):
    """Pre-P2G particle impulse."""
    mask: torch.Tensor        # (P,) int
    force: torch.Tensor       # (3,)
    start_time: torch.Tensor
    end_time: torch.Tensor
    scale_by_mass: bool = True
    start_s: float | None = None
    end_s: float | None = None


@dataclasses.dataclass(frozen=True)
class ParticleVelocityModifier(_Window):
    """Dirichlet particle velocity before P2G."""
    mask: torch.Tensor        # (P,) int
    velocity: torch.Tensor    # (3,)
    start_time: torch.Tensor
    end_time: torch.Tensor
    start_s: float | None = None
    end_s: float | None = None


@dataclasses.dataclass(frozen=True)
class RotationVelocityModifier(_Window):
    """Cylinder-region rotation Dirichlet velocity about ``normal`` with
    optional translation along it."""
    mask: torch.Tensor
    point: torch.Tensor
    normal: torch.Tensor
    horizontal_axis_1: torch.Tensor
    horizontal_axis_2: torch.Tensor
    rotation_scale: torch.Tensor
    translation_scale: torch.Tensor
    start_time: torch.Tensor
    end_time: torch.Tensor
    start_s: float | None = None
    end_s: float | None = None


@dataclasses.dataclass(frozen=True)
class MeshCollider:
    """Body-mesh collision config; per-substep vertex positions and
    velocities are stepper inputs."""
    faces: torch.Tensor       # (Mf, 3) int64, cast once at registration
    friction: torch.Tensor    # scalar


@dataclasses.dataclass(frozen=True)
class ColliderSet:
    """All registered BCs.  ``grid_post`` keeps registration order across
    the grid BC types."""
    grid_post: Tuple = ()
    impulses: Tuple[ParticleImpulse, ...] = ()
    velocity_modifiers: Tuple = ()
    mesh_colliders: Tuple[MeshCollider, ...] = ()
    use_particle_mover: bool = False
