"""Solver orchestration: collider registry, the frame loop (with its
substeps optionally checkpointed for a differentiated rollout), the
world <-> sim transform, the material-parameter setters and the
covariance helpers (port of mpmavatar_tpu/sim/solver.py).

The TPU solver's column-bin, halo, z-window, bf16 and rebinning knobs and
their cap sizing (``adapt_row_cap``, ``calibrate_caps``,
``adapt_mesh_cap``, ``check_overflow``) are not ported: they exist to feed
the TPU's matrix unit without atomics inside its on-chip memory, and the
port's kernels work on the dense grid with atomics, so there is nothing
to size.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from .. import resolve_device
from ..core import stepping
from ..core.colliders import (BoundingBoxCollider, ColliderSet,
                              CuboidCollider, GridMaskCollider,
                              MeshCollider, ParticleImpulse,
                              ParticleVelocityModifier,
                              RotationVelocityModifier, SurfaceCollider,
                              CUT, FRICTIONAL, SLIP, STICKY)
from ..core.types import (MPMModel, MPMState, MPMStaticConfig,
                          finalize_mu_lam)
from ..utils import profiling
from . import substep_graph

MATERIAL_IDS = {
    "jelly": 0, "metal": 1, "sand": 2, "foam": 3, "snow": 4,
    "plasticine": 5, "neo-hookean": 6, "cloth": 7,
}


class MPMSolver:
    """Owns the static config and the collider set; ``substep`` and
    ``frame`` advance a state.  Runs on CUDA unless ``device="cpu"``."""

    def __init__(self, cfg: MPMStaticConfig, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.colliders = ColliderSet()

    def _f32(self, value):
        return torch.as_tensor(np.asarray(value, np.float32),
                               device=self.device)

    def _window(self, start_time, end_time) -> dict:
        """A release window's interval: the device scalars the step
        compares, and the same float32 values on the host for tracing's
        ``windows.live``."""
        return dict(start_time=self._f32(start_time),
                    end_time=self._f32(end_time),
                    start_s=float(np.float32(start_time)),
                    end_s=float(np.float32(end_time)))

    def _i32(self, value):
        return torch.as_tensor(np.asarray(value, np.int32),
                               device=self.device)

    @property
    def colliders(self) -> ColliderSet:
        return self._colliders

    @colliders.setter
    def colliders(self, value: ColliderSet):
        self._colliders = value
        self._grid_stage = None
        self._graph = None      # frame's captured substep, if any

    def _replace(self, **kw):
        self.colliders = dataclasses.replace(self.colliders, **kw)

    def grid_stage(self):
        """The grid stage of the registered colliders (K5 and its packed
        surface parameters), built once per collider set."""
        if self._grid_stage is None:
            self._grid_stage = stepping.make_grid_stage(self.cfg,
                                                        self.colliders)
        return self._grid_stage

    # ------------------------------------------------------------------
    # registration API
    # ------------------------------------------------------------------
    def _add_grid_post(self, col):
        self._replace(grid_post=self.colliders.grid_post + (col,))

    def add_surface_collider(self, point, normal, surface="sticky",
                             friction=0.0, start_time=0.0, end_time=999.0):
        if surface == "sticky" and friction != 0:
            raise ValueError("friction must be 0 on sticky surfaces.")
        stype = {"sticky": STICKY, "slip": SLIP, "cut": CUT}.get(
            surface, FRICTIONAL)
        n = np.asarray(normal, np.float32)
        n = n / np.linalg.norm(n)
        self._add_grid_post(SurfaceCollider(
            point=self._f32(point), normal=self._f32(n),
            friction=self._f32(friction), start_time=self._f32(start_time),
            end_time=self._f32(end_time), surface_type=stype))

    def add_bounding_box(self, start_time=0.0, end_time=999.0):
        self._add_grid_post(BoundingBoxCollider(
            start_time=self._f32(start_time), end_time=self._f32(end_time)))

    def set_velocity_on_cuboid(self, point, size, velocity, start_time=0.0,
                               end_time=999.0, reset=0):
        self._add_grid_post(CuboidCollider(
            point=self._f32(point), size=self._f32(size),
            velocity=self._f32(velocity), start_time=self._f32(start_time),
            end_time=self._f32(end_time), reset=reset))

    def enforce_grid_velocity_by_mask(self, mask):
        self._add_grid_post(GridMaskCollider(mask=self._i32(mask)))

    def add_mesh_collider(self, mesh_faces, friction=0.0):
        """A body-mesh collider of these faces; its vertex positions and
        velocities are ``frame``/``substep`` inputs."""
        self._replace(mesh_colliders=self.colliders.mesh_colliders + (
            MeshCollider(faces=torch.as_tensor(np.asarray(mesh_faces),
                                               dtype=torch.int64,
                                               device=self.device),
                         friction=self._f32(friction)),))

    def add_particle_mover(self):
        """Pin the joint particles (``cfg.num_joint_*``) to the joint
        velocities given to ``frame``/``substep``."""
        self._replace(use_particle_mover=True)

    def add_impulse_on_particles(self, mask, force, start_time=0.0,
                                 end_time=999.0, scale_by_mass=True):
        self._replace(impulses=self.colliders.impulses + (ParticleImpulse(
            mask=self._i32(mask), force=self._f32(force),
            scale_by_mass=scale_by_mass,
            **self._window(start_time, end_time)),))

    def enforce_particle_velocity_by_mask(self, mask, velocity,
                                          start_time=0.0, end_time=999.0):
        self._replace(velocity_modifiers=self.colliders.velocity_modifiers
                      + (ParticleVelocityModifier(
                          mask=self._i32(mask), velocity=self._f32(velocity),
                          **self._window(start_time, end_time)),))

    def enforce_particle_velocity_translation(self, state, point, size,
                                              velocity, start_time=0.0,
                                              end_time=999.0):
        """Select the particles inside a box once; pin their velocity."""
        x = state.x.detach().cpu().numpy()
        inside = np.all(np.abs(x - np.asarray(point)[None])
                        < np.asarray(size)[None], axis=-1)
        self.enforce_particle_velocity_by_mask(inside.astype(np.int32),
                                               velocity, start_time, end_time)

    def enforce_particle_velocity_rotation(self, state, point, normal,
                                           half_height_and_radius,
                                           rotation_scale, translation_scale,
                                           start_time=0.0, end_time=999.0):
        """Cylinder-region rotation field."""
        normal = np.asarray(normal, np.float64)
        normal = normal / np.linalg.norm(normal)
        h1 = np.array([1.0, 1.0, 1.0])
        if abs(h1 @ normal) < 0.01:
            h1 = np.array([0.72, 0.37, -0.67])
        h1 = h1 - (h1 @ normal) * normal
        h1 = h1 / np.linalg.norm(h1)
        h2 = np.cross(h1, normal)

        x = state.x.detach().cpu().numpy()
        offset = x - np.asarray(point)[None]
        axial = offset @ normal
        radial = np.linalg.norm(offset - axial[:, None] * normal[None],
                                axis=-1)
        hh, rr = half_height_and_radius
        mask = (np.abs(axial) < hh) & (radial < rr)
        self._replace(velocity_modifiers=self.colliders.velocity_modifiers
                      + (RotationVelocityModifier(
                          mask=self._i32(mask.astype(np.int32)),
                          point=self._f32(point), normal=self._f32(normal),
                          horizontal_axis_1=self._f32(h1),
                          horizontal_axis_2=self._f32(h2),
                          rotation_scale=self._f32(rotation_scale),
                          translation_scale=self._f32(translation_scale),
                          **self._window(start_time, end_time)),))

    def release_particles_sequentially(self, state, normal, start_position,
                                       end_position, start_time, end_time,
                                       num_layers=50):
        """Shrinking pin region releases particles layer by layer along
        ``normal``."""
        point = [0.0, 0.0, 0.0]
        size = [0.0, 0.0, 0.0]
        axis = -1
        for i in range(3):
            if normal[i] == 0:
                point[i] = 1.0
                size[i] = 1.0
            else:
                axis = i
                point[i] = end_position
        half = abs(start_position - end_position) / num_layers
        end_portion = end_time / num_layers
        for i in range(num_layers):
            size[axis] = half * (num_layers - i)
            self.enforce_particle_velocity_translation(
                state, point, size, [0.0, 0.0, 0.0],
                start_time=start_time, end_time=end_portion * (i + 1))

    # ------------------------------------------------------------------
    # stepping
    # ------------------------------------------------------------------
    def substep(self, state: MPMState, model: MPMModel, dt: float,
                time: float, **scene) -> MPMState:
        """One substep; ``scene`` takes ``p2g2p``'s mesh_x, mesh_v and
        joint_*_v."""
        return stepping.p2g2p(self.cfg, self.colliders, state, model, dt,
                              time, grid_stage=self.grid_stage(), **scene)

    def frame(self, state: MPMState, model: MPMModel, dt: float,
              num_substeps: int, time0: float, mesh_x=None, mesh_v=None,
              joint_verts_v=None, joint_faces_v=None, remat: bool = False):
        """``num_substeps`` substeps from ``time0``; returns (state, time).
        Time advances in float32 steps of dt, as in the JAX frame scan.
        ``mesh_x`` is the collider mesh at the frame's start: substep s
        sees ``mesh_x + (s dt) mesh_v``, computed on the device.

        ``remat=True`` runs each substep under a non-reentrant
        ``torch.utils.checkpoint``, as the JAX frame checkpoints its
        scanned body: the backward keeps only each substep's input state
        and recomputes the substep (its kernels launch again) when it
        needs the rest.  The forward is the same computation.

        On CUDA, with ``remat`` off and nothing to differentiate
        (``sim/substep_graph.py::graphable``), each substep replays one
        captured CUDA graph of ``p2g2p``, the same kernels in the same
        order; the graph is kept on the solver and captured again when
        what it baked in changes (``graph_key``), after that frame's first
        substep runs eagerly.  The returned tensors are the frame's own,
        never the graph's buffers.

        Traced, the span ``frame``'s self time is the glue around the
        substeps; each replay is a ``substep`` span without the phases'
        spans, and counts one ``substep.graphed`` and the release windows
        (``SubstepGraph.run``); the capture records nothing."""
        with profiling.span("frame"):
            t = np.float32(time0)
            dt32 = np.float32(dt)
            grid_stage = self.grid_stage()
            as_dev = lambda a: None if a is None else torch.as_tensor(
                a, dtype=torch.float32, device=self.device)
            mesh_x, mesh_v = as_dev(mesh_x), as_dev(mesh_v)
            joints = dict(joint_verts_v=as_dev(joint_verts_v),
                          joint_faces_v=as_dev(joint_faces_v))
            inputs = (mesh_x, mesh_v, *joints.values())

            def mesh_at(s):
                return None if mesh_x is None else \
                    mesh_x + float(np.float32(s) * dt32) * mesh_v

            def substep(state, mx, time):
                return stepping.p2g2p(self.cfg, self.colliders, state, model,
                                      float(dt32), time, mesh_x=mx,
                                      mesh_v=mesh_v, grid_stage=grid_stage,
                                      **joints)

            if num_substeps and substep_graph.graphable(state, model, inputs,
                                                        remat):
                key = substep_graph.graph_key(self.cfg, self.colliders,
                                              state, model, dt32, inputs)
                s = 0
                if self._graph is None or self._graph.key != key:
                    self._graph = None      # its memory goes first
                    # a capture needs one eager run: the frame's first
                    state = substep(state, mesh_at(0), float(t))
                    t, s = np.float32(t + dt32), 1
                    self._graph = substep_graph.SubstepGraph(
                        key, self.cfg, self.colliders, grid_stage, model,
                        state, float(dt32), inputs)
                self._graph.load(state, inputs, t, s)
                t = self._graph.run(num_substeps - s, t)
                return self._graph.output(state), float(t)

            profiling.count("substep.graphed", 0)
            for s in range(num_substeps):
                mx = mesh_at(s)
                if remat:
                    # the substep draws no random numbers: no RNG state to
                    # keep
                    state = checkpoint(substep, state, mx, float(t),
                                       use_reentrant=False,
                                       preserve_rng_state=False)
                else:
                    state = substep(state, mx, float(t))
                t = np.float32(t + dt32)
            return state, float(t)

    @staticmethod
    def check_finite(state: MPMState, context: str = "rollout"):
        """Raise on the first non-finite state (call at frame
        boundaries)."""
        bad = validate_state(state)
        if bad:
            raise FloatingPointError(
                f"non-finite simulation state during {context}: "
                f"{bad} (field -> bad-value count). The timestep is "
                "likely unstable for this stiffness/grid — reduce dt "
                "or raise the substep count.")


def validate_state(state: MPMState) -> dict:
    """Field -> count of non-finite values, for the dynamic fields."""
    bad = {}
    for field in ("x", "v", "C", "F", "F_trial", "d"):
        t = getattr(state, field)
        n_bad = int(t.numel() - torch.isfinite(t).sum().item())
        if n_bad:
            bad[field] = n_bad
    return bad


def cfl_dt(state: MPMState, cfg: MPMStaticConfig, safety: float = 0.5,
           dt_max: float = 1e-3) -> float:
    """Suggested stable dt from the CFL condition |v| dt < safety * dx."""
    vmax = float(state.v.detach().abs().max())
    if vmax <= 0:
        return dt_max
    return min(dt_max, safety * cfg.dx / vmax)


# ----------------------------------------------------------------------
# world <-> sim normalization
# ----------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class SimTransform:
    """Maps world space into the simulation box: p * scale + shift, the
    garment's bounding box scaled to unit extent and centred on
    (1, 1, 1)."""

    scale: float
    shift: np.ndarray  # (3,) float32

    @classmethod
    def from_verts(cls, verts) -> "SimTransform":
        v = verts.detach().cpu().numpy() if isinstance(verts, torch.Tensor) \
            else np.asarray(verts)
        min_pos = v.min(0)
        max_pos = v.max(0)
        scale = 1.0 / float((max_pos - min_pos).max())
        shift = np.ones(3) - (min_pos + max_pos) / 2.0 * scale
        return cls(scale=scale, shift=shift.astype(np.float32))

    @staticmethod
    def _tensor(p, device=None):
        if isinstance(p, torch.Tensor):
            return p
        return torch.as_tensor(np.asarray(p, np.float32), device=device)

    def wld2sim(self, p, device=None):
        """World -> sim positions (a tensor; numpy input goes to
        ``device``, default the CPU)."""
        p = self._tensor(p, device)
        return p * self.scale + torch.as_tensor(self.shift, device=p.device)

    def sim2wld(self, p, device=None):
        p = self._tensor(p, device)
        return (p - torch.as_tensor(self.shift, device=p.device)) / self.scale

    def vel2sim(self, v, device=None):
        return self._tensor(v, device) * self.scale


def _f32(value, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(np.float32(value), device=like.device)


def set_parameters_dict(cfg: MPMStaticConfig, model: MPMModel,
                        state: MPMState, params: dict):
    """Apply a parameter dict (the reference solver's
    ``set_parameters_dict`` keys).  Returns (cfg, model, state);
    ``material`` and ``hardening`` change the static config."""
    if "material" in params:
        cfg = dataclasses.replace(cfg,
                                  material=MATERIAL_IDS[params["material"]])
    mupd = {}
    if "g" in params:
        mupd["gravity"] = torch.as_tensor(
            np.asarray(params["g"], np.float32), device=model.E.device)
    if "friction_angle" in params:
        ang = params["friction_angle"] / 180.0 * 3.14159265
        sin_phi = np.sin(ang)
        mupd["friction_coeff"] = _f32(np.tan(ang), model.E)
        mupd["alpha"] = _f32(np.sqrt(2.0 / 3.0) * 2.0 * sin_phi
                             / (3.0 - sin_phi), model.E)
    for k in ("rpic_damping", "plastic_viscosity", "softening",
              "grid_v_damping_scale", "xi"):
        if k in params:
            mupd[k] = _f32(params[k], model.E)
    if mupd:
        model = dataclasses.replace(model, **mupd)
    supd = {}
    if "yield_stress" in params:
        supd["yield_stress"] = torch.full_like(state.yield_stress,
                                               float(params["yield_stress"]))
    if "density" in params:
        density = torch.full_like(state.density, float(params["density"]))
        supd["density"] = density
        supd["mass"] = density * state.vol
    if supd:
        state = dataclasses.replace(state, **supd)
    if "hardening" in params:
        cfg = dataclasses.replace(cfg, hardening=int(params["hardening"]))
    return cfg, model, state


def _broadcast(value, like: torch.Tensor) -> torch.Tensor:
    """``value`` (a number or a tensor, kept in the autograd graph) as a
    tensor of ``like``'s shape, dtype and device."""
    if not isinstance(value, torch.Tensor):
        value = torch.as_tensor(np.asarray(value, np.float32))
    value = value.to(dtype=like.dtype, device=like.device)
    return value.expand(like.shape).clone()


def set_E_nu(model: MPMModel, E=None, nu=None, gamma=None, kappa=None,
             finalize: bool = True) -> MPMModel:
    """Set E, nu, gamma, kappa (a scalar broadcasts; an array is taken per
    particle) and, with ``finalize``, recompute mu/lam from E/nu."""
    upd = {name: _broadcast(val, getattr(model, name))
           for name, val in (("E", E), ("nu", nu), ("gamma", gamma),
                             ("kappa", kappa)) if val is not None}
    model = dataclasses.replace(model, **upd)
    return finalize_mu_lam(model) if finalize else model


def set_parameters_in_box(model: MPMModel, state: MPMState, point, size,
                          E=None, nu=None, density=None):
    """Region-box material override: the particles inside the axis-aligned
    box [point - size, point + size] get the given E / nu / density (mass
    refreshed); mu/lam are recomputed when E or nu change."""
    pt = torch.as_tensor(np.asarray(point, np.float32), device=state.x.device)
    sz = torch.as_tensor(np.asarray(size, np.float32), device=state.x.device)
    inside = torch.all(torch.abs(state.x - pt) < sz, dim=-1)
    mupd = {name: torch.where(inside, _broadcast(val, cur), cur)
            for name, val, cur in (("E", E, model.E), ("nu", nu, model.nu))
            if val is not None}
    if mupd:
        model = finalize_mu_lam(dataclasses.replace(model, **mupd))
    if density is not None:
        dens = torch.where(inside, _broadcast(density, state.density),
                           state.density)
        state = dataclasses.replace(state, density=dens,
                                    mass=dens * state.vol)
    return model, state


def reset_density(state: MPMState, density, update_mass: bool = True
                  ) -> MPMState:
    """Set every particle's density (a scalar broadcasts; a tensor stays
    in the autograd graph) and, with ``update_mass``, mass = density *
    vol."""
    density = _broadcast(density, state.density)
    mass = density * state.vol if update_mass else state.mass
    return dataclasses.replace(state, density=density, mass=mass)


def _unpack_cov(c):
    return torch.stack([
        torch.stack([c[:, 0], c[:, 1], c[:, 2]], -1),
        torch.stack([c[:, 1], c[:, 3], c[:, 4]], -1),
        torch.stack([c[:, 2], c[:, 4], c[:, 5]], -1),
    ], -2)


def _pack_cov(m):
    return torch.stack([m[:, 0, 0], m[:, 0, 1], m[:, 0, 2], m[:, 1, 1],
                        m[:, 1, 2], m[:, 2, 2]], -1)


def export_particle_cov(state: MPMState, cfg: MPMStaticConfig):
    """Render-time covariance of the non-vertex particles, packed (N, 6):
    F_trial cov0 F_trial^T, with the identity for the elements (they have
    no F)."""
    nnv = cfg.n_no_vertices
    c = state.cov[:nnv]
    cov0 = _unpack_cov(c)
    eye = torch.eye(3, dtype=c.dtype, device=c.device).expand(
        cfg.n_elements, 3, 3)
    f = torch.cat([eye, state.F_trial], 0)[:nnv]
    return _pack_cov(f @ cov0 @ f.transpose(-1, -2))


def update_cov(state: MPMState, cfg: MPMStaticConfig, grad_v, dt):
    """Advect the packed covariance with the velocity gradient grad_v
    (P, 3, 3): cov + dt (grad_v cov + cov grad_v^T).  Returns the new
    packed (E+T, 6) array."""
    nnv = cfg.n_no_vertices
    cov_n = _unpack_cov(state.cov)
    gv = grad_v[:nnv]
    cov_np1 = cov_n + dt * (gv @ cov_n + cov_n @ gv.transpose(-1, -2))
    return _pack_cov(cov_np1)
