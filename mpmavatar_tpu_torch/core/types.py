"""State / model containers (port of mpmavatar_tpu/core/types.py).

Particle layout, as in the JAX package:

    [0, E)            element particles   (one per garment face)
    [E, E+T)          traditional particles (sand / jelly / ...)
    [E+T, E+T+V)      vertex particles    (garment mesh vertices)

Block boundaries are static Python ints carried by ``MPMStaticConfig``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .. import resolve_device


@dataclasses.dataclass(frozen=True)
class MPMStaticConfig:
    """Static solver configuration: the particle block layout and the
    knobs that select code paths."""

    n_elements: int
    n_traditional: int
    n_vertices: int
    n_grid: int
    grid_lim: float = 2.0
    material: int = 7          # 0 jelly, 1 metal, 2 sand, 3 foam, 5 plasticine, 7 cloth
    hardening: int = 0
    update_cov: bool = False
    num_joint_t: int = 0
    num_joint_v: int = 0
    num_joint_f: int = 0

    @property
    def n_particles(self) -> int:
        return self.n_elements + self.n_traditional + self.n_vertices

    @property
    def n_no_vertices(self) -> int:
        return self.n_elements + self.n_traditional

    @property
    def dx(self) -> float:
        return self.grid_lim / self.n_grid

    @property
    def inv_dx(self) -> float:
        return self.n_grid / self.grid_lim


class _Tensors:
    """``.to(device)`` for a dataclass whose fields are all tensors."""

    def to(self, device):
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)})


@dataclasses.dataclass(frozen=True)
class MPMState(_Tensors):
    """Dynamic simulation state.  P particles, E elements, T traditional,
    V vertices."""

    x: torch.Tensor            # (P, 3) positions in sim space [0, grid_lim]
    v: torch.Tensor            # (P, 3) velocities
    C: torch.Tensor            # (P, 3, 3) APIC affine velocity field
    F: torch.Tensor            # (T, 3, 3) elastic deformation gradient
    F_trial: torch.Tensor      # (T, 3, 3) trial deformation gradient
    d: torch.Tensor            # (E, 3, 3) direction matrix, columns (d1, d2, d3)
    R_inv: torch.Tensor        # (E, 3) packed inverse rest metric (iR11, iR12, iR22)
    vol: torch.Tensor          # (P,)
    mass: torch.Tensor         # (P,)
    density: torch.Tensor      # (P,)
    cov: torch.Tensor          # (E+T, 6) packed covariance (render export)
    selection: torch.Tensor    # (P,) int32; 0 = simulate
    faces: torch.Tensor        # (E, 3) int32 vertex-particle-local indices
    yield_stress: torch.Tensor  # (P,)


@dataclasses.dataclass(frozen=True)
class MPMModel(_Tensors):
    """Material parameters: per-particle (P,) tensors and 0-d scalars."""

    E: torch.Tensor
    nu: torch.Tensor
    mu: torch.Tensor
    lam: torch.Tensor
    gamma: torch.Tensor
    kappa: torch.Tensor
    gravity: torch.Tensor               # (3,)
    friction_coeff: torch.Tensor        # tan(friction_angle)
    alpha: torch.Tensor                 # Drucker-Prager alpha
    rpic_damping: torch.Tensor
    grid_v_damping_scale: torch.Tensor
    plastic_viscosity: torch.Tensor
    softening: torch.Tensor
    xi: torch.Tensor                    # hardening coefficient


def make_model(n_particles: int, E: float = 2000.0, nu: float = 0.3,
               gamma: float = 500.0, kappa: float = 500.0,
               gravity=(0.0, -9.8, 0.0), friction_angle: float = 40.0,
               rpic_damping: float = 0.0, grid_v_damping_scale: float = 1.1,
               plastic_viscosity: float = 0.0, softening: float = 0.1,
               xi: float = 0.0, device=None,
               dtype=torch.float32) -> MPMModel:
    """An MPMModel with uniform material parameters (mu/lam from E/nu;
    friction_coeff and alpha from the friction angle)."""
    device = resolve_device(device)
    scalar = lambda val: torch.tensor(float(val), dtype=dtype, device=device)
    ones = torch.ones((n_particles,), dtype=dtype, device=device)
    e = ones * E
    nu_a = ones * nu
    mu = e / (2.0 * (1.0 + nu_a))
    lam = e * nu_a / ((1.0 + nu_a) * (1.0 - 2.0 * nu_a))
    sin_phi = np.sin(friction_angle / 180.0 * 3.14159265)
    return MPMModel(
        E=e, nu=nu_a, mu=mu, lam=lam,
        gamma=ones * gamma, kappa=ones * kappa,
        gravity=torch.tensor(gravity, dtype=dtype, device=device),
        friction_coeff=scalar(np.tan(friction_angle / 180.0 * 3.14159265)),
        alpha=scalar(np.sqrt(2.0 / 3.0) * 2.0 * sin_phi / (3.0 - sin_phi)),
        rpic_damping=scalar(rpic_damping),
        grid_v_damping_scale=scalar(grid_v_damping_scale),
        plastic_viscosity=scalar(plastic_viscosity),
        softening=scalar(softening),
        xi=scalar(xi),
    )


def finalize_mu_lam(model: MPMModel) -> MPMModel:
    """Recompute mu/lam from (possibly updated) E/nu."""
    mu = model.E / (2.0 * (1.0 + model.nu))
    lam = model.E * model.nu / ((1.0 + model.nu) * (1.0 - 2.0 * model.nu))
    return dataclasses.replace(model, mu=mu, lam=lam)


def make_state(cfg: MPMStaticConfig, x, faces=None, d=None, R_inv=None,
               vol=None, density=None, v=None, yield_stress: float = 0.0,
               device=None, dtype=torch.float32) -> MPMState:
    """Assemble an MPMState from arrays or tensors (moved to ``device``)."""
    device = resolve_device(device)
    P, E, T = cfg.n_particles, cfg.n_elements, cfg.n_traditional
    as_t = lambda a, dt=dtype: torch.as_tensor(a, dtype=dt, device=device)
    x = as_t(x)
    if tuple(x.shape) != (P, 3):
        raise ValueError(f"x has shape {tuple(x.shape)}, expected ({P}, 3)")
    zeros = lambda *s: torch.zeros(s, dtype=dtype, device=device)
    eye = torch.eye(3, dtype=dtype, device=device).expand(T, 3, 3).clone()
    density_a = torch.ones((P,), dtype=dtype, device=device) \
        if density is None else as_t(density)
    vol_a = zeros(P) if vol is None else as_t(vol)
    return MPMState(
        x=x,
        v=zeros(P, 3) if v is None else as_t(v),
        C=zeros(P, 3, 3),
        F=eye,
        F_trial=eye.clone(),
        d=zeros(E, 3, 3) if d is None else as_t(d),
        R_inv=zeros(E, 3) if R_inv is None else as_t(R_inv),
        vol=vol_a,
        mass=density_a * vol_a,
        density=density_a,
        cov=zeros(E + T, 6),
        selection=torch.zeros((P,), dtype=torch.int32, device=device),
        faces=(torch.zeros((E, 3), dtype=torch.int32, device=device)
               if faces is None else as_t(faces, torch.int32)),
        yield_stress=torch.full((P,), float(yield_stress), dtype=dtype,
                                device=device),
    )


def cloth_geometry(verts: torch.Tensor, faces: torch.Tensor,
                   thickness: float = 1e-5):
    """Direction matrices, rest metric and volumes for a garment mesh.

    Returns (init_dir (E,3,3), rest_R_inv (E,3), element_vol (E,),
    vertex_vol (V,)), on the device of ``verts``."""
    faces = faces.long()
    d1 = verts[faces[:, 1]] - verts[faces[:, 0]]
    d2 = verts[faces[:, 2]] - verts[faces[:, 0]]
    d3 = torch.linalg.cross(d1, d2, dim=-1)
    d3 = d3 / torch.linalg.norm(d3, dim=1, keepdim=True)
    init_dir = torch.stack([d1, d2, d3], dim=-1)

    rest_R_inv = rest_dir_inv_from_vf(verts, faces)

    area = 0.5 * torch.linalg.norm(torch.linalg.cross(d1, d2, dim=-1), dim=1)
    element_vol = 0.25 * thickness * area
    vertex_vol = torch.zeros((verts.shape[0],), dtype=verts.dtype,
                             device=verts.device)
    vertex_vol.index_add_(0, faces.reshape(-1),
                          element_vol.repeat_interleave(3))
    return init_dir, rest_R_inv, element_vol, vertex_vol


def rest_dir_inv_from_vf(verts: torch.Tensor,
                         faces: torch.Tensor) -> torch.Tensor:
    """Packed inverse rest metric (iR11, iR12, iR22) from vertices+faces."""
    faces = faces.long()
    d1 = verts[faces[:, 1]] - verts[faces[:, 0]]
    d2 = verts[faces[:, 2]] - verts[faces[:, 0]]
    r11 = torch.linalg.norm(d1, dim=1)
    r12 = torch.sum(d1 * d2, dim=1) / r11
    r22 = torch.linalg.norm(d2 - (r12 / r11)[:, None] * d1, dim=1)
    i11 = 1.0 / r11
    i22 = 1.0 / r22
    i12 = -r12 * i11 * i22
    return torch.stack([i11, i12, i22], dim=-1)


def build_cloth(nx: int, ny: int, y0: float = 1.3, extent: float = 0.9):
    """A flat nx x ny vertex cloth at height ``y0`` centred over x = z = 1
    (the bench scene's garment): returns (verts (V,3) f32, faces (E,3)
    int32) as numpy arrays."""
    xs = np.linspace(1.0 - extent / 2, 1.0 + extent / 2, nx)
    zs = np.linspace(1.0 - extent / 2, 1.0 + extent / 2, ny)
    verts = np.stack(np.meshgrid(xs, zs, indexing="ij"), -1).reshape(-1, 2)
    verts = np.stack([verts[:, 0], np.full(len(verts), y0), verts[:, 1]],
                     -1).astype(np.float32)
    idx = np.arange(nx * ny).reshape(nx, ny)
    a = idx[:-1, :-1].ravel()
    b = idx[:-1, 1:].ravel()
    c = idx[1:, :-1].ravel()
    d = idx[1:, 1:].ravel()
    faces = np.concatenate(
        [np.stack([a, b, c], -1), np.stack([b, d, c], -1)], 0).astype(np.int32)
    return verts, faces


def build_body_sphere(n_theta: int = 48, n_phi: int = 48,
                      center=(1.0, 0.9, 1.0), r: float = 0.25):
    """A UV sphere standing in for the body mesh (the bench scene's
    collider; 48 x 48 vertices, 4,512 faces): returns (verts (Vb,3) f32,
    faces (Fb,3) int32) as numpy arrays."""
    th = np.linspace(0, np.pi, n_theta)
    ph = np.linspace(0, 2 * np.pi, n_phi, endpoint=False)
    tt, pp = np.meshgrid(th, ph, indexing="ij")
    pts = np.stack([np.sin(tt) * np.cos(pp), np.cos(tt),
                    np.sin(tt) * np.sin(pp)], -1) * r + np.asarray(center)
    idx = np.arange(n_theta * n_phi).reshape(n_theta, n_phi)
    a = idx[:-1, :].ravel()
    b = idx[1:, :].ravel()
    c = idx[:-1, np.r_[1:n_phi, 0]].ravel()
    d = idx[1:, np.r_[1:n_phi, 0]].ravel()
    faces = np.concatenate([np.stack([a, b, c], -1),
                            np.stack([c, b, d], -1)], 0).astype(np.int32)
    return pts.reshape(-1, 3).astype(np.float32), faces


def cloth_scene(verts, faces, n_grid: int, E: float = 2000.0,
                nu: float = 0.3, device=None):
    """(cfg, state, model) for a cloth of elements + vertices (material 7),
    one element particle at each face centroid."""
    device = resolve_device(device)
    faces_np = np.asarray(faces, np.int32)
    cfg = MPMStaticConfig(n_elements=len(faces_np), n_traditional=0,
                          n_vertices=len(verts), n_grid=n_grid,
                          grid_lim=2.0, material=7)
    v = torch.as_tensor(np.asarray(verts, np.float32), device=device)
    f = torch.as_tensor(faces_np, device=device)
    dmat, r_inv, evol, vvol = cloth_geometry(v, f)
    x = torch.cat([v[f.long()].mean(1), v], 0)
    state = make_state(cfg, x, faces=f, d=dmat, R_inv=r_inv,
                       vol=torch.cat([evol, vvol]), device=device)
    model = make_model(cfg.n_particles, E=E, nu=nu, device=device)
    return cfg, state, model
