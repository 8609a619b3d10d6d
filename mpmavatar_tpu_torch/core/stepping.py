"""The MPM substep (port of mpmavatar_tpu/core/stepping.py).

Phase order, as in the JAX package:
  stress -> P2G -> grid normalize+gravity(+damping) -> mesh colliders ->
  particle mover -> grid BCs -> G2P(vertices/traditional) -> G2P(elements).

On CUDA tensors ``p2g2p`` runs K1 (cloth stress) and K8 (sand stress) ->
K2 (P2G) -> K4 (collider and mover splats) -> K5 (grid pipeline) -> K3
(G2P), the kernels under ops/csrc.  It takes the unfused ``grid_update``
+ ``apply_mesh_collider`` + ``apply_particle_mover`` + ``apply_grid_bc``
only where the JAX package's fused path does not apply: more than one
mesh collider, or BCs outside ``grid_pipeline.supported_bcs`` (CUT
surfaces, cuboids, grid masks).  On CPU tensors the same calls run each
kernel's plain version.
"""

from __future__ import annotations

import dataclasses

import torch

from ..ops import grid_pipeline as _gp
from ..ops import splat as _splat
from ..ops import stress as _stress
from ..ops import transfer as _transfer
from . import constitutive, linalg
from .colliders import (CUT, STICKY, SLIP, BoundingBoxCollider,
                        ColliderSet, CuboidCollider, GridMaskCollider,
                        MeshCollider, RotationVelocityModifier,
                        SurfaceCollider)
from .types import MPMModel, MPMState, MPMStaticConfig


def compute_stress(cfg: MPMStaticConfig, state: MPMState, model: MPMModel,
                   dt: float):
    """Return-map + stress for all non-vertex particles.  Returns
    (new_d (E,3,3), new_F (T,3,3), new_yield_stress (P,),
    stress (E+T,3,3), vertex_force (V,3)).  The element block goes
    through K1 (``ops.stress.cloth_stress``) and sand (material 2)
    through K8 (``ops.stress.sand_stress``), as the JAX package's
    ``compute_stress(pallas=True)`` does."""
    E, T, V = cfg.n_elements, cfg.n_traditional, cfg.n_vertices
    x = state.x
    dtype, dev = x.dtype, x.device
    new_ys = state.yield_stress

    vertex_force = torch.zeros((V, 3), dtype=dtype, device=dev)
    if E > 0:
        sel_e = (state.selection[:E] == 0).to(dtype)
        new_d, stress_e, f1, f2, f3 = _stress.cloth_stress(
            state.d, state.R_inv, state.vol[:E], sel_e, model.mu[:E],
            model.lam[:E], model.gamma[:E], model.kappa[:E],
            model.friction_coeff)
        faces = state.faces.long()
        vertex_force.index_add_(0, faces[:, 0], f1)
        vertex_force.index_add_(0, faces[:, 1], f2)
        vertex_force.index_add_(0, faces[:, 2], f3)
    else:
        new_d = state.d
        stress_e = torch.zeros((0, 3, 3), dtype=dtype, device=dev)

    if T > 0 and cfg.material == 2:
        sl = slice(E, E + T)
        f_new, stress_t = _stress.sand_stress(
            state.F_trial, state.F, (state.selection[sl] == 0).to(dtype),
            model.mu[sl], model.lam[sl], model.alpha)
    elif T > 0:
        f_new, new_ys, stress_t = _traditional_stress(cfg, state, model, dt)
    else:
        f_new = state.F
        stress_t = torch.zeros((0, 3, 3), dtype=dtype, device=dev)

    stress = torch.cat([stress_e, stress_t], dim=0)
    return new_d, f_new, new_ys, stress, vertex_force


def _traditional_stress(cfg, state, model, dt):
    """Return map + Kirchhoff stress of the traditional block, plain
    PyTorch for every material but sand (XLA, not Pallas, in the JAX
    package)."""
    E, T = cfg.n_elements, cfg.n_traditional
    sl = slice(E, E + T)
    mu, lam = model.mu[sl], model.lam[sl]
    ys = state.yield_stress[sl]
    f_trial = state.F_trial
    mat = cfg.material
    ys_new = ys
    if mat == 1:      # metal
        f_new, ys_new = constitutive.von_mises_return_mapping(
            f_trial, mu, lam, ys, model.xi, cfg.hardening)
    elif mat == 3:    # foam / viscoplastic
        f_new = constitutive.viscoplasticity_return_mapping_stvk(
            f_trial, mu, ys, model.plastic_viscosity, dt)
    elif mat == 5:    # plasticine (von Mises + damage)
        mu = torch.where(ys > 0, mu, 0.0)
        lam = torch.where(ys > 0, lam, 0.0)
        f_new, ys_new, mu, lam = \
            constitutive.von_mises_return_mapping_with_damage(
                f_trial, mu, lam, ys, model.softening, model.xi,
                cfg.hardening)
    else:             # elastic
        f_new = f_trial

    sel_t = state.selection[sl] == 0
    f_new = torch.where(sel_t[:, None, None], f_new, state.F)
    new_ys = state.yield_stress.clone()
    new_ys[sl] = torch.where(sel_t, ys_new, ys)

    j = linalg.det3(f_new)
    u, sig, v = linalg.svd3(f_new)
    if mat in (1, 3):
        st = constitutive.kirchoff_stress_stvk(f_new, u, v, sig, mu, lam)
    elif mat == 6:
        st = constitutive.kirchoff_stress_neo_hookean(f_new, u, v, j, sig,
                                                      mu, lam)
    else:
        st = constitutive.kirchoff_stress_fcr(f_new, u, v, j, mu, lam)
    st = 0.5 * (st + st.transpose(-1, -2))
    return f_new, new_ys, torch.where(sel_t[:, None, None], st, 0.0)


def p2g(cfg: MPMStaticConfig, state: MPMState, model: MPMModel, stress,
        vertex_force, dt: float):
    """APIC particle-to-grid scatter through K2 (``ops.transfer.p2g``).
    ``stress`` is compute_stress's raw (E+T,3,3) stress; this applies the
    RPIC mix, vol (traditional) and dt.  Returns (grid_v_in (G^3,3),
    grid_m (G^3,))."""
    E = cfg.n_elements
    dtype = state.x.dtype
    c = state.C
    rd = model.rpic_damping
    c_eff = (1.0 - rd) * c + rd / 2.0 * (c - c.transpose(-1, -2))
    c_eff = torch.where(rd < -0.001, 0.0, c_eff)
    sel = (state.selection == 0).to(dtype)
    stress_eff = torch.cat([stress[:E],
                            state.vol[E:cfg.n_no_vertices, None, None]
                            * stress[E:]], dim=0)
    return _transfer.p2g(state.x, state.v, c_eff, state.mass, sel,
                         dt * stress_eff, dt * vertex_force, cfg.n_grid,
                         cfg.inv_dx, cfg.dx)


def grid_update(cfg: MPMStaticConfig, model: MPMModel, grid_v_in, grid_m,
                dt: float):
    """Momentum -> velocity, gravity, damping (unfused path)."""
    active = grid_m > 1e-15
    v_out = torch.where(active[:, None],
                        grid_v_in / torch.clamp_min(grid_m, 1e-15)[:, None]
                        + dt * model.gravity[None, :], 0.0)
    scale = model.grid_v_damping_scale
    return torch.where(scale < 1.0, v_out * scale, v_out)


def mesh_face_values(col: MeshCollider, mesh_x, mesh_v):
    """The collider splat's inputs: face centroids (Fb, 3) and per face
    the mean vertex velocity and the unit normal cross(p1-p0, p2-p0)
    (Fb, 6).  The collider resists motion against that normal, so a body
    mesh's faces wind counter-clockwise seen from outside."""
    return triangle_values(mesh_x[col.faces], mesh_v[col.faces])


def triangle_values(tri_x, tri_v):
    """``mesh_face_values`` of triangles given by their corners' positions
    and velocities, (Fb, 3, 3) each."""
    p0, p1, p2 = tri_x.unbind(1)
    centroid = (p0 + p1 + p2) / 3.0
    v0, v1, v2 = tri_v.unbind(1)
    fvel = (v0 + v1 + v2) / 3.0
    fnorm = linalg.cross(p1 - p0, p2 - p0)
    fnorm = fnorm / torch.clamp_min(linalg.safe_norm(fnorm, keepdim=True),
                                    1e-12)
    return centroid, torch.cat([fvel, fnorm], -1)


def mesh_collider_fields(cfg: MPMStaticConfig, col: MeshCollider, mesh_x,
                         mesh_v):
    """Face-centroid velocity + unit normal splatted to the grid through
    K4 (``ops.splat.splat``, the splat half of apply_mesh_collider):
    (acc (G^3, 6), grid_w (G^3,)).  Its inputs are detached, as the JAX
    package's ``stop_gradient`` does:
    the collider mesh is a rollout input and no gradient reaches it."""
    points, values = mesh_face_values(col, mesh_x, mesh_v)
    return _splat.splat(points.detach(), values.detach(), cfg.n_grid,
                        cfg.inv_dx)


def apply_mesh_collider(cfg: MPMStaticConfig, col: MeshCollider, mesh_x,
                        mesh_v, grid_v_out):
    """Grid-level body-mesh collision (unfused path): splat the faces,
    then strip the inward normal part of the velocity relative to the
    mesh, with Coulomb friction."""
    acc, grid_w = mesh_collider_fields(cfg, col, mesh_x, mesh_v)
    return project_on_mesh(acc, grid_w, col.friction, grid_v_out)


def project_on_mesh(acc, grid_w, friction, grid_v_out):
    """The projection half of apply_mesh_collider on the collider splat's
    fields (acc (N, 6), grid_w (N,)) and friction coefficient."""
    covered = grid_w > 1e-15
    mesh_vel = acc[:, :3] / torch.clamp_min(grid_w, 1e-15)[:, None]
    n = acc[:, 3:]
    n = n / torch.clamp_min(linalg.safe_norm(n, keepdim=True), 1e-12)
    v_rel = grid_v_out - mesh_vel
    normal_comp = torch.sum(v_rel * n, dim=-1)
    v_proj = v_rel - torch.clamp_max(normal_comp, 0.0)[:, None] * n
    v_proj_len = linalg.safe_norm(v_proj)
    fric_len = torch.clamp_min(v_proj_len + normal_comp * friction, 0.0)
    fric_active = (normal_comp < 0.0) & (v_proj_len > 1e-20)
    len_safe = torch.where(fric_active, v_proj_len, 1.0)
    v_fric = torch.where(fric_active[:, None],
                         (fric_len / len_safe)[:, None] * v_proj, v_proj)
    return torch.where(covered[:, None], v_fric + mesh_vel, grid_v_out)


def mover_points(cfg: MPMStaticConfig, state: MPMState, joint_verts_v=None,
                 joint_faces_v=None, joint_traditional_v=None):
    """The mover splat's inputs, all joint classes together: (positions
    (J, 3), prescribed velocities (J, 3)), or None without joints."""
    E, T = cfg.n_elements, cfg.n_traditional
    pts, vels = [], []
    if joint_traditional_v is not None and cfg.num_joint_t > 0:
        # joint traditional particles sit at the end of the traditional
        # block
        pts.append(state.x[E + T - cfg.num_joint_t:E + T])
        vels.append(joint_traditional_v)
    if joint_verts_v is not None and cfg.num_joint_v > 0:
        pts.append(state.x[E + T:E + T + cfg.num_joint_v])
        vels.append(joint_verts_v)
    if joint_faces_v is not None and cfg.num_joint_f > 0:
        pts.append(state.x[:cfg.num_joint_f])
        vels.append(joint_faces_v)
    if not pts:
        return None
    return torch.cat(pts, 0), torch.cat(vels, 0)


def mover_fields(cfg: MPMStaticConfig, state: MPMState, joint_verts_v=None,
                 joint_faces_v=None, joint_traditional_v=None):
    """Prescribed joint velocities splatted from the joint particles'
    positions in one splat through K4 (the scatter half of
    apply_particle_mover): (grid_vel (G^3, 3), grid_w (G^3,)).  Under
    grad both fields are differentiable w.r.t. ``state.x``, as JAX's
    ``rasterize_to_grid`` is (ops/splat.py)."""
    points = mover_points(cfg, state, joint_verts_v, joint_faces_v,
                          joint_traditional_v)
    if points is None:
        n = cfg.n_grid ** 3
        return (state.x.new_zeros((n, 3)), state.x.new_zeros((n,)))
    return _splat.splat(*points, cfg.n_grid, cfg.inv_dx)


def apply_particle_mover(cfg: MPMStaticConfig, state: MPMState, grid_v_out,
                         joint_verts_v=None, joint_faces_v=None,
                         joint_traditional_v=None):
    """Joint-band Dirichlet velocities (unfused path): overwrite the grid
    velocity wherever the joint splat's weight is nonzero."""
    grid_vel, grid_w = mover_fields(cfg, state, joint_verts_v,
                                    joint_faces_v, joint_traditional_v)
    covered = grid_w > 1e-15
    v = grid_vel / torch.clamp_min(grid_w, 1e-15)[:, None]
    return torch.where(covered[:, None], v, grid_v_out)


def _grid_coords(cfg: MPMStaticConfig, dtype, device, cell_start: int,
                 n: int):
    """(idx (n, 3), pos (n, 3)) of the flat cells [cell_start,
    cell_start + n) (x-major: flat = (x G + y) G + z)."""
    g = cfg.n_grid
    f = cell_start + torch.arange(n, device=device)
    idx = torch.stack([f // (g * g), (f // g) % g, f % g], dim=-1)
    return idx, idx.to(dtype) * cfg.dx


def apply_grid_bc(cfg: MPMStaticConfig, col, grid_v_out, time: float,
                  dt: float, cell_start: int = 0):
    """Apply one grid-level BC (unfused path), dispatched on its type.
    ``grid_v_out``'s rows are the flat cells from ``cell_start`` on: the
    whole grid, or a rank's slab of it (parallel/sharded.py; the JAX
    package's ``apply_grid_bc(..., coords=slab_coords(...),
    cell_start=)``)."""
    n = grid_v_out.shape[0]
    idx, pos = _grid_coords(cfg, grid_v_out.dtype, grid_v_out.device,
                            cell_start, n)
    if isinstance(col, SurfaceCollider):
        active = (time >= col.start_time) & (time < col.end_time)
        dotp = torch.sum((pos - col.point[None, :]) * col.normal[None, :],
                         dim=-1)
        inside = dotp < 0.0
        if col.surface_type == STICKY:
            new_v = torch.zeros_like(grid_v_out)
        elif col.surface_type == CUT:
            z = pos[:, 2]
            band = (z >= 0.4) & (z <= 0.53)
            damped = torch.stack([grid_v_out[:, 0],
                                  torch.zeros_like(grid_v_out[:, 1]),
                                  grid_v_out[:, 2]], dim=-1) * 0.3
            new_v = torch.where(band[:, None], damped, 0.0)
        else:
            v = grid_v_out
            nc = torch.sum(v * col.normal[None, :], dim=-1)
            if col.surface_type == SLIP:
                v2 = v - nc[:, None] * col.normal[None, :]
            else:
                v2 = v - torch.clamp_max(nc, 0.0)[:, None] \
                    * col.normal[None, :]
            vlen = linalg.safe_norm(v2)
            fric = torch.clamp_min(vlen + nc * col.friction, 0.0)
            f_act = (nc < 0.0) & (vlen > 1e-20)
            vlen_safe = torch.where(f_act, vlen, 1.0)
            new_v = torch.where(f_act[:, None],
                                (fric / vlen_safe)[:, None] * v2, v2)
        return torch.where((active & inside)[:, None], new_v, grid_v_out)

    if isinstance(col, CuboidCollider):
        active = (time >= col.start_time) & (time < col.end_time)
        t_active = torch.clamp(torch.as_tensor(time, dtype=pos.dtype,
                                               device=pos.device),
                               col.start_time, col.end_time) \
            - col.start_time
        point = col.point + t_active * col.velocity
        inside = torch.all(torch.abs(pos - point[None, :])
                           < col.size[None, :], dim=-1)
        out = torch.where((active & inside)[:, None],
                          col.velocity.expand_as(grid_v_out), grid_v_out)
        if col.reset == 1:
            resetting = (~active) & (time < col.end_time + 15.0 * dt)
            out = torch.where(resetting, torch.zeros_like(out), out)
        return out

    if isinstance(col, BoundingBoxCollider):
        active = (time >= col.start_time) & (time < col.end_time)
        pad, g = col.padding, cfg.n_grid
        cols = []
        for a in range(3):
            va = grid_v_out[:, a]
            low = (idx[:, a] < pad) & (va < 0)
            high = (idx[:, a] >= g - pad) & (va > 0)
            cols.append(torch.where(active & (low | high), 0.0, va))
        return torch.stack(cols, dim=-1)

    if isinstance(col, GridMaskCollider):
        masked = col.mask.reshape(-1)[cell_start:cell_start + n] >= 1
        return torch.where(masked[:, None], 0.0, grid_v_out)

    raise TypeError(f"unknown grid BC {type(col)}")


def gather_quantities(cfg: MPMStaticConfig, state: MPMState, grid_v_out):
    """27-stencil gather through K3 (``ops.transfer.g2p``): per-particle
    velocity, APIC C and velocity gradient."""
    return _transfer.g2p(state.x, grid_v_out, cfg.n_grid, cfg.inv_dx)


def g2p(cfg: MPMStaticConfig, state: MPMState, model: MPMModel, grid_v_out,
        dt: float, gathered=None):
    """Grid-to-particle gather + advection: vertex/traditional particles
    update first, then element particles read the *updated* vertex
    positions/velocities.  Returns (x, v, C, F_trial, d)."""
    E, T = cfg.n_elements, cfg.n_traditional
    P, dx = cfg.n_particles, cfg.dx
    if gathered is None:
        gathered = gather_quantities(cfg, state, grid_v_out)
    new_v, new_c, grad_v = gathered

    sel = state.selection == 0
    new_x = torch.clamp(state.x + dt * new_v, dx * 2.0,
                        cfg.grid_lim - dx * 2.0)
    nonelem = torch.arange(P, device=sel.device) >= E
    upd = (sel & nonelem)
    x1 = torch.where(upd[:, None], new_x, state.x)
    v1 = torch.where(upd[:, None], new_v, state.v)
    c1 = torch.where(upd[:, None, None], new_c, state.C)

    if T > 0:
        # F += dt grad_v F as an elementwise product and sum: as a batched
        # (T,3,3)@(T,3,3) product it runs as cuBLAS GEMMs of 3x3 tiles
        f_new = state.F + dt * (grad_v[E:E + T, :, :, None]
                                * state.F[:, None, :, :]).sum(2)
        f_trial = torch.where(sel[E:E + T, None, None], f_new,
                              state.F_trial)
    else:
        f_trial = state.F_trial

    if E > 0:
        fi = state.faces.long() + (E + T)
        pa, pb, pc = x1[fi[:, 0]], x1[fi[:, 1]], x1[fi[:, 2]]
        ex = (pa + pb + pc) / 3.0
        ev = (v1[fi[:, 0]] + v1[fi[:, 1]] + v1[fi[:, 2]]) / 3.0
        d3_old = state.d[:, :, 2]
        # d3 += dt grad_v d3 as an elementwise product and sum: as a
        # batched (E,3,3)@(E,3) product it runs as a slow gemv on CUDA
        d3 = d3_old + dt * (grad_v[:E] * d3_old[:, None, :]).sum(-1)
        new_d = torch.stack([pb - pa, pc - pa, d3], dim=-1)
        sel_e = sel[:E]
        x1 = torch.cat([torch.where(sel_e[:, None], ex, state.x[:E]),
                        x1[E:]], dim=0)
        v1 = torch.cat([torch.where(sel_e[:, None], ev, state.v[:E]),
                        v1[E:]], dim=0)
        c1 = torch.cat([torch.where(sel_e[:, None, None], new_c[:E],
                                    state.C[:E]), c1[E:]], dim=0)
        d_out = torch.where(sel_e[:, None, None], new_d, state.d)
    else:
        d_out = state.d
    return x1, v1, c1, f_trial, d_out


def _pre_p2g_velocity(colliders: ColliderSet, state: MPMState, dt: float,
                      time: float):
    """Particle impulses and velocity modifiers, in registration order."""
    v = state.v
    for imp in colliders.impulses:
        active = (time >= imp.start_time) & (time < imp.end_time)
        if imp.scale_by_mass:
            delta = imp.force[None, :] / state.mass[:, None] * dt
        else:
            delta = (imp.force[None, :] * dt).expand_as(v)
        v = torch.where((active & (imp.mask >= 1))[:, None], v + delta, v)
    for mod in colliders.velocity_modifiers:
        active = (time >= mod.start_time) & (time < mod.end_time)
        if isinstance(mod, RotationVelocityModifier):
            offset = state.x - mod.point[None, :]
            axial = torch.sum(offset * mod.normal[None, :], -1)
            radial = offset - axial[:, None] * mod.normal[None, :]
            hd = torch.sqrt(torch.sum(radial * radial, -1) + 1e-20)
            cosine = torch.sum(offset * mod.horizontal_axis_1[None, :],
                               -1) / hd
            theta = torch.arccos(torch.clamp(cosine, -1.0, 1.0))
            theta = torch.where(
                torch.sum(offset * mod.horizontal_axis_2[None, :], -1) > 0,
                theta, -theta)
            v_rot = (-hd * torch.sin(theta) * mod.rotation_scale)[:, None] \
                * mod.horizontal_axis_1[None, :] \
                + (hd * torch.cos(theta) * mod.rotation_scale)[:, None] \
                * mod.horizontal_axis_2[None, :] \
                + mod.translation_scale * mod.normal[None, :]
            v = torch.where((active & (mod.mask == 1))[:, None], v_rot, v)
        else:
            v = torch.where((active & (mod.mask == 1))[:, None],
                            mod.velocity.expand_as(v), v)
    return v


def make_grid_stage(cfg: MPMStaticConfig, colliders: ColliderSet):
    """The substep's grid phase, bound once per collider set:
    fn(grid_v_in, grid_m, state, model, time, dt, mesh_x, mesh_v, joints)
    -> grid_v_out, ``joints`` = (joint_verts_v, joint_faces_v,
    joint_traditional_v).  With at most one mesh collider and every BC
    kernel-supported it is K5 (the fused grid pipeline) fed by the K4
    splats, else the unfused ``grid_update`` -> ``apply_mesh_collider``
    -> ``apply_particle_mover`` -> ``apply_grid_bc``, as in the JAX
    package.  The mover runs when it is registered and joint velocities
    are given."""
    post, meshes = colliders.grid_post, colliders.mesh_colliders

    def mover_on(joints):
        return colliders.use_particle_mover and any(
            j is not None for j in joints)

    def check_mesh(mesh_x, mesh_v):
        if meshes and (mesh_x is None or mesh_v is None):
            raise ValueError("a mesh collider is registered: pass mesh_x "
                             "and mesh_v")

    if len(meshes) > 1 or not _gp.supported_bcs(post):
        def unfused(grid_v_in, grid_m, state, model, time, dt, mesh_x,
                    mesh_v, joints):
            check_mesh(mesh_x, mesh_v)
            grid_v_out = grid_update(cfg, model, grid_v_in, grid_m, dt)
            for col in meshes:
                grid_v_out = apply_mesh_collider(cfg, col, mesh_x, mesh_v,
                                                 grid_v_out)
            if mover_on(joints):
                grid_v_out = apply_particle_mover(cfg, state, grid_v_out,
                                                  *joints)
            for col in post:
                grid_v_out = apply_grid_bc(cfg, col, grid_v_out, time, dt)
            return grid_v_out
        return unfused

    pipelines = {mover: _gp.make_grid_pipeline(cfg, post,
                                               has_mesh=bool(meshes),
                                               has_mover=mover)
                 for mover in (False, True)}
    surf = _gp.pack_surface_params(post)

    def fused(grid_v_in, grid_m, state, model, time, dt, mesh_x, mesh_v,
              joints):
        check_mesh(mesh_x, mesh_v)
        acc = mesh_w = friction = mover_v = mover_w = None
        if meshes:
            acc, mesh_w = mesh_collider_fields(cfg, meshes[0], mesh_x,
                                               mesh_v)
            friction = meshes[0].friction
        mover = mover_on(joints)
        if mover:
            mover_v, mover_w = mover_fields(cfg, state, *joints)
        return pipelines[mover](grid_v_in, grid_m, acc, mesh_w, mover_v,
                                mover_w, model.gravity,
                                model.grid_v_damping_scale, friction, time,
                                dt, surf)
    return fused


def p2g2p(cfg: MPMStaticConfig, colliders: ColliderSet, state: MPMState,
          model: MPMModel, dt: float, time: float, mesh_x=None, mesh_v=None,
          joint_verts_v=None, joint_faces_v=None, joint_traditional_v=None,
          grid_stage=None) -> MPMState:
    """One full MPM substep; ``dt`` and ``time`` are Python floats.
    ``mesh_x``/``mesh_v`` (Vb, 3) are the body-mesh collider's vertices
    this substep; the ``joint_*_v`` are the mover's prescribed velocities
    of the joint vertices, faces and traditional particles.
    ``grid_stage`` is ``make_grid_stage(cfg, colliders)``, built here when
    the caller has none."""
    if grid_stage is None:
        grid_stage = make_grid_stage(cfg, colliders)
    dt, time = float(dt), float(time)
    state = dataclasses.replace(
        state, v=_pre_p2g_velocity(colliders, state, dt, time))

    new_d, new_f, new_ys, stress, vertex_force = compute_stress(
        cfg, state, model, dt)
    state = dataclasses.replace(state, d=new_d, F=new_f,
                                yield_stress=new_ys)
    grid_v_in, grid_m = p2g(cfg, state, model, stress, vertex_force, dt)
    grid_v_out = grid_stage(grid_v_in, grid_m, state, model, time, dt,
                            mesh_x, mesh_v, (joint_verts_v, joint_faces_v,
                                             joint_traditional_v))
    x1, v1, c1, f_trial, d1 = g2p(cfg, state, model, grid_v_out, dt)
    return dataclasses.replace(state, x=x1, v=v1, C=c1, F_trial=f_trial,
                               d=d1)
