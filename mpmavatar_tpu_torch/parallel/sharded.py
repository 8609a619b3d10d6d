"""Multi-device MPM stepping over a ``torch.distributed`` process group
(port of mpmavatar_tpu/parallel/sharded.py, its dense path).

The particles are sharded over the ranks: every array of a
``ShardedClothState`` splits on axis 0 into equal blocks, one per rank
(``shard_state``).  One substep on a rank's block (``local_cloth_substep``):

- stress: K1 on the local elements (K8 on the local sand); the corner
  forces are added into a (V, 3) array that is all-reduced, and the rank
  keeps its own vertex block;
- P2G: K2 once on the local [elements, sand, vertices] into a full G^3
  grid, reduce-scattered so that the rank owns a contiguous slab of
  G^3 / N cells;
- the collider (its faces sharded like the particles) splatted by K4 and
  reduce-scattered; the mover's joint points all-gathered and splatted by
  K4 on every rank, which keeps its slab of that replicated splat;
- the grid update, the collider projection, the mover and the grid BCs
  on the slab: K5 from the slab's first cell (the unfused plain PyTorch
  route where a BC is one K5 does not support, as ``make_grid_stage``
  does on one device);
- the slabs all-gathered into the full grid; K3 once on the local
  particles; the vertices updated, then the elements rebuilt from the
  all-gathered vertices (padded elements frozen at identity ``d``).

Per substep that is K1, K2, K3, K5 (and K8) once and K4 twice: the
launches of the single-device substep.  On CPU tensors each kernel
wrapper runs its plain version.

Not ported: the column-bin, Pallas-column and packed-halo options
(``column_k``, ``column_c_cap``, ``column_pallas``, ``halo_cap``,
``mesh_column_k``) and the overflow output that serves them: they lay
the grid out for the TPU's matrix unit, and the port's kernels work on
the dense grid, which drops nothing.

**The gradient.**  ``make_sharded_material_step`` returns the true
gradient of the loss it returns.  The JAX step all-reduces an already
all-reduced loss's gradients, which is N times that gradient on N
devices (tests/test_torch_parallel.py shows the factor); the port seeds
each rank's copy of the replicated loss with 1 / N (parallel/
collectives.py).  The loss itself is JAX's: the mean over the PADDED
vertex count, padded vertices included (G2P clamps them from the origin
to 2 dx, so they add (2 dx)^2 * 3 each against a zero target).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..core import stepping
from ..core.types import MPMState, MPMStaticConfig, _Tensors
from ..ops import grid_pipeline as _gp
from ..ops import splat as _splat
from ..ops import stress as _stress
from ..ops import transfer as _transfer
from . import collectives as C

_EPS = 1e-15


@dataclasses.dataclass(frozen=True)
class ShardedClothState(_Tensors):
    """Block-separated mixed state; every array shards on axis 0.

    The traditional (sand) block rides along as zero-length arrays when
    absent, so the same container covers cloth-only and mixed scenes."""
    xe: torch.Tensor      # (E, 3) element positions
    xv: torch.Tensor      # (V, 3) vertex positions
    ve: torch.Tensor      # (E, 3)
    vv: torch.Tensor      # (V, 3)
    Ce: torch.Tensor      # (E, 3, 3)
    Cv: torch.Tensor      # (V, 3, 3)
    d: torch.Tensor       # (E, 3, 3)
    R_inv: torch.Tensor   # (E, 3)
    vol_e: torch.Tensor   # (E,)
    vol_v: torch.Tensor   # (V,)
    mass_e: torch.Tensor  # (E,)
    mass_v: torch.Tensor  # (V,)
    faces: torch.Tensor   # (E, 3) int32 global vertex indices
    valid_e: torch.Tensor  # (E,) 1.0 for real elements, 0.0 for padding
    xt: torch.Tensor      # (T, 3)
    vt: torch.Tensor      # (T, 3)
    Ct: torch.Tensor      # (T, 3, 3)
    Ft: torch.Tensor      # (T, 3, 3) elastic deformation gradient
    vol_t: torch.Tensor   # (T,)
    mass_t: torch.Tensor  # (T,)


@dataclasses.dataclass(frozen=True)
class UniformModel(_Tensors):
    """Uniform material scalars (0-d tensors).  ``mu`` and ``lam`` may
    instead be per-element (E_local,) blocks, sharded like the elements
    (JAX's ``model_spec``); ``alpha`` is the sand's Drucker-Prager
    coefficient."""
    mu: torch.Tensor
    lam: torch.Tensor
    gamma: torch.Tensor
    kappa: torch.Tensor
    friction_coeff: torch.Tensor
    gravity: torch.Tensor        # (3,)
    mesh_friction: torch.Tensor
    alpha: torch.Tensor = dataclasses.field(
        default_factory=lambda: torch.tensor(0.0))


def pad_to_multiple(arr, m: int, axis: int = 0, fill=0.0):
    """``arr`` padded with ``fill`` along ``axis`` to a multiple of m."""
    pad = (-arr.shape[axis]) % m
    if pad == 0:
        return arr
    shape = list(arr.shape)
    shape[axis] = pad
    return torch.cat([arr, torch.full(shape, fill, dtype=arr.dtype,
                                      device=arr.device)], dim=axis)


def _pad_eye(f, m: int):
    """Pad (N, 3, 3) with identity rows: a zero-padded F (or d) is
    singular, and the sand return map's log of it (the QR of d) would be
    NaN even at zero mass."""
    pad = (-f.shape[0]) % m
    if pad == 0:
        return f
    eye = torch.eye(3, dtype=f.dtype, device=f.device).expand(pad, 3, 3)
    return torch.cat([f, eye], 0)


def make_sharded_cloth_state(cfg: MPMStaticConfig, state: MPMState,
                             n_devices: int) -> ShardedClothState:
    """Split an MPMState into padded per-block arrays, each a multiple of
    ``n_devices`` long.  Padding has zero mass and volume, so padded
    particles add nothing; padded faces point at vertex 0 with zero
    force, identity ``d`` and ``R_inv`` (1, 0, 1)."""
    E, T = cfg.n_elements, cfg.n_traditional
    pe = lambda a: pad_to_multiple(a, n_devices)
    st = slice(E, E + T)
    r_inv = pad_to_multiple(state.R_inv, n_devices).clone()
    r_inv[E:] = torch.tensor([1.0, 0.0, 1.0], dtype=r_inv.dtype,
                             device=r_inv.device)
    return ShardedClothState(
        xe=pe(state.x[:E]), xv=pe(state.x[E + T:]),
        ve=pe(state.v[:E]), vv=pe(state.v[E + T:]),
        Ce=pe(state.C[:E]), Cv=pe(state.C[E + T:]),
        d=_pad_eye(state.d, n_devices), R_inv=r_inv,
        vol_e=pe(state.vol[:E]), vol_v=pe(state.vol[E + T:]),
        mass_e=pe(state.mass[:E]), mass_v=pe(state.mass[E + T:]),
        faces=pe(state.faces.to(torch.int32)),
        valid_e=pe(torch.ones((E,), dtype=state.x.dtype,
                              device=state.x.device)),
        xt=pe(state.x[st]), vt=pe(state.v[st]), Ct=pe(state.C[st]),
        Ft=_pad_eye(state.F, n_devices),
        vol_t=pe(state.vol[st]), mass_t=pe(state.mass[st]))


def shard_state(st: ShardedClothState, rank: int, world: int
                ) -> ShardedClothState:
    """Rank ``rank``'s axis-0 block of every array (JAX places the whole
    state with a ``NamedSharding``; here each rank holds its own block)."""
    return dataclasses.replace(st, **{
        f.name: _block(getattr(st, f.name), rank, world)
        for f in dataclasses.fields(st)})


def _block(a, rank: int, world: int):
    if a.shape[0] % world:
        raise ValueError(f"{a.shape[0]} rows do not split over {world} "
                         "ranks: pad with make_sharded_cloth_state")
    k = a.shape[0] // world
    return a[rank * k:(rank + 1) * k]


def make_slab_grid_stage(cfg: MPMStaticConfig, grid_post, has_mesh: bool,
                         has_mover: bool):
    """The grid phase on a rank's slab: fn(grid_v_in, grid_m, mesh,
    mover, um, time, dt, cell_start) -> grid_v_out, ``mesh`` = (acc,
    grid_w) of the collider splat or None, ``mover`` = (grid_vel,
    grid_w) of the mover splat or None, all on the slab's cells.  K5 from
    ``cell_start`` where every BC is kernel-supported, else the unfused
    plain PyTorch route.  ``UniformModel`` has no grid damping."""
    if _gp.supported_bcs(grid_post):
        pipeline = _gp.make_grid_pipeline(cfg, grid_post, has_mesh,
                                          has_mover)
        surf = _gp.pack_surface_params(grid_post)

        def fused(grid_v_in, grid_m, mesh, mover, um, time, dt, cell_start):
            acc, mesh_w = mesh if has_mesh else (None, None)
            mover_v, mover_w = mover if has_mover else (None, None)
            return pipeline(grid_v_in, grid_m, acc, mesh_w, mover_v, mover_w,
                            um.gravity, 1.0,
                            um.mesh_friction if has_mesh else None, time, dt,
                            surf, cell_start=cell_start)
        return fused

    def unfused(grid_v_in, grid_m, mesh, mover, um, time, dt, cell_start):
        active = grid_m > _EPS
        v = torch.where(active[:, None],
                        grid_v_in / torch.clamp_min(grid_m, _EPS)[:, None]
                        + dt * um.gravity[None, :], 0.0)
        if has_mesh:
            v = stepping.project_on_mesh(*mesh, um.mesh_friction, v)
        if has_mover:
            mover_v, mover_w = mover
            v = torch.where((mover_w > _EPS)[:, None],
                            mover_v / torch.clamp_min(mover_w, _EPS)[:, None],
                            v)
        for col in grid_post:
            v = stepping.apply_grid_bc(cfg, col, v, time, dt,
                                       cell_start=cell_start)
        return v
    return unfused


def local_cloth_substep(cfg: MPMStaticConfig, st: ShardedClothState,
                        um: UniformModel, dt: float, mesh_x, mesh_v,
                        joint_verts_v, num_joint_v: int, n_vertices: int,
                        group, grid_stage, time: float = 0.0,
                        joint_faces_v=None, num_joint_f: int = 0
                        ) -> ShardedClothState:
    """One substep on this rank's block (see the module docstring).
    ``mesh_x``/``mesh_v`` are this rank's collider triangles (F_local, 3,
    3) or None; ``joint_verts_v`` (num_joint_v, 3) and ``joint_faces_v``
    (num_joint_f, 3) are the mover's velocities, the same on every rank;
    ``n_vertices`` is the padded vertex count of all ranks;
    ``grid_stage`` is ``make_slab_grid_stage``'s function."""
    rank, world = C.rank(group), C.world_size(group)
    e_loc, t_loc, v_loc = st.xe.shape[0], st.xt.shape[0], st.xv.shape[0]
    G = cfg.n_grid
    if G ** 3 % world:
        raise ValueError(f"the {G}^3 grid does not split over {world} ranks")
    slab = G ** 3 // world
    slab_start = rank * slab
    dtype, dev = st.xe.dtype, st.xe.device
    ones_e = torch.ones((e_loc,), dtype=dtype, device=dev)
    # cloth material leaves: scalars, or per-element blocks like xe
    per_e = lambda leaf: leaf if leaf.dim() > 0 else leaf * ones_e

    # ---- stress (local elements) + vertex forces (all-reduced) ----------
    d_new, stress_e, f1, f2, f3 = _stress.cloth_stress(
        st.d, st.R_inv, st.vol_e, ones_e, per_e(um.mu), per_e(um.lam),
        per_e(um.gamma), per_e(um.kappa), um.friction_coeff)
    faces = st.faces.long()
    vforce = torch.zeros((n_vertices, 3), dtype=dtype, device=dev)
    for c, fc in enumerate((f1, f2, f3)):
        vforce = vforce.index_add(0, faces[:, c], fc)
    vforce = C.all_reduce(vforce, group)
    my_vforce = vforce[rank * v_loc:(rank + 1) * v_loc]

    # ---- traditional (sand) block: K8 --------------------------------------
    if t_loc > 0 and um.mu.dim() > 0:
        raise ValueError("per-element cloth materials are not supported "
                         "together with a traditional block (the sand's "
                         "return map needs scalar mu/lam)")
    if t_loc > 0:
        ones_t = torch.ones((t_loc,), dtype=dtype, device=dev)
        f_new, stress_t = _stress.sand_stress(
            st.Ft, st.Ft, ones_t, um.mu * ones_t, um.lam * ones_t, um.alpha)
        stress_t = st.vol_t[:, None, None] * stress_t
    else:
        f_new = st.Ft
        stress_t = st.Ft.new_zeros((0, 3, 3))

    # ---- P2G: K2 on the local particles, reduce-scattered to the slab ----
    x = torch.cat([st.xe, st.xt, st.xv], 0)
    grid_v_in, grid_m = _transfer.p2g(
        x, torch.cat([st.ve, st.vt, st.vv], 0),
        torch.cat([st.Ce, st.Ct, st.Cv], 0),
        torch.cat([st.mass_e, st.mass_t, st.mass_v], 0),
        torch.ones((x.shape[0],), dtype=dtype, device=dev),
        dt * torch.cat([stress_e, stress_t], 0), dt * my_vforce,
        G, cfg.inv_dx, cfg.dx)
    grid_v_in = C.reduce_scatter(grid_v_in, group)
    grid_m = C.reduce_scatter(grid_m, group)

    # ---- the collider: faces sharded, K4 splat reduce-scattered ----------
    mesh = None
    if mesh_x is not None:
        points, values = stepping.triangle_values(mesh_x, mesh_v)
        acc, mesh_w = _splat.splat(points.detach(), values.detach(), G,
                                   cfg.inv_dx)
        mesh = (C.reduce_scatter(acc, group),
                C.reduce_scatter(mesh_w, group))

    # ---- the mover: every rank splats all joint points, keeps its slab ----
    pts, vels = [], []
    if joint_verts_v is not None and num_joint_v > 0:
        pts.append(C.all_gather(st.xv, group)[:num_joint_v])
        vels.append(joint_verts_v)
    if joint_faces_v is not None and num_joint_f > 0:
        # joint ELEMENTS, pinned at their centroids
        pts.append(C.all_gather(st.xe, group)[:num_joint_f])
        vels.append(joint_faces_v)
    mover = None
    if pts:
        mover_v, mover_w = _splat.splat(torch.cat(pts, 0),
                                        torch.cat(vels, 0), G, cfg.inv_dx)
        cells = slice(slab_start, slab_start + slab)
        mover = (mover_v[cells], mover_w[cells])

    # ---- the grid phase on the slab, then the full grid for G2P ----------
    grid_v_out = grid_stage(grid_v_in, grid_m, mesh, mover, um, time, dt,
                            slab_start)
    grid_v_out = C.all_gather(grid_v_out, group)

    # ---- G2P: K3 on the local particles ----------------------------------
    new_v, new_c, grad_v = _transfer.g2p(x, grid_v_out, G, cfg.inv_dx)
    sl_t = slice(e_loc, e_loc + t_loc)
    sl_v = slice(e_loc + t_loc, None)
    a_min, a_max = cfg.dx * 2.0, cfg.grid_lim - cfg.dx * 2.0
    vv_new, cv_new = new_v[sl_v], new_c[sl_v]
    xv_new = torch.clamp(st.xv + dt * vv_new, a_min, a_max)
    if t_loc > 0:
        vt_new, ct_new = new_v[sl_t], new_c[sl_t]
        xt_new = torch.clamp(st.xt + dt * vt_new, a_min, a_max)
        # F += dt grad_v F, as core/stepping.py::g2p writes it
        ft_next = f_new + dt * (grad_v[sl_t, :, :, None]
                                * f_new[:, None, :, :]).sum(2)
    else:
        xt_new, vt_new, ct_new, ft_next = st.xt, st.vt, st.Ct, f_new

    # ---- elements from the all-gathered vertices -------------------------
    xv_full = C.all_gather(xv_new, group)
    vv_full = C.all_gather(vv_new, group)
    fa, fb, fc = faces[:, 0], faces[:, 1], faces[:, 2]
    xe_new = (xv_full[fa] + xv_full[fb] + xv_full[fc]) / 3.0
    ve_new = (vv_full[fa] + vv_full[fb] + vv_full[fc]) / 3.0
    d3_old = d_new[:, :, 2]
    d3 = d3_old + dt * (grad_v[:e_loc] * d3_old[:, None, :]).sum(-1)
    d_out = torch.stack([xv_full[fb] - xv_full[fa],
                         xv_full[fc] - xv_full[fa], d3], dim=-1)
    # padded elements (faces all 0) rebuild a singular d whose QR is NaN
    # on the next substep: freeze them at identity instead
    eye = torch.eye(3, dtype=dtype, device=dev).expand_as(d_out)
    d_out = torch.where(st.valid_e[:, None, None] > 0.5, d_out, eye)
    return dataclasses.replace(
        st, xe=xe_new, xv=xv_new, ve=ve_new, vv=vv_new, Ce=new_c[:e_loc],
        Cv=cv_new, d=d_out, xt=xt_new, vt=vt_new, Ct=ct_new, Ft=ft_next)


def _stages(cfg, grid_post, has_mesh):
    """The slab grid stage without and with the mover."""
    return {m: make_slab_grid_stage(cfg, grid_post, has_mesh, m)
            for m in (False, True)}


def _has_mover(joint_verts_v, num_joint_v, joint_faces_v, num_joint_f):
    return ((joint_verts_v is not None and num_joint_v > 0)
            or (joint_faces_v is not None and num_joint_f > 0))


def _substep_mesh(mesh_x, mesh_v, s: int, dt32):
    """The collider at substep s of the frame: mesh_x + (s dt) mesh_v."""
    return mesh_x + float(np.float32(s) * dt32) * mesh_v


def make_sharded_frame(cfg: MPMStaticConfig, group, num_substeps: int,
                       dt: float, num_joint_v: int = 0, grid_post=(),
                       with_mesh: bool = True, with_joints: bool = False,
                       num_joint_f: int = 0):
    """The multi-device forward frame over mixed cloth + sand scenes with
    grid BCs, the counterpart of ``MPMSolver.frame``.

    Returns fn(st, um[, mesh_x (F_local, 3, 3), mesh_v][, joint_verts_v
    [, joint_faces_v]]) -> st, each rank passing its own block of the
    state (``shard_state``), of the collider's triangles and of any
    per-element ``um.mu``/``um.lam``, and the same joint velocities.
    Time advances in float32 steps of dt from 0."""
    stages = _stages(cfg, tuple(grid_post), with_mesh)
    dt32 = np.float32(dt)

    def frame(st, um, *rest):
        rest = list(rest)
        mesh_x = mesh_v = joint_verts_v = joint_faces_v = None
        if with_mesh:
            mesh_x, mesh_v = rest.pop(0), rest.pop(0)
        if with_joints:
            joint_verts_v = rest.pop(0)
            if num_joint_f > 0:
                joint_faces_v = rest.pop(0)
        if rest:
            raise TypeError(f"{len(rest)} unexpected frame inputs")
        nv = st.xv.shape[0] * C.world_size(group)
        stage = stages[_has_mover(joint_verts_v, num_joint_v, joint_faces_v,
                                  num_joint_f)]
        t = np.float32(0.0)
        for s in range(num_substeps):
            mx = None if mesh_x is None else _substep_mesh(mesh_x, mesh_v, s,
                                                           dt32)
            st = local_cloth_substep(
                cfg, st, um, float(dt32), mx, mesh_v, joint_verts_v,
                num_joint_v, nv, group, stage, time=float(t),
                joint_faces_v=joint_faces_v, num_joint_f=num_joint_f)
            t = np.float32(t + dt32)
        return st

    return frame


def make_sharded_material_step(cfg: MPMStaticConfig, group,
                               num_substeps: int, dt: float,
                               num_joint_v: int = 0):
    """The multi-device material-training step.

    Returns fn(st, um, mesh_x (F_local, 3, 3), mesh_v, joint_verts_v
    (num_joint_v, 3) or None, target (V_local, 3)) -> (loss, grads, st):
    the loss sum((xv - target)^2) / (3 V_padded) over all ranks after
    ``num_substeps`` substeps from time 0, its gradient with respect to
    every leaf of ``um`` (a ``UniformModel`` of the true gradient, the
    same on every rank) and this rank's final block, detached.  Each
    substep is checkpointed (non-reentrant ``torch.utils.checkpoint``, as
    ``MPMSolver.frame(remat=True)``): the backward recomputes it, and its
    collectives run again in the same order on every rank."""
    stages = _stages(cfg, (), True)
    dt32 = np.float32(dt)

    def step(st, um, mesh_x, mesh_v, joint_verts_v, target):
        world = C.world_size(group)
        nv = st.xv.shape[0] * world
        names = [f.name for f in dataclasses.fields(um)]
        leaves = {k: getattr(um, k).detach().to(st.xv.device).clone()
                  .requires_grad_(True) for k in names}
        um_ = UniformModel(**leaves)
        stage = stages[_has_mover(joint_verts_v, num_joint_v, None, 0)]

        def substep(state, mx):
            return local_cloth_substep(cfg, state, um_, float(dt32), mx,
                                       mesh_v, joint_verts_v, num_joint_v,
                                       nv, group, stage)

        with torch.enable_grad():
            s = st
            for k in range(num_substeps):
                # the substep draws no random numbers: no RNG state to keep
                s = checkpoint(substep, s, _substep_mesh(mesh_x, mesh_v, k,
                                                         dt32),
                               use_reentrant=False, preserve_rng_state=False)
            err = torch.sum((s.xv - target) ** 2)
            loss = C.all_reduce(err, group) / (3.0 * nv)
            # the loss is replicated: the ranks' seeds sum to one
            grads = torch.autograd.grad(
                loss, list(leaves.values()),
                grad_outputs=torch.full_like(loss, 1.0 / world),
                allow_unused=True)
        with torch.no_grad():
            grads = {k: C.all_reduce(torch.zeros_like(leaves[k]) if g is None
                                     else g, group)
                     for k, g in zip(names, grads)}
            s = dataclasses.replace(s, **{
                f.name: getattr(s, f.name).detach()
                for f in dataclasses.fields(s)})
        return loss.detach(), UniformModel(**grads), s

    return step


__all__ = ["ShardedClothState", "UniformModel", "pad_to_multiple",
           "make_sharded_cloth_state", "shard_state",
           "make_slab_grid_stage", "local_cloth_substep",
           "make_sharded_frame", "make_sharded_material_step"]
