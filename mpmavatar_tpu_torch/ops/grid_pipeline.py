"""K5: fused grid pipeline, one pass over the dense grid per substep.

normalize + gravity + damping -> body-mesh projection -> mover override
-> surface BCs (sticky / slip / frictional, within their time window) ->
bounding-box zeroing, per cell.  It runs on the whole grid or on a slab of
it, the contiguous cells from a first flat cell on (a rank's share of the
grid in parallel/sharded.py, as mpmavatar_tpu/core/stepping.py::
slab_coords and ``apply_grid_bc(..., cell_start=)`` give JAX's sharded
substep): positions and the bounding box's indices come from each cell's
flat index in the whole grid.  ``make_grid_pipeline`` returns a function
that launches the CUDA kernel of ``csrc/grid_pipeline.cu`` on CUDA
tensors and runs ``grid_pipeline_plain`` on CPU tensors.  It replaces
mpmavatar_tpu/ops/pallas_grid_pipeline.py::make_grid_pipeline (kernel
``_grid_pipeline_pallas``, math ``_make_math``) and computes what that
kernel computes — including its order (surfaces before the bounding box,
whatever the registration order) and its bounding box without a time
window.  Scenes with other grid BCs take the unfused path in
core/stepping.py.

It differentiates as the JAX pipeline does (a custom VJP over
``_math_full``): on CUDA tensors that need grad the kernel's backward is
autograd over ``grid_pipeline_plain`` (``_autograd.call``).
"""

from __future__ import annotations

import torch

from ..core.colliders import (CUT, SLIP, STICKY, BoundingBoxCollider,
                              SurfaceCollider)
from ..core.types import MPMStaticConfig
from . import _autograd, _build

KERNEL = "grid_pipeline"
_EPS = 1e-15
_MAX_SURFACES = 15        # two bits of the kernel's surf_types int each


def supported_bcs(grid_post) -> bool:
    """True when every grid BC is kernel-supported (surface non-CUT or
    bounding box)."""
    for col in grid_post:
        if isinstance(col, SurfaceCollider):
            if col.surface_type == CUT:
                return False
        elif not isinstance(col, BoundingBoxCollider):
            return False
    return True


def pack_surface_params(grid_post) -> torch.Tensor:
    """(9 * surfaces,) float32: per surface point(3), normal(3), friction,
    t0, t1, in the order the pipeline expects.  Depends only on the
    collider set, so a solver packs it once."""
    rows = [torch.cat([col.point.reshape(3), col.normal.reshape(3),
                       col.friction.reshape(1), col.start_time.reshape(1),
                       col.end_time.reshape(1)])
            for col in grid_post if isinstance(col, SurfaceCollider)]
    return torch.cat(rows) if rows else torch.zeros(0)


def make_grid_pipeline(cfg: MPMStaticConfig, grid_post, has_mesh: bool,
                       has_mover: bool):
    """Bind the static scene structure; returns
    fn(grid_v_in (N,3), grid_m (N,), mesh_acc (N,6)|None, mesh_w (N,)|None,
    mover_v (N,3)|None, mover_w (N,)|None, gravity (3,), damping,
    mesh_friction (None without a mesh), time, dt, surf_params,
    cell_start=0) -> grid_v_out (N,3): the N cells from flat cell
    ``cell_start`` on (N = G^3 from 0: the whole grid); ``surf_params``
    from ``pack_surface_params``.  Under grad, the grid, the mesh and mover
    fields, gravity, damping, mesh_friction and surf_params are
    differentiable (JAX differentiates its scalar vector, surfaces
    included); dt is a Python float, and time a Python float or a float32
    0-d tensor on the grid's device, which the kernel reads when it runs
    (a captured substep's clock)."""
    if not supported_bcs(grid_post):
        raise ValueError("grid pipeline: unsupported grid BC in grid_post")
    surfaces = tuple(int(col.surface_type) for col in grid_post
                     if isinstance(col, SurfaceCollider))
    if len(surfaces) > _MAX_SURFACES:
        raise ValueError(f"grid pipeline: at most {_MAX_SURFACES} surfaces")
    bboxes = [col for col in grid_post
              if isinstance(col, BoundingBoxCollider)]
    has_bbox = bool(bboxes)
    bbox_pad = int(bboxes[-1].padding) if bboxes else 3
    G, cell_size = cfg.n_grid, float(cfg.dx)
    types = sum(t << (2 * i) for i, t in enumerate(surfaces))

    def pipeline(grid_v_in, grid_m, mesh_acc, mesh_w, mover_v, mover_w,
                 gravity, damping, mesh_friction, time, dt, surf_params,
                 cell_start: int = 0):
        dev, dtype = grid_v_in.device, grid_v_in.dtype
        n = grid_v_in.shape[0]
        if grid_v_in.shape != (n, 3) or grid_m.shape != (n,):
            raise ValueError("grid pipeline: grid must be (N, 3), (N,)")
        if not 0 <= cell_start <= G ** 3 - n:
            raise ValueError(f"grid pipeline: cells [{cell_start}, "
                             f"{cell_start + n}) outside the {G}^3 grid")
        if has_mesh != (mesh_acc is not None) or \
                has_mover != (mover_v is not None):
            raise ValueError("grid pipeline: mesh/mover fields do not "
                             "match the bound structure")
        if surf_params.numel() != 9 * len(surfaces):
            raise ValueError("grid pipeline: 9 parameters per surface")
        as_t = lambda v: None if v is None else torch.as_tensor(
            v, dtype=dtype, device=dev)
        gravity, damping = as_t(gravity).reshape(3), as_t(damping).reshape(())
        mesh_friction = as_t(mesh_friction).reshape(()) if has_mesh else None
        surf = as_t(surf_params) if surfaces else None
        if not isinstance(time, torch.Tensor):
            time = float(time)
        args = (grid_v_in, grid_m, mesh_acc, mesh_w, mover_v, mover_w,
                gravity, damping, mesh_friction, surf, time, float(dt),
                int(cell_start))
        if not grid_v_in.is_cuda:
            return plain(*args)
        return _autograd.call("grid_pipeline", launch, plain, *args)

    def plain(*args):
        *args, cell_start = args
        return grid_pipeline_plain(*args, G, cell_size, surfaces, has_bbox,
                                   bbox_pad, cell_start=cell_start)

    def launch(grid_v_in, grid_m, mesh_acc, mesh_w, mover_v, mover_w,
               gravity, damping, mesh_friction, surf, time, dt, cell_start):
        dev, dtype, n = grid_v_in.device, grid_v_in.dtype, grid_v_in.shape[0]
        ins = [None if t is None else _build.check_cuda(name, t)
               for name, t in (("grid_v_in", grid_v_in), ("grid_m", grid_m),
                               ("mesh_acc", mesh_acc), ("mesh_w", mesh_w),
                               ("mover_v", mover_v), ("mover_w", mover_w),
                               ("gravity", gravity), ("damping", damping),
                               ("mesh_friction", mesh_friction),
                               ("surf_params", surf))]
        time, time_p = _build.time_arg(time)
        out = torch.empty((n, 3), dtype=dtype, device=dev)
        _build.launch(KERNEL, "launch_grid_pipeline",
                      *[_build.ptr(t) for t in ins], time, dt, time_p,
                      cell_start, n, G, cell_size, int(has_mesh), int(has_mover),
                      len(surfaces), types, int(has_bbox), bbox_pad,
                      out.data_ptr(), _build.stream(dev))
        return out

    return pipeline


def grid_pipeline_plain(grid_v_in, grid_m, mesh_acc, mesh_w, mover_v,
                        mover_w, gravity, damping, mesh_friction, surf,
                        time: float, dt: float, G: int, cell_size: float,
                        surfaces, has_bbox: bool, bbox_pad: int,
                        cell_start: int = 0):
    """Plain PyTorch version of the kernel, with its arguments (``surf``
    as ``pack_surface_params`` gives it): the grid's rows are the cells
    from flat cell ``cell_start`` on."""
    cell = cell_start + torch.arange(grid_v_in.shape[0],
                                     device=grid_v_in.device)
    gi = (cell // (G * G), (cell // G) % G, cell % G)
    pos = [g.to(grid_v_in.dtype) * cell_size for g in gi]

    active = grid_m > _EPS
    m_safe = torch.where(active, grid_m, 1.0)
    v = [torch.where(active, grid_v_in[:, c] / m_safe + dt * gravity[c], 0.0)
         for c in range(3)]
    v = [torch.where(damping < 1.0, vc * damping, vc) for vc in v]

    if mesh_acc is not None:
        covered = mesh_w > _EPS
        w_safe = torch.where(covered, mesh_w, 1.0)
        mvel = [mesh_acc[:, c] / w_safe for c in range(3)]
        nx, ny, nz = mesh_acc[:, 3], mesh_acc[:, 4], mesh_acc[:, 5]
        nl = torch.clamp_min(torch.sqrt(nx * nx + ny * ny + nz * nz), 1e-12)
        nrm = (nx / nl, ny / nl, nz / nl)
        rel = [v[c] - mvel[c] for c in range(3)]
        nc = rel[0] * nrm[0] + rel[1] * nrm[1] + rel[2] * nrm[2]
        ncm = torch.clamp_max(nc, 0.0)
        pr = [rel[c] - ncm * nrm[c] for c in range(3)]
        vpl = torch.sqrt(pr[0] ** 2 + pr[1] ** 2 + pr[2] ** 2 + 1e-40)
        fric = torch.clamp_min(vpl + nc * mesh_friction, 0.0)
        f_act = (nc < 0.0) & (vpl > 1e-20)
        rat = torch.where(f_act, fric / torch.where(f_act, vpl, 1.0), 1.0)
        v = [torch.where(covered, rat * pr[c] + mvel[c], v[c])
             for c in range(3)]

    if mover_v is not None:
        movered = mover_w > _EPS
        mw_safe = torch.where(movered, mover_w, 1.0)
        v = [torch.where(movered, mover_v[:, c] / mw_safe, v[c])
             for c in range(3)]

    for si, stype in enumerate(surfaces):
        sp = surf[9 * si: 9 * si + 9]
        dotp = ((pos[0] - sp[0]) * sp[3] + (pos[1] - sp[1]) * sp[4]
                + (pos[2] - sp[2]) * sp[5])
        inside = (time >= sp[7]) & (time < sp[8]) & (dotp < 0.0)
        if stype == STICKY:
            v = [torch.where(inside, 0.0, vc) for vc in v]
            continue
        nc = v[0] * sp[3] + v[1] * sp[4] + v[2] * sp[5]
        cut = nc if stype == SLIP else torch.clamp_max(nc, 0.0)
        v2 = [v[c] - cut * sp[3 + c] for c in range(3)]
        vlen = torch.sqrt(v2[0] ** 2 + v2[1] ** 2 + v2[2] ** 2 + 1e-40)
        fr = torch.clamp_min(vlen + nc * sp[6], 0.0)
        fa = (nc < 0.0) & (vlen > 1e-20)
        rat = torch.where(fa, fr / torch.where(fa, vlen, 1.0), 1.0)
        v = [torch.where(inside, rat * v2[c], v[c]) for c in range(3)]

    if has_bbox:
        for a in range(3):
            low = (gi[a] < bbox_pad) & (v[a] < 0)
            high = (gi[a] >= G - bbox_pad) & (v[a] > 0)
            v[a] = torch.where(low | high, 0.0, v[a])
    return torch.stack(v, dim=-1)
