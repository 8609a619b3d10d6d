"""K4: w-weighted B-spline splat of point values onto the dense grid.

``splat`` launches the CUDA kernel of ``csrc/splat.cu`` on CUDA tensors
and runs ``splat_plain`` on CPU tensors.  Both replace
mpmavatar_tpu/ops/pallas_transfer.py::splat_columns_fused (inline kernel
over ``_splat_math``) with its contract minus the column bins, which is
the contract of mpmavatar_tpu/core/stepping.py::rasterize_to_grid: the
grid is flat
x-major, the weight comes back as its own channel, and the bounds check is
the reference's asymmetric ``base >= 0 & base < G - 3`` on every axis (a
point with base G - 3 is dropped whole).

The collider splat's inputs are detached by
core/stepping.py::mesh_collider_fields (JAX's ``stop_gradient``): the
collider mesh is a rollout input.  The mover splat
(``stepping.mover_fields``) splats the joint particles' own positions,
``state.x``, which a differentiated rollout makes depend on the material
parameters.  JAX differentiates that splat through the plain
``rasterize_to_grid``; its forward-only ``splat_columns_fused`` serves
only the halo path, which the port does not have.  So on CUDA tensors
that need grad ``splat`` launches the kernel inside
``_autograd.KernelWithTwinGrad``, whose backward is autograd over
``splat_plain``, as for K1, K2, K3, K5 and K8.

On the card each warp of 32 points sums its nodes in a shared-memory tile
of their stencils' box where the box fits, else adds them straight into
the grid; a launch of fewer than TILE_MIN_POINTS points takes a kernel
with one thread per point and node, straight into the grid
(csrc/splat.cu).  ``branch_counts`` counts the warps of each branch.
"""

from __future__ import annotations

import torch

from . import _autograd, _build
from .transfer import bspline, flat_indices, scatter_rows, stencil_products

KERNEL = "splat"
# the fewest points splatted through warp tiles; fewer (a few warps per
# SM, whose chains of 27 nodes would set the kernel's time) go one thread
# per point and node straight into the grid (csrc/splat.cu, where the
# timings that set it are)
TILE_MIN_POINTS = 8192


def _check_shapes(points, values):
    if points.dim() != 2 or points.shape[1] != 3 or values.dim() != 2 \
            or values.shape[0] != points.shape[0]:
        raise ValueError("splat: points must be (N, 3) and values (N, CH)")


def splat(points, values, n_grid: int, inv_dx: float,
          bounds_check: bool = True, branch_counts=None):
    """(grid_vals (G^3, CH), grid_w (G^3,)): sum over points of w * values
    and of w, w the 27-node stencil weight.

    On CUDA tensors this launches the kernel (or raises); it runs the
    plain version only for CPU tensors.  Under grad, points and values
    are differentiable; the backward is autograd over ``splat_plain``.
    ``branch_counts``, an int32 (2,) CUDA tensor, counts the warps of 32
    points that summed their nodes in a shared-memory tile and those that
    added them straight into the grid."""
    _check_shapes(points, values)
    if not points.is_cuda:
        return splat_plain(points, values, n_grid, inv_dx, bounds_check)
    _build.check_branch_counts("splat", branch_counts)
    launch = lambda *args: _launch(*args, branch_counts)
    return _autograd.call("splat", launch, splat_plain, points, values,
                          n_grid, inv_dx, bounds_check)


def _launch(points, values, n_grid, inv_dx, bounds_check, branch_counts):
    """K4 on CUDA tensors into the two zero-filled outputs."""
    pts = _build.check_cuda("points", points)
    vals = _build.check_cuda("values", values)
    n, ch = vals.shape
    n_cells = n_grid ** 3
    # both outputs zeroed by one fill, each a contiguous view of it
    fields = torch.zeros((n_cells * (ch + 1),), dtype=pts.dtype,
                         device=pts.device)
    grid_vals = fields[:n_cells * ch].view(n_cells, ch)
    grid_w = fields[n_cells * ch:]
    if n:
        _build.launch(KERNEL, "launch_splat", pts.data_ptr(), vals.data_ptr(),
                      n, ch, n_grid, inv_dx, int(bounds_check),
                      int(n >= TILE_MIN_POINTS), grid_vals.data_ptr(),
                      grid_w.data_ptr(),
                      _build.ptr(branch_counts), _build.stream(pts.device))
    return grid_vals, grid_w


def kernel_info() -> dict:
    """K4's registers, spills, shared memory and blocks per SM as built,
    at CH = 6 (the collider) and CH = 3 (the mover) (CUDA only)."""
    return {f"{KERNEL} (CH={ch})": _build.kernel_attributes("splat_info", ch)
            for ch in (6, 3)}


def splat_plain(points, values, n_grid: int, inv_dx: float,
                bounds_check: bool = True):
    """Plain PyTorch version of the kernel (``index_add_`` scatter), as
    the JAX package's ``stepping.rasterize_to_grid`` computes it."""
    base, _, w, _ = bspline(points, inv_dx)
    w27 = stencil_products(w)                                 # (N, 27)
    if bounds_check:
        inb = torch.all((base >= 0) & (base < n_grid - 3), dim=-1)
        w27 = w27 * inb[:, None].to(w27.dtype)
    src = torch.cat([w27[..., None] * values[:, None, :], w27[..., None]],
                    -1).reshape(-1, values.shape[1] + 1)
    grid = scatter_rows(flat_indices(base, n_grid).reshape(-1), src,
                        n_grid ** 3)
    return grid[:, :-1].contiguous(), grid[:, -1].contiguous()
