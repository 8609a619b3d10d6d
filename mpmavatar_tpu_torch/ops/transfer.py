"""K2 (P2G) and K3 (G2P): APIC transfers on the dense grid.

``p2g`` / ``g2p`` launch the CUDA kernels of ``csrc/transfer.cu`` on CUDA
tensors and run ``p2g_plain`` / ``g2p_plain`` on CPU tensors.  They
replace mpmavatar_tpu/ops/pallas_transfer.py::p2g_columns_fused (kernel
``_p2g_pallas``) and ::g2p_columns_fused (kernel ``_g2p_pallas``) with
the same contract, minus the column-bin layout: the grid is flat x-major,
``(x*G + y)*G + z``, velocity ``(G^3, 3)`` channel-last.

P2G scaling contract: ``stress`` (N, 3, 3) covers the N non-vertex
particles and ``vforce`` (P - N, 3) the vertices; both arrive multiplied
by dt (traditional stress also by vol), and the kernel applies mass*sel
to the momentum and sel to the force terms.

Both differentiate as their JAX entry points do (custom VJPs that
re-trace ``_p2g_math`` / ``_g2p_math``): on CUDA tensors that need grad
the kernel's backward is autograd over its plain version
(``_autograd.call``).
"""

from __future__ import annotations

import torch

from . import _autograd, _build

P2G_KERNEL = "p2g"
G2P_KERNEL = "g2p"

# 27-stencil offsets (i, j, k) row-major, as the JAX package orders them
_OFFSETS_I = torch.tensor([[i, j, k] for i in range(3) for j in range(3)
                           for k in range(3)], dtype=torch.int64)


def bspline(x, inv_dx: float):
    """Quadratic B-spline stencil data for positions ``x`` (N, 3):
    (base (N,3) int64, fx (N,3), w (N,3,3), dw (N,3,3)) with w[:, o, a]
    the offset-``o`` weight along axis ``a``."""
    grid_pos = x * inv_dx
    base = torch.floor(grid_pos - 0.5).to(torch.int64)
    fx = grid_pos - base.to(x.dtype)
    wa, wb, wc = 1.5 - fx, fx - 1.0, fx - 0.5
    w = torch.stack([0.5 * wa * wa, 0.75 - wb * wb, 0.5 * wc * wc], dim=-2)
    dw = torch.stack([fx - 1.5, -2.0 * (fx - 1.0), fx - 0.5], dim=-2)
    return base, fx, w, dw


def stencil_products(w):
    """weight(i,j,k) = w[:,i,0] * w[:,j,1] * w[:,k,2] as (N, 27)."""
    wx, wy, wz = w[:, :, 0], w[:, :, 1], w[:, :, 2]
    return (wx[:, :, None, None] * wy[:, None, :, None]
            * wz[:, None, None, :]).reshape(w.shape[0], 27)


def dweight27(w, dw, inv_dx: float):
    """Gradient-of-weight vectors (N, 27, 3)."""
    wx, wy, wz = w[:, :, 0], w[:, :, 1], w[:, :, 2]
    dwx, dwy, dwz = dw[:, :, 0], dw[:, :, 1], dw[:, :, 2]
    n = w.shape[0]
    gx = (dwx[:, :, None, None] * wy[:, None, :, None]
          * wz[:, None, None, :]).reshape(n, 27)
    gy = (wx[:, :, None, None] * dwy[:, None, :, None]
          * wz[:, None, None, :]).reshape(n, 27)
    gz = (wx[:, :, None, None] * wy[:, None, :, None]
          * dwz[:, None, None, :]).reshape(n, 27)
    return torch.stack([gx, gy, gz], dim=-1) * inv_dx


def offsets(device):
    """(27, 3) int64 stencil offsets on ``device``."""
    return _OFFSETS_I.to(device)


def flat_indices(base, n_grid: int):
    """(N, 3) base -> (N, 27) flat grid indices."""
    idx = base[:, None, :] + offsets(base.device)[None]
    return (idx[..., 0] * n_grid + idx[..., 1]) * n_grid + idx[..., 2]


def scatter_rows(flat, src, n_cells: int):
    """Sum the rows ``src`` (M, C) into a zeroed (n_cells, C) grid at flat
    indices ``flat`` (M,), with the index rule of the JAX package's
    ``.at[].add(mode="drop")``: an index in [-n_cells, 0) wraps to
    index + n_cells, and what still lies outside [0, n_cells) is
    dropped."""
    flat = torch.where(flat < 0, flat + n_cells, flat)
    keep = (flat >= 0) & (flat < n_cells)
    grid = torch.zeros((n_cells, src.shape[1]), dtype=src.dtype,
                       device=src.device)
    grid.index_add_(0, flat[keep], src[keep])
    return grid


def _check_p2g_shapes(x, v, c_eff, mass, sel, stress, vforce):
    p = x.shape[0]
    nnv = stress.shape[0]
    if (x.shape != (p, 3) or v.shape != (p, 3) or c_eff.shape != (p, 3, 3)
            or mass.shape != (p,) or sel.shape != (p,)
            or stress.shape != (nnv, 3, 3) or vforce.shape != (p - nnv, 3)):
        raise ValueError("p2g: inconsistent particle shapes")


def p2g(x, v, c_eff, mass, sel, stress, vforce, n_grid: int, inv_dx: float,
        dx: float, branch_counts=None):
    """APIC particle-to-grid scatter.  Returns (grid_v_in (G^3, 3),
    grid_m (G^3,)); see the module docstring for the scaling contract.

    On CUDA tensors this launches the kernel (or raises); it runs the
    plain version only for CPU tensors.  Under grad, x, v, c_eff, mass,
    sel, stress and vforce are differentiable; the backward is autograd
    over ``p2g_plain``.  ``branch_counts``, an int32 (2,) CUDA tensor,
    counts the kernel's blocks that accumulated in shared memory and
    those that added straight into the grid (csrc/transfer.cu)."""
    _check_p2g_shapes(x, v, c_eff, mass, sel, stress, vforce)
    if not x.is_cuda:
        return p2g_plain(x, v, c_eff, mass, sel, stress, vforce, n_grid,
                         inv_dx, dx)
    _build.check_branch_counts("p2g", branch_counts)
    launch = lambda *args: _launch_p2g(*args, branch_counts)
    return _autograd.call("p2g", launch, p2g_plain, x, v, c_eff, mass, sel,
                          stress, vforce, n_grid, inv_dx, dx)


def _launch_p2g(x, v, c_eff, mass, sel, stress, vforce, n_grid, inv_dx, dx,
                branch_counts):
    """K2 on CUDA tensors into two zero-filled grids."""
    ins = [_build.check_cuda(name, t) for name, t in (
        ("x", x), ("v", v), ("c_eff", c_eff), ("mass", mass), ("sel", sel),
        ("stress", stress), ("vforce", vforce))]
    n_cells = n_grid ** 3
    grid_v = torch.zeros((n_cells, 3), dtype=x.dtype, device=x.device)
    grid_m = torch.zeros((n_cells,), dtype=x.dtype, device=x.device)
    n = x.shape[0]
    if n:
        _build.launch(P2G_KERNEL, "launch_p2g", *[t.data_ptr() for t in ins],
                      n, stress.shape[0], n_grid, inv_dx, dx,
                      grid_v.data_ptr(), grid_m.data_ptr(),
                      _build.ptr(branch_counts), _build.stream(x.device))
    return grid_v, grid_m


def p2g_plain(x, v, c_eff, mass, sel, stress, vforce, n_grid: int,
              inv_dx: float, dx: float):
    """Plain PyTorch version of the P2G kernel (index_add_ scatter)."""
    n, nnv = x.shape[0], stress.shape[0]
    base, fx, w, dw = bspline(x, inv_dx)
    w27 = stencil_products(w)                                 # (P, 27)
    dweight = dweight27(w, dw, inv_dx)                        # (P, 27, 3)
    gidx = flat_indices(base, n_grid)                         # (P, 27)
    dpos = (offsets(x.device)[None].to(x.dtype) - fx[:, None, :]) * dx

    force_stress = -torch.einsum("pab,pnb->pna", stress, dweight[:nnv])
    force_vertex = w27[nnv:, :, None] * vforce[:, None, :]
    force = torch.cat([force_stress, force_vertex], dim=0)   # (P, 27, 3)

    momentum = v[:, None, :] + torch.einsum("pab,pnb->pna", c_eff, dpos)
    mass_w = w27 * (mass * sel)[:, None]
    v_add = mass_w[..., None] * momentum + sel[:, None, None] * force

    src = torch.cat([v_add, mass_w[..., None]], -1).reshape(-1, 4)
    grid = scatter_rows(gidx.reshape(-1), src, n_grid ** 3)
    return grid[:, :3].contiguous(), grid[:, 3].contiguous()


def g2p(x, grid_v, n_grid: int, inv_dx: float, branch_counts=None):
    """27-stencil gather: (new_v (P,3), new_C (P,3,3), grad_v (P,3,3)).

    On CUDA tensors this launches the kernel (or raises); it runs the
    plain version only for CPU tensors.  Under grad, x and grid_v are
    differentiable; the backward is autograd over ``g2p_plain``.
    ``branch_counts``, an int32 (2,) CUDA tensor, counts the kernel's
    blocks that gathered from a shared-memory tile of their stencils' box
    and those that gathered straight from the grid (csrc/transfer.cu)."""
    if x.shape[1:] != (3,) or grid_v.shape != (n_grid ** 3, 3):
        raise ValueError("g2p: x must be (P, 3) and grid_v (G^3, 3)")
    if not x.is_cuda:
        return g2p_plain(x, grid_v, n_grid, inv_dx)
    _build.check_branch_counts("g2p", branch_counts)
    launch = lambda *args: _launch_g2p(*args, branch_counts)
    return _autograd.call("g2p", launch, g2p_plain, x, grid_v, n_grid,
                          inv_dx)


def _launch_g2p(x, grid_v, n_grid, inv_dx, branch_counts):
    """K3 on CUDA tensors."""
    x_c = _build.check_cuda("x", x)
    g_c = _build.check_cuda("grid_v", grid_v)
    n = x.shape[0]
    new_v = torch.empty((n, 3), dtype=x.dtype, device=x.device)
    new_c = torch.empty((n, 3, 3), dtype=x.dtype, device=x.device)
    grad_v = torch.empty((n, 3, 3), dtype=x.dtype, device=x.device)
    if n:
        _build.launch(G2P_KERNEL, "launch_g2p", x_c.data_ptr(),
                      g_c.data_ptr(), n, n_grid, inv_dx, new_v.data_ptr(),
                      new_c.data_ptr(), grad_v.data_ptr(),
                      _build.ptr(branch_counts), _build.stream(x.device))
    return new_v, new_c, grad_v


def kernel_info() -> dict:
    """K2's and K3's registers, spills, shared memory and blocks per SM as
    built (CUDA only)."""
    return {P2G_KERNEL: _build.kernel_attributes("p2g_info"),
            G2P_KERNEL: _build.kernel_attributes("g2p_info")}


def g2p_plain(x, grid_v, n_grid: int, inv_dx: float):
    """Plain PyTorch version of the G2P kernel."""
    base, fx, w, dw = bspline(x, inv_dx)
    w27 = stencil_products(w)
    dweight = dweight27(w, dw, inv_dx)
    gidx = torch.clamp(flat_indices(base, n_grid), 0, n_grid ** 3 - 1)
    gv = grid_v[gidx]                                         # (P, 27, 3)
    new_v = torch.sum(w27[..., None] * gv, dim=1)
    dpos = offsets(x.device)[None].to(x.dtype) - fx[:, None, :]  # unitless
    new_c = torch.sum((w27 * inv_dx * 4.0)[..., None, None]
                      * gv[..., :, None] * dpos[..., None, :], dim=1)
    grad_v = torch.sum(gv[..., :, None] * dweight[..., None, :], dim=1)
    return new_v, new_c, grad_v
