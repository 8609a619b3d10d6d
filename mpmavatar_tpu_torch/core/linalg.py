"""Batched small-matrix linear algebra (port of
mpmavatar_tpu/core/linalg.py).

Written by hand rather than through ``torch.linalg.qr`` / ``svd``: those
use other sign conventions, and the anisotropic return map depends on the
ones below.

* ``qr3_pos``: thin QR of ``d`` whose columns are (d1, d2, d3).  Q is a
  proper rotation, R upper triangular with R11 > 0, R22 > 0 and
  R33 = det(d) / (R11 * R22) carrying the element-inversion sign.
* ``svd3``: rotation-convention SVD — U, V proper rotations, the
  smallest-magnitude singular value negative when det(F) < 0.
"""

from __future__ import annotations

import torch

_EPS = 1e-12


def safe_sqrt(x):
    """sqrt with a zero (sub)gradient at x == 0 instead of NaN."""
    safe = x > 0
    return torch.where(safe, torch.sqrt(torch.where(safe, x, 1.0)), 0.0)


def safe_norm(x, dim=-1, keepdim=False):
    """L2 norm with a zero gradient at ||x|| == 0."""
    return safe_sqrt(torch.sum(x * x, dim=dim, keepdim=keepdim))


def safe_normalize(x, dim=-1, eps=_EPS):
    """x / max(||x||, eps)."""
    return x / torch.clamp_min(safe_norm(x, dim=dim, keepdim=True), eps)


def cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def det3(m):
    """Determinant of (..., 3, 3) by cofactors."""
    return (m[..., 0, 0] * (m[..., 1, 1] * m[..., 2, 2]
                            - m[..., 1, 2] * m[..., 2, 1])
            - m[..., 0, 1] * (m[..., 1, 0] * m[..., 2, 2]
                              - m[..., 1, 2] * m[..., 2, 0])
            + m[..., 0, 2] * (m[..., 1, 0] * m[..., 2, 1]
                              - m[..., 1, 1] * m[..., 2, 0]))


def qr3_pos(d):
    """Batched thin QR of (..., 3, 3) matrices with columns (d1, d2, d3).

    Returns (Q, R) with Q a proper rotation, R upper triangular,
    R11, R22 > 0."""
    d1, d2, d3 = d[..., :, 0], d[..., :, 1], d[..., :, 2]
    r11 = safe_norm(d1)
    q1 = d1 / torch.clamp_min(r11, _EPS)[..., None]
    r12 = torch.sum(q1 * d2, dim=-1)
    u2 = d2 - r12[..., None] * q1
    r22 = safe_norm(u2)
    q2 = u2 / torch.clamp_min(r22, _EPS)[..., None]
    q3 = cross(q1, q2)

    r13 = torch.sum(q1 * d3, dim=-1)
    r23 = torch.sum(q2 * d3, dim=-1)
    r33 = torch.sum(q3 * d3, dim=-1)

    q = torch.stack([q1, q2, q3], dim=-1)
    zero = torch.zeros_like(r11)
    r = torch.stack([
        torch.stack([r11, r12, r13], dim=-1),
        torch.stack([zero, r22, r23], dim=-1),
        torch.stack([zero, zero, r33], dim=-1),
    ], dim=-2)
    return q, r


def polar2x2_rotation(f11, f12, f21, f22):
    """(c, s) of the polar rotation [[c, -s], [s, c]] of a 2x2 matrix with
    positive determinant: theta = atan2(f21 - f12, f11 + f22)."""
    x = f11 + f22
    y = f21 - f12
    scale = torch.rsqrt(torch.clamp_min(x * x + y * y, _EPS))
    return x * scale, y * scale


def _jacobi_eigh3(a, sweeps: int = 8):
    """Cyclic-Jacobi eigendecomposition of symmetric (..., 3, 3), fixed
    sweep count.  Returns (eigenvalues, eigenvectors as columns),
    unsorted."""

    def rot_pq(a, v, p, q):
        app, aqq, apq = a[..., p, p], a[..., q, q], a[..., p, q]
        small = torch.abs(apq) < _EPS
        tau = (aqq - app) / (2.0 * torch.where(small, 1.0, apq))
        sgn = torch.where(tau >= 0.0, 1.0, -1.0)
        t = sgn / (torch.abs(tau) + torch.sqrt(1.0 + tau * tau))
        t = torch.where(small, 0.0, t)
        c = 1.0 / torch.sqrt(1.0 + t * t)
        s = t * c
        cb, sb = c[..., None], s[..., None]
        # A' = G^T A G, V' = V G with G[p,p]=G[q,q]=c, G[p,q]=s, G[q,p]=-s
        ap, aq = a[..., :, p], a[..., :, q]
        b = a.clone()
        b[..., :, p] = cb * ap - sb * aq
        b[..., :, q] = sb * ap + cb * aq
        brp, brq = b[..., p, :], b[..., q, :]
        a2 = b.clone()
        a2[..., p, :] = cb * brp - sb * brq
        a2[..., q, :] = sb * brp + cb * brq
        vp, vq = v[..., :, p], v[..., :, q]
        v2 = v.clone()
        v2[..., :, p] = cb * vp - sb * vq
        v2[..., :, q] = sb * vp + cb * vq
        return a2, v2

    v = torch.eye(3, dtype=a.dtype, device=a.device) * torch.ones_like(a)
    for _ in range(sweeps):
        for (p, q) in ((0, 1), (0, 2), (1, 2)):
            a, v = rot_pq(a, v, p, q)
    return torch.stack([a[..., 0, 0], a[..., 1, 1], a[..., 2, 2]], -1), v


def svd3(f, sweeps: int = 8):
    """Batched SVD of (..., 3, 3) in the rotation convention.

    Returns (U, sigma, V) with U, V proper rotations and ``sigma`` sorted
    descending; ``sigma[..., 2] < 0`` iff det(f) < 0."""
    ata = torch.sum(f[..., :, :, None] * f[..., :, None, :], dim=-3)
    eigval, v = _jacobi_eigh3(ata, sweeps=sweeps)

    order = torch.argsort(-eigval, dim=-1, stable=True)
    eigval = torch.gather(eigval, -1, order)
    v = torch.gather(v, -1, order[..., None, :].expand_as(v))

    sign_v = torch.sign(det3(v))
    v = torch.cat([v[..., :, :2], v[..., :, 2:] * sign_v[..., None, None]],
                  dim=-1)

    sigma = torch.sqrt(torch.clamp_min(eigval, 0.0))

    fv = torch.sum(f[..., :, :, None] * v[..., None, :, :], dim=-2)
    u0 = fv[..., :, 0] / torch.clamp_min(sigma[..., 0], _EPS)[..., None]
    u0 = u0 / torch.clamp_min(safe_norm(u0, keepdim=True), _EPS)
    u1_raw = fv[..., :, 1] - torch.sum(fv[..., :, 1] * u0, dim=-1,
                                       keepdim=True) * u0
    u1_norm = safe_norm(u1_raw, keepdim=True)
    # made on the device (a copy from the host cannot be graph-captured)
    ex, ey = torch.eye(3, dtype=f.dtype, device=f.device)[:2]
    alt = cross(u0, torch.where(torch.abs(u0[..., :1]) < 0.9, ex, ey))
    alt = alt / torch.clamp_min(safe_norm(alt, keepdim=True), _EPS)
    u1 = torch.where(u1_norm > 1e-6,
                     u1_raw / torch.clamp_min(u1_norm, _EPS), alt)
    u2 = cross(u0, u1)
    u = torch.stack([u0, u1, u2], dim=-1)

    flip = torch.where(det3(f) < 0.0, -1.0, 1.0)
    sigma = torch.cat([sigma[..., :2], sigma[..., 2:] * flip[..., None]],
                      dim=-1)
    return u, sigma, v


def inverse_lower_triangle(m):
    """Batched inverse of (..., 3, 3) lower-triangular matrices."""
    m11, m21, m22 = m[..., 0, 0], m[..., 1, 0], m[..., 1, 1]
    m31, m32, m33 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    invdet = 1.0 / (m11 * m22 * m33)
    zero = torch.zeros_like(m11)
    out = torch.stack([
        torch.stack([m22 * m33, zero, zero], dim=-1),
        torch.stack([-m21 * m33, m11 * m33, zero], dim=-1),
        torch.stack([m21 * m32 - m31 * m22, -m11 * m32, m11 * m22], dim=-1),
    ], dim=-2)
    return invdet[..., None, None] * out
