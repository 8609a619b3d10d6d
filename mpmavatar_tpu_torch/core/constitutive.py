"""Constitutive models and plastic return mappings (port of
mpmavatar_tpu/core/constitutive.py): masked tensor arithmetic over
(N, ...) batches.  Matrices are (..., 3, 3); singular values (..., 3).
"""

from __future__ import annotations

import math

import torch

from . import linalg
from .linalg import safe_norm, safe_sqrt


def _t(m):
    return m.transpose(-1, -2)


def _mat(diag):
    """Diagonal (..., 3) -> (..., 3, 3)."""
    return torch.diag_embed(diag)


def kirchoff_stress_fcr(f, u, v, j, mu, lam):
    """Fixed-corotated Kirchhoff stress."""
    r = u @ _t(v)
    eye = torch.eye(3, dtype=f.dtype, device=f.device)
    return (2.0 * mu)[..., None, None] * ((f - r) @ _t(f)) + \
        eye * (lam * j * (j - 1.0))[..., None, None]


def kirchoff_stress_neo_hookean(f, u, v, j, sig, mu, lam):
    """Compressible neo-Hookean Kirchhoff stress."""
    b = sig * sig
    tr = torch.sum(b, dim=-1, keepdim=True)
    b_hat = b - tr / 3.0
    tau = mu[..., None] * (j ** (-2.0 / 3.0))[..., None] * b_hat + \
        (lam / 2.0 * (j * j - 1.0))[..., None]
    return u @ _mat(tau) @ _t(v) @ _t(f)


def kirchoff_stress_stvk(f, u, v, sig, mu, lam):
    """St. Venant-Kirchhoff (Hencky) stress."""
    sig = torch.clamp_min(sig, 0.01)
    eps = torch.log(sig)
    log_sum = torch.sum(eps, dim=-1, keepdim=True)
    tau = 2.0 * mu[..., None] * eps + lam[..., None] * log_sum
    return u @ _mat(tau) @ _t(v) @ _t(f)


def von_mises_return_mapping(f_trial, mu, lam, yield_stress, xi,
                             hardening: int):
    """von Mises plastic return map.  Returns (F_elastic, yield_stress)."""
    u, sig_old, v = linalg.svd3(f_trial)
    sig = torch.clamp_min(sig_old, 0.01)
    eps = torch.log(sig)
    temp = torch.mean(eps, dim=-1, keepdim=True)
    tau = 2.0 * mu[..., None] * eps \
        + lam[..., None] * torch.sum(eps, -1, keepdim=True)
    cond = tau - torch.mean(tau, dim=-1, keepdim=True)
    yielding = safe_norm(cond) > yield_stress

    eps_hat = eps - temp
    eps_hat_norm = safe_norm(eps_hat) + 1e-6
    delta_gamma = eps_hat_norm - yield_stress / (2.0 * mu)
    eps_new = eps - (delta_gamma / eps_hat_norm)[..., None] * eps_hat
    f_elastic = u @ _mat(torch.exp(eps_new)) @ _t(v)

    f_out = torch.where(yielding[..., None, None], f_elastic, f_trial)
    if hardening == 1:
        ys_out = torch.where(yielding,
                             yield_stress + 2.0 * mu * xi * delta_gamma,
                             yield_stress)
    else:
        ys_out = yield_stress
    return f_out, ys_out


def von_mises_return_mapping_with_damage(f_trial, mu, lam, yield_stress,
                                         softening, xi, hardening: int):
    """von Mises with damage softening.
    Returns (F_elastic, yield_stress, mu, lam)."""
    u, sig_old, v = linalg.svd3(f_trial)
    sig = torch.clamp_min(sig_old, 0.01)
    eps = torch.log(sig)
    temp = torch.mean(eps, dim=-1, keepdim=True)
    tau = 2.0 * mu[..., None] * eps \
        + lam[..., None] * torch.sum(eps, -1, keepdim=True)
    cond = tau - torch.mean(tau, dim=-1, keepdim=True)
    yielding = (safe_norm(cond) > yield_stress) & (yield_stress > 0)

    eps_hat = eps - temp
    eps_hat_norm = safe_norm(eps_hat) + 1e-6
    delta_gamma = eps_hat_norm - yield_stress / (2.0 * mu)
    corr = (delta_gamma / eps_hat_norm)[..., None] * eps_hat
    eps_new = eps - corr
    ys_soft = yield_stress - softening * safe_norm(corr)
    damaged = ys_soft <= 0
    f_elastic = u @ _mat(torch.exp(eps_new)) @ _t(v)

    f_out = torch.where(yielding[..., None, None], f_elastic, f_trial)
    ys_out = torch.where(yielding, ys_soft, yield_stress)
    if hardening == 1:
        ys_out = torch.where(yielding, ys_out + 2.0 * mu * xi * delta_gamma,
                             ys_out)
    mu_out = torch.where(yielding & damaged, 0.0, mu)
    lam_out = torch.where(yielding & damaged, 0.0, lam)
    return f_out, ys_out, mu_out, lam_out


def viscoplasticity_return_mapping_stvk(f_trial, mu, yield_stress,
                                        plastic_viscosity, dt):
    """Viscoplastic (foam) return map."""
    u, sig_old, v = linalg.svd3(f_trial)
    sig = torch.clamp_min(sig_old, 0.01)
    b_trial = sig * sig
    eps = torch.log(sig)
    trace_eps = torch.sum(eps, dim=-1, keepdim=True)
    eps_hat = eps - trace_eps / 3.0
    s_trial = 2.0 * mu[..., None] * eps_hat
    s_norm = safe_norm(s_trial)
    y = s_norm - math.sqrt(2.0 / 3.0) * yield_stress
    yielding = y > 0

    mu_hat = mu * torch.mean(b_trial, dim=-1)
    s_new_norm = s_norm - y / (1.0 + plastic_viscosity / (2.0 * mu_hat * dt))
    s_new = (s_new_norm / torch.clamp_min(s_norm, 1e-12))[..., None] * s_trial
    eps_new = s_new / (2.0 * mu[..., None]) + trace_eps / 3.0
    f_elastic = u @ _mat(torch.exp(eps_new)) @ _t(v)
    return torch.where(yielding[..., None, None], f_elastic, f_trial)


def anisotropy_return_mapping(d, gamma, kappa, friction_coeff):
    """Garment return map on the QR factor of the direction matrix; only
    the third column (d3) of d changes."""
    q, r = linalg.qr3_pos(d)
    _, d3 = map_r_col3(q, r, gamma, kappa, friction_coeff)
    return torch.cat([d[..., :, :2], d3[..., :, None]], dim=-1)


def map_r_col3(q, r, gamma, kappa, friction_coeff):
    """Return-map core on a precomputed QR: new R column 3 and the mapped
    d3 = Q @ col3 (Q and R columns 1-2 are unchanged by the map)."""
    r13, r23, r33 = r[..., 0, 2], r[..., 1, 2], r[..., 2, 2]

    separated = r33 > 1.0
    fn = kappa * (1.0 - r33) ** 2
    ff = gamma * safe_sqrt(r13 * r13 + r23 * r23)
    slipping = ff > friction_coeff * fn
    ff_safe = torch.where(slipping, ff, 1.0)
    scale = friction_coeff * fn / ff_safe

    new_r13 = torch.where(separated, r13,
                          torch.where(slipping, r13 * scale, r13))
    new_r23 = torch.where(separated, r23,
                          torch.where(slipping, r23 * scale, r23))
    new_r33 = torch.where(separated, 1.0, r33)

    col3 = torch.stack([new_r13, new_r23, new_r33], dim=-1)
    d3 = torch.einsum("...ij,...j->...i", q, col3)
    return col3, d3


def anisotropic_stress(r_inv, d, vol, mu, lam, gamma, kappa):
    """Anisotropic garment Kirchhoff stress + per-element corner forces.
    Returns (stress (E,3,3), f1, f2, f3 each (E,3))."""
    q, r = linalg.qr3_pos(d)
    return anisotropic_stress_qr(r_inv, q, r, d[..., :, 2], vol,
                                 mu, lam, gamma, kappa)


def anisotropic_stress_qr(r_inv, q, r, d3, vol, mu, lam, gamma, kappa):
    """anisotropic_stress on a precomputed QR of d."""
    i11, i12, i22 = r_inv[..., 0], r_inv[..., 1], r_inv[..., 2]

    f11 = r[..., 0, 0] * i11
    f12 = r[..., 0, 0] * i12 + r[..., 0, 1] * i22
    f22 = r[..., 1, 1] * i22

    # in-plane 2x2 fixed corotated + volume term
    c, s = linalg.polar2x2_rotation(f11, f12, torch.zeros_like(f11), f22)
    j = f11 * f22
    two_mu = 2.0 * mu
    k11 = two_mu * (f11 - c) + lam * (j - 1.0) * f22
    k12 = two_mu * (f12 + s)
    k22 = two_mu * (f22 - c) + lam * (j - 1.0) * f11

    r13, r23, r33 = r[..., 0, 2], r[..., 1, 2], r[..., 2, 2]
    dr13 = gamma * r13
    dr23 = gamma * r23
    dr33 = torch.where(r33 > 1.0, 0.0, -kappa * (1.0 - r33) ** 2)

    zeros = torch.zeros_like(k11)
    dr = torch.stack([
        torch.stack([k11, k12, dr13], dim=-1),
        torch.stack([zeros, k22, dr23], dim=-1),
        torch.stack([zeros, zeros, dr33], dim=-1),
    ], dim=-2)
    # RiDT = [[F11,0,0],[F12,F22,0],[R13,R23,R33]] (lower triangular)
    ridt = torch.stack([
        torch.stack([f11, zeros, zeros], dim=-1),
        torch.stack([f12, f22, zeros], dim=-1),
        torch.stack([r13, r23, r33], dim=-1),
    ], dim=-2)

    k3 = dr @ ridt
    k3_sym = torch.stack([
        torch.stack([k3[..., 0, 0], k3[..., 0, 1], k3[..., 0, 2]], dim=-1),
        torch.stack([k3[..., 0, 1], k3[..., 1, 1], k3[..., 1, 2]], dim=-1),
        torch.stack([k3[..., 0, 2], k3[..., 1, 2], k3[..., 2, 2]], dim=-1),
    ], dim=-2)

    p = q @ k3_sym @ linalg.inverse_lower_triangle(ridt)
    p1, p2, p3 = p[..., :, 0], p[..., :, 1], p[..., :, 2]

    volb = vol[..., None]
    f2 = -volb * (i11[..., None] * p1 + i12[..., None] * p2)
    f3 = -volb * i22[..., None] * p2
    f1 = -(f2 + f3)
    stress = volb[..., None] * (p3[..., :, None] * d3[..., None, :])
    return stress, f1, f2, f3
