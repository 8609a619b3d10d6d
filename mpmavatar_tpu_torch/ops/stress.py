"""K1: fused cloth stress (QR + return map + anisotropic stress).

``cloth_stress`` launches the CUDA kernel of ``csrc/stress.cu`` on CUDA
tensors and runs ``cloth_stress_plain`` on CPU tensors.  Both replace
mpmavatar_tpu/ops/pallas_stress.py::cloth_stress_fused (kernel
``_stress_pallas``, math ``_stress_math``) and compute what it computes:
the ``sqrt(x + 1e-24)`` norms, the ``1/max(., 1e-12)`` guards and the
unselected elements that keep their d3 and get zero stress and forces.
"""

from __future__ import annotations

import torch

from . import _build

KERNEL = "cloth_stress"
_EPS = 1e-12


def cloth_stress(d, r_inv, vol, sel, mu, lam, gamma, kappa, friction_coeff):
    """Per element: (new_d (E,3,3) with mapped column 3, stress (E,3,3),
    f1, f2, f3 (E,3)).  ``sel`` is 1.0 where the element is simulated.

    On CUDA tensors this launches the kernel (or raises); it runs the
    plain version only for CPU tensors."""
    if not d.is_cuda:
        return cloth_stress_plain(d, r_inv, vol, sel, mu, lam, gamma, kappa,
                                  friction_coeff)
    n = d.shape[0]
    ins = [_build.check_cuda(name, t) for name, t in (
        ("d", d), ("r_inv", r_inv), ("vol", vol), ("sel", sel), ("mu", mu),
        ("lam", lam), ("gamma", gamma), ("kappa", kappa),
        ("friction_coeff", friction_coeff.reshape(1)))]
    if d.shape != (n, 3, 3) or r_inv.shape != (n, 3) or any(
            t.shape != (n,) for t in ins[2:8]):
        raise ValueError("cloth_stress: inconsistent element shapes")
    new_d = torch.empty_like(ins[0])
    stress = torch.empty_like(ins[0])
    forces = torch.empty_like(ins[0])
    if n:
        _build.launch(KERNEL, "launch_cloth_stress",
                      *[t.data_ptr() for t in ins], new_d.data_ptr(),
                      stress.data_ptr(), forces.data_ptr(), n,
                      _build.stream(d.device))
    return new_d, stress, forces[:, 0], forces[:, 1], forces[:, 2]


def cloth_stress_plain(d, r_inv, vol, sel, mu, lam, gamma, kappa,
                       friction_coeff):
    """Plain PyTorch version of the kernel, line for line with
    ``_stress_math``; runs on any device."""
    col = lambda j: (d[:, 0, j], d[:, 1, j], d[:, 2, j])
    dot = lambda a, b: a[0] * b[0] + a[1] * b[1] + a[2] * b[2]
    norm = lambda a: torch.sqrt(dot(a, a) + 1e-24)
    i11, i12, i22 = r_inv[:, 0], r_inv[:, 1], r_inv[:, 2]
    fric = friction_coeff

    d1, d2, d3c = col(0), col(1), col(2)
    r11 = norm(d1)
    inv_r11 = 1.0 / torch.clamp_min(r11, _EPS)
    q1 = tuple(c * inv_r11 for c in d1)
    r12 = dot(q1, d2)
    u2 = tuple(d2[i] - r12 * q1[i] for i in range(3))
    r22 = norm(u2)
    inv_r22 = 1.0 / torch.clamp_min(r22, _EPS)
    q2 = tuple(c * inv_r22 for c in u2)
    q3 = (q1[1] * q2[2] - q1[2] * q2[1],
          q1[2] * q2[0] - q1[0] * q2[2],
          q1[0] * q2[1] - q1[1] * q2[0])
    r13, r23, r33 = dot(q1, d3c), dot(q2, d3c), dot(q3, d3c)

    # return map on column 3
    separated = r33 > 1.0
    fn = kappa * (1.0 - r33) ** 2
    ff = gamma * torch.sqrt(r13 * r13 + r23 * r23 + 1e-24)
    slipping = ff > fric * fn
    scale = fric * fn / torch.where(slipping, ff, 1.0)
    m13 = torch.where(separated, r13, torch.where(slipping, r13 * scale, r13))
    m23 = torch.where(separated, r23, torch.where(slipping, r23 * scale, r23))
    m33 = torch.where(separated, 1.0, r33)
    use = sel > 0.5
    n13 = torch.where(use, m13, r13)
    n23 = torch.where(use, m23, r23)
    n33 = torch.where(use, m33, r33)
    new_d3 = tuple(torch.where(use, q1[i] * n13 + q2[i] * n23 + q3[i] * n33,
                               d3c[i]) for i in range(3))

    # anisotropic stress on the mapped R
    f11 = r11 * i11
    f12 = r11 * i12 + r12 * i22
    f22 = r22 * i22
    x = f11 + f22
    y = -f12
    psc = torch.rsqrt(torch.clamp_min(x * x + y * y, _EPS))
    c, s = x * psc, y * psc
    j = f11 * f22
    two_mu = 2.0 * mu
    k11 = two_mu * (f11 - c) + lam * (j - 1.0) * f22
    k12 = two_mu * (f12 + s)
    k22 = two_mu * (f22 - c) + lam * (j - 1.0) * f11
    dr13 = gamma * n13
    dr23 = gamma * n23
    dr33 = torch.where(n33 > 1.0, 0.0, -kappa * (1.0 - n33) ** 2)

    k300 = k11 * f11 + k12 * f12 + dr13 * n13
    k301 = k12 * f22 + dr13 * n23
    k302 = dr13 * n33
    k311 = k22 * f22 + dr23 * n23
    k312 = dr23 * n33
    k322 = dr33 * n33
    ks = ((k300, k301, k302), (k301, k311, k312), (k302, k312, k322))

    det = f11 * f22 * n33
    invdet = 1.0 / torch.where(torch.abs(det) > _EPS, det, _EPS)
    l00 = f22 * n33 * invdet
    l10 = -f12 * n33 * invdet
    l11 = f11 * n33 * invdet
    l20 = (f12 * n23 - n13 * f22) * invdet
    l21 = -f11 * n23 * invdet
    l22 = f11 * f22 * invdet

    m = [(ks[i][0] * l00 + ks[i][1] * l10 + ks[i][2] * l20,
          ks[i][1] * l11 + ks[i][2] * l21,
          ks[i][2] * l22) for i in range(3)]
    q = (q1, q2, q3)
    p = [[q[0][i] * m[0][jc] + q[1][i] * m[1][jc] + q[2][i] * m[2][jc]
          for jc in range(3)] for i in range(3)]

    f2 = torch.stack([-vol * (i11 * p[i][0] + i12 * p[i][1])
                      for i in range(3)], -1)
    f3 = torch.stack([-vol * i22 * p[i][1] for i in range(3)], -1)
    f1 = -(f2 + f3)
    nd3 = torch.stack(new_d3, -1)
    p3 = torch.stack([p[i][2] for i in range(3)], -1)
    msk = sel[:, None]
    stress = (vol[:, None, None] * p3[:, :, None] * nd3[:, None, :]) \
        * msk[:, :, None]
    new_d = torch.cat([d[:, :, :2], nd3[:, :, None]], dim=-1)
    return new_d, stress, f1 * msk, f2 * msk, f3 * msk
