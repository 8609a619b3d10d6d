"""K1: fused cloth stress (QR + return map + anisotropic stress) and K8:
fused sand stress (Jacobi SVD + Drucker-Prager return map + spectral
stress).

``cloth_stress`` launches the CUDA kernel of ``csrc/stress.cu`` on CUDA
tensors and runs ``cloth_stress_plain`` on CPU tensors.  Both replace
mpmavatar_tpu/ops/pallas_stress.py::cloth_stress_fused (kernel
``_stress_pallas``, math ``_stress_math``) and compute what it computes:
the ``sqrt(x + 1e-24)`` norms, the ``1/max(., 1e-12)`` guards and the
unselected elements that keep their d3 and get zero stress and forces.

``sand_stress`` launches the CUDA kernel of ``csrc/sand.cu`` on CUDA
tensors and runs ``sand_stress_plain`` on CPU tensors.  Both replace
::sand_stress_fused (kernel ``_sand_pallas``, math ``_sand_math`` and
``_svd3_planes``) on (T, 3, 3) tensors, without the 22-plane packing.

Both differentiate as their JAX entry points do (custom VJPs that
re-trace ``_stress_math`` / ``_sand_math``): on CUDA tensors that need
grad the kernel's backward is autograd over its plain version
(``_autograd.call``).
"""

from __future__ import annotations

import torch

from . import _autograd, _build

KERNEL = "cloth_stress"
SAND_KERNEL = "sand_stress"
_EPS = 1e-12
# sand_stress branch codes (the kernel's optional ``branch`` output)
UNSELECTED, ELASTIC, CONE, TIP = 0, 1, 2, 3


def cloth_stress(d, r_inv, vol, sel, mu, lam, gamma, kappa, friction_coeff):
    """Per element: (new_d (E,3,3) with mapped column 3, stress (E,3,3),
    f1, f2, f3 (E,3)).  ``sel`` is 1.0 where the element is simulated.

    On CUDA tensors this launches the kernel (or raises); it runs the
    plain version only for CPU tensors.  Under grad, d, r_inv, vol, sel,
    mu, lam, gamma, kappa and friction_coeff are differentiable, as every
    row of ``_stress_math``'s input is in JAX; the backward is autograd
    over ``cloth_stress_plain``.  At a branch point of the return map
    (R33 = 1, or the friction cone's surface) it takes the gradient of
    the branch the plain version picks."""
    if not d.is_cuda:
        return cloth_stress_plain(d, r_inv, vol, sel, mu, lam, gamma, kappa,
                                  friction_coeff)
    new_d, stress, forces = _autograd.call(
        "cloth_stress", _launch_cloth_stress, _cloth_stress_twin, d, r_inv,
        vol, sel, mu, lam, gamma, kappa, friction_coeff)
    return new_d, stress, forces[:, 0], forces[:, 1], forces[:, 2]


def _launch_cloth_stress(d, r_inv, vol, sel, mu, lam, gamma, kappa,
                         friction_coeff):
    """K1: (new_d, stress, forces (E, 3, 3) with forces[:, c] the force on
    corner c)."""
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
    return new_d, stress, forces


def kernel_info() -> dict:
    """K1's and K8's registers, spills, shared memory and blocks per SM as
    built (CUDA only)."""
    return {KERNEL: _build.kernel_attributes("cloth_stress_info"),
            SAND_KERNEL: _build.kernel_attributes("sand_stress_info")}


def _cloth_stress_twin(*args):
    """``cloth_stress_plain`` with the kernel's outputs."""
    new_d, stress, f1, f2, f3 = cloth_stress_plain(*args)
    return new_d, stress, torch.stack([f1, f2, f3], 1)


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


def sand_stress(f_trial, f_prev, sel, mu, lam, alpha,
                return_branch: bool = False):
    """Drucker-Prager return map + spectral Kirchhoff stress of the
    traditional block: (f_new (T,3,3), stress (T,3,3)), plus the branch
    code of each particle (int32, ``UNSELECTED``/``ELASTIC``/``CONE``/
    ``TIP``) when ``return_branch``.  ``sel`` is 1.0 where the particle is
    simulated; an unselected particle keeps ``f_prev`` and gets zero
    stress.

    On CUDA tensors this launches the kernel (or raises); it runs the
    plain version only for CPU tensors.  Under grad, f_trial, f_prev, sel,
    mu, lam and alpha are differentiable, as every row of ``_sand_math``'s
    input is in JAX; the backward is autograd over ``sand_stress_plain``.
    At a branch point of the return map (delta_gamma = 0, tr = 0) it
    takes the gradient of the branch the plain version picks."""
    n = f_trial.shape[0]
    if f_trial.shape != (n, 3, 3) or f_prev.shape != (n, 3, 3) or any(
            t.shape != (n,) for t in (sel, mu, lam)):
        raise ValueError("sand_stress: inconsistent particle shapes")
    if not f_trial.is_cuda:
        return sand_stress_plain(f_trial, f_prev, sel, mu, lam, alpha,
                                 return_branch)
    return _autograd.call("sand_stress", _launch_sand, sand_stress_plain,
                          f_trial, f_prev, sel, mu, lam, alpha, return_branch)


def _launch_sand(f_trial, f_prev, sel, mu, lam, alpha, return_branch):
    """K8 on CUDA tensors: (f_new, stress[, branch])."""
    n = f_trial.shape[0]
    ins = [_build.check_cuda(name, t) for name, t in (
        ("f_trial", f_trial), ("f_prev", f_prev), ("sel", sel), ("mu", mu),
        ("lam", lam), ("alpha", alpha.reshape(1)))]
    f_new = torch.empty_like(ins[0])
    stress = torch.empty_like(ins[0])
    branch = (torch.empty((n,), dtype=torch.int32, device=f_trial.device)
              if return_branch else None)
    if n:
        _build.launch(SAND_KERNEL, "launch_sand",
                      *[t.data_ptr() for t in ins], n, f_new.data_ptr(),
                      stress.data_ptr(), _build.ptr(branch),
                      _build.stream(f_trial.device))
    return (f_new, stress, branch) if return_branch else (f_new, stress)


def _svd3_planes(f):
    """Line for line ``pallas_stress._svd3_planes`` on a 3x3 of (T,)
    tensors: (u, sigma, v), u and v 3x3 lists, sigma a 3-list sorted
    descending with sigma[2] < 0 iff det f < 0.  8 cyclic Jacobi sweeps
    on the full f^T f, so it squares f's condition number."""
    a = [[f[0][i] * f[0][j] + f[1][i] * f[1][j] + f[2][i] * f[2][j]
          for j in range(3)] for i in range(3)]
    one, zero = torch.ones_like(f[0][0]), torch.zeros_like(f[0][0])
    v = [[one if i == j else zero for j in range(3)] for i in range(3)]
    for _ in range(8):
        for (p, q) in ((0, 1), (0, 2), (1, 2)):
            app, aqq, apq = a[p][p], a[q][q], a[p][q]
            small = torch.abs(apq) < _EPS
            tau = (aqq - app) / (2.0 * torch.where(small, 1.0, apq))
            sgn = torch.where(tau >= 0.0, 1.0, -1.0)
            t = sgn / (torch.abs(tau) + torch.sqrt(1.0 + tau * tau))
            t = torch.where(small, 0.0, t)
            c = 1.0 / torch.sqrt(1.0 + t * t)
            s = t * c
            bp = [c * a[i][p] - s * a[i][q] for i in range(3)]
            bq = [s * a[i][p] + c * a[i][q] for i in range(3)]
            b = [[bp[i] if j == p else (bq[i] if j == q else a[i][j])
                  for j in range(3)] for i in range(3)]
            rp = [c * b[p][j] - s * b[q][j] for j in range(3)]
            rq = [s * b[p][j] + c * b[q][j] for j in range(3)]
            a = [[rp[j] if i == p else (rq[j] if i == q else b[i][j])
                  for j in range(3)] for i in range(3)]
            vp = [c * v[i][p] - s * v[i][q] for i in range(3)]
            vq = [s * v[i][p] + c * v[i][q] for i in range(3)]
            v = [[vp[i] if j == p else (vq[i] if j == q else v[i][j])
                  for j in range(3)] for i in range(3)]

    ev = [a[0][0], a[1][1], a[2][2]]
    for (i, j) in ((0, 1), (1, 2), (0, 1)):      # stable descending sort
        sw = ev[i] < ev[j]
        ev[i], ev[j] = (torch.where(sw, ev[j], ev[i]),
                        torch.where(sw, ev[i], ev[j]))
        for r in range(3):
            v[r][i], v[r][j] = (torch.where(sw, v[r][j], v[r][i]),
                                torch.where(sw, v[r][i], v[r][j]))

    detv = (v[0][0] * (v[1][1] * v[2][2] - v[1][2] * v[2][1])
            - v[0][1] * (v[1][0] * v[2][2] - v[1][2] * v[2][0])
            + v[0][2] * (v[1][0] * v[2][1] - v[1][1] * v[2][0]))
    sv = torch.sign(detv)
    for i in range(3):
        v[i][2] = v[i][2] * sv
    sigma = [torch.sqrt(torch.clamp_min(e, 0.0)) for e in ev]

    fv = [[f[i][0] * v[0][j] + f[i][1] * v[1][j] + f[i][2] * v[2][j]
           for j in range(2)] for i in range(3)]
    inv_s0 = 1.0 / torch.clamp_min(sigma[0], _EPS)
    u0 = [fv[i][0] * inv_s0 for i in range(3)]
    n0 = torch.sqrt(u0[0] * u0[0] + u0[1] * u0[1] + u0[2] * u0[2] + 1e-24)
    u0 = [c / torch.clamp_min(n0, _EPS) for c in u0]
    d1 = fv[0][1] * u0[0] + fv[1][1] * u0[1] + fv[2][1] * u0[2]
    u1r = [fv[i][1] - d1 * u0[i] for i in range(3)]
    n1 = torch.sqrt(u1r[0] * u1r[0] + u1r[1] * u1r[1] + u1r[2] * u1r[2]
                    + 1e-24)
    # degenerate fallback: cross(u0, e_x or e_y)
    use_x = torch.abs(u0[0]) < 0.9
    ax = [torch.where(use_x, 1.0, 0.0), torch.where(use_x, 0.0, 1.0), zero]
    alt = [u0[1] * ax[2] - u0[2] * ax[1],
           u0[2] * ax[0] - u0[0] * ax[2],
           u0[0] * ax[1] - u0[1] * ax[0]]
    na = torch.sqrt(alt[0] * alt[0] + alt[1] * alt[1] + alt[2] * alt[2]
                    + 1e-24)
    alt = [c / torch.clamp_min(na, _EPS) for c in alt]
    ok1 = n1 > 1e-6
    inv_n1 = 1.0 / torch.clamp_min(n1, _EPS)
    u1 = [torch.where(ok1, u1r[i] * inv_n1, alt[i]) for i in range(3)]
    u2 = [u0[1] * u1[2] - u0[2] * u1[1],
          u0[2] * u1[0] - u0[0] * u1[2],
          u0[0] * u1[1] - u0[1] * u1[0]]
    u = [[u0[i], u1[i], u2[i]] for i in range(3)]

    detf = (f[0][0] * (f[1][1] * f[2][2] - f[1][2] * f[2][1])
            - f[0][1] * (f[1][0] * f[2][2] - f[1][2] * f[2][0])
            + f[0][2] * (f[1][0] * f[2][1] - f[1][1] * f[2][0]))
    sigma[2] = sigma[2] * torch.where(detf < 0.0, -1.0, 1.0)
    return u, sigma, v


def sand_stress_plain(f_trial, f_prev, sel, mu, lam, alpha,
                      return_branch: bool = False):
    """Plain PyTorch version of the kernel, line for line with
    ``_sand_math`` on (T,) tensors; runs on any device."""
    ft = [[f_trial[:, i, j] for j in range(3)] for i in range(3)]
    fp = [[f_prev[:, i, j] for j in range(3)] for i in range(3)]
    u, sig, v = _svd3_planes(ft)

    eps = [torch.log(torch.clamp_min(torch.abs(s), 1e-14)) for s in sig]
    tr = eps[0] + eps[1] + eps[2]
    eh = [e - tr / 3.0 for e in eps]
    ehn = torch.sqrt(eh[0] * eh[0] + eh[1] * eh[1] + eh[2] * eh[2] + 1e-24)
    delta_gamma = ehn + (3.0 * lam + 2.0 * mu) / (2.0 * mu) * tr * alpha
    scale = delta_gamma / torch.clamp_min(ehn, _EPS)
    h = [eps[k] - eh[k] * scale for k in range(3)]
    exph = [torch.exp(hk) for hk in h]

    def recompose(diag, w):
        return [[u[i][0] * diag[0] * w[j][0] + u[i][1] * diag[1] * w[j][1]
                 + u[i][2] * diag[2] * w[j][2] for j in range(3)]
                for i in range(3)]

    one = torch.ones_like(sig[0])
    f_proj = recompose(exph, v)
    f_tip = recompose([one, one, one], v)
    yielding = delta_gamma > 0
    expand = tr > 0
    use = sel > 0.5
    f_new = [[torch.where(use, torch.where(
        yielding, torch.where(expand, f_tip[i][j], f_proj[i][j]), ft[i][j]),
        fp[i][j]) for j in range(3)] for i in range(3)]

    # spectral Drucker-Prager stress from the return map's log s (the
    # elastic branch: log of the trial singular values unclamped, NaN for
    # det < 0, as the (T,3,3) path)
    zero = torch.zeros_like(sig[0])
    logs = [torch.where(yielding, torch.where(expand, zero, h[k]),
                        torch.log(sig[k])) for k in range(3)]
    log_sum = logs[0] + logs[1] + logs[2]
    diag = [2.0 * mu * logs[k] + lam * log_sum for k in range(3)]
    st = recompose(diag, u)
    stress = [[torch.where(use, st[i][j], 0.0) for j in range(3)]
              for i in range(3)]
    f_new = torch.stack([torch.stack(row, -1) for row in f_new], -2)
    stress = torch.stack([torch.stack(row, -1) for row in stress], -2)
    if not return_branch:
        return f_new, stress
    branch = torch.where(use, torch.where(
        yielding, torch.where(expand, TIP, CONE), ELASTIC), UNSELECTED)
    return f_new, stress, branch.to(torch.int32)
