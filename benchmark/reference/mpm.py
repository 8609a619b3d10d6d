"""Plain MPM substep: anisotropic cloth (elements + vertices) and
Drucker-Prager sand on a dense grid, with a body-mesh collider, the
particle mover, a sticky floor and the sand's release windows
(MPMAvatar's ``warp_mpm`` substep, as its JAX and PyTorch ports order
it).

Written from the physics, in batched tensor form, for the benchmark's
check of what the program produced: no kernel, no program code.  The
sand's SVD is ``torch.linalg.svd`` (in float64) brought to the rotation
convention; every sum of products goes through :class:`Arith`.  What the
program does at the grid's edges is part of its semantics and is kept:
a stencil node outside the grid scatters at its flat index wrapped once
(and is dropped past that), G2P reads the nearest flat index, and the
splats drop a point whose stencil base leaves [0, G - 3).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .arith import Arith

EPS = 1e-12
OFFSETS = [(i, j, k) for i in range(3) for j in range(3) for k in range(3)]


@dataclasses.dataclass
class Scene:
    """What does not change in a rollout, worked out from the raw
    inputs.  Particles: [0, E) elements, [E, E + T) sand, then V
    vertices."""
    E: int
    T: int
    V: int
    G: int
    lim: float
    faces: torch.Tensor          # (E, 3) vertex-local, int64
    r_inv: torch.Tensor          # (E, 3)
    vol: torch.Tensor            # (P,)
    mass: torch.Tensor           # (P,)
    mu: torch.Tensor             # (P,)
    lam: torch.Tensor            # (P,)
    gamma: float
    kappa: float
    friction: float              # tan(friction angle): the cloth's cone
    alpha: float                 # Drucker-Prager
    gravity: torch.Tensor        # (3,)
    collider_faces: torch.Tensor  # (Fb, 3) int64
    collider_friction: float
    floor: torch.Tensor | None = None  # (G^3,) cells under the sticky floor
    joint_v: int = 0
    joint_f: int = 0
    # release windows: each particle pinned at zero velocity while
    # pin_start <= t < pin_until (pin_until -inf: never)
    pin_until: torch.Tensor | None = None
    pin_start: float = 0.0
    offsets: torch.Tensor | None = None  # (27, 3) stencil node offsets

    def __post_init__(self):
        if self.offsets is None:
            self.offsets = torch.tensor(OFFSETS, device=self.vol.device)

    @property
    def dx(self):
        return self.lim / self.G

    @property
    def inv_dx(self):
        return self.G / self.lim


def cloth_geometry(verts, faces, thickness=1e-5):
    """(d (E, 3, 3), packed inverse rest metric (E, 3), element volume
    (E,), vertex volume (V,))."""
    faces = faces.long()
    d1 = verts[faces[:, 1]] - verts[faces[:, 0]]
    d2 = verts[faces[:, 2]] - verts[faces[:, 0]]
    n = torch.linalg.cross(d1, d2, dim=-1)
    area = 0.5 * n.norm(dim=1)
    d = torch.stack([d1, d2, n / n.norm(dim=1, keepdim=True)], -1)
    evol = 0.25 * thickness * area
    vvol = torch.zeros(verts.shape[0], device=verts.device).index_add_(
        0, faces.reshape(-1), evol.repeat_interleave(3))
    return d, rest_metric(verts, faces), evol, vvol


def rest_metric(verts, faces):
    """Inverse of the rest triangle's 2 x 2 R factor, packed (i11, i12,
    i22)."""
    faces = faces.long()
    d1 = verts[faces[:, 1]] - verts[faces[:, 0]]
    d2 = verts[faces[:, 2]] - verts[faces[:, 0]]
    r11 = d1.norm(dim=1)
    r12 = (d1 * d2).sum(1) / r11
    r22 = (d2 - (r12 / r11)[:, None] * d1).norm(dim=1)
    return torch.stack([1.0 / r11, -r12 / (r11 * r22), 1.0 / r22], -1)


def lame(E, nu):
    return E / (2.0 * (1.0 + nu)), E * nu / ((1.0 + nu) * (1.0 - 2.0 * nu))


def drucker_prager_alpha(angle_deg):
    s = np.sin(angle_deg / 180.0 * 3.14159265)
    return float(np.sqrt(2.0 / 3.0) * 2.0 * s / (3.0 - s))


# ----------------------------------------------------------------------
# stress
# ----------------------------------------------------------------------
def cloth_stress(sc: Scene, d, mu, lam, ar: Arith):
    """QR of d, the return map of its third column (contact: separated,
    sticking or slipping on the friction cone), the anisotropic stress.
    (new d, stress (E, 3, 3), corner forces (E, 3, 3) [:, corner])."""
    nrm = lambda a: torch.sqrt((a * a).sum(-1) + 1e-24)
    d1, d2, d3 = d[..., 0], d[..., 1], d[..., 2]
    r11 = nrm(d1)
    q1 = d1 / torch.clamp_min(r11, EPS)[:, None]
    r12 = (q1 * d2).sum(-1)
    u2 = d2 - r12[:, None] * q1
    r22 = nrm(u2)
    q2 = u2 / torch.clamp_min(r22, EPS)[:, None]
    q3 = torch.linalg.cross(q1, q2, dim=-1)
    q = torch.stack([q1, q2, q3], -1)
    r13, r23, r33 = [(qc * d3).sum(-1) for qc in (q1, q2, q3)]

    fn = sc.kappa * (1.0 - r33) ** 2
    ff = sc.gamma * torch.sqrt(r13 * r13 + r23 * r23 + 1e-24)
    slip = ff > sc.friction * fn
    shrink = torch.where(slip, sc.friction * fn / torch.where(slip, ff, 1.0),
                         1.0)
    separated = r33 > 1.0
    n13 = torch.where(separated, r13, r13 * shrink)
    n23 = torch.where(separated, r23, r23 * shrink)
    n33 = torch.where(separated, 1.0, r33)
    r = ar.r
    new_d3 = (r(q) * r(torch.stack([n13, n23, n33], -1))[:, None, :]).sum(-1)

    i11, i12, i22 = sc.r_inv.unbind(-1)
    f11, f12, f22 = r11 * i11, r11 * i12 + r12 * i22, r22 * i22
    x, y = f11 + f22, -f12
    inv = torch.rsqrt(torch.clamp_min(x * x + y * y, EPS))
    c, s = x * inv, y * inv
    j = f11 * f22
    k11 = 2.0 * mu * (f11 - c) + lam * (j - 1.0) * f22
    k12 = 2.0 * mu * (f12 + s)
    k22 = 2.0 * mu * (f22 - c) + lam * (j - 1.0) * f11
    dr13, dr23 = sc.gamma * n13, sc.gamma * n23
    dr33 = torch.where(n33 > 1.0, 0.0, -sc.kappa * (1.0 - n33) ** 2)
    # K = P_hat F_hat^T on the tangent block, plus the contact terms;
    # symmetric
    z = torch.zeros_like(f11)
    kp = torch.stack([torch.stack([k11, k12], -1),
                      torch.stack([z, k22], -1)], -2)
    fh = torch.stack([torch.stack([f11, f12], -1),
                      torch.stack([z, f22], -1)], -2)
    blk = (r(kp)[:, :, None, :] * r(fh)[:, None, :, :]).sum(-1)
    s00 = blk[:, 0, 0] + dr13 * n13
    s01 = blk[:, 0, 1] + dr13 * n23
    s11 = blk[:, 1, 1] + dr23 * n23
    s02, s12, s22 = dr13 * n33, dr23 * n33, dr33 * n33
    kk = torch.stack([torch.stack([s00, s01, s02], -1),
                      torch.stack([s01, s11, s12], -1),
                      torch.stack([s02, s12, s22], -1)], -2)
    # times the inverse transpose of the mapped R, guarded as a
    # determinant under 1e-12 is
    det = f11 * f22 * n33
    invdet = 1.0 / torch.where(det.abs() > EPS, det, EPS)
    lt = torch.stack([
        torch.stack([f22 * n33, z, z], -1),
        torch.stack([-f12 * n33, f11 * n33, z], -1),
        torch.stack([f12 * n23 - n13 * f22, -f11 * n23, f11 * f22], -1),
    ], -2) * invdet[:, None, None]
    mm = lambda a, b: (r(a)[:, :, :, None] * r(b)[:, None, :, :]).sum(2)
    p = mm(q, mm(kk, lt))
    vol = sc.vol[:sc.E]
    f2 = -vol[:, None] * (i11[:, None] * p[..., 0] + i12[:, None] * p[..., 1])
    f3 = -vol[:, None] * i22[:, None] * p[..., 1]
    forces = torch.stack([-(f2 + f3), f2, f3], 1)
    stress = vol[:, None, None] * p[..., 2][:, :, None] * new_d3[:, None, :]
    return torch.cat([d[..., :2], new_d3[..., None]], -1), stress, forces


def _rotate(m, p: int, q: int, c, s, cols: bool):
    """m J (``cols``) or J^T m, J the Jacobi rotation of (p, q)."""
    c, s = c[:, None], s[:, None]
    take = (lambda i: m[:, :, i]) if cols else (lambda i: m[:, i, :])
    mp, mq = take(p), take(q)
    new = {p: c * mp - s * mq, q: s * mp + c * mq}
    parts = [new.get(i, take(i)) for i in range(3)]
    return torch.stack(parts, 2 if cols else 1)


def rotation_svd(f, sweeps: int = 4):
    """(U, sigma, V) of (T, 3, 3) float32 ``f`` with U, V proper
    rotations, sigma descending and its last entry negative iff det f <
    0: cyclic Jacobi on f^T f, in float64."""
    f64 = f.double()
    a = f64.transpose(-1, -2) @ f64
    n = f.shape[0]
    v = torch.eye(3, dtype=torch.float64, device=f.device).expand(
        n, 3, 3).contiguous()
    for _ in range(sweeps):
        for p, q in ((0, 1), (0, 2), (1, 2)):
            app, aqq, apq = a[:, p, p], a[:, q, q], a[:, p, q]
            small = apq.abs() < 1e-30
            tau = (aqq - app) / (2.0 * torch.where(small, 1.0, apq))
            t = torch.where(tau >= 0, 1.0, -1.0) / (
                tau.abs() + torch.sqrt(1 + tau * tau))
            t = torch.where(small, 0.0, t)
            c = 1.0 / torch.sqrt(1.0 + t * t)
            s = t * c
            a = _rotate(_rotate(a, p, q, c, s, True), p, q, c, s, False)
            v = _rotate(v, p, q, c, s, True)
    ev = [a[:, 0, 0], a[:, 1, 1], a[:, 2, 2]]
    vc = [v[:, :, 0], v[:, :, 1], v[:, :, 2]]
    for i, j in ((0, 1), (1, 2), (0, 1)):          # descending, stable
        sw = ev[i] < ev[j]
        ev[i], ev[j] = torch.where(sw, ev[j], ev[i]), torch.where(sw, ev[i],
                                                                  ev[j])
        vc[i], vc[j] = (torch.where(sw[:, None], vc[j], vc[i]),
                        torch.where(sw[:, None], vc[i], vc[j]))
    ev, v = torch.stack(ev, 1), torch.stack(vc, 2)
    v[:, :, 2] *= torch.sign(torch.linalg.det(v))[:, None]
    sig = torch.sqrt(torch.clamp_min(ev, 0.0))
    fv = f64 @ v
    u0 = fv[:, :, 0] / torch.clamp_min(sig[:, :1], 1e-30)
    u0 = u0 / u0.norm(dim=1, keepdim=True)
    u1 = fv[:, :, 1] - (fv[:, :, 1] * u0).sum(1, keepdim=True) * u0
    u1 = u1 / torch.clamp_min(u1.norm(dim=1, keepdim=True), 1e-30)
    u = torch.stack([u0, u1, torch.linalg.cross(u0, u1, dim=-1)], -1)
    sig = torch.cat([sig[:, :2], sig[:, 2:] * torch.where(
        torch.linalg.det(f64) < 0, -1.0, 1.0)[:, None]], 1)
    return u.float(), sig.float(), v.float()


def sand_stress(sc: Scene, f_trial, mu, lam, ar: Arith):
    """Drucker-Prager return map in log strain, and the Kirchhoff stress
    from the mapped log singular values: (F (T, 3, 3), stress)."""
    u, sig, v = rotation_svd(f_trial)
    eps = torch.log(torch.clamp_min(sig.abs(), 1e-14))
    tr = eps.sum(-1, keepdim=True)
    dev = eps - tr / 3.0
    dev_n = torch.sqrt((dev * dev).sum(-1, keepdim=True) + 1e-24)
    dgamma = dev_n + ((3.0 * lam + 2.0 * mu) / (2.0 * mu))[:, None] * tr \
        * sc.alpha
    h = eps - dev * (dgamma / torch.clamp_min(dev_n, EPS))
    yielding, expand = dgamma > 0, tr > 0
    r = ar.r
    rec = lambda diag, w: (r(u)[:, :, None, :] * r(diag)[:, None, None, :]
                           * r(w)[:, None, :, :]).sum(-1)
    f_new = torch.where(yielding[..., None], torch.where(
        expand[..., None], rec(torch.ones_like(h), v), rec(torch.exp(h), v)),
        f_trial)
    logs = torch.where(yielding, torch.where(expand, 0.0, h), torch.log(sig))
    diag = 2.0 * mu[:, None] * logs + lam[:, None] * logs.sum(-1,
                                                              keepdim=True)
    return f_new, rec(diag, u)


# ----------------------------------------------------------------------
# grid transfers
# ----------------------------------------------------------------------
def stencil(x, inv_dx: float, G: int, off):
    """Quadratic B-spline stencils of positions (N, 3): (flat node index
    (N, 27) unwrapped, weight (N, 27), weight gradient (N, 27, 3),
    node offset from the particle in cells (N, 27, 3))."""
    gp = x * inv_dx
    base = torch.floor(gp - 0.5)
    fx = gp - base
    w = torch.stack([0.5 * (1.5 - fx) ** 2, 0.75 - (fx - 1.0) ** 2,
                     0.5 * (fx - 0.5) ** 2], 1)            # (N, 3, 3)
    dw = torch.stack([fx - 1.5, -2.0 * (fx - 1.0), fx - 0.5], 1)
    ox, oy, oz = off[:, 0], off[:, 1], off[:, 2]
    wx, wy, wz = w[:, ox, 0], w[:, oy, 1], w[:, oz, 2]
    weight = wx * wy * wz
    grad = torch.stack([dw[:, ox, 0] * wy * wz, wx * dw[:, oy, 1] * wz,
                        wx * wy * dw[:, oz, 2]], -1) * inv_dx
    node = base.long()[:, None, :] + off[None]
    flat = (node[..., 0] * G + node[..., 1]) * G + node[..., 2]
    rel = off[None].to(x.dtype) - fx[:, None, :]
    return flat, weight, grad, rel, base


def scatter(flat, rows, n: int):
    """Sum rows (M, C) at flat indices (M,) into (n, C): an index in
    [-n, 0) wraps to index + n, one outside [-n, n) is dropped (summed
    into a row past the end)."""
    flat = torch.where(flat < 0, flat + n, flat)
    flat = torch.where((flat >= 0) & (flat < n), flat, n)
    out = torch.zeros((n + 1, rows.shape[1]), dtype=rows.dtype,
                      device=rows.device)
    return out.index_add(0, flat, rows)[:n]


def splat(points, values, G: int, inv_dx: float, off):
    """The weight-averaging splat of point values: (sum w values (G^3, C),
    sum w (G^3,)); a point whose stencil base leaves [0, G - 3) on an
    axis is left out."""
    flat, w, _, _, base = stencil(points, inv_dx, G, off)
    inside = ((base >= 0) & (base < G - 3)).all(-1)
    w = w * inside[:, None].to(w.dtype)
    rows = torch.cat([w[..., None] * values[:, None, :], w[..., None]], -1)
    out = scatter(flat.reshape(-1), rows.reshape(-1, values.shape[1] + 1),
                  G ** 3)
    return out[:, :-1], out[:, -1]


def below_plane(G: int, dx: float, point, normal, device):
    """(G^3,) the cells (flat x-major) strictly behind a plane."""
    i = torch.arange(G, device=device, dtype=torch.float32) * dx
    p = torch.tensor(point, device=device)
    nrm = torch.tensor(normal, device=device)
    gx, gy, gz = torch.meshgrid(i - p[0], i - p[1], i - p[2], indexing="ij")
    return (gx * nrm[0] + gy * nrm[1] + gz * nrm[2]).reshape(-1) < 0.0


# ----------------------------------------------------------------------
# the substep and the frame
# ----------------------------------------------------------------------
def substep(sc: Scene, st: dict, t, dt: float, mesh_x, mesh_v, joint_v,
            joint_f, ar: Arith) -> dict:
    """One substep from state ``st`` (x, v, C, F, F_trial, d) at time
    ``t`` (a float32 number or 0-d tensor); ``mesh_x``/``mesh_v`` the
    collider's vertices this substep, ``joint_v``/``joint_f`` the
    mover's velocities (or None)."""
    E, T, G = sc.E, sc.T, sc.G
    nnv, n, r = E + T, G ** 3, ar.r
    x, v, c = st["x"], st["v"], st["C"]
    if sc.pin_until is not None:
        pinned = (t >= sc.pin_start) & (t < sc.pin_until)
        v = torch.where(pinned[:, None], 0.0, v)

    new_d, stress_e, forces = cloth_stress(sc, st["d"], sc.mu[:E],
                                           sc.lam[:E], ar)
    vforce = torch.zeros((sc.V, 3), device=x.device)
    for corner in range(3):
        vforce = vforce.index_add(0, sc.faces[:, corner], forces[:, corner])
    f_ret = st["F"]
    stress = stress_e
    if T:
        f_ret, stress_t = sand_stress(sc, st["F_trial"], sc.mu[E:nnv],
                                      sc.lam[E:nnv], ar)
        stress = torch.cat([stress_e, sc.vol[E:nnv, None, None] * stress_t])

    # P2G (APIC); stress and vertex forces are impulses over dt
    flat, w, dw, rel, _ = stencil(x, sc.inv_dx, G, sc.offsets)
    force_s = -(r(dt * stress)[:, None, :, :] * r(dw[:nnv])[:, :, None, :]
                ).sum(-1)
    force = torch.cat([force_s, w[nnv:, :, None] * (dt * vforce)[:, None, :]])
    mom = v[:, None, :] + (r(c)[:, None, :, :]
                           * r(rel * sc.dx)[:, :, None, :]).sum(-1)
    mw = w * sc.mass[:, None]
    rows = torch.cat([mw[..., None] * mom + force, mw[..., None]], -1)
    grid = scatter(flat.reshape(-1), rows.reshape(-1, 4), n)
    gm = grid[:, 3]
    active = gm > 1e-15
    gv = torch.where(active[:, None], grid[:, :3]
                     / torch.where(active, gm, 1.0)[:, None]
                     + dt * sc.gravity, 0.0)

    # the body collider: face centroids splat their mean velocity and
    # unit normal; the grid keeps what does not move into the body
    tri_x, tri_v = mesh_x[sc.collider_faces], mesh_v[sc.collider_faces]
    nrm = torch.linalg.cross(tri_x[:, 1] - tri_x[:, 0],
                             tri_x[:, 2] - tri_x[:, 0], dim=-1)
    nl = torch.sqrt((nrm * nrm).sum(-1, keepdim=True))
    nrm = nrm / torch.clamp_min(nl, EPS)
    acc, cw = splat(tri_x.mean(1), torch.cat([tri_v.mean(1), nrm], -1), G,
                    sc.inv_dx, sc.offsets)
    covered = cw > 1e-15
    mvel = acc[:, :3] / torch.where(covered, cw, 1.0)[:, None]
    mn = acc[:, 3:]
    mn = mn / torch.clamp_min(torch.sqrt((mn * mn).sum(-1, keepdim=True)),
                              EPS)
    relv = gv - mvel
    nc = (relv * mn).sum(-1)
    proj = relv - torch.clamp_max(nc, 0.0)[:, None] * mn
    plen = torch.sqrt((proj * proj).sum(-1) + 1e-40)
    fric = torch.clamp_min(plen + nc * sc.collider_friction, 0.0)
    sliding = (nc < 0.0) & (plen > 1e-20)
    ratio = torch.where(sliding, fric / torch.where(sliding, plen, 1.0), 1.0)
    gv = torch.where(covered[:, None], ratio[:, None] * proj + mvel, gv)

    # the mover: pinned vertices, then pinned faces, at given velocities
    pts, vel = [], []
    if joint_v is not None and sc.joint_v:
        pts.append(x[nnv:nnv + sc.joint_v])
        vel.append(joint_v)
    if joint_f is not None and sc.joint_f:
        pts.append(x[:sc.joint_f])
        vel.append(joint_f)
    if pts:
        jv, jw = splat(torch.cat(pts), torch.cat(vel), G, sc.inv_dx,
                       sc.offsets)
        moved = jw > 1e-15
        gv = torch.where(moved[:, None],
                         jv / torch.where(moved, jw, 1.0)[:, None], gv)

    if sc.floor is not None:
        gv = torch.where(sc.floor[:, None], 0.0, gv)

    # G2P from the nearest flat index
    g = r(gv[flat.clamp(0, n - 1)])                          # (P, 27, 3)
    wr = r(w)
    v_new = (wr[..., None] * g).sum(1)
    c_new = (r(w * (4.0 * sc.inv_dx))[..., None, None] * g[..., :, None]
             * r(rel)[..., None, :]).sum(1)
    grad_v = (g[..., :, None] * r(dw)[..., None, :]).sum(1)
    x_new = torch.clamp(x + dt * v_new, 2.0 * sc.dx, sc.lim - 2.0 * sc.dx)
    x1 = torch.cat([x[:E], x_new[E:]])
    v1 = torch.cat([v[:E], v_new[E:]])
    f_trial = st["F_trial"]
    if T:
        f_trial = f_ret + dt * (r(grad_v[E:nnv])[:, :, :, None]
                                * r(f_ret)[:, None, :, :]).sum(2)
    fi = sc.faces + nnv
    pa, pb, pc = x1[fi[:, 0]], x1[fi[:, 1]], x1[fi[:, 2]]
    d3 = new_d[..., 2]
    d3 = d3 + dt * (r(grad_v[:E]) * r(d3)[:, None, :]).sum(-1)
    d_out = torch.stack([pb - pa, pc - pa, d3], -1)
    x1 = torch.cat([(pa + pb + pc) / 3.0, x1[E:]])
    v1 = torch.cat([v1[fi].mean(1), v1[E:]])
    return {"x": x1, "v": v1, "C": c_new, "F": f_ret, "F_trial": f_trial,
            "d": d_out}


FIELDS = ("x", "v", "C", "F", "F_trial", "d")


def frame(sc: Scene, st: dict, t0: float, dt: float, n_sub: int, mesh_x,
          mesh_v, joint_v, joint_f, ar: Arith, checkpoint: bool = False):
    """``n_sub`` substeps from time t0 (float32 steps of dt); the
    collider moves with its frame velocity.  Returns (state, time).
    ``checkpoint`` keeps each substep's graph for a backward only while
    it recomputes it; on a CUDA device with grad off the substep is
    captured once as a CUDA graph and replayed."""
    dt32 = np.float32(dt)
    times = [np.float32(t0)]
    for _ in range(n_sub):
        times.append(np.float32(times[-1] + dt32))
    offsets = [float(np.float32(s) * dt32) for s in range(n_sub)]
    if mesh_x.is_cuda and not torch.is_grad_enabled():
        return _replayed(sc, st, times, offsets, float(dt32), mesh_x,
                         mesh_v, joint_v, joint_f, ar), float(times[-1])
    for s in range(n_sub):
        args = (sc, st, float(times[s]), float(dt32),
                mesh_x + offsets[s] * mesh_v, mesh_v, joint_v, joint_f, ar)
        if checkpoint:
            st = dict(zip(FIELDS, torch.utils.checkpoint.checkpoint(
                _substep_tuple, *args, use_reentrant=False)))
        else:
            st = substep(*args)
    return st, float(times[-1])


def _substep_tuple(*args):
    out = substep(*args)
    return tuple(out[k] for k in FIELDS)


def _replayed(sc, st, times, offsets, dt, mesh_x, mesh_v, joint_v, joint_f,
              ar):
    """The substeps as replays of one captured substep; the time and the
    collider's offset are device numbers set before each replay."""
    dev = mesh_x.device
    state = {k: st[k].clone() for k in FIELDS}
    t = torch.zeros((), device=dev)
    off = torch.zeros((), device=dev)

    def step():
        return substep(sc, state, t, dt, mesh_x + off * mesh_v, mesh_v,
                       joint_v, joint_f, ar)

    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        step()                      # warm up outside the capture
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = step()
    for s in range(len(offsets)):
        t.fill_(float(times[s]))
        off.fill_(offsets[s])
        graph.replay()
        for k in FIELDS:
            state[k].copy_(out[k])
    del graph
    return state
