"""Plain stage-2 appearance steps in float32 (TF32 off): MPMAvatar's
``train_appearance.py`` loss and Adam over its mesh-bound 3D Gaussians,
written from the published description and independent of the program.

One step, for one (camera, frame):

- the face frames of the frame's vertices plus ``verts_offset``: the
  first edge, the normal and their cross product as the axes, the face's
  scale (|edge| + the height on it) / 2 (GaussianAvatars' binding);
- the binding: each alive splat's position R (x s) + centre, scale
  exp(s) times the face's scale, rotation q_face (x) q, from its face;
- SH degree 3 towards the camera, + 0.5, clamped at 0; times the
  quasi-shadow: the UNet of weight-normalised 3x3 convolutions with
  untied biases on (AO - mean AO), sampled bilinearly at the face UVs;
- splatting (``splatting.py``), opacity sigmoid(o);
- colour calibration (C exp(cam_m) + cam_c) times the alpha map, clamped
  to [0, 1];
- (1 - 0.2) L1 + 0.2 (1 - SSIM) + 0.2 LPIPS-VGG16 + the regularisers:
  0.1 normal, 0.05 opacity, 20 iso, 1000 area, 1 xyz over 1, 1 scale over
  0.6 (the last two over the visible splats);
- Adam per group (eps 1e-15, the configuration's learning rates).

Departures from the published code, each the program's too:

- only the alive splats are rendered (the program holds a capacity of
  slots, the dead ones at opacity 0, which add nothing);
- the UNet's resizes are antialiased bilinear (half-pixel centres), as
  ``jax.image.resize`` computes them, as matrices along each axis;
- SSIM's window is the 11 x 11 gaussian of sigma 1.5 with zero padding.

Every sum of products (the projections, the covariances, SH, the
compositing's colour sum, the UNet's and LPIPS's convolutions, the
resizes, the bilinear taps, SSIM's filter) takes its operands through
``Arith.r``, so the control rounds them to TF32.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import splatting
from .arith import Arith

FROZEN = ("shadow.ao_mean", "shadow.beta")
SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
         0.3731763325901154, -0.4570457994644658, 1.445305721320277,
         -0.5900435899266435)
VGG = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M",
       512, 512, 512)
TAPS = (1, 3, 6, 9, 12)
SHIFT = (-0.030, -0.088, -0.188)
SCALE = (0.458, 0.448, 0.450)
BETA1, BETA2 = 0.9, 0.999


def _normalize(x):
    return x / torch.clamp_min(torch.linalg.vector_norm(
        x, dim=-1, keepdim=True), 1e-12)


def _quat_of(m):
    """(..., 3, 3) rotation -> (..., 4) wxyz, from the largest of the four
    candidates (any sign: only R(q) is used)."""
    m00, m11, m22 = m[..., 0, 0], m[..., 1, 1], m[..., 2, 2]
    cand = torch.stack([1 + m00 + m11 + m22, 1 + m00 - m11 - m22,
                        1 - m00 + m11 - m22, 1 - m00 - m11 + m22], -1)
    big = torch.sqrt(torch.clamp_min(cand, 1e-12)) / 2
    d = lambda i, j: m[..., i, j]
    rows = torch.stack([
        torch.stack([big[..., 0], (d(2, 1) - d(1, 2)) / (4 * big[..., 0]),
                     (d(0, 2) - d(2, 0)) / (4 * big[..., 0]),
                     (d(1, 0) - d(0, 1)) / (4 * big[..., 0])], -1),
        torch.stack([(d(2, 1) - d(1, 2)) / (4 * big[..., 1]), big[..., 1],
                     (d(0, 1) + d(1, 0)) / (4 * big[..., 1]),
                     (d(0, 2) + d(2, 0)) / (4 * big[..., 1])], -1),
        torch.stack([(d(0, 2) - d(2, 0)) / (4 * big[..., 2]),
                     (d(0, 1) + d(1, 0)) / (4 * big[..., 2]), big[..., 2],
                     (d(1, 2) + d(2, 1)) / (4 * big[..., 2])], -1),
        torch.stack([(d(1, 0) - d(0, 1)) / (4 * big[..., 3]),
                     (d(0, 2) + d(2, 0)) / (4 * big[..., 3]),
                     (d(1, 2) + d(2, 1)) / (4 * big[..., 3]), big[..., 3]],
                    -1)], -2)
    pick = torch.argmax(cand.detach(), -1)
    return torch.gather(rows, -2, pick[..., None, None].expand(
        *pick.shape, 1, 4))[..., 0, :]


def _quat_mul(a, b):
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack([aw * bw - ax * bx - ay * by - az * bz,
                        aw * bx + ax * bw + ay * bz - az * by,
                        aw * by - ax * bz + ay * bw + az * bx,
                        aw * bz + ax * by - ay * bx + az * bw], -1)


def _rotation(q):
    w, x, y, z = _normalize(q).unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], -1)], -2)


def _sh_basis(d):
    """(N, 16) real SH basis of degree 3 at unit directions (the 3DGS
    convention and signs)."""
    x, y, z = d.unbind(-1)
    xx, yy, zz, xy, yz, xz = x * x, y * y, z * z, x * y, y * z, x * z
    one = torch.ones_like(x)
    return torch.stack([
        SH_C0 * one, -SH_C1 * y, SH_C1 * z, -SH_C1 * x,
        SH_C2[0] * xy, SH_C2[1] * yz, SH_C2[2] * (2 * zz - xx - yy),
        SH_C2[3] * xz, SH_C2[4] * (xx - yy),
        SH_C3[0] * y * (3 * xx - yy), SH_C3[1] * xy * z,
        SH_C3[2] * y * (4 * zz - xx - yy),
        SH_C3[3] * z * (2 * zz - 3 * xx - 3 * yy),
        SH_C3[4] * x * (4 * zz - xx - yy), SH_C3[5] * z * (xx - yy),
        SH_C3[6] * x * (xx - 3 * yy)], -1)


def _resize_matrix(n_in: int, n_out: int, device):
    """(n_out, n_in): antialiased bilinear resizing along one axis
    (half-pixel centres), read off ``F.interpolate`` of the unit
    vectors."""
    eye = torch.eye(n_in, device=device).reshape(n_in, 1, 1, n_in)
    return F.interpolate(eye, size=(1, n_out), mode="bilinear",
                         align_corners=False,
                         antialias=True)[:, 0, 0, :].T.contiguous()


class Appearance:
    """The stage-2 loss and Adam step of one configuration's assets
    ``raw`` (``avatar_scene.inputs``, with the first state's ``alive``
    and ``binding``) on ``device``, products through ``ar``."""

    def __init__(self, cfg: dict, raw: dict, alive, binding, device,
                 ar: Arith):
        self.cfg, self.ar, self.dev = cfg, ar, device
        t = lambda a, dt=torch.float32: torch.as_tensor(a, dtype=dt,
                                                        device=device)
        self.faces = t(raw["faces"], torch.int64)
        self.verts = t(raw["verts"])
        self.ao = t(raw["ao"])
        self.uv = t(raw["uv"])
        self.nbr = t(raw["face_neighbors"], torch.int64)
        self.nbr_w = t(raw["neighbor_weight"])
        self.nbr_d = t(raw["neighbor_dist"])
        im = cfg["image"]
        self.width, self.height = im["width"], im["height"]
        self.cams = [splatting.camera(k, w2c, self.width, self.height,
                                      im["near"], im["far"], device)
                     for k, w2c in raw["cams"]]
        self.lp = {k: t(v) for k, v in raw["lpips"].items()}
        self.alive = torch.nonzero(t(alive, torch.bool))[:, 0]
        self.binding = t(binding, torch.int64)[self.alive]
        opt = cfg["optimization"]
        scale = raw["spatial_lr_scale"]
        self.lr = {"splats.xyz": opt["position_lr_init"] * scale,
                   "splats.features_dc": opt["feature_lr"],
                   "splats.features_rest": opt["feature_rest_lr"],
                   "splats.opacity": opt["opacity_lr"],
                   "splats.scaling": opt["scaling_lr"],
                   "splats.rotation": opt["rotation_lr"],
                   "verts_offset": opt["verts_lr_init"] * scale,
                   "cam_m": opt["cams_lr"], "cam_c": opt["cams_lr"]}
        self.shadow_lr = opt["shadow_lr"]
        g = torch.exp(-(torch.arange(11, device=device, dtype=torch.float64)
                        - 5) ** 2 / (2 * cfg["ssim"]["sigma"] ** 2))
        self.window = (g / g.sum()).float()
        self._resizes = {}

    # ---- pieces ---------------------------------------------------------
    def face_frames(self, verts):
        v0, v1, v2 = (verts[self.faces[:, i]] for i in range(3))
        a0 = _normalize(v1 - v0)
        a1 = _normalize(torch.linalg.cross(a0, v2 - v0, dim=-1))
        a2 = -_normalize(torch.linalg.cross(a1, a0, dim=-1))
        rot = torch.stack([a0, a1, a2], -1)
        s = (torch.linalg.vector_norm(v1 - v0, dim=-1)
             + torch.abs(torch.sum(a2 * (v2 - v0), -1))) / 2
        center = (v0 + v1 + v2) / 3
        return rot, _quat_of(rot), s[:, None], center

    def _resize(self, x, hw):
        ar = self.ar
        h, w = x.shape[-2:]
        mats = []
        for n_in, n_out in ((h, hw[0]), (w, hw[1])):
            key = (n_in, n_out)
            if key not in self._resizes:
                self._resizes[key] = _resize_matrix(n_in, n_out, self.dev)
            mats.append(self._resizes[key])
        return ar.einsum("oh,bchw,pw->bcop", mats[0], x, mats[1])

    def _conv(self, x, w, bias=None, padding=1):
        ar = self.ar
        return F.conv2d(ar.r(x), ar.r(w), bias, padding=padding)

    def shadow_map(self, sh, ao):
        """The quasi-shadow UNet on one (1, S, S) AO map -> (S, S)."""
        slope = self.cfg["shadow"]["lrelu_slope"]
        size = sh["ao_mean"].shape[-1]
        sizes = [size // 2 ** i for i in range(4)]
        leaky = lambda v: torch.where(v >= 0, v, slope * v)

        def wn(name):
            v, gain = sh[f"{name}_v"], sh[f"{name}_g"]
            return v * (gain / torch.sqrt(torch.sum(v * v, dim=(1, 2, 3),
                                                    keepdim=True) + 1e-12))

        x = ao[None] - sh["ao_mean"]
        acts = []
        for i in range(4):
            x = leaky(self._conv(x, wn(f"enc{i}")) + sh[f"enc{i}_b"])
            acts.append(x)
            if i < 3:
                x = self._resize(x, (sizes[i + 1], sizes[i + 1]))
        for i in range(4):
            if i:
                skip = acts[-i - 1]
                x = torch.cat([self._resize(x, skip.shape[-2:]), skip], 1)
            x = leaky(self._conv(x, wn(f"dec{i}")) + sh[f"dec{i}_b"])
        low = torch.sigmoid(self._conv(x, wn("pred")) + sh["pred_b"]
                            + sh["beta"])
        uv = self.cfg["shadow"]["uv_size"]
        return self._resize(low, (uv, uv))[0, 0]

    def sample(self, img):
        """Bilinear (zero padding, align_corners False) at the face UVs."""
        ar = self.ar
        h, w = img.shape
        x = ((self.uv[:, 0] + 1.0) * w - 1.0) * 0.5
        y = ((self.uv[:, 1] + 1.0) * h - 1.0) * 0.5
        x0, y0 = torch.floor(x), torch.floor(y)
        wx, wy = x - x0, y - y0
        out = 0.0
        for ix, iy, wt in ((x0, y0, (1 - wx) * (1 - wy)),
                           (x0 + 1, y0, wx * (1 - wy)),
                           (x0, y0 + 1, (1 - wx) * wy),
                           (x0 + 1, y0 + 1, wx * wy)):
            inb = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
            tap = img[iy.clamp(0, h - 1).long(), ix.clamp(0, w - 1).long()]
            out = out + ar.r(torch.where(inb, tap, 0.0)) * ar.r(wt)
        return out

    def _filter(self, x):
        """SSIM's separable gaussian, zero padding, per map."""
        c = x.shape[1]
        g = self.window
        x = F.conv2d(self.ar.r(x), self.ar.r(g.reshape(1, 1, 11, 1)).expand(
            c, 1, 11, 1), padding=(5, 0), groups=c)
        return F.conv2d(self.ar.r(x), self.ar.r(g.reshape(1, 1, 1, 11))
                        .expand(c, 1, 1, 11), padding=(0, 5), groups=c)

    def ssim(self, a, b):
        a, b = a[None], b[None]
        mu1, mu2 = self._filter(a), self._filter(b)
        s11 = self._filter(a * a) - mu1 * mu1
        s22 = self._filter(b * b) - mu2 * mu2
        s12 = self._filter(a * b) - mu1 * mu2
        c1, c2 = 0.01 ** 2, 0.03 ** 2
        return torch.mean(((2 * mu1 * mu2 + c1) * (2 * s12 + c2))
                          / ((mu1 * mu1 + mu2 * mu2 + c1) * (s11 + s22 + c2)))

    def lpips(self, x, y):
        ar = self.ar
        shift = torch.tensor(SHIFT, device=self.dev).reshape(1, 3, 1, 1)
        scale = torch.tensor(SCALE, device=self.dev).reshape(1, 3, 1, 1)

        def feats(v):
            v = (v[None] - shift) / scale
            out, i = [], 0
            for item in VGG:
                if item == "M":
                    v = F.max_pool2d(v, 2, 2)
                    continue
                v = torch.relu(self._conv(v, self.lp[f"conv{i}_w"],
                                          self.lp[f"conv{i}_b"]))
                if i in TAPS:
                    out.append(v)
                i += 1
            return out

        total = 0.0
        for j, (a, b) in enumerate(zip(feats(x), feats(y))):
            na = torch.sqrt(torch.sum(ar.r(a) * ar.r(a), 1, keepdim=True))
            nb = torch.sqrt(torch.sum(ar.r(b) * ar.r(b), 1, keepdim=True))
            d = (a / (na + 1e-10) - b / (nb + 1e-10)) ** 2
            total = total + torch.mean(torch.sum(
                ar.r(d) * ar.r(self.lp[f"lin{j}_w"]), 1))
        return total

    def regularisers(self, verts, p, radius):
        w = self.cfg["loss_weights"]
        vf = verts[self.faces]
        cr = torch.linalg.cross(vf[:, 1] - vf[:, 0], vf[:, 2] - vf[:, 0],
                                dim=-1)
        n = _normalize(cr)
        normal = torch.mean(torch.abs(torch.sum(
            n[:, None] * n[self.nbr], -1).mean(-1) - 1.0))
        op = torch.sigmoid(p["splats.opacity"][self.alive, 0])
        opacity = torch.mean(1.0 - op)
        centers = vf.mean(1)
        off = centers[self.nbr] - centers[:, None]
        mag = torch.sqrt(torch.sum(off ** 2, -1) + 1e-20)
        own = self.nbr == torch.arange(len(self.faces), device=self.dev)[
            :, None]
        val = torch.where(own, 0.0, (mag - self.nbr_d) ** 2 * self.nbr_w)
        iso = torch.mean(torch.sqrt(val + 1e-20))
        area = 0.5 * torch.linalg.vector_norm(cr, dim=-1)
        area = torch.mean(torch.abs(area - torch.mean(area)))
        vis = (radius > 0).to(op.dtype)
        count = torch.clamp_min(vis.sum(), 1.0)
        xyz = p["splats.xyz"][self.alive]
        excess = torch.relu(torch.sqrt(torch.sum(xyz * xyz, 1) + 1e-12)
                            - w["threshold_xyz"])
        sc = torch.relu(torch.exp(p["splats.scaling"][self.alive])
                        - w["threshold_scale"])
        scale = torch.sqrt(torch.sum(sc * sc, 1) + 1e-12)
        return (w["normal"] * normal + w["opacity"] * opacity
                + w["iso"] * iso + w["area"] * area
                + w["xyz"] * torch.sum(excess * vis) / count
                + w["scale"] * torch.sum(scale * vis) / count)

    # ---- the step -------------------------------------------------------
    def world(self, p: dict, frame: int):
        """(the frame's vertices, the alive splats' world positions and
        3D covariances) through the binding."""
        ar = self.ar
        verts = self.verts[frame] + p["verts_offset"][frame]
        rot, quat, fscale, center = self.face_frames(verts)
        b, a = self.binding, self.alive
        xyz = ar.einsum("nij,nj->ni", rot[b], p["splats.xyz"][a]) \
            * fscale[b] + center[b]
        scale = torch.exp(p["splats.scaling"][a]) * fscale[b]
        q = _quat_mul(_normalize(quat[b]), _normalize(p["splats.rotation"][a]))
        l = _rotation(q) * scale[:, None, :]
        return verts, xyz, ar.einsum("nij,nkj->nik", l, l)

    def loss(self, p: dict, camera: int, frame: int, gt_rgb, gt_msk):
        """The stage-2 loss of the leaves ``p`` (name -> tensor, the
        program's capacity-padded layout) for one (camera, frame)."""
        ar, cam, w = self.ar, self.cams[camera], self.cfg["loss_weights"]
        a, b = self.alive, self.binding
        verts, xyz, cov = self.world(p, frame)
        sh = {k[len("shadow."):]: v for k, v in p.items()
              if k.startswith("shadow.")}
        shadow = self.sample(self.shadow_map(sh, self.ao[frame]))[b]
        dirs = _normalize(xyz - cam["center"])
        coeffs = torch.cat([p["splats.features_dc"][a],
                            p["splats.features_rest"][a]], 1)
        rgb = torch.clamp_min(ar.einsum("nk,nkc->nc", _sh_basis(dirs),
                                        coeffs) + 0.5, 0.0)
        means2d, depth, conic, radius, _ = splatting.project(
            xyz, cov, cam, self.width, self.height, ar)
        img, trans = splatting.composite(
            means2d, conic, shadow[:, None] * rgb,
            torch.sigmoid(p["splats.opacity"][a, 0]), radius, depth,
            self.width, self.height, ar)
        render = img * torch.exp(p["cam_m"][camera])[:, None, None] \
            + p["cam_c"][camera][:, None, None]
        render = torch.clamp(render * (1.0 - trans)[None], 0.0, 1.0)
        gt = gt_rgb * gt_msk
        loss = (1.0 - w["dssim"]) * torch.mean(torch.abs(render - gt)) \
            + w["dssim"] * (1.0 - self.ssim(render, gt))
        if w["lpips"]:
            loss = loss + w["lpips"] * self.lpips(render, gt)
        return loss + self.regularisers(verts, p, radius)

    def adam_step(self, p0: dict, m0: dict, v0: dict, n0: int, camera: int,
                  frame: int, gt):
        """One step from the leaves ``p0`` with Adam's moments ``m0``,
        ``v0`` after ``n0`` updates: (the loss at ``p0``, its gradient, the
        leaves after the step, the moments after it), tensors by name."""
        opt_eps = self.cfg["optimization"]["eps"]
        leaves = {k: v.detach().clone().requires_grad_(k not in FROZEN)
                  for k, v in p0.items()}
        loss = self.loss(leaves, camera, frame, *gt)
        names = [k for k in leaves if k not in FROZEN]
        grads = dict(zip(names, torch.autograd.grad(
            loss, [leaves[k] for k in names], allow_unused=True)))
        n = n0 + 1
        p1, m1, v1 = dict(p0), {}, {}
        for k in names:
            g = grads[k] if grads[k] is not None else torch.zeros_like(p0[k])
            grads[k] = g
            m = BETA1 * m0[k] + (1 - BETA1) * g
            v = BETA2 * v0[k] + (1 - BETA2) * g * g
            lr = self.lr.get(k, self.shadow_lr)
            denom = v.sqrt() / math.sqrt(1 - BETA2 ** n) + opt_eps
            p1[k] = p0[k] - (lr / (1 - BETA1 ** n)) * m / denom
            m1[k], v1[k] = m, v
        return float(loss.detach()), grads, p1, (m1, v1)

    def train(self, init: dict, draws, gts) -> dict:
        """Steps from ``init`` over ``draws`` [(camera, frame)] with their
        ground truth: each step's loss, the first step's gradient and the
        leaves after the last step."""
        p = dict(init)
        names = [k for k in p if k not in FROZEN]
        m = {k: torch.zeros_like(p[k]) for k in names}
        v = {k: torch.zeros_like(p[k]) for k in names}
        losses, first = [], None
        for i, ((camera, frame), gt) in enumerate(zip(draws, gts)):
            loss, grads, p, (m, v) = self.adam_step(p, m, v, i, camera,
                                                    frame, gt)
            losses.append(loss)
            first = grads if first is None else first
        return {"loss": losses, "grad": first, "params": p}
