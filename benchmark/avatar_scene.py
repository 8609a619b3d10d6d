"""The stage-2 avatar's assets and traffic, made from the seed with numpy
and plain PyTorch (nothing of the program): the body-scale mesh, its
tracked frames, AO maps, UVs and colours, the ring of cameras with their
colour calibration, the LPIPS-VGG16 weights and the ground truth of each
(camera, frame), and the first state of the splats and the shadow UNet.
The driver loads them into the program and the reference
(``reference/appearance.py``) reads them as they are.

The mesh has ``render/bench_render.py``'s 160 x 158 grid of a body-scale
ellipsoid (1.7 m tall, 0.25 m radius): 50,244 faces, each bound to one
splat.  Its rows lie at equal arc length along the meridian and stop
``pole_margin`` radians short of each pole, so that its faces are of like
size, as a tracked body mesh's are: the UV sphere's rows at equal angle
close on a fan of 158 faces at each pole, which put over 2,000 splats in
one 16 x 16 tile.
"""

from __future__ import annotations

import math

import numpy as np
import torch

SH_C0 = 0.28209479177387814


def body_mesh(n_theta: int, n_phi: int, height: float, radius: float,
              pole_margin: float):
    """(verts (V, 3) float32, faces (F, 3) int64) of the ellipsoid's
    grid, faces in the order ``bench_render.build_body_mesh`` makes them:
    ``n_theta`` rows at equal arc length from ``pole_margin`` to pi -
    ``pole_margin``."""
    dense = np.linspace(pole_margin, np.pi - pole_margin, 20_001)
    step = np.hypot(radius * np.cos(dense), 0.5 * height * np.sin(dense))
    arc = np.concatenate([[0.0], np.cumsum(0.5 * (step[1:] + step[:-1])
                                           * np.diff(dense))])
    th = np.interp(np.linspace(0.0, arc[-1], n_theta), arc, dense)
    ph = np.linspace(0, 2 * np.pi, n_phi, endpoint=False)
    tt, pp = np.meshgrid(th, ph, indexing="ij")
    verts = np.stack([radius * np.sin(tt) * np.cos(pp),
                      0.5 * height * np.cos(tt),
                      radius * np.sin(tt) * np.sin(pp)], -1)
    idx = np.arange(n_theta * n_phi).reshape(n_theta, n_phi)
    a = idx[:-1, :].ravel()
    b = idx[1:, :].ravel()
    c = idx[:-1, np.r_[1:n_phi, 0]].ravel()
    d = idx[1:, np.r_[1:n_phi, 0]].ravel()
    faces = np.concatenate([np.stack([a, b, c], -1),
                            np.stack([c, b, d], -1)], 0)
    return verts.reshape(-1, 3).astype(np.float32), faces.astype(np.int64)


def adjacent_faces(faces: np.ndarray) -> np.ndarray:
    """(F, 3): each face's edge neighbours in the order the edges are met,
    the face itself where it has fewer than three (the regularisers'
    neighbour table, as the program's loaders build it)."""
    edges = {}
    for fi, (a, b, c) in enumerate(faces):
        for e in ((a, b), (b, c), (c, a)):
            edges.setdefault((min(e), max(e)), []).append(fi)
    out = np.tile(np.arange(len(faces))[:, None], (1, 3))
    fill = np.zeros(len(faces), int)
    for fl in edges.values():
        if len(fl) == 2:
            for f0, f1 in (fl, fl[::-1]):
                if fill[f0] < 3:
                    out[f0, fill[f0]] = f1
                    fill[f0] += 1
    return out


def ring_cameras(cfg: dict, rng) -> list:
    """The cameras, each (K (3, 3), world-to-camera (4, 4)) in float64:
    one per sector of the ring in azimuth, at a seeded azimuth in it and a
    seeded elevation, looking at the origin with the image upright."""
    im, rig = cfg["image"], cfg["rig"]
    n = cfg["cameras"]
    lo, hi = (math.radians(d) for d in rig["elevation_deg"])
    cams = []
    for i in range(n):
        az = 2 * math.pi * (i + rng.random()) / n
        el = lo + (hi - lo) * rng.random()
        eye = rig["distance"] * np.array([math.cos(el) * math.sin(az),
                                          math.sin(el),
                                          -math.cos(el) * math.cos(az)])
        fwd = -eye / np.linalg.norm(eye)
        right = np.cross([0.0, -1.0, 0.0], fwd)
        right /= np.linalg.norm(right)
        rot = np.stack([right, np.cross(fwd, right), fwd], 1)   # c2w
        w2c = np.eye(4)
        w2c[:3, :3] = rot.T
        w2c[:3, 3] = -rot.T @ eye
        f, w, h = im["focal"], im["width"], im["height"]
        k = np.array([[f, 0.0, w / 2], [0.0, f, h / 2], [0.0, 0.0, 1.0]])
        cams.append((k, w2c))
    return cams


def lpips_weights(seed: int) -> dict:
    """LPIPS-VGG16's arrays in the published layout (13 3x3 convolutions
    ``conv{i}_w``/``conv{i}_b`` up to relu5_3, 5 linear heads ``lin{i}_w``),
    drawn from the seed: He-normal kernels, so that the activations keep
    their scale through the 13 layers, small biases, non-negative heads of
    mean 1 / channels."""
    gen = torch.Generator().manual_seed(seed)
    ladder = [64, 64, 128, 128, 256, 256, 256, 512, 512, 512, 512, 512, 512]
    taps = (1, 3, 6, 9, 12)
    out, c_in = {}, 3
    for i, c in enumerate(ladder):
        std = math.sqrt(2.0 / (9 * c_in))
        out[f"conv{i}_w"] = (torch.randn((c, c_in, 3, 3), generator=gen)
                             * std).numpy()
        out[f"conv{i}_b"] = (torch.randn((c,), generator=gen) * 0.01).numpy()
        c_in = c
    for j, i in enumerate(taps):
        c = ladder[i]
        out[f"lin{j}_w"] = (torch.rand((1, c, 1, 1), generator=gen)
                            * (2.0 / c)).numpy()
    return out


def shadow_unet(seed: int, ao_mean: np.ndarray, cfg: dict) -> dict:
    """The quasi-shadow UNet's first weights in the program's layout
    (``enc0``-``enc3`` down, ``dec0``-``dec3`` up with the skips' channels,
    ``pred`` to one channel): each 3x3 kernel weight-normalised, ``v``
    Kaiming-uniform with the leaky ReLU's gain, ``g`` = |v| per output
    channel, biases untied (one per pixel of the layer's map, one for
    ``pred``) and zero; ``ao_mean`` (1, 1, S, S), ``beta`` 1."""
    gen = torch.Generator().manual_seed(seed)
    n, size, slope = cfg["n_dims"], cfg["shadow_size"], cfg["lrelu_slope"]
    sizes = [size // 2 ** i for i in range(4)]
    layers = ([(f"enc{i}", 1 if i == 0 else n, n, sizes[i], slope)
               for i in range(4)]
              + [(f"dec{i}", n if i == 0 else 2 * n, n, sizes[-i - 1], slope)
                 for i in range(4)]
              + [("pred", n, 1, 1, 1.0)])
    out = {"ao_mean": torch.as_tensor(ao_mean, dtype=torch.float32).reshape(
        1, 1, size, size), "beta": torch.tensor(1.0)}
    for name, c_in, c_out, bias_hw, gain_slope in layers:
        bound = math.sqrt(2.0 / (1.0 + gain_slope ** 2)) \
            * math.sqrt(3.0 / (9 * c_in))
        v = (torch.rand((c_out, c_in, 3, 3), generator=gen) * 2 - 1) * bound
        out[f"{name}_v"] = v
        out[f"{name}_g"] = torch.sqrt((v * v).sum((1, 2, 3), keepdim=True))
        out[f"{name}_b"] = torch.zeros((1, c_out, bias_hw, bias_hw))
    return out


def first_state(cfg: dict, raw: dict, seed: int) -> dict:
    """The state before the first step, as MPMAvatar's
    ``mesh_gaussian_model.py:61-84`` initialises it, on the CPU: name ->
    tensor for every float leaf (``splats.*``, ``verts_offset``,
    ``cam_m``, ``cam_c``, ``shadow.*``) and ``splats.binding``,
    ``splats.alive``.  One splat a face in the first slots, at the face's
    centre (xyz 0) with the face's colour in its SH DC band, scaling log
    0.1 of the face's scale, the identity rotation and opacity 0.1; the
    capacity's other slots dead (opacity 0 through ``alive``), bound to
    face 0, with zero colour."""
    nf = len(raw["faces"])
    cap = int(nf * cfg["capacity_factor"])
    n_rest = (cfg["sh_degree"] + 1) ** 2 - 1
    dc = torch.zeros((cap, 1, 3))
    dc[:nf, 0] = (torch.as_tensor(raw["rgb"]) - 0.5) / SH_C0
    rotation = torch.zeros((cap, 4))
    rotation[:, 0] = 1.0
    slots = torch.arange(cap)
    state = {
        "splats.xyz": torch.zeros((cap, 3)),
        "splats.features_dc": dc,
        "splats.features_rest": torch.zeros((cap, n_rest, 3)),
        "splats.scaling": torch.full((cap, 3), math.log(0.1)),
        "splats.rotation": rotation,
        "splats.opacity": torch.full((cap, 1), math.log(0.1 / 0.9)),
        "splats.binding": torch.where(slots < nf, slots, 0),
        "splats.alive": slots < nf,
        "verts_offset": torch.zeros(raw["verts"].shape),
        "cam_m": torch.as_tensor(raw["cam_m"]),
        "cam_c": torch.as_tensor(raw["cam_c"])}
    unet = shadow_unet((seed * 31 + 7) % 2 ** 63, raw["ao"].mean(axis=0),
                       cfg["shadow"])
    state.update({f"shadow.{k}": v for k, v in unet.items()})
    return state


def inputs(cfg: dict, seed: int) -> dict:
    """Every asset of the configuration from ``seed``, as numpy arrays
    (host side; made once in set-up)."""
    rng = np.random.default_rng(seed)
    m = cfg["mesh"]
    verts, faces = body_mesh(m["n_theta"], m["n_phi"], m["height"],
                             m["radius"], m["pole_margin"])
    nf, nt = len(faces), cfg["frames"]
    # the tracked frames: a breathing stretch along y, a sway in x and z,
    # and each vertex's tracking noise, so that no frame is the template
    # whose neighbour distances the regularisers hold (at rest, iso's
    # |distance - rest| has its kink at every pair, and rounding alone
    # would choose the sign of its gradient)
    mo = cfg["motion"]
    t = np.arange(nt)
    stretch = 1.0 + mo["stretch"] * np.sin(2 * np.pi * t / max(nt, 1))
    sway = rng.uniform(-mo["sway_m"], mo["sway_m"], (nt, 3)) \
        * np.array([1.0, 0.0, 1.0])
    frames = (verts[None] * np.stack([np.ones(nt), stretch, np.ones(nt)],
                                     1)[:, None] + sway[:, None]
              + rng.normal(0.0, mo["noise_m"], (nt,) + verts.shape))
    s = cfg["shadow"]["uv_size"]
    ao = (0.4 + 0.5 * rng.random((nt, 1, s, s))).astype(np.float32)
    uv = (rng.random((nf, 2)) * 2.0 - 1.0).astype(np.float32)
    rgb = rng.random((nf, 3)).astype(np.float32)
    nbr = adjacent_faces(faces)
    centers = verts[faces].mean(1)
    sq = np.sum((centers[nbr] - centers[:, None]) ** 2, -1)
    cams = ring_cameras(cfg, rng)
    n = cfg["cameras"]
    centers_c = np.stack([-w2c[:3, :3].T @ w2c[:3, 3] for _, w2c in cams])
    # 3DGS's scene radius (getNerfppNorm): 1.1 x the cameras' largest
    # distance from their mean, the spatial learning-rate scale
    radius = 1.1 * float(np.max(np.linalg.norm(
        centers_c - centers_c.mean(0), axis=1)))
    return {
        "faces": faces, "verts": frames.astype(np.float32), "ao": ao,
        "uv": uv, "rgb": rgb, "face_neighbors": nbr,
        "neighbor_weight": np.exp(-2000 * sq).astype(np.float32),
        "neighbor_dist": np.sqrt(sq).astype(np.float32),
        "cams": cams,
        "cam_m": rng.uniform(-0.05, 0.05, (n, 3)).astype(np.float32),
        "cam_c": rng.uniform(-0.02, 0.02, (n, 3)).astype(np.float32),
        "lpips": lpips_weights(seed % 2 ** 63),
        "spatial_lr_scale": radius,
    }


def ground_truth(cfg: dict, seed: int, camera: int, frame: int, device):
    """(rgb (3, H, W), mask (1, H, W)) of one (camera, frame): a seeded
    image made on ``device`` and a full mask.  The same arguments give the
    same image on the same kind of device."""
    im = cfg["image"]
    gen = torch.Generator(device).manual_seed(
        (seed * 1_000_003 + camera * 1_009 + frame) % 2 ** 63)
    rgb = torch.rand((3, im["height"], im["width"]), generator=gen,
                     device=device)
    return rgb, torch.ones((1, im["height"], im["width"]), device=device)
