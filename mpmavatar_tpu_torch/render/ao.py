"""UV-space ambient-occlusion bake, port of mpmavatar_tpu/render/ao.py.

Per-frame UV AO maps (256^2 by default) for the quasi-shadow network, in
place of a Blender Cycles bake: cosine-hemisphere rays from each covered
texel's surface point, marched through a soft voxel occupancy of the
posed mesh (the transmittance exp(-k * optical depth)).  The UV chart
(texel -> face + barycentric) is a host-side numpy precomputation from
the UV template, made once; ``bake_ao`` runs on the device of ``verts``
(plain PyTorch: the JAX package has no Pallas kernel here).

The ray march holds (texels, rays, steps) points; ``bake_ao`` marches
``texel_chunk`` texels at a time so that its temporaries stay within a
few hundred MB at the production 256^2 x 32 rays x 48 steps.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.linalg import cross

# face-sample barycentrics: dense enough that triangles larger than a
# voxel still register contiguous occupancy
_BARY_SET = ((1 / 3, 1 / 3, 1 / 3), (0.6, 0.2, 0.2), (0.2, 0.6, 0.2),
             (0.2, 0.2, 0.6), (0.5, 0.5, 0.0), (0.0, 0.5, 0.5),
             (0.5, 0.0, 0.5), (0.8, 0.1, 0.1), (0.1, 0.8, 0.1),
             (0.1, 0.1, 0.8))
TEXEL_CHUNK = 8192


@dataclasses.dataclass
class UVChart:
    """Texel -> surface mapping for one UV layout (static)."""
    face_idx: np.ndarray    # (T,) face per covered texel
    bary: np.ndarray        # (T, 3)
    texel_ij: np.ndarray    # (T, 2) row, col
    resolution: int


def rasterize_uv_chart(uv_verts: np.ndarray, uv_faces: np.ndarray,
                       resolution: int = 256) -> UVChart:
    """Fill UV triangles into a texel table (host, once).

    uv_verts (Nuv, 2) in [0, 1]; uv_faces (F, 3) indices into uv_verts
    (per-corner UV topology like OBJ f v/vt records)."""
    face_idx, bary, texel = [], [], []
    res = resolution
    for fi, tri in enumerate(uv_faces):
        p = uv_verts[tri]  # (3, 2) in [0,1]
        # texel centers covered by the triangle bbox
        lo = np.clip(np.floor(p.min(0) * res).astype(int), 0, res - 1)
        hi = np.clip(np.ceil(p.max(0) * res).astype(int), 0, res)
        if np.any(hi <= lo):
            continue
        us, vs = np.meshgrid(np.arange(lo[0], hi[0]),
                             np.arange(lo[1], hi[1]), indexing="ij")
        pts = np.stack([(us.ravel() + 0.5) / res,
                        (vs.ravel() + 0.5) / res], -1)
        d = p[1:] - p[0]
        det = d[0, 0] * d[1, 1] - d[0, 1] * d[1, 0]
        if abs(det) < 1e-12:
            continue
        rel = pts - p[0]
        b1 = (rel[:, 0] * d[1, 1] - rel[:, 1] * d[1, 0]) / det
        b2 = (-rel[:, 0] * d[0, 1] + rel[:, 1] * d[0, 0]) / det
        inside = (b1 >= -1e-4) & (b2 >= -1e-4) & (b1 + b2 <= 1 + 1e-4)
        if not inside.any():
            continue
        b1, b2 = b1[inside], b2[inside]
        face_idx.append(np.full(inside.sum(), fi))
        bary.append(np.stack([1 - b1 - b2, b1, b2], -1))
        # image row = v flipped (texture convention), col = u
        texel.append(np.stack([res - 1 - pts[inside][:, 1] * res,
                               pts[inside][:, 0] * res], -1).astype(int))
    if not face_idx:
        raise ValueError("UV chart covers no texels")
    return UVChart(face_idx=np.concatenate(face_idx),
                   bary=np.concatenate(bary).astype(np.float32),
                   texel_ij=np.clip(np.concatenate(texel), 0, res - 1),
                   resolution=resolution)


def load_uv_chart(uv_path: str, resolution: int = 256) -> UVChart:
    """UV chart straight from an OBJ's vt/f records (host, once)."""
    vt, fuv = [], []
    with open(uv_path) as f:
        for line in f:
            if line[:2] == "vt":
                vt.append([float(x) for x in line[2:].split()])
            elif line[:2] == "f ":
                fuv.append([int(p.split("/")[1]) - 1
                            for p in line[2:].split()])
    return rasterize_uv_chart(np.asarray(vt, np.float32),
                              np.asarray(fuv), resolution=resolution)


def _fibonacci_hemisphere(n: int) -> np.ndarray:
    """Cosine-ish hemisphere directions around +z."""
    i = np.arange(n) + 0.5
    phi = np.pi * (1 + 5 ** 0.5) * i
    cos_t = np.sqrt(1.0 - i / n)      # cosine-weighted in z
    sin_t = np.sqrt(1.0 - cos_t ** 2)
    return np.stack([np.cos(phi) * sin_t, np.sin(phi) * sin_t,
                     cos_t], -1).astype(np.float32)


def _normalize(v):
    return v / torch.clamp_min(
        torch.linalg.vector_norm(v, dim=-1, keepdim=True), 1e-12)


def _occupancy_grid(verts, faces, grid_res: int = 96,
                   occupancy_sigma: float = 1.5):
    """(occupancy (grid_res^3,), lo (3,), scale (3,)): the soft
    occupancy 1 - exp(-sigma * n) of the vertices and 10 barycentric
    samples per face counted into a grid_res^3 box around the mesh (5 cm
    of margin); ``(p - lo) * scale`` is a point's grid coordinate."""
    lo = verts.amin(0) - 0.05
    hi = verts.amax(0) + 0.05
    scale = (grid_res - 1) / torch.clamp_min(hi - lo, 1e-6)
    # the samples as explicit products and sums (no matrix product): a
    # sample an ulp from a voxel face lands in the same voxel on every
    # device
    tri = verts[faces]                                      # (F, 3, 3)
    face_samples = torch.stack([
        b0 * tri[:, 0] + b1 * tri[:, 1] + b2 * tri[:, 2]
        for b0, b1, b2 in _BARY_SET], 1).reshape(-1, 3)
    samples = torch.cat([verts, face_samples], 0)
    cell = torch.clamp((samples - lo) * scale, 0, grid_res - 1 - 1e-4)
    ci = cell.to(torch.int64)
    flat = (ci[:, 0] * grid_res + ci[:, 1]) * grid_res + ci[:, 2]
    # a count per sample: exact in float32 up to 2^24, so the sum does
    # not depend on the order of the atomic adds on the card
    occ = torch.zeros(grid_res ** 3, dtype=verts.dtype, device=verts.device)
    occ.index_add_(0, flat, torch.ones_like(flat, dtype=verts.dtype))
    return 1.0 - torch.exp(-occupancy_sigma * occ), lo, scale


def _sample_occ(occ, p, lo, scale, grid_res: int):
    """Trilinear occupancy at world points p (..., 3)."""
    g = torch.clamp((p - lo) * scale, 0.0, grid_res - 1.001)
    g0 = torch.floor(g).to(torch.int64)
    f = g - g0
    base = (g0[..., 0] * grid_res + g0[..., 1]) * grid_res + g0[..., 2]
    out = 0.0
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                w = ((f[..., 0] if dx else 1 - f[..., 0])
                     * (f[..., 1] if dy else 1 - f[..., 1])
                     * (f[..., 2] if dz else 1 - f[..., 2]))
                out = out + w * occ[base + (dx * grid_res + dy) * grid_res
                                    + dz]
    return out


def bake_ao(verts, faces, chart_face_idx, chart_bary, chart_texel,
            resolution: int = 256, grid_res: int = 96, n_rays: int = 32,
            n_steps: int = 48, max_dist: float = 0.5,
            occupancy_sigma: float = 1.5, extinction: float = 2.0,
            texel_chunk: int = TEXEL_CHUNK):
    """A (1, res, res) AO map of the posed mesh (``verts`` (V, 3),
    ``faces`` (F, 3)) over a UV chart's texels, on the device of
    ``verts``; uncovered texels read 1.

    Per texel: transmittance exp(-extinction * tau) along n_rays cosine
    hemisphere rays, tau the step-length-weighted occupancy of n_steps
    samples out to max_dist, in voxels.  The extinction 2 and 48 steps
    are the JAX package's calibration against a ray-traced oracle.  A
    texel that the chart lists twice (a texel centre on an edge two
    faces share) takes its last entry's value, as a sequential scatter
    does."""
    dev = verts.device
    verts = torch.as_tensor(verts, dtype=torch.float32, device=dev)
    faces = torch.as_tensor(faces, dtype=torch.int64, device=dev)
    face_idx = torch.as_tensor(chart_face_idx, dtype=torch.int64,
                               device=dev)
    bary = torch.as_tensor(chart_bary, dtype=torch.float32, device=dev)
    texel = torch.as_tensor(chart_texel, dtype=torch.int64, device=dev)
    with torch.no_grad():
        occ, lo, scale = _occupancy_grid(verts, faces, grid_res,
                                        occupancy_sigma)
        eps = 2.0 / scale.max()
        voxel = 1.0 / scale.max()
        # i / n_steps in float32, as jnp.linspace(0, 1, n_steps + 1)
        ts = (torch.arange(n_steps + 1, dtype=torch.float32, device=dev)
              / n_steps)[1:] ** 1.5 * max_dist
        dls = torch.diff(torch.cat([ts.new_zeros(1), ts]))
        dirs_local = torch.as_tensor(_fibonacci_hemisphere(n_rays),
                                     device=dev)
        ao = []
        for s in range(0, len(face_idx), texel_chunk):
            tri = verts[faces[face_idx[s:s + texel_chunk]]]   # (t, 3, 3)
            pts = torch.einsum("tc,tcd->td", bary[s:s + texel_chunk], tri)
            n = _normalize(cross(tri[:, 1] - tri[:, 0],
                                 tri[:, 2] - tri[:, 0]))
            helper = torch.where(
                torch.abs(n[:, :1]) < 0.9,
                torch.tensor([[1.0, 0.0, 0.0]], device=dev),
                torch.tensor([[0.0, 1.0, 0.0]], device=dev))
            t1 = _normalize(cross(n, helper.expand_as(n)))
            t2 = cross(n, t1)
            dirs = (dirs_local[None, :, 0:1] * t1[:, None]
                    + dirs_local[None, :, 1:2] * t2[:, None]
                    + dirs_local[None, :, 2:3] * n[:, None])   # (t, R, 3)
            ray_pts = pts[:, None, None, :] + dirs[:, :, None, :] * \
                ts[None, None, :, None] + n[:, None, None, :] * eps
            occ_along = _sample_occ(occ, ray_pts, lo, scale, grid_res)
            tau = torch.sum(occ_along * dls, dim=-1) / voxel
            ao.append(torch.mean(torch.exp(-extinction * tau), dim=-1))
        ao = torch.cat(ao)
        flat = texel[:, 0] * resolution + texel[:, 1]
        last = torch.full((resolution * resolution,), -1, dtype=torch.int64,
                          device=dev).scatter_reduce_(
            0, flat, torch.arange(len(flat), device=dev), "amax")
        last = last[last >= 0]
        img = torch.ones(resolution * resolution, device=dev)
        img[flat[last]] = ao[last]
    return img.reshape(1, resolution, resolution)
