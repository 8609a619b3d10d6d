"""Robust-Skin-Weights-Transfer LBS weight inpainting (host scipy).

Copy of mpmavatar_tpu/preprocess/lbs_inpainting.py (numpy and scipy,
the port's native KD-tree): vertices of the tracked mesh are matched to
SMPL-X by distance + normal-angle confidence; low-confidence weights
are inpainted by solving the biharmonic-like system ``Q = -L + L M^-1 L``
per bone with a sparse direct solver.  The reference uses the ``robust_laplacian`` package; here
a standard cotangent Laplacian + barycentric lumped mass matrix is built
directly (same operator family; intrinsic-Delaunay robustness is traded
for zero dependencies).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as splinalg


def cotangent_laplacian(verts: np.ndarray, faces: np.ndarray):
    """(L, M): positive semi-definite cotan Laplacian + lumped mass."""
    v = np.asarray(verts, np.float64)
    f = np.asarray(faces, np.int64)
    n = len(v)

    ii, jj, ww = [], [], []
    areas = np.zeros(n)
    for k in range(3):
        i0 = f[:, k]
        i1 = f[:, (k + 1) % 3]
        i2 = f[:, (k + 2) % 3]
        e1 = v[i1] - v[i0]
        e2 = v[i2] - v[i0]
        cross = np.cross(e1, e2)
        area2 = np.linalg.norm(cross, axis=1)
        cot = np.einsum("ij,ij->i", e1, e2) / np.maximum(area2, 1e-12)
        # edge (i1, i2) opposite vertex i0 gets 0.5 * cot weight
        ii += [i1, i2]
        jj += [i2, i1]
        ww += [0.5 * cot, 0.5 * cot]
        np.add.at(areas, i0, area2 / 6.0)  # barycentric lumped

    ii = np.concatenate(ii)
    jj = np.concatenate(jj)
    ww = np.concatenate(ww)
    w_mat = sp.coo_matrix((ww, (ii, jj)), shape=(n, n)).tocsr()
    lap = sp.diags(np.asarray(w_mat.sum(axis=1)).ravel()) - w_mat
    mass = sp.diags(np.maximum(areas, 1e-12))
    return lap.tocsr(), mass.tocsr()


def threshold_distance(verts: np.ndarray, ratio: float = 0.05) -> float:
    """Bounding-box-relative match threshold
    (lbs_weights_inpainting_actorshq.py:203-221)."""
    diag = verts.max(0) - verts.min(0)
    return float(np.linalg.norm(diag)) * ratio


def vertex_normals(verts, faces):
    fn = np.cross(verts[faces[:, 1]] - verts[faces[:, 0]],
                  verts[faces[:, 2]] - verts[faces[:, 0]])
    vn = np.zeros_like(verts)
    for k in range(3):
        np.add.at(vn, faces[:, k], fn)
    return vn / np.maximum(np.linalg.norm(vn, axis=1, keepdims=True), 1e-12)


def segregate_by_confidence(src_verts, src_normals, dst_verts, dst_normals,
                            dist_ratio=0.05, angle_deg=15.0):
    """Confident matches: close AND normal-aligned
    (lbs_weights_inpainting_actorshq.py:222-234).  Returns (confident_idx,
    unconvinced_idx, closest_src_idx)."""
    from ..native import knn
    thr = threshold_distance(dst_verts, dist_ratio)
    d2, idx = knn.query(src_verts, dst_verts, 1)
    d = np.sqrt(d2[:, 0])
    closest = idx[:, 0]
    cosang = np.einsum("ij,ij->i", dst_normals, src_normals[closest])
    ok = (d <= thr) & (cosang >= np.cos(np.deg2rad(angle_deg)))
    conf = np.where(ok)[0]
    unconf = np.where(~ok)[0]
    return conf, unconf, closest


def inpaint_weights(mesh_v, mesh_f, lbs_w, unknown_idx):
    """Solve Q = -L + L M^-1 L per bone
    (lbs_weights_inpainting_actorshq.py:237-289)."""
    lap, mass = cotangent_laplacian(mesh_v, mesh_f)
    q = -lap + lap @ sp.diags(np.reciprocal(mass.diagonal())) @ lap

    n = len(mesh_v)
    unknown = np.asarray(sorted(set(map(int, unknown_idx))))
    known = np.asarray(sorted(set(range(n)) - set(unknown.tolist())))

    q_uu = sp.csr_matrix(q[np.ix_(unknown, unknown)])
    q_ui = sp.csr_matrix(q[np.ix_(unknown, known)])

    w = np.array(lbs_w, np.float64, copy=True)
    w_i = w[known]
    w_u = np.empty((len(unknown), w.shape[1]))
    lu = splinalg.splu(q_uu.tocsc())
    for bone in range(w.shape[1]):
        b = -q_ui @ w_i[:, bone]
        w_u[:, bone] = lu.solve(b)
    w[unknown] = w_u
    w = np.clip(w, 1e-10, 1.0)
    return (w / (w.sum(axis=1, keepdims=True) + 1e-10)).astype(np.float32)


def transfer_and_inpaint(body_verts, body_faces, body_weights,
                         target_verts, target_faces,
                         dist_ratio=0.05, angle_deg=15.0):
    """Full pipeline: direct-copy weights for confident matches, inpaint
    the rest (lbs_weights_inpainting :304-370)."""
    bn = vertex_normals(np.asarray(body_verts, np.float64),
                        np.asarray(body_faces))
    tn = vertex_normals(np.asarray(target_verts, np.float64),
                        np.asarray(target_faces))
    conf, unconf, closest = segregate_by_confidence(
        np.asarray(body_verts, np.float32), bn,
        np.asarray(target_verts, np.float32), tn, dist_ratio, angle_deg)
    w0 = np.zeros((len(target_verts), body_weights.shape[1]), np.float64)
    w0[conf] = body_weights[closest[conf]]
    if len(unconf) == 0:
        return w0.astype(np.float32)
    return inpaint_weights(np.asarray(target_verts, np.float64),
                           np.asarray(target_faces), w0, unconf)
