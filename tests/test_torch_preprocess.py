"""The port's mesh preprocessing against the JAX package's on the CPU:
the garment split with and without fixed vertices (identical arrays),
the cotangent Laplacian and the LBS inpainting's sparse solve (<= 1e-6),
the whole weight transfer through each package's native KD-tree, the
mesh cleaning (identical) and the UV attachment (identical files)."""

import os

import numpy as np
import pytest

from test_substep_golden import make_cloth

from mpmavatar_tpu.preprocess import garment_split as jgs
from mpmavatar_tpu.preprocess import lbs_inpainting as jli
from mpmavatar_tpu.preprocess import mesh_cleaning as jmc
from mpmavatar_tpu.preprocess import uv_attach as jua

from mpmavatar_tpu_torch.preprocess import garment_split as tgs
from mpmavatar_tpu_torch.preprocess import lbs_inpainting as tli
from mpmavatar_tpu_torch.preprocess import mesh_cleaning as tmc
from mpmavatar_tpu_torch.preprocess import uv_attach as tua

SOLVE_TOL = 1e-6


def _same(a, b):
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                      err_msg=k)
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k


@pytest.mark.parametrize("fixed", [False, True], ids=["dilate", "fixed"])
def test_garment_split_matches_jax(fixed):
    verts, faces = make_cloth(nx=12, ny=12)
    is_cloth = verts[faces].mean(1)[:, 0] < 1.0
    fix_v = np.arange(0, 24) if fixed else None
    _same(tgs.split_cloth_human(verts, faces, is_cloth, fix_v, 2),
          jgs.split_cloth_human(verts, faces, is_cloth, fix_v, 2))


def test_cotangent_laplacian_matches_jax():
    verts, faces = make_cloth(nx=9, ny=7)
    verts = verts + 0.01 * np.random.default_rng(0).normal(size=verts.shape)
    for a, b in zip(tli.cotangent_laplacian(verts, faces),
                    jli.cotangent_laplacian(verts, faces)):
        assert abs(a - b).max() <= SOLVE_TOL * abs(b).max()


def test_inpaint_weights_matches_jax():
    verts, faces = make_cloth(nx=10, ny=10)
    t = (verts[:, 0] - verts[:, 0].min()) / np.ptp(verts[:, 0])
    w = np.stack([1 - t, t, 0.5 * t * (1 - t)], -1)
    unknown = np.where((t > 0.3) & (t < 0.7))[0]
    w[unknown] = 0.0
    out = tli.inpaint_weights(verts, faces, w, unknown)
    ref = jli.inpaint_weights(verts, faces, w, unknown)
    assert out.dtype == ref.dtype
    np.testing.assert_allclose(out, ref, atol=SOLVE_TOL, rtol=0)


def test_transfer_and_inpaint_matches_jax():
    """A body cloth and a target cloth 0.02 above it, half of it tilted
    away, so some vertices match confidently and the rest are solved."""
    body_v, body_f = make_cloth(nx=12, ny=12)
    tgt_v, tgt_f = make_cloth(nx=9, ny=9)
    tgt_v = tgt_v + np.asarray([0.0, 0.02, 0.0], np.float32)
    far = tgt_v[:, 0] > 1.1
    tgt_v[far, 1] += 0.8 * (tgt_v[far, 0] - 1.1)
    rng = np.random.default_rng(1)
    bw = rng.random((len(body_v), 4))
    bw /= bw.sum(1, keepdims=True)
    out = tli.transfer_and_inpaint(body_v, body_f, bw, tgt_v, tgt_f)
    ref = jli.transfer_and_inpaint(body_v, body_f, bw, tgt_v, tgt_f)
    conf, unconf, _ = tli.segregate_by_confidence(
        body_v, tli.vertex_normals(body_v.astype(np.float64), body_f),
        tgt_v, tli.vertex_normals(tgt_v.astype(np.float64), tgt_f))
    assert len(conf) and len(unconf)
    np.testing.assert_allclose(out, ref, atol=SOLVE_TOL, rtol=0)


def test_clean_mesh_matches_jax():
    verts, faces = make_cloth(nx=8, ny=8)
    rgb = np.random.default_rng(2).random((len(faces), 3)).astype(np.float32)
    rgb[::5] = 0.0                        # near-black ghosts
    out, ref = tmc.clean_mesh(verts, faces, rgb), jmc.clean_mesh(verts,
                                                                 faces, rgb)
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a, b)


def test_attach_uv_matches_jax(tmp_path):
    verts, faces = make_cloth(nx=5, ny=4)
    mesh_dir = tmp_path / "meshes"
    mesh_dir.mkdir()
    for i in range(2):
        with open(mesh_dir / f"mesh_cloth_{i}.obj", "w") as f:
            for v in verts + 0.01 * i:
                f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
            for fc in faces:
                f.write(f"f {fc[0] + 1} {fc[1] + 1} {fc[2] + 1}\n")
    uv = tmp_path / "uv.obj"
    with open(uv, "w") as f:
        for v in verts:
            f.write(f"vt {v[0] / 2:.5f} {v[2] / 2:.5f}\n")
        for fc in faces:
            f.write("f " + " ".join(f"{i + 1}/{i + 1}" for i in fc) + "\n")
    outs = tua.attach_uv_sequence(str(mesh_dir), str(uv),
                                  str(tmp_path / "port"))
    refs = jua.attach_uv_sequence(str(mesh_dir), str(uv),
                                  str(tmp_path / "jax"))
    assert [os.path.basename(p) for p in outs] == \
        [os.path.basename(p) for p in refs] and len(outs) == 2
    for a, b in zip(outs, refs):
        assert open(a).read() == open(b).read()
