"""Layered garments in the port against the JAX package on the CPU:
``train/merge_meshes`` against scripts/merge_meshes.py (identical files),
and the two-pass flow of tests/test_layered_garments.py (an upper and a
lower garment simulated apart by the port's ``MaterialTrainer``, each
pass writing full meshes, the merge CLI, the geometry metrics) against
the same flow through the JAX trainer on its dense path (the rollouts
within 1e-4, the merged frames within 1e-4, the metrics within 1e-3 of
their values)."""

import os
import sys

import numpy as np
import pytest

from test_substep_golden import make_cloth
from test_torch_core import REPO

from mpmavatar_tpu.train.evaluate import geometry_metrics as j_metrics
from mpmavatar_tpu.train.material import MaterialTrainer as JTrainer
from mpmavatar_tpu.train.material import \
    MaterialTrainerConfig as JTrainerConfig

from mpmavatar_tpu_torch.train import merge_meshes
from mpmavatar_tpu_torch.train.evaluate import geometry_metrics
from mpmavatar_tpu_torch.train.material import (MaterialTrainer,
                                                MaterialTrainerConfig)
from mpmavatar_tpu_torch.utils.io import read_obj, write_obj

sys.path.insert(0, str(REPO / "scripts"))
import merge_meshes as jmerge  # noqa: E402

SIM_TOL = 1e-4
N_FRAMES = 2


def _write_passes(root, sims_u, sims_l, uv, lv, faces):
    """Each pass's full meshes: its own garment simulated, the other as
    tracked."""
    n_u = len(uv)
    upper, lower = np.arange(n_u), np.arange(n_u, n_u + len(lv))
    for seq, sims, own, other_v, other in (("s_upper", sims_u, upper, lv,
                                            lower),
                                           ("s_lower", sims_l, lower, uv,
                                            upper)):
        d = os.path.join(root, seq, "uvmesh")
        os.makedirs(d, exist_ok=True)
        for i, v in enumerate(sims):
            full = np.zeros((n_u + len(lv), 3), np.float32)
            full[own], full[other] = v, other_v
            write_obj(os.path.join(d, f"{i:03d}.obj"), full, faces)
    split = os.path.join(root, "split_idx_upper.npz")
    np.savez(split, reordered_cloth_v_idx=upper)
    return split


def test_merge_meshes_matches_the_jax_script(tmp_path):
    rng = np.random.default_rng(0)
    uv, uf = make_cloth(nx=4, ny=4, y0=1.1)
    lv, lf = make_cloth(nx=5, ny=4, y0=1.0)
    faces = np.concatenate([uf, lf + len(uv)])
    sims_u = [uv + rng.normal(0, 0.01, uv.shape) for _ in range(3)]
    sims_l = [lv + rng.normal(0, 0.01, lv.shape) for _ in range(3)]
    outs = {}
    for name, run in (("port", merge_meshes.main), ("jax", jmerge.main)):
        root = tmp_path / name
        split = _write_passes(str(root), sims_u, sims_l, uv, lv, faces)
        args = ["--seq", "s", "--output_dir", str(root),
                "--split_idx_upper", split]
        if name == "port":
            assert run(args, log=lambda s: None) == 3
        else:
            run(args)
        outs[name] = root / "s" / "uvmesh"
    names = sorted(os.listdir(outs["jax"]))
    assert names == sorted(os.listdir(outs["port"])) and len(names) == 3
    for n in names:
        assert (outs["port"] / n).read_bytes() == \
            (outs["jax"] / n).read_bytes()


def test_merge_meshes_rejects_unequal_frame_counts(tmp_path):
    for seq, n in (("s_upper", 2), ("s_lower", 1)):
        d = tmp_path / seq / "uvmesh"
        d.mkdir(parents=True)
        for i in range(n):
            write_obj(str(d / f"{i:03d}.obj"), np.zeros((3, 3)), [[0, 1, 2]])
    with pytest.raises(RuntimeError, match="frame count mismatch"):
        merge_meshes.merge_dirs(str(tmp_path / "s_upper" / "uvmesh"),
                                str(tmp_path / "s_lower" / "uvmesh"),
                                str(tmp_path / "out"), [0])


def _simulate(verts, faces, jax_side):
    """One physics pass on one garment (tests/test_layered_garments.py's
    set-up): 32^3, 5 substeps a frame, a still quad below."""
    body = np.array([[0.6, 0.85, 0.6], [1.4, 0.85, 0.6],
                     [1.4, 0.85, 1.4], [0.6, 0.85, 1.4]], np.float32)
    body_f = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    smplx = np.stack([body] * (N_FRAMES + 1))
    train = np.stack([verts] * (N_FRAMES + 1))
    knobs = dict(grid_size=32, substep=5, iterations=1)
    if jax_side:
        tr = JTrainer(JTrainerConfig(**knobs, column_k=0, column_c_cap=0,
                                     mesh_column_k=0), faces, verts, train,
                      smplx, body_f, num_joint_v=0, num_joint_f=0)
    else:
        tr = MaterialTrainer(MaterialTrainerConfig(**knobs), faces, verts,
                             train, smplx, body_f, num_joint_v=0,
                             num_joint_f=0, device="cpu")
    return tr.simulate(verts, np.zeros_like(verts), smplx[:-1],
                       (smplx[1:] - smplx[:-1]) * 25.0, n_frames=N_FRAMES)


def test_layered_two_pass_flow_matches_jax(tmp_path):
    uv, uf = make_cloth(nx=5, ny=5, y0=1.1, extent=0.4)
    lv, lf = make_cloth(nx=5, ny=5, y0=1.0, extent=0.4)
    faces = np.concatenate([uf, lf + len(uv)])
    sims = {side: (_simulate(uv, uf, side), _simulate(lv, lf, side))
            for side in (True, False)}
    for (ju, jl), (pu, pl) in [(sims[True], sims[False])]:
        for a, b in zip(pu + pl, ju + jl):
            assert np.isfinite(a).all()
            np.testing.assert_allclose(a, b, atol=SIM_TOL)
    pu, pl = sims[False]
    assert pu[-1][:, 1].mean() < uv[:, 1].mean()      # both fell
    assert pl[-1][:, 1].mean() < lv[:, 1].mean()

    split = _write_passes(str(tmp_path), pu, pl, uv, lv, faces)
    assert merge_meshes.main(["--seq", "s", "--output_dir", str(tmp_path),
                              "--split_idx_upper", split],
                             log=lambda s: None) == N_FRAMES
    merged = tmp_path / "s" / "uvmesh"
    n_u = len(uv)
    for i, name in enumerate(sorted(os.listdir(merged))):
        mv, mf = read_obj(str(merged / name))
        np.testing.assert_array_equal(mf, faces)
        np.testing.assert_allclose(mv[:n_u], pu[i], atol=1e-5)
        np.testing.assert_allclose(mv[n_u:], pl[i], atol=1e-5)
    gt = np.concatenate([uv, lv])
    ours = geometry_metrics(mv, faces, gt, faces, sample_count=2000)
    ref = j_metrics(mv, faces, gt, faces, sample_count=2000)
    assert set(ours) == set(ref)
    for k in ref:
        assert np.isfinite(ours[k])
        assert abs(ours[k] - ref[k]) <= 1e-3 * max(1.0, abs(ref[k])), k
    assert ours["CD"] < 100.0
