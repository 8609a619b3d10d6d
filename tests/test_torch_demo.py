"""The zero-shot demo in the port against the JAX package on the CPU.

The sand block, the orbit cameras, the extra gaussians' packs and the
face pruning (exact or <= 1e-6); ``build_demo_sim``'s state and model
(<= 1e-6) and the 50 release masks (identical) against the JAX function
on its dense path (``column_k=0, mesh_column_k=0, column_c_cap=0``: the
TPU layout is not ported); a cut demo sim, 2 frames x 100 substeps at
32^3 with the release windows live and the mover on, against the JAX
solver (x <= 2e-5, v <= 1e-3); a sheet thrown onto the 12-triangle
chair at 48^3, entering its box past the drape limit alike in both
packages (x <= 2e-5) and held on the seat by the same box split into 768
triangles; ``render_demo_frame`` with the sand, with
the chair, with both and with neither at 64^2 (<= 1e-5 off the alpha
cutoff's ties); ``load_chair_gaussians`` from an npz and a 3DGS PLY;
``data/make_demo_assets`` against scripts/make_demo_assets.py (identical
files, except the rig's faces: the JAX file's prefix slice keeps faces
that index past ``v_template``, the port's boolean mask keeps exactly
the in-range ones); ``train/run_demo`` cut against scripts/run_demo.py
run in a JAX subprocess (per-frame OBJs <= 1e-4); the release windows
that the demo's defaults leave dead."""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_avatar_render import _jax_avatar
from test_substep_golden import make_cloth
from test_torch_core import REPO, np_fields

from mpmavatar_tpu.render import gaussians as jg
from mpmavatar_tpu.render.cameras import Camera as JCamera
from mpmavatar_tpu.sim import SimTransform as JSimTransform
from mpmavatar_tpu.train import demo as jdemo

from mpmavatar_tpu_torch import convert
from mpmavatar_tpu_torch.data import make_demo_assets as tassets
from mpmavatar_tpu_torch.ops.composite import ALPHA_MIN
from mpmavatar_tpu_torch.render import bench_render
from mpmavatar_tpu_torch.render.rasterizer import (camera_arrays,
                                                   project_gaussians)
from mpmavatar_tpu_torch.render.geometry import \
    covariance_from_scaling_rotation
from mpmavatar_tpu_torch.render import gaussians as tg
from mpmavatar_tpu_torch.sim.solver import SimTransform
from mpmavatar_tpu_torch.train import demo as tdemo
from mpmavatar_tpu_torch.train import run_demo as trun
from mpmavatar_tpu_torch.utils.io import read_obj, write_obj

sys.path.insert(0, str(REPO / "scripts"))
import make_demo_assets as jassets  # noqa: E402

torch.set_num_threads(1)

EXACT_TOL = 1e-6
PATH_ATOL = {"x": 2e-5, "v": 1e-3}
FRAME_TOL = 1e-5
OBJ_TOL = 1e-4
SMALL_SAND = (20, 3, 6)
CHAIR_GRID = 48


def _t(a):
    return torch.as_tensor(np.array(a))


def _scene():
    """A 24 x 10 skirt on a small capsule, the chair box, 360 sand
    particles."""
    cloth_v, cloth_f = jassets.skirt_cloth(n_u=24, n_v=10)
    body_v, body_f = jassets.capsule_body(n_theta=12, n_phi=12)
    chair_v, chair_f = jassets.chair_box()
    col_v = np.concatenate([body_v, chair_v])
    col_f = np.concatenate([body_f, chair_f + len(body_v)])
    sand, vol = jdemo.get_sand(res=SMALL_SAND)
    return cloth_v, cloth_f, col_v, col_f, sand, vol


def test_get_sand_is_the_jax_block():
    for kw in ({}, {"res": SMALL_SAND, "seed": 3, "noise": 0.02}):
        a, b = tdemo.get_sand(**kw), jdemo.get_sand(**kw)
        for x, y in zip(a, b):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)


def test_orbit_cameras_match_jax():
    k = np.array([[1000.0, 0, 512], [0, 1000.0, 512], [0, 0, 1]])
    from mpmavatar_tpu_torch.render.cameras import Camera
    ours = tdemo.get_spherical_cam(Camera.from_kw2c("ref", 1024, 1024, k,
                                                    np.eye(4)), 7)
    ref = jdemo.get_spherical_cam(JCamera.from_kw2c("ref", 1024, 1024, k,
                                                    np.eye(4)), 7)
    assert len(ours) == len(ref) == 7
    for a, b in zip(ours, ref):
        for f in ("world_view_transform", "full_proj_transform",
                  "camera_center"):
            np.testing.assert_allclose(getattr(a, f), getattr(b, f),
                                       atol=EXACT_TOL)
        assert (a.image_width, a.fx, a.FoVy) == (b.image_width, b.fx, b.FoVy)
    np.testing.assert_array_equal(tdemo.pose_spherical(30.0, -10.0, 0, 1.1, 3),
                                  jdemo.pose_spherical(30.0, -10.0, 0, 1.1, 3))


def _chair(n=300, seed=5):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(n, 4))
    return {"xyz": rng.normal(0, 0.3, (n, 3)).astype(np.float32),
            "opacity": rng.uniform(0.3, 0.95, (n, 1)).astype(np.float32),
            "scale": rng.uniform(0.005, 0.03, (n, 3)).astype(np.float32),
            "rotation": (q / np.linalg.norm(q, axis=1, keepdims=True)
                         ).astype(np.float32)}, \
        rng.normal(0, 0.3, (n, 4, 3)).astype(np.float32)


def test_extra_attr_and_pruning_match_jax():
    chair, _ = _chair()
    sand = np.random.default_rng(1).normal(size=(50, 3)).astype(np.float32)
    color = np.random.default_rng(2).random((len(chair["xyz"]), 3)).astype(
        np.float32)
    ref = jdemo.get_extra_attr({k: jnp.asarray(v) for k, v in chair.items()},
                               jnp.asarray(color), jnp.asarray(sand))
    out = tdemo.get_extra_attr({k: _t(v) for k, v in chair.items()},
                               _t(color), _t(sand))
    for a, b in zip(jax.tree_util.tree_leaves(ref),
                    [x for grp in out for x in
                     (grp if isinstance(grp, tuple) else (grp,))]):
        np.testing.assert_allclose(a, b.numpy(), atol=EXACT_TOL)

    splats = jg.init_from_mesh(40, 1, capacity=48)
    splats = jg.GaussianParams(**{**np_fields(splats), "opacity": np.random
                                  .default_rng(3).normal(size=(48, 1))
                                  .astype(np.float32)})
    pruned = jdemo.prune_faces_opacity(splats, [0, 3, 17])
    ours = tdemo.prune_faces_opacity(convert.gaussians_from_numpy(
        np_fields(splats), "cpu"), [0, 3, 17])
    np.testing.assert_array_equal(ours.opacity.numpy(),
                                  np.asarray(pruned.opacity))


def _scenes(grid=32, nj=24):
    cloth_v, cloth_f, col_v, col_f, sand, vol = _scene()
    jtf = JSimTransform.from_verts(cloth_v)
    tf = SimTransform.from_verts(cloth_v)
    jb = jdemo.build_demo_sim(cloth_v, cloth_f, sand, vol, col_v, col_f,
                              jtf, grid_size=grid, num_joint_v=nj,
                              num_joint_f=nj, column_k=0, mesh_column_k=0,
                              column_c_cap=0)
    tb = tdemo.build_demo_sim(cloth_v, cloth_f, sand, vol, col_v, col_f, tf,
                              grid_size=grid, num_joint_v=nj,
                              num_joint_f=nj, device="cpu")
    return (cloth_v, cloth_f, col_v, sand, tf, jtf), jb, tb


def _live_windows(solver, time):
    """How many of the solver's velocity modifiers hold ``time`` in their
    window [start, end)."""
    return sum(float(m.start_time) <= time < float(m.end_time)
               for m in solver.colliders.velocity_modifiers)


def _release(solver, state, tf, sand, t0, t1):
    z = np.asarray(tf.wld2sim(sand if isinstance(tf, SimTransform)
                              else jnp.asarray(sand)))[:, 2]
    solver.release_particles_sequentially(state, [0.0, 0.0, 1.0],
                                          float(z.max()), float(z.min()),
                                          start_time=t0, end_time=t1)


def test_build_demo_sim_and_release_masks_match_jax():
    (_, _, _, sand, tf, jtf), (jcfg, jstate, jmodel, jsolver), \
        (cfg, state, model, solver) = _scenes()
    assert dataclass_dict(cfg) == {k: v for k, v in dataclass_dict(
        jcfg).items() if k in dataclass_dict(cfg)}
    assert cfg.material == 2 and cfg.n_traditional == len(sand)
    for name, ours, ref in (("state", state, jstate),
                            ("model", model, jmodel)):
        for k, v in convert.to_numpy(ours).items():
            r = np.asarray(getattr(ref, k))
            np.testing.assert_allclose(v, r, atol=EXACT_TOL * max(
                1.0, float(np.abs(r).max())), err_msg=f"{name}.{k}")
    assert len(solver.colliders.grid_post) == 1
    assert len(solver.colliders.mesh_colliders) == 1
    assert solver.colliders.use_particle_mover
    np.testing.assert_array_equal(
        solver.colliders.mesh_colliders[0].faces.numpy(),
        np.asarray(jsolver.colliders.mesh_colliders[0].faces))

    _release(jsolver, jstate, jtf, sand, 0.04, 0.12)
    _release(solver, state, tf, sand, 0.04, 0.12)
    jmods = jsolver.colliders.velocity_modifiers
    mods = solver.colliders.velocity_modifiers
    assert len(mods) == len(jmods) == 50
    for a, b in zip(mods, jmods):
        np.testing.assert_array_equal(a.mask.numpy(), np.asarray(b.mask))
        for f in ("velocity", "start_time", "end_time"):
            np.testing.assert_array_equal(getattr(a, f).numpy(),
                                          np.asarray(getattr(b, f)))
    # the boxes shrink layer by layer.  Each spans (0, 2) in x and y, so
    # it holds the cloth particles in the sand's z range; the sand itself
    # starts at sim y 2.26-2.30 with these assets (the skirt's bounding
    # box centres the transform at world y 0.525), above every box and
    # the grid: no box holds it.  Both packages select the same particles
    sizes = [int(m.mask.sum()) for m in mods]
    e, n_t = cfg.n_elements, cfg.n_traditional
    assert float(state.x[e:e + n_t, 1].min()) > 2.0
    assert not any(bool(m.mask[e:e + n_t].any()) for m in mods)
    assert sizes == sorted(sizes, reverse=True) and sizes[0] > 0


def dataclass_dict(obj):
    return dataclasses.asdict(obj)


def test_demo_sim_matches_the_jax_solver():
    """2 frames x 100 substeps (dt 1e-4), the release windows live from
    t = 0.005 and closing one after another to 0.02, the first 24 cloth
    vertices and faces driven by the mover, the collider (body + chair)
    moving in frame 0."""
    (cloth_v, cloth_f, col_v, sand, tf, jtf), \
        (jcfg, jstate, jmodel, jsolver), (cfg, state, model, solver) = \
        _scenes()
    _release(jsolver, jstate, jtf, sand, 0.005, 0.02)
    _release(solver, state, tf, sand, 0.005, 0.02)
    dt, n = 1e-4, 100
    rng = np.random.default_rng(7)
    jv = (0.05 * rng.normal(size=(24, 3))).astype(np.float32)
    jf = jv[np.minimum(cloth_f[:24], 23)].mean(1)
    mesh_x = np.asarray(jtf.wld2sim(jnp.asarray(col_v)))
    mesh_v = np.tile(np.float32([0.0, 0.2, 0.0]), (len(col_v), 1))
    t_j = t_p = 0.0
    held = None
    for f in range(2):
        mv = mesh_v if f == 0 else 0 * mesh_v
        jstate, t_j = jsolver.frame(jstate, jmodel, dt, n, t_j,
                                    mesh_x=jnp.asarray(mesh_x),
                                    mesh_v=jnp.asarray(mv),
                                    joint_verts_v=jnp.asarray(jv),
                                    joint_faces_v=jnp.asarray(jf))
        state, t_p = solver.frame(state, model, dt, n, t_p, mesh_x=mesh_x,
                                  mesh_v=mv, joint_verts_v=jv,
                                  joint_faces_v=jf)
        mesh_x = mesh_x + n * dt * mv
        if f == 0:
            held = _live_windows(solver, t_p)
    assert abs(t_p - float(t_j)) < 1e-7
    assert held > 0            # windows still live into frame 1
    for field, tol in PATH_ATOL.items():
        a = getattr(state, field).numpy()
        b = np.asarray(getattr(jstate, field))
        assert np.isfinite(a).all()
        err = float(np.abs(a - b).max())
        assert err <= tol, (field, err)
    # the sand moved (it fell from its block before the release)
    e = cfg.n_elements
    assert float(np.abs(state.x[e:e + cfg.n_traditional].numpy()
                        - np.asarray(jtf.wld2sim(jnp.asarray(sand)))
                        ).max()) > 1e-3



def _subdivide(verts, faces, k):
    """Each triangle split into k^2 by a barycentric lattice (shared edge
    vertices repeated)."""
    out_v, out_f = [], []
    for a, b, c in faces:
        idx = {}
        for i in range(k + 1):
            for j in range(k + 1 - i):
                idx[i, j] = len(out_v)
                out_v.append(verts[a] + (verts[b] - verts[a]) * i / k
                             + (verts[c] - verts[a]) * j / k)
        for i in range(k):
            for j in range(k - i):
                out_f.append([idx[i, j], idx[i + 1, j], idx[i, j + 1]])
                if i + j < k - 1:
                    out_f.append([idx[i + 1, j], idx[i + 1, j + 1],
                                  idx[i, j + 1]])
    return np.asarray(out_v, np.float32), np.asarray(out_f, np.int32)


def _chair_drop(package, chair_v, chair_f, grid=CHAIR_GRID):
    """An 8 x 8 sheet 0.02 above the chair's seat, thrown down at 5 (sim
    units / s) for 150 substeps (dt 1e-4) onto the chair alone, under the
    demo's transform: the sheet's sim positions."""
    sheet_v, sheet_f = make_cloth(nx=8, ny=8, y0=0.0, extent=1.0)
    sheet_v = ((sheet_v - [1.0, 0.0, 1.0]) * [0.5, 0.0, 0.4]
               + [0.0, 0.52, -0.55]).astype(np.float32)
    skirt = jassets.skirt_cloth(n_u=24, n_v=10)[0]
    sand, vol = jdemo.get_sand(res=SMALL_SAND)
    mesh_x = np.asarray(SimTransform.from_verts(skirt).wld2sim(chair_v))
    if package == "jax":
        cfg, state, model, solver = jdemo.build_demo_sim(
            sheet_v, sheet_f, sand, vol, chair_v, chair_f,
            JSimTransform.from_verts(skirt), grid_size=grid, column_k=0,
            mesh_column_k=0, column_c_cap=0)
        asarray = jnp.asarray
    else:
        cfg, state, model, solver = tdemo.build_demo_sim(
            sheet_v, sheet_f, sand, vol, chair_v, chair_f,
            SimTransform.from_verts(skirt), grid_size=grid, device="cpu")
        asarray = torch.as_tensor
    e, n_t = cfg.n_elements, cfg.n_traditional
    v = np.zeros((cfg.n_particles, 3), np.float32)
    v[:e, 1] = v[e + n_t:, 1] = -5.0
    state = dataclasses.replace(state, v=asarray(v))
    state, _ = solver.frame(state, model, 1e-4, 150, 0.0,
                            mesh_x=asarray(mesh_x),
                            mesh_v=asarray(np.zeros_like(mesh_x)))
    return np.asarray(state.x)[e + n_t:], mesh_x.min(0), mesh_x.max(0)


def test_chair_box_collides_only_near_its_face_centroids():
    """The collider splats each face as one point at its centroid, so
    make_demo_assets' 12-triangle chair acts only near 12 points: a sheet
    thrown onto the seat passes into the box past the drape limit (two
    cells) in both packages alike, and stays on the seat when the same
    box is split into 768 triangles."""
    chair_v, chair_f = jassets.chair_box()

    def depth(x, lo, hi):
        d = np.minimum(x - lo, hi - x)
        return np.where((d > 0).all(1), d.min(1), 0.0)

    ours, lo, hi = _chair_drop("port", chair_v, chair_f)
    ref, _, _ = _chair_drop("jax", chair_v, chair_f)
    assert float(np.abs(ours - ref).max()) <= PATH_ATOL["x"]
    limit = 2.0 / CHAIR_GRID
    d_ours, d_ref = depth(ours, lo, hi), depth(ref, lo, hi)
    np.testing.assert_allclose(d_ours, d_ref, atol=PATH_ATOL["x"])
    assert float(d_ref.max()) > limit and int((d_ref > limit).sum()) > 0
    dense, _, _ = _chair_drop("port", *_subdivide(chair_v, chair_f, 8))
    assert float(depth(dense, lo, hi).max()) <= limit

def _near_cutoff(xyz, cov, opacity, ca, w, h, rel=1e-4):
    m2d, _, conic, _, vis = project_gaussians(xyz, cov, ca, w, h)
    op = opacity * vis
    py, px = torch.meshgrid(torch.arange(h), torch.arange(w), indexing="ij")
    dx = px.reshape(-1, 1) - m2d[None, :, 0]
    dy = py.reshape(-1, 1) - m2d[None, :, 1]
    power = -0.5 * (conic[:, 0] * dx * dx + conic[:, 2] * dy * dy) \
        - conic[:, 1] * dx * dy
    alpha = op * torch.exp(torch.clamp_max(power, 0.0))
    return ((alpha - ALPHA_MIN).abs() < rel * ALPHA_MIN).any(1).reshape(
        h, w).numpy()


@pytest.mark.parametrize("sand_on,chair_on,degree",
                         [(True, False, 1), (False, True, 1),
                          (True, True, 1), (False, False, 1),
                          (True, True, 3)],
                         ids=["sand", "chair", "both", "neither",
                              "both, degree 3 over the chair's 4"])
def test_render_demo_frame_matches_jax(sand_on, chair_on, degree):
    """At degree 3 the chair's 4 SH coefficients are read past their end:
    JAX's gather clamps the index to the last one, and so does the
    port."""
    javatar, jparams, arrays = _jax_avatar()
    avatar = convert.mesh_avatar_from_numpy(
        {k: getattr(javatar, k) for k in javatar.__dataclass_fields__})
    params = convert.avatar_params_from_numpy(**arrays, device="cpu")
    w = h = 64
    cam = bench_render.look_down_z(w, h, 1400.0 * w / 1500, 2.6, 0.1, 20.0)
    rng = np.random.default_rng(8)
    sand = (rng.uniform(-0.3, 0.3, (300, 3)) + [0.0, 0.0, -0.5]).astype(
        np.float32)
    chair, shs = _chair()
    chair["xyz"][:, 2] -= 0.3
    kw = dict(active_sh_degree=degree, tile_capacity=256,
              tile_capacity_lo=64, hot_tiles=8)
    ref, rout = jdemo.render_demo_frame(
        javatar, jparams, javatar.select_verts(jparams, 1),
        jnp.asarray(javatar.ao_maps[1]), cam, 2,
        sand_xyz=jnp.asarray(sand) if sand_on else None,
        chair={k: jnp.asarray(v) for k, v in chair.items()} if chair_on
        else None, chair_shs=jnp.asarray(shs), **kw)
    verts = avatar.select_verts(params, 1)
    img, out = tdemo.render_demo_frame(
        avatar, params, verts, avatar.tensor("ao_maps", "cpu")[1], cam, 2,
        sand_xyz=_t(sand) if sand_on else None,
        chair={k: _t(v) for k, v in chair.items()} if chair_on else None,
        chair_shs=_t(shs), **kw)
    assert int(rout["big_overflow"]) == 0 and int(out["big_overflow"]) == 0
    # the pixels with any alpha near the cutoff, over every gaussian drawn
    frames = avatar.frames_for_verts(verts)
    xyz = [tg.get_xyz(params.splats, frames)]
    cov = [tg.get_covariance(params.splats, frames)]
    op = [tg.get_opacity(params.splats)[:, 0] * params.splats.alive]
    if sand_on:
        xyz.append(_t(sand))
        cov.append(covariance_from_scaling_rotation(
            torch.full((300, 3), tdemo.SAND_SCALE), 1.0,
            torch.tensor([[1.0, 0, 0, 0]]).expand(300, 4)))
        op.append(torch.ones(300))
    if chair_on:
        xyz.append(_t(chair["xyz"]))
        cov.append(covariance_from_scaling_rotation(
            _t(chair["scale"]), 1.0, _t(chair["rotation"])))
        op.append(_t(chair["opacity"])[:, 0])
    tied = _near_cutoff(torch.cat(xyz), torch.cat(cov), torch.cat(op),
                        camera_arrays(cam, "cpu"), w, h)
    assert tied.sum() <= 0.01 * w * h
    np.testing.assert_allclose(img.numpy()[:, ~tied],
                               np.asarray(ref)[:, ~tied], atol=FRAME_TOL)
    assert float(img.min()) >= 0.0 and float(img.max()) <= 1.0


def test_render_demo_frame_sand_changes_the_frame():
    javatar, jparams, arrays = _jax_avatar()
    avatar = convert.mesh_avatar_from_numpy(
        {k: getattr(javatar, k) for k in javatar.__dataclass_fields__})
    params = convert.avatar_params_from_numpy(**arrays, device="cpu")
    cam = bench_render.look_down_z(64, 64, 60.0, 2.6, 0.1, 20.0)
    sand = _t((np.random.default_rng(3).uniform(-0.2, 0.2, (200, 3))
               + [0.0, 0.0, -0.6]).astype(np.float32))
    verts = avatar.select_verts(params, 1)
    ao = avatar.tensor("ao_maps", "cpu")[1]
    plain, _ = tdemo.render_demo_frame(avatar, params, verts, ao, cam, 0,
                                       tile_capacity=128)
    with_sand, _ = tdemo.render_demo_frame(avatar, params, verts, ao, cam, 0,
                                           sand_xyz=sand, tile_capacity=128)
    assert torch.isfinite(with_sand).all()
    assert float((with_sand - plain).abs().max()) > 0.01


def test_load_chair_gaussians_both_formats(tmp_path):
    chair, shs = _chair(n=40)
    npz = str(tmp_path / "chair.npz")
    np.savez(npz, shs=shs, **{k: (v[:, 0] if k == "opacity" else v)
                              for k, v in chair.items()})
    from mpmavatar_tpu.utils.io import write_ply_gaussians
    ply = str(tmp_path / "chair.ply")
    rng = np.random.default_rng(0)
    write_ply_gaussians(ply, chair["xyz"], shs[:, :1], shs[:, 1:],
                        rng.normal(size=(40, 1)).astype(np.float32),
                        np.log(chair["scale"]), chair["rotation"])
    for path in (npz, ply):
        ref, rshs = jdemo.load_chair_gaussians(path)
        ours, oshs = tdemo.load_chair_gaussians(path, device="cpu")
        assert set(ours) == set(ref)
        for k in ref:
            np.testing.assert_allclose(ours[k].numpy(), np.asarray(ref[k]),
                                       atol=EXACT_TOL, err_msg=k)
        np.testing.assert_allclose(oshs.numpy(), np.asarray(rshs),
                                   atol=EXACT_TOL)


_JAX_RUNNER = """
import runpy, sys
args = sys.argv[1:]
cut = args.index("--")
import mpmavatar_tpu.train.demo as D
get_sand, build = D.get_sand, D.build_demo_sim
D.get_sand = lambda: get_sand(res=%r)
D.build_demo_sim = lambda *a, **k: build(*a, column_k=0, mesh_column_k=0,
                                         column_c_cap=0, **k)
for script, argv in (("make_demo_assets", args[:cut]),
                     ("run_demo", args[cut + 1:])):
    sys.argv = [script + ".py"] + argv
    runpy.run_path("scripts/" + script + ".py", run_name="__main__")
""" % (SMALL_SAND,)


def _demo_flags(root):
    """The cut demo on the port's assets under ``root``: the skirt cut to
    24 x 10, the pose playback over the 3 poses, 32^3, 100 substeps a
    frame, the release from frame 1, 24 pinned vertices and faces."""
    a = root / "port"
    return ["--cloth_obj", str(root / "cloth.obj"), "--body_obj",
            str(a / "body.obj"), "--chair_obj", str(a / "chair.obj"),
            "--smplx_model_npz", str(a / "smplx_model.npz"),
            "--first_smplx_npz", str(a / "first_smplx.npz"), "--pose_npz",
            str(a / "pose_seq.npz"), "--extra_frames", "0", "--grid_size",
            "32", "--substep", "100", "--sand_release_frame", "1",
            "--num_joint_v", "24", "--num_joint_f", "24"]


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    """Both packages' demo assets (3 poses), and scripts/run_demo.py's cut
    demo (``_demo_flags``, the sand cut to SMALL_SAND) on the port's
    assets in ``jax_demo``: both JAX scripts in one subprocess."""
    root = tmp_path_factory.mktemp("demo_assets")
    tassets.main(["--out", str(root / "port"), "--n_poses", "3"])
    v, f = jassets.skirt_cloth(n_u=24, n_v=10)
    write_obj(str(root / "cloth.obj"), v, f)
    proc = subprocess.run(
        [sys.executable, "-c", _JAX_RUNNER, "--out", str(root / "jax"),
         "--n_poses", "3", "--", *_demo_flags(root), "--out_dir",
         str(root / "jax_demo")], cwd=REPO, capture_output=True, text=True,
        timeout=600, env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    return root

def _files(d):
    return sorted(os.path.relpath(os.path.join(r, f), d)
                  for r, _, fs in os.walk(d) for f in fs)


def test_make_demo_assets_matches_the_jax_script(assets):
    port, ref = assets / "port", assets / "jax"
    assert _files(port) == _files(ref) and len(_files(port)) == 10
    for rel in _files(ref):
        if rel.endswith(".npz"):
            a, b = np.load(port / rel), np.load(ref / rel)
            assert sorted(a.files) == sorted(b.files), rel
            for k in b.files:
                if rel == "smplx_model.npz" and k == "f":
                    continue
                np.testing.assert_array_equal(a[k], b[k], err_msg=rel + k)
        else:
            assert (port / rel).read_bytes() == (ref / rel).read_bytes(), rel


def test_make_demo_assets_rig_faces_are_masked(assets):
    """The JAX file keeps faces past the template and drops valid ones;
    the port's keeps exactly the faces whose vertices all lie in it."""
    a, b = np.load(assets / "port" / "smplx_model.npz"), \
        np.load(assets / "jax" / "smplx_model.npz")
    n = len(b["v_template"])
    body_f = jassets.capsule_body(n_theta=121, n_phi=87)[1]
    inside = (body_f < n).all(1)
    assert int(b["f"].max()) >= n                      # the JAX file's fault
    assert int((b["f"] >= n).any(1).sum()) > 0
    assert len(b["f"]) == int(inside.sum())             # same count, wrong set
    np.testing.assert_array_equal(a["f"], body_f[inside])
    assert int(a["f"].max()) < n
    # the port's rig loads and poses through the 22-joint chain
    from mpmavatar_tpu_torch.avatar.smplx import load_smplx_npz, \
        smplx_forward
    rig = load_smplx_npz(str(assets / "port" / "smplx_model.npz"),
                         device="cpu")
    assert len(rig.parents) == 22 and rig.posedirs.shape[0] == 189
    pose = dict(np.load(assets / "port" / "pose_seq.npz"))
    out = smplx_forward(rig, {k: _t(v) for k, v in pose.items()})
    assert out.vertices.shape == (3, n, 3)
    assert torch.isfinite(out.vertices).all()



def test_run_demo_cli_matches_the_jax_script(assets, tmp_path,
                                            monkeypatch):
    """``_demo_flags``' cut demo, the sand cut to SMALL_SAND: both
    packages' per-frame OBJs."""
    monkeypatch.setattr(trun, "get_sand",
                        lambda: tdemo.get_sand(res=SMALL_SAND))
    res = trun.main(_demo_flags(assets) + ["--out_dir", str(tmp_path),
                                           "--device", "cpu"],
                    log=lambda s: None)
    assert len(res["frame_s"]) == 3
    for i in range(3):
        for sub in ("uvmesh", "sand"):
            pv, pf = read_obj(str(tmp_path / sub / f"{i:03d}.obj"))
            jv, jf = read_obj(str(assets / "jax_demo" / sub /
                                  f"{i:03d}.obj"))
            np.testing.assert_array_equal(pf, jf)
            assert np.isfinite(pv).all()
            np.testing.assert_allclose(pv, jv, atol=OBJ_TOL,
                                       err_msg=f"{sub} {i}")

def test_release_windows_under_the_demo_defaults():
    """The demo's defaults with the assets' 30 poses: 160 frames, the
    release from frame 100 (t = 4.0 s) to frame 160 (6.4 s).  Layer i's
    window ends at 6.4 / 50 (i + 1), so layers 0-30 (the largest boxes)
    never open: the JAX package's semantics, kept."""
    _, (jcfg, jstate, _, jsolver), (cfg, state, _, solver) = _scenes()
    sand = tdemo.get_sand(res=SMALL_SAND)[0]
    tf = SimTransform.from_verts(_scene()[0])
    t0, t1 = 100 / 25.0, 100 / 25.0 + 60 / 25.0
    _release(solver, state, tf, sand, t0, t1)
    ends = [float(m.end_time) for m in solver.colliders.velocity_modifiers]
    dead = [i for i, e in enumerate(ends) if e <= t0]
    assert dead == list(range(31))
    assert _live_windows(solver, t0) == 19
    assert _live_windows(solver, t0 - 1e-3) == 0
