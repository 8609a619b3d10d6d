"""The port's host utilities (mpmavatar_tpu_torch/utils and native)
against the JAX package's, on the CPU: OBJ files (the native and the
Python parser) and PLY files written by one package and read by the
other, npz checkpoints read both ways, the torch checkpoint round trip
and ``latest_checkpoint``, the native KNN and ``mean_dist2_3nn`` against
the JAX package's native library and brute force, the mesh preview's
image, ``RunLogger``'s JSONL, ``trace`` with a span in it,
``expon_lr_func``, ``safe_state`` and ``run_subprocess``.

Files, images, parsed arrays, checkpoint leaves and KNN results are held
exactly; schedules to float64 rounding.
"""

import dataclasses
import json
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpmavatar_tpu import native as jnative
from mpmavatar_tpu.render.cameras import Camera as JCamera
from mpmavatar_tpu.utils import checkpoint as jckpt
from mpmavatar_tpu.utils import io as jio
from mpmavatar_tpu.utils import logging as jlogging
from mpmavatar_tpu.utils import mesh_preview as jpreview
from mpmavatar_tpu.utils import misc as jmisc
from mpmavatar_tpu.utils import schedules as jsched

from mpmavatar_tpu_torch import native
from mpmavatar_tpu_torch.render.cameras import Camera
from mpmavatar_tpu_torch.utils import (checkpoint, io, logging, mesh_preview,
                                       misc, profiling, schedules)

torch.set_num_threads(1)


def _mesh(seed=0, n=37, m=20):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, 3)).astype(np.float32),
            rng.integers(0, n, (m, 3)).astype(np.int32))


# ----------------------------------------------------------------------
# OBJ and PLY
# ----------------------------------------------------------------------
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_obj_written_by_one_package_reads_the_same_in_both(tmp_path, writer):
    verts, faces = _mesh()
    path = tmp_path / "m.obj"
    (jio if writer == "jax" else io).write_obj(
        str(path), verts if writer == "jax" else torch.as_tensor(verts),
        faces)
    ref = jio.read_obj(str(path))
    for out in (io.read_obj(str(path)), io._read_obj_py(str(path)),
                native.fast_obj.read_obj(str(path))):
        assert out[0].dtype == np.float32 and out[1].dtype == np.int32
        assert np.array_equal(out[0], ref[0])
        assert np.array_equal(out[1], ref[1])
    np.testing.assert_allclose(ref[0], verts, atol=1e-6)
    assert np.array_equal(ref[1], faces)


def test_write_obj_text_is_the_jax_text(tmp_path):
    verts, faces = _mesh(1)
    extra = ["vt 0.1 0.2\n", "vt 0.3 0.4\n"]
    jio.write_obj(str(tmp_path / "a.obj"), verts, faces, extra_lines=extra)
    io.write_obj(str(tmp_path / "b.obj"), torch.as_tensor(verts),
                 torch.as_tensor(faces), extra_lines=extra)
    assert (tmp_path / "a.obj").read_bytes() == \
        (tmp_path / "b.obj").read_bytes()


def test_obj_with_uv_faces_parses_in_the_native_and_python_readers(
        tmp_path):
    p = tmp_path / "uv.obj"
    p.write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nvt 0.1 0.2\nvt 0.3 0.4\n"
                 "vt 0.5 0.6\nf 1/1 2/2 3/3\n")
    for out in (native.fast_obj.read_obj(str(p)), io._read_obj_py(str(p))):
        assert out[0].shape == (3, 3)
        assert np.array_equal(out[1], [[0, 1, 2]])


def test_read_obj_falls_back_to_python_and_says_so_once(tmp_path,
                                                        monkeypatch,
                                                        caplog):
    verts, faces = _mesh(2)
    io.write_obj(str(tmp_path / "m.obj"), verts, faces)

    def no_compiler():
        raise FileNotFoundError("g++")

    monkeypatch.setattr(native, "build", no_compiler)
    monkeypatch.setattr(io, "_native_failure_logged", False)
    with caplog.at_level("WARNING"):
        a = io.read_obj(str(tmp_path / "m.obj"))
        b = io.read_obj(str(tmp_path / "m.obj"))
    assert sum("native OBJ parser unavailable" in r.message
               for r in caplog.records) == 1
    ref = jio.read_obj(str(tmp_path / "m.obj"))
    for out in (a, b):
        assert np.array_equal(out[0], ref[0])
        assert np.array_equal(out[1], ref[1])


def _gaussians(seed=0, n=50):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    return dict(xyz=f(n, 3), features_dc=f(n, 1, 3), features_rest=f(n, 15, 3),
                opacity=f(n, 1), scaling=f(n, 3), rotation=f(n, 4),
                binding=rng.integers(0, 100, n).astype(np.int32))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_gaussian_ply_written_by_one_package_reads_in_the_other(tmp_path,
                                                                writer):
    g = _gaussians()
    path = str(tmp_path / "point_cloud.ply")
    if writer == "jax":
        jio.write_ply_gaussians(path, **g)
    else:
        io.write_ply_gaussians(path, **{k: torch.as_tensor(v)
                                        for k, v in g.items()})
    out, ref = io.read_ply_gaussians(path), jio.read_ply_gaussians(path)
    for k in g:
        assert np.array_equal(out[k], ref[k]), k
        assert np.array_equal(out[k].reshape(g[k].shape), g[k]), k


def test_gaussian_ply_bytes_are_the_jax_bytes(tmp_path):
    g = _gaussians(1)
    jio.write_ply_gaussians(str(tmp_path / "a.ply"), **g)
    io.write_ply_gaussians(str(tmp_path / "b.ply"), **g)
    assert (tmp_path / "a.ply").read_bytes() == \
        (tmp_path / "b.ply").read_bytes()


def test_mesh_ply_with_faces_reads_the_same_in_both(tmp_path):
    verts, faces = _mesh(3)
    el = np.empty(len(verts), dtype=[("x", "f4"), ("y", "f4"), ("z", "f4")])
    for i, a in enumerate("xyz"):
        el[a] = verts[:, i]
    io._write_ply_binary(str(tmp_path / "m.ply"), "vertex", el,
                         face_lists=list(faces))
    out, ref = io.read_ply(str(tmp_path / "m.ply")), \
        jio.read_ply(str(tmp_path / "m.ply"))
    assert np.array_equal(out[0], ref[0]) and np.array_equal(out[1], ref[1])
    assert np.array_equal(out[0], verts) and np.array_equal(out[1], faces)


# ----------------------------------------------------------------------
# checkpoints
# ----------------------------------------------------------------------
@dataclasses.dataclass
class _Pair:
    first: object
    second: object


jax.tree_util.register_dataclass(_Pair, data_fields=["first", "second"],
                                 meta_fields=[])


def _tree(seed=0):
    """A nested tree whose dict keys are out of order, with a list, a
    tuple, a dataclass and a None: the flattening order matters."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    return {"params": {"w": f(3, 4), "b": f(4), "a": f(2)},
            "opt": [f(3), (f(2, 2), f(1))],
            "pair": _Pair(first=f(5), second=None),
            "count": np.int32(7)}


def _as(tree, fn):
    if isinstance(tree, dict):
        return {k: _as(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_as(v, fn) for v in tree)
    if isinstance(tree, _Pair):
        return _Pair(_as(tree.first, fn), _as(tree.second, fn))
    return None if tree is None else fn(tree)


def _leaves(tree):
    return checkpoint._flatten(tree)


def test_npz_checkpoint_written_by_jax_restores_in_the_port(tmp_path):
    tree = _tree()
    jckpt.save_npz_pytree(str(tmp_path / "j.npz"), _as(tree, jnp.asarray))
    like = _as(_tree(1), torch.as_tensor)
    out = checkpoint.load_npz_pytree(str(tmp_path / "j.npz"), like)
    assert list(out["params"]) == ["w", "b", "a"]
    for a, b in zip(_leaves(out), _leaves(tree)):
        assert isinstance(a, torch.Tensor)
        assert np.array_equal(a.numpy(), np.asarray(b))
    # the port writes, JAX restores
    checkpoint.save_npz_pytree(str(tmp_path / "t.npz"),
                               _as(tree, torch.as_tensor))
    back = jckpt.load_npz_pytree(str(tmp_path / "t.npz"),
                                 _as(_tree(2), jnp.asarray))
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(_as(tree, jnp.asarray))):
        assert np.array_equal(np.asarray(a), np.asarray(b))


def test_save_and_restore_pytree_round_trip_with_optimizer_state(tmp_path):
    w = torch.nn.Parameter(torch.arange(6.0).reshape(2, 3))
    opt = torch.optim.Adam([w], lr=0.1)
    w.sum().backward()
    opt.step()
    tree = {"params": {"w": w.detach().clone()},
            "opt": opt.state_dict(), "step": 1}
    for step in (3, 12, 7):
        checkpoint.save_pytree(str(tmp_path / f"step_{step}"), tree,
                               step=step)
    (tmp_path / "step_x").mkdir()
    latest = checkpoint.latest_checkpoint(str(tmp_path))
    assert latest == str(tmp_path / "step_12")
    assert checkpoint.latest_checkpoint(str(tmp_path / "none")) is None
    out, step = checkpoint.restore_pytree(latest, like=tree)
    assert step == 12
    assert torch.equal(out["params"]["w"], tree["params"]["w"])
    opt2 = torch.optim.Adam([torch.nn.Parameter(torch.zeros(2, 3))], lr=0.1)
    opt2.load_state_dict(out["opt"])
    st, st2 = opt.state_dict()["state"][0], opt2.state_dict()["state"][0]
    for k in ("exp_avg", "exp_avg_sq", "step"):
        assert torch.equal(st[k], st2[k]), k
    plain, none = checkpoint.restore_pytree(str(tmp_path / "step_3"))
    assert none == 3 and torch.equal(plain["params"]["w"],
                                     tree["params"]["w"])


# ----------------------------------------------------------------------
# native KNN
# ----------------------------------------------------------------------
def test_native_knn_matches_the_jax_library_and_brute_force():
    rng = np.random.default_rng(1)
    pts = rng.normal(size=(500, 3)).astype(np.float32)
    q = rng.normal(size=(64, 3)).astype(np.float32)
    d2, idx = native.knn.query(pts, q, 5)
    jd2, jidx = jnative.knn.query(pts, q, 5)
    assert np.array_equal(d2, jd2) and np.array_equal(idx, jidx)
    brute = np.sum((q[:, None] - pts[None]) ** 2, -1)
    order = np.argsort(brute, axis=1)[:, :5]
    assert np.array_equal(np.sort(idx, 1), np.sort(order, 1))
    assert np.array_equal(np.sort(d2, 1),
                          np.sort(np.take_along_axis(brute, order, 1), 1))


def test_native_mean_dist2_3nn_matches_the_jax_library_and_brute_force():
    rng = np.random.default_rng(2)
    pts = rng.normal(size=(200, 3)).astype(np.float32)
    out = native.knn.mean_dist2_3nn(pts)
    assert np.array_equal(out, jnative.knn.mean_dist2_3nn(pts))
    brute = np.sum((pts[:, None] - pts[None]) ** 2, -1).astype(np.float64)
    np.fill_diagonal(brute, np.inf)
    np.testing.assert_allclose(out, np.sort(brute, 1)[:, :3].mean(1),
                               rtol=1e-6)


def test_native_library_builds_into_the_ports_build_dir():
    path = native.build()
    assert path.parent == native.BUILD_DIR
    assert path.parent.parent.name == "mpmavatar_tpu_torch"
    assert native.build() == path          # unchanged sources: no rebuild


# ----------------------------------------------------------------------
# preview, logging, profiling, schedules, misc
# ----------------------------------------------------------------------
def _camera(cls, w=48, h=40, f=30.0, cam_z=-2.0):
    k = np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]])
    w2c = np.eye(4)
    w2c[2, 3] = -cam_z
    return cls.from_kw2c("test", w, h, k, w2c, near=0.5, far=20.0)


def test_render_mesh_image_is_the_jax_image():
    verts = np.array([[-0.5, -0.5, 0], [0.5, -0.5, 0], [0.0, 0.5, 0],
                      [0.0, -0.8, 0.3], [0.4, 0.3, -0.2]], np.float32)
    faces = np.array([[0, 1, 2], [0, 1, 3], [1, 4, 2]])
    img = mesh_preview.render_mesh(torch.as_tensor(verts),
                                   torch.as_tensor(faces), _camera(Camera))
    ref = jpreview.render_mesh(verts, faces, _camera(JCamera))
    assert img.dtype == np.uint8 and img.shape == (40, 48, 3)
    assert (img[:, :, 0] < 250).mean() > 0.02
    assert np.array_equal(img, ref)


def test_run_logger_writes_the_jax_jsonl(tmp_path):
    lines = {}
    for name, mod in (("jax", jlogging), ("port", logging)):
        lg = mod.RunLogger(str(tmp_path / name), use_tensorboard=False)
        lg.log(1, {"loss": 0.5, "lr": np.float32(1e-3)})
        lg.log(2, {"loss": torch.tensor(0.25)}, prefix="train/")
        lg.close()
        lines[name] = [json.loads(s) for s in (tmp_path / name /
                                               "metrics.jsonl").read_text()
                       .splitlines()]
    for a, b in zip(lines["port"], lines["jax"]):
        assert a.pop("time") > 0 and b.pop("time") > 0
        assert a == b
    assert lines["port"][1] == {"step": 2, "train/loss": 0.25}


def test_trace_writes_a_trace_file(tmp_path):
    with profiling.trace(str(tmp_path / "trace")):
        with profiling.span("substep.p2g"):
            torch.ones(100).sum()
    path = tmp_path / "trace" / "trace.json"
    assert path.exists() and '"substep.p2g"' in path.read_text()


@pytest.mark.parametrize("kw", [dict(lr_init=1.6e-4, lr_final=1.6e-6,
                                     max_steps=30000),
                                dict(lr_init=1e-2, lr_final=1e-4,
                                     lr_delay_steps=100, lr_delay_mult=0.01,
                                     max_steps=1000),
                                dict(lr_init=0.0, lr_final=0.0)])
def test_expon_lr_func_is_the_jax_schedule(kw):
    fn, ref = schedules.expon_lr_func(**kw), jsched.expon_lr_func(**kw)
    for step in (-1, 0, 1, 50, 100, 999, 1000, 30000, 40000):
        assert fn(step) == ref(step)


def test_safe_state_seeds_python_and_numpy_as_jax_does():
    draws = []
    for mod in (jmisc, misc):
        assert mod.safe_state(5, silent=True) == 5
        draws.append((random.random(), np.random.rand()))
    assert draws[0] == draws[1]


def test_run_subprocess(capsys):
    assert misc.run_subprocess(["true"], label="t") == 0
    assert misc.run_subprocess(["sh", "-c", "echo hi; exit 3"], label="t",
                               check=False) == 3
    assert "[t] hi" in capsys.readouterr().out
    with pytest.raises(RuntimeError, match="exit code 3"):
        misc.run_subprocess(["sh", "-c", "exit 3"], label="t")
    assert misc.run_subprocess(["no-such-binary-here"], check=False) == 127
