"""The port's configuration and capture loaders against the JAX package's,
on the toy captures of tests/test_data.py (32 x 24 ActorsHQ layout) and a
toy 4D-DRESS layout: the flags reflected from the dataclasses (bools as
``store_true``, lists as ``nargs="+"``), ``cfg_args.json`` written by one
package and read by the other, and the loaders' cameras, scene radius,
frame windows and ``load_frame`` arrays.  Both packages decode with
Pillow, so the arrays must be identical (tolerance 0); the cameras are
the same float64/float32 formulas, compared exactly.

``toy_capture`` (used by the other stage-2/stage-4 test files) puts the
tracked 5 x 5 cloth of tests/test_train.py beside the ActorsHQ layout and
aims the layout's cameras down at the cloth, so that renders are not
empty."""

import argparse
import dataclasses
import json
import os
import pickle

import numpy as np
import pytest

from test_data import _make_actorshq_layout
from test_train import make_fake_tracking_assets

from mpmavatar_tpu.data import config as jconfig
from mpmavatar_tpu.data import datasets as jdatasets

from mpmavatar_tpu_torch.data import config as tconfig
from mpmavatar_tpu_torch.data import datasets as tdatasets

CLASSES = ("ModelParams", "OptimizationParams", "PipelineParams")


def _rotation(ax, az):
    """Rotation about x by ``ax``, then about z by ``az``."""
    cx, sx, cz, sz = np.cos(ax), np.sin(ax), np.cos(az), np.sin(az)
    rx = np.array([[1.0, 0.0, 0.0], [0.0, cx, -sx], [0.0, sx, cx]])
    rz = np.array([[cz, -sz, 0.0], [sz, cz, 0.0], [0.0, 0.0, 1.0]])
    return rz @ rx


def toy_capture(root, n_cams=3, frames=(0, 1), focal=40.0):
    """The ActorsHQ layout (``n_cams`` cameras, 32 x 24, random images)
    and the tracked cloth (2 frames, 32 faces, uv.obj) under ``root``,
    the cameras looking down at the cloth from 1.2 away, tilted about two
    axes so that no two splats share a depth (equal depths would make
    the compositing order a tie).  Returns (verts, faces) of the
    cloth."""
    _make_actorshq_layout(str(root), n_cams=n_cams, frames=frames)
    verts, faces = make_fake_tracking_assets(root)
    w, h = 32, 24
    cam_info = {}
    for ci in range(n_cams):
        c2w = np.eye(4)
        # x right, image y along +z, looking down -y; then tilted
        rot = _rotation(0.21 + 0.05 * ci, 0.13 - 0.04 * ci)
        c2w[:3, :3] = rot @ np.array([[1.0, 0.0, 0.0], [0.0, 0.0, -1.0],
                                      [0.0, 1.0, 0.0]])
        target = np.array([1.0 + 0.03 * (ci - 1), 1.0, 1.0 + 0.02 * ci])
        c2w[:3, 3] = target - 1.2 * c2w[:3, 2]
        cam_info[f"Cam{ci:03d}"] = {
            "W": w, "H": h,
            "K": [[focal, 0, w / 2], [0, focal, h / 2], [0, 0, 1]],
            "RT": c2w.tolist()}
    with open(os.path.join(root, "a1_s1", "cam_info.json"), "w") as fp:
        json.dump(cam_info, fp)
    return verts, faces


def _defaults(cls):
    return dataclasses.asdict(cls())


@pytest.mark.parametrize("name", CLASSES)
def test_config_fields_and_defaults_match_jax(name):
    assert _defaults(getattr(tconfig, name)) == \
        _defaults(getattr(jconfig, name))


def test_config_reflects_bools_and_lists_as_jax_does():
    def parse(mod, argv):
        p = argparse.ArgumentParser()
        mod.add_dataclass_args(p, mod.ModelParams)
        mod.add_dataclass_args(p, mod.OptimizationParams)
        return p.parse_args(argv)

    argv = ["--white_bkgd", "--test_camera_index", "3", "7",
            "--image_downscale_ratio", "2", "--grid_size", "128",
            "--random_background"]
    for mod in (tconfig, jconfig):
        args = parse(mod, argv)
        cfg = mod.extract_dataclass(args, mod.ModelParams)
        assert cfg.white_bkgd is True
        assert cfg.test_camera_index == [3, 7]
        assert cfg.image_downscale_ratio == 2.0
        assert cfg.grid_size == 128
        assert mod.extract_dataclass(args, mod.OptimizationParams) \
            .random_background is True
        # a bool flag takes no value, and its default stays False
        assert parse(mod, []).white_bkgd is False
        with pytest.raises(SystemExit):
            parse(mod, ["--white_bkgd", "False"])
    assert vars(parse(tconfig, argv)) == vars(parse(jconfig, argv))


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_cfg_args_json_loads_in_the_other_package(tmp_path, writer):
    mods = {"port": tconfig, "jax": jconfig}
    w = mods[writer]
    r = mods["jax" if writer == "port" else "port"]
    cfg = w.ModelParams(white_bkgd=True, test_camera_index=[8],
                        train_frame_start_num=[0, 4], sh_degree=2)
    opt = w.OptimizationParams(iterations=30, lambda_lpips=0.1, seed=3)
    path = str(tmp_path / "cfg_args.json")
    w.dump_config(path, cfg, opt)
    assert dataclasses.asdict(r.load_config(path, r.ModelParams)) == \
        dataclasses.asdict(cfg)
    assert dataclasses.asdict(r.load_config(path, r.OptimizationParams)) \
        == dataclasses.asdict(opt)


def _cam_fields(cam):
    return {f.name: getattr(cam, f.name) for f in dataclasses.fields(cam)}


def _assert_same_cameras(a, b):
    assert len(a) == len(b)
    for ca, cb in zip(a, b):
        fa, fb = _cam_fields(ca), _cam_fields(cb)
        assert fa.keys() == fb.keys()
        for k in fa:
            np.testing.assert_array_equal(np.asarray(fa[k]),
                                          np.asarray(fb[k]), err_msg=k)


def _assert_same_frames(ta, ja):
    for ci in range(len(ja.camera_list)):
        for fi in range(len(ja.frame_index)):
            a, b = ta.load_frame(ci, fi), ja.load_frame(ci, fi)
            assert (a["camera_idx"], a["frame_idx"]) == \
                (b["camera_idx"], b["frame_idx"])
            for k in ("rgb", "msk"):
                assert a[k].dtype == b[k].dtype == np.float32
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("downscale", [1.0, 2.0])
def test_actorshq_dataset_matches_jax(tmp_path, downscale):
    _make_actorshq_layout(str(tmp_path), n_cams=3)
    kw = dict(actor=1, sequence=1, frame_index=[0, 1],
              downscale_ratio=downscale)
    for train in (True, False):
        t = tdatasets.ActorsHQDataset(str(tmp_path), train=train,
                                      test_camera_index=[2], **kw)
        j = jdatasets.ActorsHQDataset(str(tmp_path), train=train,
                                      test_camera_index=[2], **kw)
        assert t.scene_radius == j.scene_radius > 0
        _assert_same_cameras(t.camera_list, j.camera_list)
        _assert_same_frames(t, j)
        assert len(t) == len(j) == len(j.camera_list) * 2
    assert t.load_frame(0, 0)["rgb"].shape == (3, round(24 / downscale),
                                               round(32 / downscale))


def _make_dress4d_layout(root, n_cams=2, frames=(3, 4), w=20, h=16):
    rng = np.random.default_rng(1)
    cams = {}
    for ci in range(n_cams):
        cid = f"{ci + 4:04d}"
        ext = np.eye(4)[:3]
        ext[:, 3] = [0.3 * ci, 0.1, 2.0 + 0.2 * ci]
        cams[cid] = {"intrinsics": [[25.0, 0, w / 2], [0, 25.0, h / 2],
                                    [0, 0, 1]], "extrinsics": ext}
        for sub, name in (("images", "capture"), ("masks", "mask")):
            d = os.path.join(root, "Capture", cid, sub)
            os.makedirs(d, exist_ok=True)
            for f in frames:
                from PIL import Image
                img = (rng.random((h, w, 4 if sub == "images" else 3))
                       * 255).astype(np.uint8)
                Image.fromarray(img).save(
                    os.path.join(d, f"{name}-f{f:05d}.png"))
    with open(os.path.join(root, "Capture", "cameras.pkl"), "wb") as fp:
        pickle.dump(cams, fp)


def test_dress4d_dataset_matches_jax(tmp_path):
    _make_dress4d_layout(str(tmp_path))
    for train in (True, False):
        kw = dict(frame_index=[3, 4], test_camera_index=[1], train=train,
                  downscale_ratio=1.0)
        t = tdatasets.DRESS4DDataset(str(tmp_path), **kw)
        j = jdatasets.DRESS4DDataset(str(tmp_path), **kw)
        assert t.scene_radius == j.scene_radius
        _assert_same_cameras(t.camera_list, j.camera_list)
        _assert_same_frames(t, j)
    assert t.load_frame(0, 1)["rgb"].shape == (3, 16, 20)


def _scene_cfg(mod, root):
    return mod.ModelParams(dataset_dir=str(root),
                           train_frame_start_num=[0, 2],
                           test_frame_start_num=[1, 1],
                           test_camera_index=[0, 2])


@pytest.mark.parametrize("return_type", ["image", "video"])
def test_scene_windows_and_preloaded_frames_match_jax(tmp_path,
                                                      return_type):
    _make_actorshq_layout(str(tmp_path), n_cams=3)
    t = tdatasets.Scene(_scene_cfg(tconfig, tmp_path), return_type)
    j = jdatasets.Scene(_scene_cfg(jconfig, tmp_path), return_type)
    for k in ("train_frame_index", "test_frame_index", "test_camera_index",
              "white_bkgd", "uv_path", "actor", "sequence"):
        assert getattr(t, k) == getattr(j, k), k
    assert t.train_frame_index == [0, 1] and t.test_frame_index == [1]
    for a, b in ((t.train_dataset, j.train_dataset),
                 (t.test_dataset, j.test_dataset)):
        assert type(a).__name__ == type(b).__name__
        assert a.scene_radius == b.scene_radius
        _assert_same_cameras(a.camera_list, b.camera_list)
        _assert_same_frames(a, b)
        rng_a, rng_b = np.random.default_rng(4), np.random.default_rng(4)
        for _ in range(3):
            sa, sb = a.sample(rng_a), b.sample(rng_b)
            assert (sa["camera_idx"], sa["frame_idx"]) == \
                (sb["camera_idx"], sb["frame_idx"])
            np.testing.assert_array_equal(sa["rgb"], sb["rgb"])
    assert len(t.test_dataset.camera_list) == 2


def test_toy_capture_cameras_see_the_cloth(tmp_path):
    verts, _ = toy_capture(tmp_path)
    ds = tdatasets.ActorsHQDataset(str(tmp_path), 1, 1, frame_index=[0])
    for cam in ds.camera_list:
        hom = np.c_[verts, np.ones(len(verts))] @ cam.full_proj_transform
        ndc = hom[:, :2] / hom[:, 3:]
        assert (np.abs(ndc) < 1).mean() > 0.5


def test_scene_selects_the_4ddress_takes_as_jax_does(tmp_path):
    base = tmp_path / "4D-DRESS" / "00170_Inner" / "Inner"
    for take in (1, 5):
        _make_dress4d_layout(str(base / f"Take{take}"), frames=(3, 4))
    kw = dict(dataset_dir=str(tmp_path), dataset_type="4ddress",
              train_frame_start_num=[3, 2], test_frame_start_num=[4, 1],
              test_camera_index=[1])
    t = tdatasets.Scene(tconfig.ModelParams(**kw))
    j = jdatasets.Scene(jconfig.ModelParams(**kw))
    assert (t.subject, t.train_take, t.test_take) == \
        (j.subject, j.train_take, j.test_take) == (170, 1, 5)
    assert t.test_dataset.data_dir == j.test_dataset.data_dir
    assert t.test_dataset.data_dir.endswith("Take5")
    _assert_same_cameras(t.train_dataset.camera_list,
                         j.train_dataset.camera_list)
    _assert_same_frames(t.test_dataset, j.test_dataset)
