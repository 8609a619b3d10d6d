"""Dataset loaders for ActorsHQ and 4D-DRESS captures (host-side numpy),
the port's own copy of mpmavatar_tpu/data/datasets.py: the same directory
layouts, camera conventions, scene radius and frame windows, and the same
arrays from ``load_frame`` (Pillow decodes and resizes the images, as in
the JAX package).  The trainers move a frame to their device themselves.
"""

from __future__ import annotations

import json
import os
import pickle
import numpy as np

from ..render.cameras import Camera


def _scale_intrinsics(k, w_raw, h_raw, downscale):
    w, h = round(w_raw / downscale), round(h_raw / downscale)
    k = [list(row) for row in k]
    sx, sy = w / w_raw, h / h_raw
    k[0][0] *= sx
    k[0][2] *= sx
    k[1][1] *= sy
    k[1][2] *= sy
    return k, w, h


def _read_resized(path, w, h):
    """The image at ``path`` resized bilinearly to (w, h), as float32 in
    [0, 1] (H, W[, C])."""
    from PIL import Image
    with Image.open(path) as im:
        return np.array(im.resize((w, h), Image.BILINEAR),
                        np.float32) / 255.0


def _scene_radius(cam_centers):
    cam_centers = np.asarray(cam_centers)
    return 1.1 * np.max(np.linalg.norm(
        cam_centers - cam_centers.mean(0)[None], axis=-1))


class ActorsHQDataset:
    """``<dir>/a<actor>_s<sequence>/cam_info.json`` + per-frame jpg rgbs
    and png masks under ``<dir>/ActorsHQ/Actor<NN>/Sequence<N>/4x``."""

    def __init__(self, data_dir, actor, sequence, white_bkgd=True,
                 downscale_ratio=1.0, test_camera_index=(), frame_index=(),
                 train=True):
        self.data_dir = data_dir
        self.camera_path = os.path.join(data_dir, f"a{actor}_s{sequence}",
                                        "cam_info.json")
        self.image_path = os.path.join(data_dir, "ActorsHQ",
                                       f"Actor{actor:02d}",
                                       f"Sequence{sequence}", "4x")
        self.white_bkgd = white_bkgd
        self.downscale_ratio = downscale_ratio
        self.frame_index = list(frame_index)
        self.train = train

        with open(self.camera_path) as f:
            contents = json.load(f)
        cameras, centers = [], []
        for camera_id, info in contents.items():
            k, w, h = _scale_intrinsics(info["K"], info["W"], info["H"],
                                        downscale_ratio)
            c2w = np.array(info["RT"])
            w2c = np.linalg.inv(c2w)
            cameras.append(Camera.from_kw2c(camera_id, w, h, k, w2c,
                                            near=1, far=10))
            centers.append(c2w[:3, 3])
        self.scene_radius = _scene_radius(centers)
        if train:
            self.camera_list = cameras
        else:
            self.camera_list = [c for i, c in enumerate(cameras)
                                if i in test_camera_index]

    def rgb_path(self, camera_id, frame):
        return os.path.join(self.image_path,
                            f"rgbs/{camera_id}/{camera_id}_rgb{frame:06d}.jpg")

    def msk_path(self, camera_id, frame):
        return os.path.join(
            self.image_path,
            f"masks/{camera_id}/{camera_id}_mask{frame:06d}.png")

    def load_frame(self, camera_idx, frame_idx):
        """dict(cam, camera_idx, frame_idx, rgb (3,H,W) float in [0,1],
        msk (1,H,W))."""
        cam = self.camera_list[camera_idx]
        frame = self.frame_index[frame_idx]
        w, h = cam.image_width, cam.image_height
        rgb = _read_resized(self.rgb_path(cam.camera_id, frame), w, h)
        msk = _read_resized(self.msk_path(cam.camera_id, frame), w, h)
        if msk.ndim == 3:
            msk = msk[..., 0]
        return {"cam": cam, "camera_idx": camera_idx,
                "frame_idx": frame_idx,
                "rgb": rgb.transpose(2, 0, 1), "msk": msk[None]}

    def __len__(self):
        return len(self.camera_list) * len(self.frame_index)

    def sample(self, rng: np.random.Generator):
        i = int(rng.integers(len(self.camera_list)))
        j = int(rng.integers(len(self.frame_index)))
        return self.load_frame(i, j)


class DRESS4DDataset:
    """``<dir>/Capture/cameras.pkl`` + per-camera capture-f%05d.png
    images and mask-f%05d.png masks."""

    def __init__(self, data_dir, white_bkgd=True, downscale_ratio=1.0,
                 test_camera_index=(), frame_index=(), train=True):
        from PIL import Image
        self.data_dir = data_dir
        self.white_bkgd = white_bkgd
        self.frame_index = list(frame_index)
        self.train = train
        with open(os.path.join(data_dir, "Capture/cameras.pkl"), "rb") as f:
            cam_data = pickle.load(f)
        cameras, centers = [], []
        for camera_id, info in cam_data.items():
            w2c = np.concatenate([info["extrinsics"], np.eye(4)[3:]], 0)
            c2w = np.linalg.inv(w2c)
            with Image.open(os.path.join(
                    data_dir, f"Capture/{camera_id}/images/"
                    f"capture-f{self.frame_index[0]:05d}.png")) as im:
                size = im.size
            k, w, h = _scale_intrinsics(info["intrinsics"], *size,
                                        downscale_ratio)
            cameras.append(Camera.from_kw2c(camera_id, w, h, k, w2c,
                                            near=1, far=10))
            centers.append(c2w[:3, 3])
        self.scene_radius = _scene_radius(centers)
        if train:
            self.camera_list = cameras
        else:
            self.camera_list = [c for i, c in enumerate(cameras)
                                if i in test_camera_index]

    def rgb_path(self, camera_id, frame):
        return os.path.join(self.data_dir,
                            f"Capture/{camera_id}/images/"
                            f"capture-f{frame:05d}.png")

    def msk_path(self, camera_id, frame):
        return os.path.join(self.data_dir,
                            f"Capture/{camera_id}/masks/"
                            f"mask-f{frame:05d}.png")

    def load_frame(self, camera_idx, frame_idx):
        cam = self.camera_list[camera_idx]
        frame = self.frame_index[frame_idx]
        w, h = cam.image_width, cam.image_height
        rgb = _read_resized(self.rgb_path(cam.camera_id, frame), w, h)
        msk = _read_resized(self.msk_path(cam.camera_id, frame), w, h)
        if msk.ndim == 3:
            msk = msk[..., 0]
        return {"cam": cam, "camera_idx": camera_idx,
                "frame_idx": frame_idx,
                "rgb": rgb[..., :3].transpose(2, 0, 1), "msk": msk[None]}

    def __len__(self):
        return len(self.camera_list) * len(self.frame_index)

    def sample(self, rng: np.random.Generator):
        i = int(rng.integers(len(self.camera_list)))
        j = int(rng.integers(len(self.frame_index)))
        return self.load_frame(i, j)


class PreloadedDataset:
    """Every (camera, frame) pair of ``base`` decoded once up front and
    served from host memory, cached as uint8 (4x smaller than float)."""

    def __init__(self, base):
        self.base = base
        self.camera_list = base.camera_list
        self.frame_index = base.frame_index
        self.scene_radius = base.scene_radius
        self._rgb = {}
        self._msk = {}
        for ci in range(len(base.camera_list)):
            for fi in range(len(base.frame_index)):
                b = base.load_frame(ci, fi)
                self._rgb[(ci, fi)] = (
                    np.clip(b["rgb"], 0, 1) * 255).astype(np.uint8)
                self._msk[(ci, fi)] = (
                    np.clip(b["msk"], 0, 1) * 255).astype(np.uint8)

    def load_frame(self, camera_idx, frame_idx):
        cam = self.camera_list[camera_idx]
        return {"cam": cam, "camera_idx": camera_idx,
                "frame_idx": frame_idx,
                "rgb": self._rgb[(camera_idx, frame_idx)].astype(
                    np.float32) / 255.0,
                "msk": self._msk[(camera_idx, frame_idx)].astype(
                    np.float32) / 255.0}

    def __len__(self):
        return len(self.camera_list) * len(self.frame_index)

    def sample(self, rng: np.random.Generator):
        i = int(rng.integers(len(self.camera_list)))
        j = int(rng.integers(len(self.frame_index)))
        return self.load_frame(i, j)


class Scene:
    """Dataset selection and the train/test frame windows of a
    ModelParams; ``return_type="video"`` preloads every frame
    (PreloadedDataset)."""

    def __init__(self, cfg, return_type="image"):
        self.dataset_type = cfg.dataset_type
        self.dataset_dir = cfg.dataset_dir
        self.white_bkgd = cfg.white_bkgd
        self.test_camera_index = cfg.test_camera_index
        self.train_frame_start, self.train_frame_num = \
            cfg.train_frame_start_num
        self.test_frame_start, self.test_frame_num = cfg.test_frame_start_num
        self.train_frame_index = list(range(
            self.train_frame_start,
            self.train_frame_start + self.train_frame_num))
        self.test_frame_index = list(range(
            self.test_frame_start,
            self.test_frame_start + self.test_frame_num))
        self.uv_path = cfg.uv_path

        if cfg.dataset_type == "actorshq":
            self.actor, self.sequence = cfg.actor, cfg.sequence
            mk = lambda train, frames: ActorsHQDataset(
                cfg.dataset_dir, cfg.actor, cfg.sequence,
                white_bkgd=cfg.white_bkgd,
                downscale_ratio=cfg.image_downscale_ratio,
                test_camera_index=cfg.test_camera_index,
                frame_index=frames, train=train)
        elif cfg.dataset_type == "4ddress":
            self.subject = cfg.subject
            self.train_take, self.test_take = cfg.train_take, cfg.test_take
            base = os.path.join(cfg.dataset_dir,
                                f"4D-DRESS/{cfg.subject:05d}_Inner/Inner")
            mk = lambda train, frames: DRESS4DDataset(
                os.path.join(base, "Take%d" % (cfg.train_take if train
                                               else cfg.test_take)),
                white_bkgd=cfg.white_bkgd,
                downscale_ratio=cfg.image_downscale_ratio,
                test_camera_index=cfg.test_camera_index,
                frame_index=frames, train=train)
        else:
            raise NotImplementedError(cfg.dataset_type)
        self.train_dataset = mk(True, self.train_frame_index)
        self.test_dataset = mk(False, self.test_frame_index)
        if return_type == "video":
            self.train_dataset = PreloadedDataset(self.train_dataset)
            self.test_dataset = PreloadedDataset(self.test_dataset)
