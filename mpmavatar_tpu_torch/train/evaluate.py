"""Evaluation, port of mpmavatar_tpu/train/evaluate.py: geometry (CD x1000,
F-Score@1e-3) and appearance (PSNR, SSIM, LPIPS when weights are given)
metrics, the layered-garment merge, and the stage-4 render loop.

``render_eval_sequence`` bakes AO for simulated meshes and renders every
held-out camera; it writes exactly the tree that ``train/eval_metrics.py``
(and the JAX package's scripts/eval.py) reads: ``aomap/%04d.png`` and
``<camera>/{pred,gt}/%04d.png``, with pred/gt videos when an ffmpeg binary
is on the path.  The mask helpers and the geometry metrics are numpy; the
image metrics run on ``device`` (the CUDA device unless given).
"""

from __future__ import annotations

import os
from typing import Callable, Optional

import numpy as np
import torch

from .. import resolve_device
from ..utils.losses import psnr, ssim
from ..utils.metrics import all_mesh_metrics


def erode(mask: np.ndarray, iterations: int = 5) -> np.ndarray:
    """3x3 erosion with edge padding, ``iterations`` times (cv2.erode)."""
    m = mask
    for _ in range(iterations):
        p = np.pad(m, 1, mode="edge")
        m = np.min(np.stack([p[i:i + m.shape[0], j:j + m.shape[1]]
                             for i in range(3) for j in range(3)]), axis=0)
    return m


def gaussian_blur5(mask: np.ndarray) -> np.ndarray:
    """5x5 Gaussian blur with cv2's automatic sigma for that size
    (0.3 * ((5 - 1) * 0.5 - 1) + 0.8 = 1.1), edge padding."""
    xs = np.arange(5) - 2
    g = np.exp(-(xs ** 2) / (2 * 1.1 ** 2))
    g /= g.sum()
    p = np.pad(mask, 2, mode="edge")
    m = np.apply_along_axis(lambda r: np.convolve(r, g, "valid"), 0, p)
    m = np.apply_along_axis(lambda r: np.convolve(r, g, "valid"), 1, m)
    return m


def eval_mask(mask_gt: np.ndarray) -> np.ndarray:
    """The appearance metrics' mask: the GT mask eroded 5 times, then
    blurred."""
    return gaussian_blur5(erode(mask_gt, 5))


def appearance_metrics(img_pred: np.ndarray, img_gt: np.ndarray,
                       mask_gt: np.ndarray,
                       lpips_fn: Optional[Callable] = None,
                       suppress_white: bool = False, device=None):
    """PSNR, SSIM (and LPIPS through ``lpips_fn``) of the masked images,
    as floats.  img_* are (3, H, W) in [0, 1], mask_gt (H, W) raw; with
    ``suppress_white`` (ActorsHQ) pixels brighter than 0.9 on average are
    zeroed in each image first."""
    device = resolve_device(device)
    img_pred = np.array(img_pred, np.float32, copy=True)
    img_gt = np.array(img_gt, np.float32, copy=True)
    if suppress_white:
        img_pred[:, img_pred.mean(axis=0) > 0.90] = 0
        img_gt[:, img_gt.mean(axis=0) > 0.90] = 0
    m = eval_mask(mask_gt)[None]
    # the product is float64 (the blurred mask), the metrics float32
    a = torch.as_tensor(img_pred * m, dtype=torch.float32,
                        device=device)[None]
    b = torch.as_tensor(img_gt * m, dtype=torch.float32, device=device)[None]
    with torch.no_grad():
        out = {"PSNR": float(psnr(a, b)), "SSIM": float(ssim(a, b))}
        if lpips_fn is not None:
            out["LPIPS"] = float(lpips_fn(a, b))
    return out


def geometry_metrics(pred_verts, pred_faces, gt_verts, gt_faces,
                     sample_count: int = 100000):
    """CD x1000 and F-Score@1e-3 of two meshes' surface samples."""
    fs, cd = all_mesh_metrics(pred_verts, pred_faces, gt_verts, gt_faces,
                              sample_count)
    return {"CD": cd, "F-Score": fs}


def merge_layered_meshes(lower_verts: np.ndarray, upper_verts: np.ndarray,
                         upper_cloth_v_idx: np.ndarray) -> np.ndarray:
    """The lower simulation's vertices with the upper garment's vertices
    (``upper_cloth_v_idx``) taken from the upper simulation."""
    out = np.array(lower_verts, copy=True)
    out[upper_cloth_v_idx] = upper_verts[upper_cloth_v_idx]
    return out


def evaluate_sequence(pred_mesh_dir: str, faces, gt_loader,
                      frames, image_pairs=None, lpips_fn=None,
                      suppress_white=False, out_path: Optional[str] = None,
                      device=None):
    """Geometry metrics of ``pred_mesh_dir/%03d.obj`` against
    ``gt_loader(frame) -> (verts, faces)`` per frame, and appearance
    metrics of ``image_pairs`` ((pred, gt, mask) triples); the means, and
    every value in ``out_path/metric.npz`` when given."""
    from ..utils.io import read_obj
    geo = {"CD": [], "F-Score": []}
    for idx, frame in enumerate(frames):
        pv, _ = read_obj(os.path.join(pred_mesh_dir, f"{idx:03d}.obj"))
        gv, gf = gt_loader(frame)
        m = geometry_metrics(pv, faces, gv, gf)
        geo["CD"].append(m["CD"])
        geo["F-Score"].append(m["F-Score"])

    app = {"PSNR": [], "SSIM": [], "LPIPS": []}
    if image_pairs is not None:
        for img_pred, img_gt, mask in image_pairs:
            m = appearance_metrics(img_pred, img_gt, mask, lpips_fn,
                                   suppress_white, device=device)
            for k in app:
                if k in m:
                    app[k].append(m[k])

    results = {k: float(np.mean(v)) for k, v in {**geo, **app}.items() if v}
    if out_path:
        np.savez(os.path.join(out_path, "metric.npz"),
                 **{**{k: np.asarray(v) for k, v in geo.items()},
                    **{k: np.asarray(v) for k, v in app.items() if v}})
    return results


def _save_png(path: str, img_hwc: np.ndarray) -> None:
    from PIL import Image
    Image.fromarray((np.clip(img_hwc, 0, 1) * 255).astype(np.uint8)).save(
        path)


@torch.no_grad()
def render_eval_sequence(avatar, params, scene, mesh_dir: str,
                         out_dir: str, uv_path: str,
                         active_sh_degree: int = 3,
                         skip_video: bool = False,
                         ao_resolution: int = 256,
                         tile_capacity: int = 512,
                         max_frames: Optional[int] = None):
    """The stage-4 render loop on the device of ``params``: each simulated
    mesh ``mesh_dir/%03d.obj`` of the test window -> its AO map
    (``bake_ao``, written to ``out_dir/aomap/%04d.png``) -> every held-out
    camera's render through the tile path (shadow UNet, SH colours,
    colour calibration) -> ``out_dir/<camera>/pred/%04d.png`` beside the
    masked GT in ``gt/`` (named by the test frame numbers), and
    pred/gt videos per camera unless ``skip_video``."""
    from ..render.ao import bake_ao, load_uv_chart
    from ..utils.io import read_obj
    from ..utils.misc import frames_to_video
    from .appearance import render_avatar_frame

    dev = params.verts_offset.device
    ds = scene.test_dataset
    n_frames = len(ds.frame_index)
    if max_frames is not None:
        n_frames = min(n_frames, max_frames)

    chart = load_uv_chart(uv_path, resolution=ao_resolution)
    faces = avatar.tensor("faces", dev)
    ao_dir = os.path.join(out_dir, "aomap")
    os.makedirs(ao_dir, exist_ok=True)
    all_verts, ao_maps = [], []
    for i in range(n_frames):
        verts, _ = read_obj(os.path.join(mesh_dir, f"{i:03d}.obj"))
        verts = torch.as_tensor(verts, device=dev)
        ao = bake_ao(verts, faces, chart.face_idx, chart.bary,
                     chart.texel_ij, resolution=ao_resolution)
        all_verts.append(verts)
        ao_maps.append(ao)
        _save_png(os.path.join(ao_dir, f"{i:04d}.png"), ao[0].cpu().numpy())

    bg = torch.full((3,), 1.0 if scene.white_bkgd else 0.0, device=dev)
    for ci, cam in enumerate(ds.camera_list):
        camera_idx = scene.test_camera_index[ci]
        savedir = os.path.join(out_dir, str(cam.camera_id))
        preddir = os.path.join(savedir, "pred")
        gtdir = os.path.join(savedir, "gt")
        os.makedirs(preddir, exist_ok=True)
        os.makedirs(gtdir, exist_ok=True)
        for i in range(n_frames):
            rendering, _ = render_avatar_frame(
                avatar, params, all_verts[i], ao_maps[i], cam, camera_idx,
                active_sh_degree, bg, scene.white_bkgd,
                tile_capacity=tile_capacity)
            frame_no = scene.test_frame_index[i]
            _save_png(os.path.join(preddir, f"{frame_no:04d}.png"),
                      rendering.permute(1, 2, 0).cpu().numpy())
            batch = ds.load_frame(ci, i)
            gt = batch["rgb"] * batch["msk"]
            if scene.white_bkgd:
                gt = gt + (1.0 - batch["msk"])
            _save_png(os.path.join(gtdir, f"{frame_no:04d}.png"),
                      gt.transpose(1, 2, 0))
        if not skip_video:
            start = scene.test_frame_index[0]
            frames_to_video(os.path.join(preddir, "%04d.png"),
                            os.path.join(savedir, "pred.mp4"),
                            start_number=start, num_frames=n_frames)
            frames_to_video(os.path.join(gtdir, "%04d.png"),
                            os.path.join(savedir, "gt.mp4"),
                            start_number=start, num_frames=n_frames)
