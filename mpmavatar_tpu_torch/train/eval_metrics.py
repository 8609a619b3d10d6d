"""Metrics of a stage-4 evaluation tree from the command line, the port's
counterpart of scripts/eval.py:

    python -m mpmavatar_tpu_torch.train.eval_metrics \\
        --output_path OUT --mesh_path uv.obj --data_path DATA \\
        --start_idx 660 --num_timesteps 200 [--dataset actorshq|4ddress] \\
        [--lpips_weights lpips.npz] [--cameras Cam008] [--device cpu]

Geometry: CD x1000 and F-Score@1e-3 of ``OUT/uvmesh/%03d.obj`` (faces from
``--mesh_path``) against the capture's meshes (``DATA/meshes/Frame%06d.obj``
for ActorsHQ, ``DATA/Meshes_pkl/mesh-f%05d.pkl`` for 4D-DRESS).
Appearance: PSNR, SSIM and LPIPS of ``OUT/<camera>/pred/%04d.png`` against
``gt/`` under the capture's eroded and blurred masks, for the held-out
cameras of the published protocol, Cam007 and Cam127 (ActorsHQ) or 0004
(4D-DRESS), or those that ``--cameras`` names.  Prints each mean, says
loudly when LPIPS is unavailable, and writes ``geo_metric.npz`` and
``app_metric.npz`` to OUT.  The image metrics run on the CUDA device
unless ``--device`` says otherwise.
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--output_path", required=True)
    parser.add_argument("--mesh_path", required=True)
    parser.add_argument("--data_path", required=True)
    parser.add_argument("--start_idx", type=int, default=660)
    parser.add_argument("--num_timesteps", type=int, default=200)
    parser.add_argument("--dataset", default="actorshq",
                        choices=["actorshq", "4ddress"])
    parser.add_argument("--lpips_weights", default=None)
    parser.add_argument("--cameras", nargs="+", default=None,
                        help="held-out cameras (default: the dataset's "
                        "published ones)")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA device)")
    return parser.parse_args(argv)


def _read_image(path) -> np.ndarray:
    from PIL import Image
    with Image.open(path) as im:
        return np.asarray(im, np.float32) / 255.0


def main(argv=None) -> int:
    from .. import resolve_device
    from ..utils.io import read_obj
    from ..utils.lpips import make_lpips_fn
    from .evaluate import appearance_metrics, geometry_metrics

    args = parse_args(argv)
    device = resolve_device(args.device)
    frames = list(range(args.start_idx, args.start_idx + args.num_timesteps))
    _, faces = read_obj(args.mesh_path)

    geo = {"CD": [], "F-Score": []}
    for idx, frame in enumerate(frames):
        pv, _ = read_obj(os.path.join(args.output_path, "uvmesh",
                                      f"{idx:03d}.obj"))
        if args.dataset == "actorshq":
            gv, gf = read_obj(os.path.join(args.data_path,
                                           f"meshes/Frame{frame:06d}.obj"))
        else:
            import pickle
            with open(os.path.join(args.data_path,
                                   f"Meshes_pkl/mesh-f{frame:05d}.pkl"),
                      "rb") as f:
                d = pickle.load(f)
            gv, gf = d["vertices"], d["faces"]
        m = geometry_metrics(pv, faces, gv, gf)
        geo["CD"].append(m["CD"])
        geo["F-Score"].append(m["F-Score"])
    for k, v in geo.items():
        print(k, float(np.mean(v)))
    np.savez(os.path.join(args.output_path, "geo_metric.npz"), **geo)

    cams = args.cameras or (["Cam007", "Cam127"]
                            if args.dataset == "actorshq" else ["0004"])
    lpips_fn = make_lpips_fn(args.lpips_weights, device=device)
    app = {"PSNR": [], "SSIM": [], "LPIPS": []}
    for frame in frames:
        for cam in cams:
            pred = _read_image(os.path.join(
                args.output_path, cam, "pred",
                f"{frame:04d}.png")).transpose(2, 0, 1)
            gt = _read_image(os.path.join(
                args.output_path, cam, "gt",
                f"{frame:04d}.png")).transpose(2, 0, 1)
            if args.dataset == "actorshq":
                mask = _read_image(os.path.join(
                    args.data_path,
                    f"masks/{cam}/{cam}_mask{frame:06d}.png"))
            else:
                mask = _read_image(os.path.join(
                    args.data_path,
                    f"Capture/{cam}/masks/mask-f{frame:05d}.png"))
            m = appearance_metrics(pred, gt, mask, lpips_fn,
                                   suppress_white=args.dataset == "actorshq",
                                   device=device)
            for k, v in m.items():
                app[k].append(v)
    for k, v in app.items():
        if v:
            print(k, float(np.mean(v)))
        elif k == "LPIPS":
            # a loud marker, not a silently dropped key: results without
            # LPIPS are not comparable to the published tables
            print("LPIPS UNAVAILABLE (no --lpips_weights supplied; "
                  "PSNR/SSIM only — not comparable to reference LPIPS "
                  "tables)")
    np.savez(os.path.join(args.output_path, "app_metric.npz"),
             **{k: v for k, v in app.items() if v})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
