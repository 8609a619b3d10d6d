"""Merge separately simulated layered garments (4D-DRESS upper / lower),
port of scripts/merge_meshes.py: per frame, the lower pass's full mesh
with its vertices at the upper garment's indices
(``reordered_cloth_v_idx`` of split_idx_upper.npz) replaced by the upper
pass's (``train/evaluate.py::merge_layered_meshes``); faces carried over
from the lower mesh.  Host numpy only.

    python -m mpmavatar_tpu_torch.train.merge_meshes --seq s170_t1 \\
        --output_dir ./output/phys \\
        --split_idx_upper ./data/s170_t1/split_idx_upper.npz
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np

from ..utils.io import read_obj, write_obj
from .evaluate import merge_layered_meshes


def merge_dirs(upper_dir: str, lower_dir: str, out_dir: str,
               upper_cloth_v_idx) -> int:
    """Merge every frame of two uvmesh directories; returns the frame
    count."""
    uppers = sorted(glob.glob(os.path.join(upper_dir, "*.obj")))
    lowers = sorted(glob.glob(os.path.join(lower_dir, "*.obj")))
    if len(uppers) != len(lowers):
        raise RuntimeError(f"frame count mismatch: {len(uppers)} upper vs "
                           f"{len(lowers)} lower meshes")
    os.makedirs(out_dir, exist_ok=True)
    idx = np.asarray(upper_cloth_v_idx)
    for uf, lf in zip(uppers, lowers):
        upper_v, _ = read_obj(uf)
        lower_v, lower_f = read_obj(lf)
        write_obj(os.path.join(out_dir, os.path.basename(lf)),
                  merge_layered_meshes(lower_v, upper_v, idx), lower_f)
    return len(uppers)


def main(argv=None, log=print) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seq", type=str, required=True)
    parser.add_argument("--output_dir", type=str, default="./output/phys")
    parser.add_argument("--split_idx_upper", type=str, required=True,
                        help="split_idx_upper.npz with "
                        "reordered_cloth_v_idx")
    args = parser.parse_args(argv)
    split = np.load(args.split_idx_upper)
    out = os.path.join(args.output_dir, args.seq, "uvmesh")
    n = merge_dirs(os.path.join(args.output_dir, f"{args.seq}_upper",
                                "uvmesh"),
                   os.path.join(args.output_dir, f"{args.seq}_lower",
                                "uvmesh"),
                   out, split["reordered_cloth_v_idx"])
    log(f"merged {n} frames -> {out}")
    return n


if __name__ == "__main__":
    main()
