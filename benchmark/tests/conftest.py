"""Shared by the harness's CPU tests: the repo root on the path, and the
cells cut to a size the CPU runs in seconds (widths and all, so the
faults and the control show as they do at the cells' size)."""

from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def tiny(cfg: dict, traffic: dict) -> None:
    """Cut a cell's configuration and traffic in place: a 12 x 12 cloth or
    skirt on a 32^3 grid, a coarse body, frames of 20 substeps at dt
    1e-4, a few poses, a small sand block."""
    cfg["grid_size"] = 32
    cfg["substep"], cfg["fps"] = 20, 500
    if cfg["scene"] == "garment":
        cfg["cloth"]["nx"] = 12
        cfg["body"].update(n_theta=9, n_phi=10)
        cfg["pins"] = {"num_joint_v": 12, "num_joint_f": 6}
        cfg["walk"] = {"root_turn_per_s": 5.0, "rise_per_s": 0.5,
                       "pose_sigma_per_s": 5.0}
        traffic["poses"] = 4
    else:
        cfg["skirt"]["n"] = [12, 12]
        cfg["collider_capsule"] = [8, 8]
        cfg["rig"].update(capsule=[12, 10], verts=100)
        cfg["sand"]["res"] = [10, 4, 5]
        cfg["poses"] = 4
