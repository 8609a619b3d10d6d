"""UV attachment: copy vt / face-uv records from a template onto frames.

Copy of mpmavatar_tpu/preprocess/uv_attach.py (plain Python): every
tracked mesh frame gets the template's UV coordinates, so that AO maps
bake into a consistent chart."""

from __future__ import annotations

import os
from glob import glob


def read_uv_template(uv_path: str):
    """Returns (vt_lines, face_lines) where face lines reference v/vt."""
    vt_lines, face_records = [], []
    with open(uv_path) as f:
        for line in f:
            if line[:2] == "vt":
                vt_lines.append(line)
            elif line[:2] == "f ":
                parts = line.strip().split()
                face_records.append([p.split("/") for p in parts[1:]])
    return vt_lines, face_records


def attach_uv(mesh_path: str, uv_path: str, out_path: str):
    """Write mesh vertices + template vt + combined f v/vt lines."""
    vt_lines, face_records = read_uv_template(uv_path)
    v_lines = []
    with open(mesh_path) as f:
        for line in f:
            if line.startswith("v "):
                v_lines.append(line)
    with open(out_path, "w") as f:
        f.writelines(v_lines)
        f.writelines(vt_lines)
        for rec in face_records:
            f.write("f " + " ".join(f"{p[0]}/{p[1] if len(p) > 1 else p[0]}"
                                    for p in rec) + "\n")


def attach_uv_sequence(mesh_dir: str, uv_path: str, out_dir: str,
                       pattern: str = "mesh_cloth_*.obj"):
    """Batch over a tracked sequence (add_uv_actorshq.py main loop)."""
    os.makedirs(out_dir, exist_ok=True)
    outs = []
    for mesh_path in sorted(glob(os.path.join(mesh_dir, pattern))):
        out = os.path.join(out_dir, os.path.basename(mesh_path))
        attach_uv(mesh_path, uv_path, out)
        outs.append(out)
    return outs
