"""Misc host utilities: seeding, subprocess runner, ffmpeg video helper
(the port's own copy of mpmavatar_tpu/utils/misc.py).

Ports of the reference's utils/general_utils.py:263-279 (safe_state),
utils/subprocess_utils.py:4-41 (run_subprocess) and the scripts' ffmpeg
calls (train_material_params.py:878-881)."""

from __future__ import annotations

import os
import random
import subprocess
import sys
import time


def safe_state(seed: int = 0, silent: bool = False):
    """Seed python/numpy and (like the reference) optionally timestamp
    stdout lines."""
    import numpy as np
    random.seed(seed)
    np.random.seed(seed)
    if not silent:
        old = sys.stdout

        class _F:
            def write(self, x):
                if x.endswith("\n"):
                    stamp = time.strftime("%d/%m %H:%M:%S")
                    old.write(x.replace("\n", f" [{stamp}]\n"))
                else:
                    old.write(x)

            def flush(self):
                old.flush()

        sys.stdout = _F()
    return seed


def run_subprocess(command, label: str = "subprocess", check: bool = True):
    """Run a command, streaming output with a label prefix."""
    print(f"[{label}] $ {' '.join(map(str, command))}", flush=True)
    try:
        proc = subprocess.Popen(list(map(str, command)),
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
    except FileNotFoundError as e:
        # missing binary (e.g. no ffmpeg in the image): degrade like a
        # nonzero exit under check=False instead of crashing the caller
        if check:
            raise
        print(f"[{label}] unavailable: {e}", flush=True)
        return 127
    for line in proc.stdout:
        print(f"[{label}] {line}", end="", flush=True)
    rc = proc.wait()
    if check and rc != 0:
        raise RuntimeError(f"{label} failed with exit code {rc}")
    return rc


def frames_to_video(frame_pattern: str, out_path: str, fps: int = 25,
                    start_number: int = 0, num_frames: int = None):
    """ffmpeg PNG-sequence -> mp4 (train_material_params.py:879)."""
    cmd = ["ffmpeg", "-y", "-hide_banner", "-loglevel", "error",
           "-framerate", fps, "-start_number", start_number,
           "-i", frame_pattern]
    if num_frames:
        cmd += ["-frames:v", num_frames]
    cmd += ["-pix_fmt", "yuv420p", "-vf",
            "scale='trunc(iw/2)*2:trunc(ih/2)*2'", out_path]
    return run_subprocess(cmd, label="ffmpeg", check=False)
