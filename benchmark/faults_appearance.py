"""Faults planted under the stage-2 step, to show that ``correct``
catches them (``benchmark/tests``, and this module's command on the
chip), with ``faults.py``'s names and meanings:

- ``unchanged``: Adam applies no update (``apply_updates_float`` does
  nothing: no moment and no leaf moves);
- ``half``: the image terms (L1, SSIM, LPIPS) over the first half of the
  image's rows;
- ``altered``: each step's loss scaled by 1.01.

    python3 -m benchmark.faults_appearance \\
        --workload avatar1500.appearance_step --seeds 11,12,13 \\
        --seconds 6 --what fault:unchanged,fault:half,fault:altered

prints one JSON line per reading, as ``benchmark.control`` does; entries
of ``--what`` that are not faults are ``control.readings``'.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

import torch

from mpmavatar_tpu_torch.train import appearance
from mpmavatar_tpu_torch.utils import lpips

from . import check, control, harness
from .faults import _patched

FAULTS = ("unchanged", "half", "altered")


def _top_half(fn, method=False):
    """``fn`` of two images over their first half of rows (``method``: a
    method, its instance first)."""
    def half(*args):
        own, (a, b) = args[:method], args[method:]
        rows = a.shape[-2] // 2
        return fn(*own, a[..., :rows, :], b[..., :rows, :])
    return half


@contextlib.contextmanager
def plant(name: str):
    """The fault ``name`` patched into the program while active."""
    if name == "unchanged":
        with _patched(appearance, "apply_updates_float",
                      lambda optimizer, params, grads: None):
            yield
    elif name == "half":
        with _patched(appearance, "l1_loss", _top_half(appearance.l1_loss)), \
                _patched(appearance, "ssim", _top_half(appearance.ssim)), \
                _patched(lpips.LPIPS, "forward",
                         _top_half(lpips.LPIPS.forward, True)):
            yield
    elif name == "altered":
        make = appearance.make_train_step

        def scaled(*a, **k):
            step = make(*a, **k)

            def run(*args):
                loss, aux = step(*args)
                return loss * 1.01, aux
            return run
        with _patched(appearance, "make_train_step", scaled):
            yield
    else:
        raise KeyError(name)


def readings(workload: str, seed: int, seconds: float, whats, device,
             spec=None, tweak=None) -> list:
    """One reading per entry of ``whats``: ``fault:<name>`` with that
    fault planted around a driver built and run as ``control.readings``
    builds and runs one; the others through ``control.readings``."""
    spec = spec if spec is not None else harness.load_json(
        harness.ROOT / "BENCHMARK.json")
    plain = [w for w in whats if not w.startswith("fault:")]
    out = control.readings(workload, seed, seconds, plain, device, spec,
                           tweak) if plain else []
    _, cfg, traffic = harness.cell_files(spec, workload)
    if tweak is not None:
        tweak(cfg, traffic)
    for what in whats:
        if not what.startswith("fault:"):
            continue
        t0 = time.perf_counter()
        with plant(what.split(":", 1)[1]):
            drv = harness.make_driver(cfg, traffic, seed, device)
            units, start = 0, time.perf_counter()
            while time.perf_counter() - start < seconds or units == 0:
                drv.run_unit()
                units += 1
        drv.release()
        nums = check.numbers(drv)
        out.append(dict(nums, workload=workload, seed=seed, what=what,
                        units=units, seconds=time.perf_counter() - t0))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=4.0)
    p.add_argument("--what", default="fault:unchanged,fault:half,"
                   "fault:altered")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",")):
        for line in readings(args.workload, seed, args.seconds,
                             args.what.split(","), device):
            print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
