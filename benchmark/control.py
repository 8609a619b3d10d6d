"""The readings that the limits of ``limits/<workload>.json`` are set from
(the benchmark's own runs do not call this):

    python3 -m benchmark.control --workload garment200.playback \\
        --seeds 11,12,13 --seconds 6 --what program,control

For each seed: set-up and a window of ``--seconds`` as a run makes them,
then the cell's numbers for each of ``--what``: ``program`` (the
program against the reference, as a run reads them), ``control`` (the
reference computed in TF32, the precision below the configuration's,
against the reference), ``fault:<name>`` (the program with a fault of
``benchmark/faults.py`` planted, against the reference).  One JSON line
per reading.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

import torch

from . import check, faults, harness


def readings(workload: str, seed: int, seconds: float, whats, device,
             spec=None, tweak=None) -> list:
    """One reading per entry of ``whats``; ``program`` and ``control``
    share one set-up and window, each fault has its own."""
    spec = spec if spec is not None else harness.load_json(
        harness.ROOT / "BENCHMARK.json")
    _, cfg, traffic = harness.cell_files(spec, workload)
    if tweak is not None:
        tweak(cfg, traffic)
    kind = "train" if traffic["driver"] == "material_step" else "sim"
    plain = [w for w in whats if not w.startswith("fault:")]
    runs = ([(None, plain)] if plain else []) + [
        (w, [w]) for w in whats if w.startswith("fault:")]
    out = []
    for fault, reads in runs:
        planted = faults.plant(kind, fault.split(":", 1)[1]) if fault \
            else contextlib.nullcontext()
        t0 = time.perf_counter()
        with planted:
            drv = harness.make_driver(cfg, traffic, seed, device)
            units, start = 0, time.perf_counter()
            while time.perf_counter() - start < seconds or units == 0:
                drv.run_unit()
                units += 1
        drv.release()
        for what in reads:
            nums = check.numbers(drv, control=(what == "control"))
            out.append(dict(nums, workload=workload, seed=seed, what=what,
                            units=units, seconds=time.perf_counter() - t0))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=4.0)
    p.add_argument("--what", default="program,control")
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
