"""One run of one cell, found by name.

``BENCHMARK.json`` names the cell's configuration and traffic; the
configuration is ``configs/<config>.json``, the traffic
``traffic/<traffic>.json`` (its ``driver`` picks ``drivers/<driver>.py``),
each metric ``metrics/<metric>.py`` or ``metrics/<stem>.py`` (a
``read(ctx)`` that returns a number, or None where the cell has nothing
to read), the limits that
decide ``correct`` ``limits/<workload>.json``.  A later cell, mix, configuration or metric
is new files and new entries, with no edit here.

A run: set-up (the driver builds the program's objects from the seed and
warms up every shape the cell uses), then whole units (frames or
training steps) until ``seconds`` have passed, each ending in a
synchronize; with ``trace`` the first ``trace_units`` of them run under
``torch.profiler`` and the rest without it.  Then the peak memory is read, the program's objects
are dropped, and the reference judges what the window and set-up
produced.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import time
from pathlib import Path

import torch

from . import check, trace

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_files(spec: dict, workload: str) -> tuple[dict, dict, dict]:
    """(workload entry, configuration, traffic) of a cell."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    configs = {c["name"]: c for c in spec["configs"]}
    cfg = load_json(ROOT / configs[cell["config"]]["file"])
    traffic = load_json(HERE / "traffic" / f"{cell['traffic']}.json")
    return cell, cfg, traffic


def limits_of(workload: str) -> dict:
    path = HERE / "limits" / f"{workload}.json"
    return load_json(path)["limits"] if path.exists() else {}


def reader(metric: str):
    """``metrics/<metric>.py``'s ``read``, or where there is none the
    reader of its quantity, ``metrics/<stem>.py`` (``mfu.sim`` and
    ``mfu.train`` both read ``mfu.py``; the cells that report each are
    ``BENCHMARK.json``'s to say)."""
    path = HERE / "metrics" / f"{metric}.py"
    if not path.exists():
        path = HERE / "metrics" / f"{metric.split('.')[0]}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark.metrics.{metric}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def metrics_of(spec: dict, key: str, workload: str) -> list:
    """The ``end_to_end`` or ``per_layer`` entries that this cell
    reports: those without ``workloads`` and those that list it."""
    return [m for m in spec[key]
            if workload in m.get("workloads", [workload])]


def make_driver(cfg: dict, traffic: dict, seed: int, device):
    module = importlib.import_module(f"benchmark.drivers.{traffic['driver']}")
    return module.Driver(cfg, traffic, seed, device)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(workload: str, seed: int, seconds: float, traced: bool,
             device, started: float, spec: dict | None = None,
             tweak=None) -> dict:
    """The run's result (the keys of its JSON line, ``checks`` last, and
    ``readings``: every number the check computed).  ``started`` is the
    process's start on the host clock; ``tweak(cfg, traffic)`` may edit
    the loaded files (the tests cut sizes with it)."""
    spec = spec if spec is not None else load_json(ROOT / "BENCHMARK.json")
    _, cfg, traffic = cell_files(spec, workload)
    if tweak is not None:
        tweak(cfg, traffic)
    drv = make_driver(cfg, traffic, seed, device)
    _sync(device)
    setup_s = time.perf_counter() - started

    units = done = 0
    summary = None
    gc.collect()            # set-up's garbage, not the window's
    t0 = time.perf_counter()
    if traced:
        n = int(traffic["trace_units"])
        events, done = trace.run_traced(drv.run_unit, n)
        units = n
    t_plain = time.perf_counter()
    while time.perf_counter() - t0 < seconds or units == 0:
        done += drv.run_unit()
        units += 1
    t_end = time.perf_counter()
    window_s = t_end - t0
    if traced:
        summary = trace.summarize(events)
        del events
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else None
    least = drv.least_seconds()
    failed = drv.failed(units)

    ctx = {"units": units, "done": done, "window_s": window_s,
           "setup_s": setup_s, "peak_bytes": peak, "least_s": least}
    if traced:
        # the traced units, and the window's units after them, which ran
        # without the profiler's cost
        n = int(traffic["trace_units"])
        ctx.update(summary, units=n,
                   substeps=n * getattr(drv, "substeps", 1),
                   plain_units=units - n,
                   plain_s=t_end - t_plain)
    metrics = {}
    for m in metrics_of(spec, "per_layer" if traced else "end_to_end",
                        workload):
        value = reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    drv.release()
    readings = check.numbers(drv)
    correct, checks = check.judge(readings, limits_of(workload))
    result = {"correct": correct and failed == 0, "attempted": units,
              "failed": failed, "metrics": metrics,
              "device": {"platform": "gpu" if device.type == "cuda"
                         else device.type,
                         "kind": torch.cuda.get_device_name(device)
                         if device.type == "cuda" else "cpu",
                         "count": 1, "memory_peak_bytes": peak}}
    if summary is not None:
        result["device"].update(busy_s=summary["busy_s"],
                                window_s=summary["window_s"])
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    result["checks"] = checks
    result["readings"] = readings
    return result
