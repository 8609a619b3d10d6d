"""A traced run reads a number for every metric of the program's spans
and counters that its cell lists (``benchmark/spans.py``): the cut
cells on the CPU, one after the other in one process, so each reads its
own session and not the one before."""

from __future__ import annotations

import time

import torch
from conftest import tiny

from benchmark import harness

CPU = torch.device("cpu")
SPEC = harness.load_json(harness.ROOT / "BENCHMARK.json")
READERS = {m["name"] for m in SPEC["per_layer"]
           if m["source"] in ("program_span", "program_counter")
           and m["name"] != "peak_gib.sim"}


def _listed(workload):
    return {m["name"] for m in harness.metrics_of(SPEC, "per_layer",
                                                  workload)} & READERS


def test_traced_runs_read_every_span_metric_they_list():
    got = {}
    for workload in ("garment200.playback", "demo_sand250.release",
                     "garment200.material_step"):
        res = harness.run_cell(workload, 2147483647 + 11, 0.0, True, CPU,
                               time.perf_counter(), tweak=tiny)
        listed = _listed(workload)
        assert listed and listed <= set(res["metrics"]), \
            sorted(listed - set(res["metrics"]))
        got[workload] = {k: res["metrics"][k]["value"] for k in listed}
    sim, train = got["demo_sand250.release"], got["garment200.material_step"]
    # the five phases lie inside the substep; the demo's 50 windows are
    # all closed in its first frames
    assert sum(sim[f"{p}_host_us.sim"] for p in
               ("windows", "stress", "p2g", "grid", "g2p")) \
        <= sim["substep_host_us.sim"]
    assert sim["dead_windows.sim"] == 50.0
    assert sim["frame_glue_us.sim"] > 0.0
    # the CPU path runs the plain versions: no twin, so no twin's backward
    assert train["twin_backward_host_ms.train"] == 0.0
    assert train["forward_host_ms.train"] > 0.0
    assert train["backward_host_ms.train"] > 0.0
