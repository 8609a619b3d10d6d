"""A configuration, a traffic mix and a metric dropped in by name are
found with no edit to the harness."""

from __future__ import annotations

import json
import shutil
import time

import torch
from conftest import ROOT, tiny

from benchmark import harness


def test_new_files_are_picked_up_by_name(tmp_path, monkeypatch):
    here = tmp_path / "benchmark"
    for sub in ("configs", "traffic", "metrics", "limits"):
        shutil.copytree(ROOT / "benchmark" / sub, here / sub)
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((here / "configs" / "garment200.json").read_text())
    cfg["pins"] = {"num_joint_v": 12, "num_joint_f": 0}
    (here / "configs" / "garment_dropped.json").write_text(json.dumps(cfg))
    mix = json.loads((here / "traffic" / "playback.json").read_text())
    mix["poses"] = 3
    (here / "traffic" / "playback_dropped.json").write_text(json.dumps(mix))
    (here / "metrics" / "frames_done.py").write_text(
        "def read(ctx):\n    return float(ctx['units'])\n")
    # a second metric of the same quantity finds the quantity's reader
    (here / "metrics" / "frames.py").write_text(
        "def read(ctx):\n    return 2.0 * ctx['units']\n")
    (here / "limits" / "garment_dropped.playback_dropped.json").write_text(
        json.dumps({"limits": {"x_max": 1e9}}))
    spec["configs"].append(dict(spec["configs"][0], name="garment_dropped",
                                file="benchmark/configs/garment_dropped.json"))
    spec["workloads"].append({"name": "garment_dropped.playback_dropped",
                              "config": "garment_dropped",
                              "traffic": "playback_dropped", "chips": 1,
                              "why": "dropped in"})
    spec["end_to_end"].append({"name": "frames_done", "unit": "frames",
                               "better": "higher", "bound": 0.25,
                               "source": "host_clock",
                               "workloads": ["garment_dropped."
                                             "playback_dropped"]})
    spec["end_to_end"].append(dict(spec["end_to_end"][-1],
                                   name="frames.dropped"))
    monkeypatch.setattr(harness, "HERE", here)
    monkeypatch.setattr(harness, "ROOT", tmp_path)
    seen = {}

    def tweak(c, t):
        seen.update(pins=c["pins"], poses=t["poses"])
        tiny(c, t)
        c["pins"] = {"num_joint_v": 12, "num_joint_f": 0}
        t["poses"] = 3

    res = harness.run_cell("garment_dropped.playback_dropped", 3, 0.0, False,
                           torch.device("cpu"), time.perf_counter(),
                           spec=spec, tweak=tweak)
    assert seen == {"pins": {"num_joint_v": 12, "num_joint_f": 0},
                    "poses": 3}
    assert res["metrics"]["frames_done"]["value"] == 1.0
    assert res["metrics"]["frames.dropped"]["value"] == 2.0
    assert set(res["metrics"]) == {"setup_s", "frames_done",
                                   "frames.dropped"}
    assert res["checks"]["x_max"]["limit"] == 1e9 and res["correct"]
