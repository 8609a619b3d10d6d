"""``BENCHMARK.json`` against the contract's shape: keys, names, units,
bounds, files found by name, and what each cell reports."""

from __future__ import annotations

import json
import math
import re

from conftest import ROOT

from benchmark import harness

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}\Z")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}\Z")
PATH = re.compile(r"[A-Za-z0-9_./-]{1,200}\Z")
WIDTH = re.compile(r"(_dim|_rank)\Z|hidden|intermediate|latent|width|"
                   r"head|expansion|experts_per")
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_size():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(SPEC["paths"]) <= 16
    for p in SPEC["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch") and (ROOT / p).is_dir()
    cmd = SPEC["command"]
    assert 1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)
    assert isinstance(SPEC["run_seconds"], int) and \
        1 <= SPEC["run_seconds"] <= 51


def test_the_check_fits_its_time_with_24_cells():
    r = SPEC["run_seconds"]
    assert (2 + 14 * 24) * (r + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_entries():
    names = set()
    for key, fields in (("configs", {"name", "source", "file", "reduced",
                                     "why"}),
                        ("workloads", {"name", "config", "traffic", "chips",
                                       "why"})):
        for entry in SPEC[key]:
            assert set(entry) == fields
            assert NAME.match(entry["name"])
            assert _line(entry["why"])
    for entry in SPEC["configs"]:
        assert _line(entry["source"]) and len(entry["reduced"]) <= 16
        for k in entry["reduced"]:
            assert NAME.match(k) and not WIDTH.search(k)
        assert entry["file"].startswith(tuple(p + "/" for p in SPEC["paths"]))
        assert (ROOT / entry["file"]).is_file()
    for w in SPEC["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4)
    metrics = SPEC["end_to_end"] + SPEC["per_layer"]
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        names.add(m["name"])
    assert len(names) == len(metrics)
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"])
    assert {m["name"] for m in SPEC["end_to_end"]} >= {"setup_s"}
    assert next(m for m in SPEC["end_to_end"]
                if m["name"] == "setup_s")["bound"] <= 0.25


def test_every_cell_finds_its_files_and_reports_enough():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    configs = {c["name"] for c in SPEC["configs"]}
    used = set()
    pairs = {(w["config"], w["traffic"]) for w in SPEC["workloads"]}
    assert len(pairs) == len(SPEC["workloads"])
    for w in SPEC["workloads"]:
        assert w["config"] in configs
        used.add(w["config"])
        harness.cell_files(SPEC, w["name"])
        assert harness.limits_of(w["name"])
        ends = [m["name"] for m in harness.metrics_of(SPEC, "end_to_end",
                                                      w["name"])]
        layers = harness.metrics_of(SPEC, "per_layer", w["name"])
        assert "setup_s" in ends and len(ends) >= 2 and layers
        for m in layers:
            assert m["moves"] in ends
    assert used == configs
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert callable(harness.reader(m["name"]))
        for w in m.get("workloads", []):
            assert w in {c["name"] for c in SPEC["workloads"]}
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e


def test_at_most_a_quarter_of_the_cells_take_four_chips():
    four = sum(w["chips"] == 4 for w in SPEC["workloads"])
    assert four <= max(1, math.floor(len(SPEC["workloads"]) / 4))


def test_shares_of_a_peak_read_under_100_on_a_chip_run_shape():
    ctx = {"units": 1, "substeps": 400, "busy_s": 0.2, "window_s": 1.6,
           "least_s": 0.004, "device_events": 40000, "peak_bytes": 2 ** 30,
           "plain_units": 20, "plain_s": 16.0}
    # the whole frame's share from the frames after the traced one
    assert harness.reader("mfu.sim")(ctx) == 0.5
    assert harness.reader("mfu.train")(ctx) == 0.5
    assert harness.reader("kernel_roofline.sim")(ctx) == 2.0
    assert harness.reader("device_idle.sim")(ctx) == 87.5
    # an untraced run, or a traced one with no unit after the traced ones,
    # has nothing to read
    assert harness.reader("mfu.sim")(dict(ctx, plain_units=0)) is None
    assert harness.reader("device_idle.train")({"window_s": 1.0}) is None
