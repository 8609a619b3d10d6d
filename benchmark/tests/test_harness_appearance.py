"""The stage-2 cell through the harness on the CPU at a cut size of its
own (96 x 64, a 20 x 18 body mesh, ``work_cap`` 64, 4 views, 3 frames),
judged by the cell's limits: a sound run is correct, each fault of
``faults_appearance.py`` is not, the control's numbers are read, the
whole step's share of the peak reads under 100 at a chip run's shape,
and an untraced run reads none of the cell's per-layer metrics."""

from __future__ import annotations

import time

import pytest
import torch

from benchmark import (avatar_scene, check, faults_appearance, harness,
                       roofline_appearance)
from benchmark.reference.appearance import Appearance
from benchmark.reference.arith import Arith

torch.set_num_threads(1)

CPU = torch.device("cpu")
CELL = "avatar1500.appearance_step"
SEED = 2147483647123


def cut(cfg: dict, traffic: dict) -> None:
    cfg["image"].update(width=96, height=64, focal=1400.0 * 96 / 1500)
    cfg["mesh"].update(n_theta=20, n_phi=18)
    cfg["raster"]["work_cap"] = 64
    cfg["cameras"], cfg["frames"] = 4, 3
    traffic.update(views=4, keep_within=1)


def _run(seed=SEED):
    return harness.run_cell(CELL, seed, 0.0, False, CPU, time.perf_counter(),
                            tweak=cut)


def test_a_sound_run_is_correct_and_reads_no_per_layer_metric():
    res = _run()
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["readings"]["window_step"] == 1
    # no peak on the CPU
    assert set(res["metrics"]) == {"train_step_ms", "setup_s"}
    spec = harness.load_json(harness.ROOT / "BENCHMARK.json")
    ctx = {"units": 1, "done": 1, "window_s": 0.3, "setup_s": 9.0,
           "peak_bytes": None, "least_s": 0.04}
    for m in harness.metrics_of(spec, "per_layer", CELL):
        assert harness.reader(m["name"])(ctx) is None, m["name"]


@pytest.mark.parametrize("fault", faults_appearance.FAULTS)
def test_a_fault_makes_the_run_incorrect(fault):
    with faults_appearance.plant(fault):
        res = _run()
    assert not res["correct"], res["checks"]


def test_the_control_is_read_and_is_not_correct():
    spec = harness.load_json(harness.ROOT / "BENCHMARK.json")
    _, cfg, traffic = harness.cell_files(spec, CELL)
    cut(cfg, traffic)
    drv = harness.make_driver(cfg, traffic, SEED, CPU)
    drv.run_unit()
    drv.release()
    sound = check.numbers(drv)
    ctl = check.numbers(drv, control=True)
    assert set(ctl) >= {"loss", "grad", "change"}
    ok, checks = check.judge(ctl, harness.limits_of(CELL))
    assert not ok, checks
    assert ctl["grad"] > 10 * sound["grad"]


def test_the_whole_step_reads_under_100_at_a_chip_runs_shape():
    """The least time of the full configuration's step (its counts from
    the scene at full size) against the CLI's H100 step without LPIPS, 163.2
    ms: the count never reads over 100%."""
    spec = harness.load_json(harness.ROOT / "BENCHMARK.json")
    _, cfg, _ = harness.cell_files(spec, CELL)
    raw = avatar_scene.inputs(cfg, SEED)
    nf = len(raw["faces"])
    first = avatar_scene.first_state(cfg, raw, SEED)
    ref = Appearance(cfg, raw, first["splats.alive"], first["splats.binding"],
                     CPU, Arith(False))
    counts = roofline_appearance.raster_counts(ref, first, 0, 0, 512, 32)
    held = 20_139_546       # the driver's Adam-held elements at this shape
    least = roofline_appearance.step_work(cfg, counts, nf, held).seconds()
    assert 0.035 < least < 0.05
    ctx = {"plain_units": 100, "plain_s": 100 * 0.1632, "least_s": least}
    share = harness.reader("mfu.appearance")(ctx)
    assert 0 < share < 100
