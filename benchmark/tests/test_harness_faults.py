"""A run with the timed path broken underneath comes out not correct,
for each fault a cell can have (``benchmark/faults.py``), and so does
the control (the reference in TF32); a sound run comes out correct.
The runs skip the harness's look for a chip and run the rest on the
CPU at a tiny size, judged by the cells' own limits."""

from __future__ import annotations

import time

import pytest
import torch
from conftest import tiny

from benchmark import check, control, faults, harness

CPU = torch.device("cpu")
CELLS = ("garment200.playback", "demo_sand250.release",
         "garment200.material_step")


def _run(workload, seed=17):
    return harness.run_cell(workload, seed, 0.0, False, CPU,
                            time.perf_counter(), tweak=tiny)


@pytest.mark.parametrize("workload", CELLS)
def test_a_sound_run_is_correct(workload):
    res = _run(workload)
    assert res["correct"], res["checks"]
    assert list(res)[-2:] == ["checks", "readings"]


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("fault", faults.FAULTS)
def test_a_fault_makes_the_run_incorrect(workload, fault):
    kind = "train" if "material" in workload else "sim"
    with faults.plant(kind, fault):
        res = _run(workload)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("workload", CELLS)
def test_the_control_is_not_correct(workload):
    (line,) = control.readings(workload, 17, 0.0, ["control"], CPU,
                               tweak=tiny)
    ok, checks = check.judge(line, harness.limits_of(workload))
    assert not ok, checks
