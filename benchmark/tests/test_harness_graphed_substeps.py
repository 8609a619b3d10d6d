"""``graphed_substeps.sim`` reads the counter ``substep.graphed`` from the
program's snapshot per traced substep, and nothing from a program that
has no such counter."""

from __future__ import annotations

import pytest

from benchmark import harness, spans


def _snapshot(counters, substeps=400):
    return {"spans": {"substep": {"count": substeps}}, "counters": counters}


@pytest.mark.parametrize("counters, want", [
    ({"substep.graphed": 400}, 1.0),
    ({"substep.graphed": 0}, 0.0),
    ({"windows.fused": 20000}, None),
])
def test_graphed_substeps_reads_the_counter_per_traced_substep(
        counters, want, monkeypatch):
    monkeypatch.setattr(spans, "snapshot", lambda: _snapshot(counters))
    read = harness.reader("graphed_substeps.sim")
    assert read({"substeps": 400}) == want
    # a session that is not the traced frames' reads nothing
    assert read({"substeps": 399}) is None
