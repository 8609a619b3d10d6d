"""The stage-2 step's spans and counter in the traced units
(``train/appearance.py``; the binding's counter in
``render/gaussians.py``), read through ``spans.snapshot``.  Each reading
is per traced step, under the profiler; a program without the spans, or a
session that does not hold one ``appearance.step`` per traced step, reads
nothing."""

from __future__ import annotations

from . import spans


def session(ctx):
    """(spans, counters) of the traced steps, or None."""
    snap = spans.snapshot() if "substeps" in ctx else None
    if snap is None or snap["spans"].get("appearance.step", {}).get(
            "count") != ctx["units"]:
        return None
    return snap["spans"], snap["counters"]


def per_step_ms(ctx, name):
    """Span ``name``'s total host time per traced step, ms."""
    got = session(ctx)
    if got is None or name not in got[0]:
        return None
    return got[0][name]["total_ns"] * 1e-6 / ctx["units"]
