"""The program's own spans and counters in the traced units
(``mpmavatar_tpu_torch/utils/profiling.py``): the profiler that traces
the units turns them on, and ``snapshot()`` after the window reads that
session.  Each reading is per traced substep or step, under the
profiler, like ``device_idle.*``.  A program without the spans, or a
session whose denominator is not the cell's traced units, reads
nothing."""

from __future__ import annotations


def snapshot():
    """The program's newest tracing session, or None."""
    try:
        from mpmavatar_tpu_torch.utils import profiling
    except ImportError:
        return None
    read = getattr(profiling, "snapshot", None)
    return None if read is None else read()


def sim(ctx):
    """(spans, counters) of the traced frames when the session holds one
    ``substep`` span per traced substep, else None."""
    snap = snapshot() if "substeps" in ctx else None
    if snap is None or snap["spans"].get("substep", {}).get("count") \
            != ctx["substeps"]:
        return None
    return snap["spans"], snap["counters"]


def per_substep_us(ctx, name, key="total_ns"):
    """Span ``name``'s ``key`` per traced substep, in us."""
    got = sim(ctx)
    if got is None or name not in got[0]:
        return None
    return got[0][name][key] * 1e-3 / ctx["substeps"]


def train(ctx):
    """The spans of the traced steps when the session holds one
    ``train.step`` span per traced step, else None."""
    snap = snapshot() if "substeps" in ctx else None
    if snap is None or snap["spans"].get("train.step", {}).get("count") \
            != ctx["units"]:
        return None
    return snap["spans"]


def per_step_ms(ctx, prefix):
    """The total of the spans whose name starts with ``prefix``, per
    traced step, in ms (0 where none ran)."""
    spans = train(ctx)
    if spans is None:
        return None
    return sum(s["total_ns"] for name, s in spans.items()
               if name.startswith(prefix)) * 1e-6 / ctx["units"]
