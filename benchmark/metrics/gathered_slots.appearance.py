"""Slots the binding gathers touch per traced stage-2 step: the counter
``binding.gathered_slots`` (``render/gaussians.py::bound_rows``, one add
of the binding's length per per-face table gathered)."""

from benchmark import spans_appearance


def read(ctx):
    got = spans_appearance.session(ctx)
    if got is None or "binding.gathered_slots" not in got[1]:
        return None
    return got[1]["binding.gathered_slots"] / ctx["units"]
