"""The numbers that decide ``correct``: what the program produced against
the reference, each held to its limit from ``limits/<workload>.json``.

A simulated frame is judged from the state it started from: the
program's own state for a window frame (the reference cannot follow the
program's thousands of substeps before it in a run's time), the
reference's first state for frame 0, which checks the start.  The
numbers compare the frame's end positions in grid cells and velocities
against the reference's largest.  A training cell compares the first
steps' losses, the first gradient as Adam got it and the parameters'
change after the steps, and the same of one window step replayed from
the program's state, each by its worst leaf.
"""

from __future__ import annotations

import math
import statistics

import torch

from .reference.arith import Arith


# the reading of a state that is not finite: a number over any limit
NOT_FINITE = 1e30


def _frame_numbers(got: dict, ref: dict, dx: float) -> dict:
    if not all(bool(torch.isfinite(got[k]).all()) for k in ("x", "v")):
        return dict.fromkeys(("x_max", "x_rms", "v_max", "v_rms"),
                             NOT_FINITE)
    dxp = (got["x"] - ref["x"]).norm(dim=1)
    dvp = (got["v"] - ref["v"]).norm(dim=1)
    vref = ref["v"].norm(dim=1)
    rms = lambda a: float(torch.sqrt((a.double() ** 2).mean()))
    return {"x_max": float(dxp.max()) / dx, "x_rms": rms(dxp) / dx,
            "v_max": float(dvp.max()) / max(float(vref.max()), 1e-30),
            "v_rms": rms(dvp) / max(rms(vref), 1e-30)}


def sim_numbers(drv, control: bool = False) -> dict:
    """The worst over the kept frames of each number: the program's end
    state against the reference's, or (``control``) the reference in TF32
    against the reference."""
    # the reference's frames, kept for a second reading of the same run
    cache = drv.__dict__.setdefault("reference_frames", {})
    run = drv.reference(Arith(False)) if len(cache) < len(drv.kept) \
        else None
    alt = drv.reference(Arith(True)) if control else None
    dx = drv.cfg["grid_lim"] / drv.cfg["grid_size"]
    worst = {}
    for key, (k, start, prog_end) in drv.kept.items():
        if key not in cache:
            cache[key] = run(k, start)
        got = alt(k, start) if control else prog_end
        for name, val in _frame_numbers(got, cache[key], dx).items():
            worst[name] = max(worst.get(name, 0.0), val)
    worst["frames"] = sorted(k for k, _, _ in drv.kept.values())
    return worst


def _leaf_gaps(a: dict, b: dict, keys, all_keys) -> float:
    """Worst over ``keys`` of the signed gap |a - b| against |b| of that
    leaf or of the median leaf of ``all_keys``, whichever is larger."""
    if not keys:
        return 0.0
    med = statistics.median(abs(b[k]) for k in all_keys)
    return max(abs(a[k] - b[k]) / max(abs(b[k]), med, 1e-30) for k in keys)


def _step_numbers(loss_got, loss_ref, grad_got, grad_ref, change_got,
                  change_ref) -> tuple[float, float, float]:
    """(loss, grad, change) of one check: the worst step's relative loss
    gap, and the gradient's and the change's signed gaps on the worst
    leaf; a leaf whose reference gradient is under a thousandth of the
    median leaf's moves by round-off alone and is left out of the
    change."""
    loss = max((abs(a - b) / max(abs(b), 1e-30) if math.isfinite(a)
                else NOT_FINITE) for a, b in zip(loss_got, loss_ref))
    keys = list(grad_ref)
    med = statistics.median(abs(grad_ref[k]) for k in keys)
    moving = [k for k in keys if abs(grad_ref[k]) >= 1e-3 * med]
    return (loss, _leaf_gaps(grad_got, grad_ref, keys, keys),
            _leaf_gaps(change_got, change_ref, moving, keys))


def train_numbers(got: dict, ref: dict) -> dict:
    """loss, grad and change, each the worse of two checks: the first
    steps of set-up (each step's loss, the first gradient, the
    parameters' change after the steps) and the kept window step (its
    loss, gradient and change, replayed by the reference from the state
    the program started it from)."""
    keys = list(ref["grad"])
    delta = lambda p, start: {k: p[k] - start[k] for k in keys}
    setup = _step_numbers(got["loss"], ref["loss"], got["grad"], ref["grad"],
                          delta(got["params"], got["init"]),
                          delta(ref["params"], ref["init"]))
    out = dict(zip(("loss_setup", "grad_setup", "change_setup"), setup))
    out["grad_ref"] = dict(ref["grad"])
    gw, rw = got.get("window"), ref.get("window")
    if gw is not None:
        window = _step_numbers([gw["loss"]], [rw["loss"]], gw["grad"],
                               rw["grad"], delta(gw["p1"], gw["p0"]),
                               delta(rw["p1"], rw["p0"]))
        out.update(zip(("loss_window", "grad_window", "change_window"),
                       window), window_step=gw["index"],
                   grad_ref_window=dict(rw["grad"]))
        setup = tuple(max(a, b) for a, b in zip(setup, window))
    out.update(zip(("loss", "grad", "change"), setup))
    return out


def numbers(drv, control: bool = False) -> dict:
    """The cell's numbers for the program, or for the control."""
    if drv.kind == "sim":
        return sim_numbers(drv, control)
    ref = drv.__dict__.get("reference_steps") or drv.reference(Arith(False))
    drv.reference_steps = ref
    got = drv.reference(Arith(True)) if control else drv.program()
    return train_numbers(got, ref)


def judge(readings: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}) over the limited numbers; a
    cell without limits is not correct."""
    checks = {name: {"value": readings[name], "limit": lim}
              for name, lim in limits.items()}
    ok = bool(checks) and all(c["value"] <= c["limit"]
                              for c in checks.values())
    return ok, checks
