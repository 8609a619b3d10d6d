"""Kernels, copies and memsets on the device per forward substep in the
traced frames (the substep glue's launches: ``MPMSolver.frame`` ->
``core/stepping.py::p2g2p``, the release windows included)."""


def read(ctx):
    if "device_events" not in ctx:
        return None
    return ctx["device_events"] / ctx["substeps"]
