"""Kernels, copies and memsets on the device per training step
(``train/material.py::MaterialTrainer.train_one_step``)."""


def read(ctx):
    if "device_events" not in ctx:
        return None
    return ctx["device_events"] / ctx["units"]
