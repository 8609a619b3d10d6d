"""Kernels, copies and memsets on the device per step: the reader of
``launches_per_step.<kind>`` where no reader of its own is there (stage
2's ``train/appearance.py::make_train_step``)."""


def read(ctx):
    if "device_events" not in ctx:
        return None
    return ctx["device_events"] / ctx["units"]
