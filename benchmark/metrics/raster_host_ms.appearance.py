"""Host time in the span ``appearance.raster`` (``train/appearance.py::
render_avatar_frame`` around ``render/rasterizer.py::rasterize``:
projection, binning and sorting, the worklists and K6's two launches) per
traced step, ms."""

from benchmark import spans_appearance


def read(ctx):
    return spans_appearance.per_step_ms(ctx, "appearance.raster")
