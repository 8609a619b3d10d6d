"""Forward substeps completed in the window over the window's time: whole
frames, their per-frame host work inside, ending in a synchronize."""


def read(ctx):
    return ctx["done"] / ctx["window_s"]
