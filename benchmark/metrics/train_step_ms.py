"""The window's time over the training steps completed in it, ms; each
step ends with its loss read back."""


def read(ctx):
    return 1e3 * ctx["window_s"] / ctx["units"]
