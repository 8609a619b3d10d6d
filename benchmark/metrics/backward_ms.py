"""Device time per step of the kernels launched from autograd's backward,
ms: the reader of ``backward_ms.<kind>`` where no reader of its own is
there (stage 2's: K7, the binding gathers' scatter-adds, LPIPS's and the
UNet's data gradients)."""


def read(ctx):
    if "backward_s" not in ctx:
        return None
    return 1e3 * ctx["backward_s"] / ctx["units"]
