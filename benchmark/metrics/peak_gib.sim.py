"""The run's peak of allocated device memory (``max_memory_allocated``,
set-up included), GiB."""


def read(ctx):
    if ctx["peak_bytes"] is None:
        return None
    return ctx["peak_bytes"] / 2 ** 30
