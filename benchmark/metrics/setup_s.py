"""From the process's start to the window's: imports, the kernels' build
or load, the scene made from the seed, the program's set-up and the
warm-up units."""


def read(ctx):
    return ctx["setup_s"]
