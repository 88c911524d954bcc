"""setup_s: seconds from the start of the run to the start of its window:
imports, the scene's compile, the kernels' build (in a checkout's first
run) and the warm-up unit."""


def read(ctx):
    return ctx.setup_s
