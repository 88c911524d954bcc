"""progressive_samples_per_s: the camera samples (pixels x samples per pixel) of
every frame or slice the window completed, over the window's seconds. The
work is what the harness asked for, not a count the program reports."""

from port_bench import yardstick


def read(ctx):
    if not ctx.units:
        return None
    return yardstick.rate(yardstick.samples(ctx.units, ctx.n_pix),
                          ctx.window_s)
