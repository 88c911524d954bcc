"""grad_rays_per_s: the exact forward scene queries of every gradient step
the window completed, over the window's seconds."""

from port_bench import yardstick


def read(ctx):
    if not ctx.units:
        return None
    return yardstick.rate(sum(u.rays for u in ctx.units), ctx.window_s)
