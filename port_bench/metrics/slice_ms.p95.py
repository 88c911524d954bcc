"""slice_ms.p95: the 95th percentile over the window's slices of one
slice's time from the call to its image on the host, in ms."""

from port_bench import yardstick


def read(ctx):
    if not ctx.units:
        return None
    return yardstick.percentile([u.seconds * 1e3 for u in ctx.units], 95)
