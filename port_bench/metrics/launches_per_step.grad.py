"""launches_per_step.grad: device kernels a gradient step launches, counted
in the profile (copies and fills left out)."""


def read(ctx):
    if not ctx.device_events:
        return None
    n = sum(1 for name, _, _ in ctx.device_events
            if not name.startswith(("Memcpy", "Memset")))
    return n / len(ctx.units)
