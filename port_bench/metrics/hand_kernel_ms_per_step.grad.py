"""hand_kernel_ms_per_step.grad: device ms a gradient step spends in the
port's hand-written kernels (the recorder, the gathers, the reductions and
sorts), by kernel name in the profile."""

from port_bench import yardstick


def read(ctx):
    if not ctx.device_events:
        return None
    s = sum(e - s0 for name, s0, e in ctx.device_events
            if yardstick.kernel_name(name) in yardstick.HAND_KERNELS)
    return s * 1e3 / len(ctx.units)
