"""device_idle_pct.progressive: the share of the traced window in which no
kernel, copy or fill ran on the device, in %. The profile records the
device's activity alone, so the host's pace is the program's own."""

from port_bench import yardstick


def read(ctx):
    if not ctx.device_events or not ctx.trace_window:
        return None
    return yardstick.idle_pct([(s, e) for _, s, e in ctx.device_events],
                              ctx.trace_window)
