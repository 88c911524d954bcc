"""grad_peak_gb: the device memory the window's gradient steps held at
their peak (torch.cuda.max_memory_allocated after a reset at the window's
start), in GB of 1e9 bytes."""


def read(ctx):
    return ctx.peak_bytes / 1e9
