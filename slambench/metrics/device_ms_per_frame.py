"""device_ms_per_frame (device trace): the summed time of every device
operation in the profiled block, over its frames."""

from slambench.metrics._device import per_frame


def read(ctx):
    return per_frame(ctx, ctx.trace.device_ns() / 1e6 if ctx.trace else 0)
