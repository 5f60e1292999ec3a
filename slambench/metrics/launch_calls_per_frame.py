"""launch_calls_per_frame (device trace): the runtime's kernel and graph
launch calls in the profiled block, over its frames."""

from slambench.metrics._device import per_frame


def read(ctx):
    return per_frame(ctx, ctx.trace.launches if ctx.trace else 0)
