"""host_syncs_per_frame (device trace): the runtime's calls that wait for
the device (stream, event and device synchronisations, synchronous
copies) in the profiled block, over its frames."""

from slambench.metrics._device import per_frame


def read(ctx):
    return per_frame(ctx, ctx.trace.syncs if ctx.trace else 0)
