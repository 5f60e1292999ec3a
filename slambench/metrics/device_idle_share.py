"""device_idle_share (device trace): the share of the profiled block's wall
in which no device operation ran: 100 (1 - union of the operations'
intervals / the block's length)."""


def read(ctx):
    if ctx.trace is None:
        return None
    wall = ctx.block_ns[1] - ctx.block_ns[0]
    return 100.0 * (1.0 - ctx.trace.busy_ns() / wall) if wall > 0 else None
