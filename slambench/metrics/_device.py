"""Counts of the profiled block's trace a frame."""


def per_frame(ctx, value):
    if ctx.trace is None or not ctx.profiled:
        return None
    return value / ctx.profiled_frames()
