"""step_self_ms_per_frame (program span): host ms of the spans
icp_slam.step outside their icp_slam.frame (the state load, the snapshot
and the info's unrow), over the profiled frames."""

from slambench.metrics._spans import intersect, length, named, traced


def read(ctx):
    if not traced(ctx):
        return None
    steps = named(ctx, "step")
    if not steps:
        return None
    own = length(steps) - length(intersect(steps, named(ctx, "frame")))
    return own / 1e6 / ctx.profiled_frames()
