"""read_idle_ms_per_frame (program span): device-idle ms inside the frame's
blocking host reads (the spans icp_slam.read.need, read.trip and
read.insert inside icp_slam.frame: the device waiting for the host to wake
after each read), over the profiled frames. A part of
host_idle_ms_per_frame."""

from slambench.metrics._spans import (idle_ns, intersect, named, starting,
                                      traced)


def read(ctx):
    if not traced(ctx):
        return None
    reads = intersect(named(ctx, "frame"), starting(ctx, "read."))
    if not reads:
        return None
    return idle_ns(ctx, reads) / 1e6 / ctx.profiled_frames()
