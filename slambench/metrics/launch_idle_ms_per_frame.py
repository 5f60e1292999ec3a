"""launch_idle_ms_per_frame (program span): device-idle ms inside the frame
loop's graph replays (the spans icp_slam.graph.<stage> inside
icp_slam.frame, verification's graph.verify_trip apart), over the
profiled frames."""

from slambench.metrics._spans import frame_split_ms


def read(ctx):
    split = frame_split_ms(ctx)
    return split[0] if split else None
