"""host_idle_ms_per_frame (program span): device-idle ms inside the spans
icp_slam.frame and outside every graph replay in them (the frame's Python,
its input copies and the wake-ups after its host reads), over the
profiled frames. With launch_idle_ms_per_frame it sums to the idle inside
the frames."""

from slambench.metrics._spans import frame_split_ms


def read(ctx):
    split = frame_split_ms(ctx)
    return split[1] if split else None
