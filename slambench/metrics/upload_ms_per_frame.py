"""upload_ms_per_frame (program span): host ms inside the spans
icp_slam.upload (the depth input's copy from the host to the card in
RGBDOdometry.init_state, step and run_fused), over the profiled frames. A
program without the span reads nothing."""

from slambench.metrics._spans import length, named, traced


def read(ctx):
    if not traced(ctx):
        return None
    spans = named(ctx, "upload")
    if not spans:
        return None
    return length(spans) / 1e6 / ctx.profiled_frames()
