"""frame_ms_p95 (host clock): the 95th percentile, over every frame of the
window, of the time from a scan handed to ScanToMapPipeline.step to its
pose on the host."""

from slambench.metrics._frames import percentile_ms


def read(ctx):
    return percentile_ms(ctx, 95)
