"""frame_ms_p50 (host clock): the median of frame_ms_p95's per-frame
times, over the traced run's sequences outside the profiled block."""

from slambench.metrics._frames import percentile_ms


def read(ctx):
    return percentile_ms(ctx, 50)
