"""The per-frame latencies of the online mix (scan handed to step to its
pose on the host), from the sequences that ran without the profiler."""

import statistics


def percentile_ms(ctx, q: int):
    times = [t for r in ctx.plain for t in r.get("frame_s", ())]
    if len(times) < 2:
        return None
    return 1e3 * statistics.quantiles(times, n=100, method="inclusive")[q - 1]
