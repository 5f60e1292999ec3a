"""backend_s_per_seq (program span): Slam3D.backend_s, the wall time of the
per-keyframe backend (descriptors and loop verification), a sequence, over
the sequences outside the profiled block."""

import statistics


def read(ctx):
    vals = [r["backend_s"] for r in ctx.plain if "backend_s" in r]
    return statistics.mean(vals) if vals else None
