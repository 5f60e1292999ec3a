"""verify_idle_s_per_seq (program span): device-idle s inside the spans
icp_slam.verify.batch (each chunk of a keyframe's batched verification
and its readbacks), a profiled sequence."""

from slambench.metrics._spans import idle_ns, named, traced


def read(ctx):
    if not traced(ctx):
        return None
    batches = named(ctx, "verify.batch")
    if not batches:
        return None
    return idle_ns(ctx, batches) / 1e9 / len(ctx.profiled)
