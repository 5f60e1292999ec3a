"""verify_launch_idle_s_per_seq (program span): device-idle s inside
verification's trip replays (the spans icp_slam.graph.verify_trip), a
profiled sequence. A part of verify_idle_s_per_seq; the rest is the
host's own code between them, the condition reads' wake-ups included."""

from slambench.metrics._spans import idle_ns, named, traced


def read(ctx):
    if not traced(ctx):
        return None
    trips = named(ctx, "graph.verify_trip")
    if not trips:
        return None
    return idle_ns(ctx, trips) / 1e9 / len(ctx.profiled)
