"""graph_solve_s_per_seq (program span): host s in the spans
icp_slam.backend.graph (Slam3D's closure selection, pose-graph solve and
per-frame correction), a profiled sequence."""

from slambench.metrics._spans import length, named, traced


def read(ctx):
    if not traced(ctx):
        return None
    solves = named(ctx, "backend.graph")
    if not solves:
        return None
    return length(solves) / 1e9 / len(ctx.profiled)
