"""The program's own spans (icp_slam.<name>, the port's obs/profile.py)
among the profiled block's host events, and the device's idle time inside
them: the part of their host intervals that no device operation covers
(the union of the operations' intervals, the rule of device_idle_share and
of the idle gaps). A program without these spans reads nothing.

Idle inside a span is read under the profiler, whose CUDA activity tracing
adds its own host cost to every launch (the more so, the more nodes a
replayed graph has): these numbers are the profiled block's, not a plain
run's."""

from slambench import trace

PREFIX = "icp_slam."
FRAME_GRAPHS = PREFIX + "graph."  # graph.<stage>, replayed by the frames
VERIFY_TRIP = PREFIX + "graph.verify_trip"  # replayed by verification


def union(intervals) -> list:
    """The union of [start, end) intervals, in order."""
    return trace.merged([(None, s, e - s, None) for s, e in intervals])


def intersect(a: list, b: list) -> list:
    """The intersection of two unions (each union()'s output)."""
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if lo < hi:
            out.append([lo, hi])
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def length(intervals) -> int:
    return sum(e - s for s, e in intervals)


def traced(ctx) -> bool:
    return ctx.trace is not None and bool(ctx.profiled)


def named(ctx, name: str) -> list:
    """The union of the spans icp_slam.<name>."""
    full = PREFIX + name
    return union((s, e) for s, e, n in ctx.trace.host if n == full)


def starting(ctx, prefix: str) -> list:
    """The union of the spans whose names start icp_slam.<prefix>."""
    full = PREFIX + prefix
    return union((s, e) for s, e, n in ctx.trace.host if n.startswith(full))


def frame_graphs(ctx) -> list:
    """The union of the frame loop's graph replays (graph.<stage> but
    verification's)."""
    return union((s, e) for s, e, n in ctx.trace.host
                 if n.startswith(FRAME_GRAPHS) and n != VERIFY_TRIP)


def idle_ns(ctx, spans: list) -> int:
    """Device-idle ns inside a union of spans."""
    busy = trace.merged(ctx.trace.ops)
    return length(spans) - length(intersect(spans, busy))


def frame_split_ms(ctx):
    """(launch, host) device-idle ms a profiled frame inside the frame
    spans: inside the frame loop's graph replays, and outside them (the
    host's own code, its reads' wake-ups included); None without frame
    spans."""
    if not traced(ctx):
        return None
    frames = named(ctx, "frame")
    if not frames:
        return None
    launch = idle_ns(ctx, intersect(frames, frame_graphs(ctx)))
    host = idle_ns(ctx, frames) - launch
    n = ctx.profiled_frames()
    return launch / 1e6 / n, host / 1e6 / n
