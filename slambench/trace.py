"""The device trace of a profiled block of sequences, reduced to what the
per-layer readers take: every device operation with its duration and the
harness span its launch fell in, the runtime's launch and
synchronisation calls, busy time and the longest idle gaps.

A device operation belongs to the innermost harness span (a
`record_function` range opened by slambench/harness.py around a call into
the program) that holds the host call that launched it, matched by the
profiler's correlation id; a kernel replayed from a CUDA graph carries the
id of the graph launch.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses

SPAN_PREFIX = "slambench."
LAUNCH_CALLS = ("cudaLaunch", "cuLaunch", "cudaGraphLaunch", "cuGraphLaunch")
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cuStreamSynchronize",
              "cuCtxSynchronize", "cuEventSynchronize")
SYNC_EXACT = ("cudaMemcpy", "cuMemcpyDtoH", "cuMemcpyDtoH_v2")
TOP = 10
MIN_GAP_NS = 5000  # shorter idle gaps are summed under one name


@dataclasses.dataclass
class Trace:
    ops: list  # (name, start_ns, dur_ns, span or None), device operations
    launches: int  # runtime launch calls (kernels and graphs)
    syncs: int  # runtime calls that wait for the device
    host: list  # (start_ns, end_ns, name) host events, for the idle gaps
    spans: list  # (start_ns, end_ns, name) the harness's spans

    def span_ns(self, name: str) -> tuple:
        """(first start, last end) of the spans named `name`."""
        got = [(s, e) for s, e, n in self.spans if n == name]
        return min(s for s, _ in got), max(e for _, e in got)

    def busy_ns(self) -> int:
        """Union of the device operations' intervals."""
        return sum(b - a for a, b in merged(self.ops))

    def device_ns(self) -> int:
        return sum(op[2] for op in self.ops)

    def family_ns(self, patterns, span=None) -> int:
        """Summed duration of the operations whose name holds one of
        `patterns` (and that were launched inside `span`, if given)."""
        return sum(d for name, _, d, sp in self.ops
                   if any(p in name for p in patterns)
                   and (span is None or sp == span))

    def top_ops(self, n=TOP) -> list:
        by = collections.Counter()
        for name, _, d, _ in self.ops:
            by[name] += d
        return [[name[:160], ns / 1e9] for name, ns in by.most_common(n)]

    def idle_gaps(self, t0_ns: int, t1_ns: int, n=TOP) -> list:
        """Device-idle time in [t0, t1] by the innermost host event running
        at each gap's middle."""
        gaps, last = [], t0_ns
        for a, b in merged(self.ops):
            if a > last:
                gaps.append((last, a))
            last = max(last, b)
        if t1_ns > last:
            gaps.append((last, t1_ns))
        host = sorted(self.host)
        starts = [h[0] for h in host]
        by = collections.Counter()
        for a, b in gaps:
            if b - a < MIN_GAP_NS:
                by["gaps under 5 us"] += b - a
                continue
            mid = (a + b) // 2
            best = None
            i = bisect.bisect_right(starts, mid)
            for s, e, name in host[max(0, i - 64):i]:
                if s <= mid <= e and (best is None or e - s < best[0]):
                    best = (e - s, name)
            by[best[1] if best else "host, no traced op"] += b - a
        return [[name[:160], ns / 1e9] for name, ns in by.most_common(n)]


def merged(ops) -> list:
    """The union of the operations' [start, end) intervals, in order."""
    out = []
    for _, s, d, _ in sorted(ops, key=lambda o: o[1]):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], s + d)
        else:
            out.append([s, s + d])
    return out


def reduce(prof) -> Trace:
    """A finished torch.profiler run to a Trace."""
    from torch.autograd import DeviceType

    events = prof.profiler.kineto_results.events()
    spans, launch_at, host, device = [], {}, [], []
    launches = syncs = 0
    for e in events:
        name = e.name()
        if e.device_type() == DeviceType.CPU:
            s, t = e.start_ns(), e.end_ns()
            if name.startswith(SPAN_PREFIX):
                spans.append((s, t, name))
                continue
            host.append((s, t, name))
            if e.correlation_id():
                # a runtime call: the device work it starts carries its id
                launch_at[e.correlation_id()] = s
            if name.startswith(LAUNCH_CALLS):
                launches += 1
            elif name.startswith(SYNC_CALLS) or name in SYNC_EXACT:
                syncs += 1
        elif e.device_type() == DeviceType.CUDA:
            # the profiler mirrors each record_function range on the
            # device's timeline: those are not operations
            if name.startswith(SPAN_PREFIX) or name.startswith("ProfilerStep"):
                continue
            device.append(e)
    spans.sort(key=lambda sp: (sp[0], -sp[1]))
    span_starts = [sp[0] for sp in spans]

    def span_of(t):
        """The innermost span holding t: the latest-starting one."""
        i = bisect.bisect_right(span_starts, t)
        for s, e, name in reversed(spans[max(0, i - 64):i]):
            if t <= e:
                return name
        return None

    ops = []
    for e in device:
        t = launch_at.get(e.linked_correlation_id(),
                          launch_at.get(e.correlation_id()))
        ops.append((e.name(), e.start_ns(), e.duration_ns(),
                    span_of(t) if t is not None else None))
    return Trace(ops=ops, launches=launches, syncs=syncs, host=host,
                 spans=spans)
