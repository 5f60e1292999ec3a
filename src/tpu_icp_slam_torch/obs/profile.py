"""The program's named spans (the port's counterpart of the reference's
obs/profile.py `annotate`/`scope`).

`span(name)` is a context manager that records one range,
`icp_slam.<name>`, in a running `torch.profiler` (`obs.timers.trace`, or
any other). It is a function-scope record (torch's private
`_RecordFunctionFast`, checked with torch 2.11 and 2.13), not a user
annotation: the profiler keeps it on the host's timeline, on the same
clock as the device operations of its run, and does not mirror it onto
the device's. With no profiler running it is a shared `nullcontext`, so
spans need no switch and cost about a bare `with`. A span is chosen when
it opens: one opened before a profiler started records nothing, which
also keeps torch from refusing to close a record it never began (an
internal assert). A span goes around a replay or a host read, never
inside a function a CUDA graph captures.

The reference's `trace` is the port's `obs.timers.trace`. Stated
deviation: an exception raised inside a span or a trace propagates. The
reference catches every exception around its profiler and yields again,
which would also swallow the block's own errors and break the generator
protocol.
"""

from __future__ import annotations

from contextlib import nullcontext

from torch._C._autograd import _profiler_enabled
from torch._C._profiler import _RecordFunctionFast

PREFIX = "icp_slam."
_OFF = nullcontext()


def span(name: str):
    """A range named icp_slam.<name> in a running profiler (a context
    manager); with none running, a context that does nothing."""
    if _profiler_enabled():
        return _RecordFunctionFast(PREFIX + name)
    return _OFF
