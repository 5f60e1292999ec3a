"""Profiler integration (port of tpu_icp_slam/obs/profile.py).

- `trace(log_dir)`: context manager around `torch.profiler` (CPU, and the
  card when there is one), written as log_dir/trace.json, a Chrome/Perfetto
  trace; the same code as `obs.timers.trace`.
- `annotate(name)`: a named span (`torch.profiler.record_function`) that
  shows inside the trace, so pipeline stages read as named ranges.
- `scope(name)`: the same span, usable as a decorator or a context manager
  (the reference's `jax.named_scope` names compiled code; torch has no
  compiled graph to name, so a span is the counterpart).

Stated deviation: an exception raised inside the block propagates. The
reference catches every exception around its profiler and yields again,
which would also swallow the block's own errors and break the generator
protocol.
"""

from __future__ import annotations

import torch

from tpu_icp_slam_torch.obs.timers import trace  # noqa: F401


def annotate(name: str):
    """A named profiler span (a context manager, or a decorator)."""
    return torch.profiler.record_function(name)


scope = annotate
