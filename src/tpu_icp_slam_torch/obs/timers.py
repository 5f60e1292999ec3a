"""Wall timers and profiling hooks (port of tpu_icp_slam/obs/timers.py).

`Timer` accumulates named spans; `timed` is the contextmanager; `trace`
wraps `torch.profiler` for a Chrome/Perfetto capture around pipeline steps.
Work on the card is asynchronous: call `realize` (a host copy, which waits
for the card) inside a span that must cover device execution.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import torch


class Timer:
    def __init__(self):
        self.spans = defaultdict(list)

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.spans[name].append(time.perf_counter() - t0)

    def total(self, name: str) -> float:
        return sum(self.spans[name])

    def summary(self) -> dict:
        return {
            k: {"n": len(v), "total_s": sum(v), "mean_s": sum(v) / len(v)}
            for k, v in self.spans.items()
            if v
        }


@contextlib.contextmanager
def timed(name: str, timer: Timer):
    with timer.span(name):
        yield


def realize(tree):
    """Copy every tensor of `tree` (nested dicts, lists and tuples) to the
    host as numpy. The copy waits until the card has produced the values,
    so it fences a timed span."""
    if isinstance(tree, torch.Tensor):
        return tree.cpu().numpy()
    if isinstance(tree, dict):
        return {k: realize(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(realize(v) for v in tree)
    return tree


@contextlib.contextmanager
def trace(logdir: str | None):
    """torch.profiler over the block if a logdir is given (CPU, and the
    card when there is one), written as logdir/trace.json; else no-op."""
    if logdir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield
    os.makedirs(logdir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
