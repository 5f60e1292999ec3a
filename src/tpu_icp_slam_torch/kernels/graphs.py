"""CUDA graphs over the port's kernel wrappers (the port's counterpart of the
reference's `jit`, where launch overhead dominates a loop of small
kernels).

`Graphed(fn, device, name, pool)` replays fn() as a CUDA graph. fn reads and
writes static buffers only and reads nothing back to the host. Its first
call runs fn eagerly on a side stream (a real run, and the warm-up torch
asks for before a capture), then captures fn without running it; every
later call replays the graph. Capturing counts no launch: each replay adds
the launches the capture counted to the kernels' counters, so a count
still equals the launches the card ran. On a CPU device fn runs every time.

A graph keeps the device pointers it was captured with: nothing it reads
or writes may be freed or moved while it lives. The callers own their
static buffers; the kernels' own scratch is allocated per call, or (K2,
K2S, KN, EX) kept for the life of the process. States are values:
`copy_into` loads a caller's state into the static buffers and `clone`
copies one out.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Callable, Optional

import torch

from tpu_icp_slam_torch.obs.profile import span


def copy_into(dst, src) -> None:
    """Each tensor field of the dataclass src into dst's, in place (nested
    dataclasses field by field; a field None in both is skipped)."""
    for f in dataclasses.fields(dst):
        d, s = getattr(dst, f.name), getattr(src, f.name)
        if dataclasses.is_dataclass(d):
            copy_into(d, s)
        elif d is not None:
            d.copy_(s)


def clone(x):
    """A dataclass of tensors (nested dataclasses and None fields kept)
    with every tensor cloned."""
    fields = {f.name: getattr(x, f.name) for f in dataclasses.fields(x)}
    return type(x)(**{k: clone(v) if dataclasses.is_dataclass(v)
                      else None if v is None else v.clone()
                      for k, v in fields.items()})


def cached(cache: collections.OrderedDict, size: int, key, make: Callable):
    """cache[key], made by make(*key) on first use; the `size` most
    recently used entries are kept."""
    value = cache.pop(key, None) or make(*key)
    cache[key] = value
    while len(cache) > size:
        cache.popitem(last=False)
    return value


def launch_counters() -> list:
    """(wrapper, attribute) of every launch counter of the port's kernels
    that a captured trip or frame can launch."""
    from tpu_icp_slam_torch.icp.point_to_point import rigid_from_stats
    from tpu_icp_slam_torch.kernels.gn_cuda import gn_accum
    from tpu_icp_slam_torch.kernels.gn_step import gn_step
    from tpu_icp_slam_torch.kernels.icp_fused import icp_fused
    from tpu_icp_slam_torch.kernels.knn_cuda import knn_normals
    from tpu_icp_slam_torch.kernels.nn_bf16 import nn_bf16
    from tpu_icp_slam_torch.kernels.nn_cuda import nn_bruteforce
    from tpu_icp_slam_torch.kernels.nn_rescore import nn_rescore
    from tpu_icp_slam_torch.kernels.p2p_step import p2p_step
    from tpu_icp_slam_torch.kernels.projective_cuda import projective_lookup
    from tpu_icp_slam_torch.kernels.select_cuda import local_select

    return [(f, a) for f in (nn_bruteforce, nn_bf16, nn_rescore, gn_accum,
                             gn_step, p2p_step, icp_fused,
                             rigid_from_stats, projective_lookup,
                             knn_normals, local_select)
            for a in vars(f) if "launches" in a]


class Graphed:
    """fn() as a CUDA graph on `device`, captured on the second call's
    behalf by the first (see the module docstring); `pool` shares one
    memory pool among the graphs of one owner, which replays them one at a
    time on one stream. Each replay (each run on a CPU device) is the span
    graph.<name>."""

    def __init__(self, fn: Callable[[], None], device: torch.device,
                 name: str, pool=None):
        self.fn = fn
        self.device = torch.device(device)
        self.pool = pool
        self.name = f"graph.{name}"
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.launches: dict = {}

    def __call__(self) -> None:
        if self.device.type != "cuda":
            with span(self.name):
                self.fn()
            return
        if self.graph is not None:
            with span(self.name):
                self.graph.replay()
                for (f, a), k in self.launches.items():
                    setattr(f, a, getattr(f, a) + k)
            return
        stream = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(stream)
        with torch.cuda.stream(side):
            self.fn()
        stream.wait_stream(side)
        before = {c: getattr(*c) for c in launch_counters()}
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self.pool):
            self.fn()
        for (f, a), v in before.items():
            self.launches[(f, a)] = getattr(f, a) - v
            setattr(f, a, v)
        self.graph = graph
