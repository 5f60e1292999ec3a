"""The frame loop the port's odometries share: scan-to-map
(slam/scan_to_map.py), RGB-D (slam/rgbd.py) and scan-to-scan
(slam/pipeline.py).

The reference runs each of them as one jitted program over the log. The
port runs a frame as `FrameGraphs`: the pipeline's stages over static
buffers, on CUDA each replayed as a CUDA graph, so that a frame is a
handful of graph launches and its host syncs are the ICP's while-condition
reads, one a trip (and the pipeline's own branch reads). On the CPU, and
as the graphs' reference, each pipeline's `_step` runs the same stages
eagerly (`run_eager` over a log). `motion_init` and the info row are the
parts of a frame the pipelines have in common.
"""

from __future__ import annotations

import collections
from typing import Callable

import torch

from tpu_icp_slam_torch.config import SlamConfig
from tpu_icp_slam_torch.core.pointcloud import PointCloud
from tpu_icp_slam_torch.icp.loop import (
    ICPResult,
    StaticAlign,
    align_with_correspondence,
    eager_loop,
)
from tpu_icp_slam_torch.kernels.graphs import Graphed, cached, clone, copy_into
from tpu_icp_slam_torch.obs.profile import span


def motion_init(state, cfg: SlamConfig) -> torch.Tensor:
    """The ICP's initial pose of a frame-to-frame odometry: the last
    inter-frame transform under motion_model="constant_velocity", identity
    otherwise."""
    if cfg.pipeline.motion_model == "constant_velocity":
        return state.T_rel
    return torch.eye(state.T_rel.shape[-1], dtype=torch.float32,
                     device=state.T_rel.device)


# A frame-to-frame odometry's info: the pose, then these.
ODOM_INFO = ("rmse", "iters", "n_inliers", "converged")


def odom_info(pose: torch.Tensor, res: ICPResult) -> dict:
    return {"pose": pose, "rmse": res.rmse, "iters": res.iters,
            "n_inliers": res.n_inliers, "converged": res.converged}


def run_eager(step: Callable, state, frames, **kw):
    """`step` over the frames' inputs from `state`: (the last state, the
    infos stacked per frame)."""
    infos = []
    for inputs in frames:
        state, info = step(state, *inputs, **kw)
        infos.append(info)
    stacked = {k: torch.stack([torch.as_tensor(i[k]) for i in infos])
               for k in infos[0]}
    return state, stacked


def info_row(info: dict, keys: tuple) -> torch.Tensor:
    """A frame's info as one float32 row (every integer below 2^24, so
    exact): the pose, then `keys`."""
    return torch.cat([info["pose"].reshape(-1)] + [
        torch.as_tensor(info[k]).to(torch.float32).reshape(1) for k in keys])


def info_unrow(rows: torch.Tensor, n: int, keys: tuple, ints: tuple) -> dict:
    """info_row's (..., n² + len(keys)) rows back to the info dict (stacked
    over the leading dims): the (n, n) pose, `ints` as int32, rmse as
    float32, the rest as bool."""
    lead, k = rows.shape[:-1], n * n
    out = {"pose": rows[..., :k].reshape(*lead, n, n)}
    for i, key in enumerate(keys):
        v = rows[..., k + i]
        out[key] = (v.to(torch.int32) if key in ints
                    else v if key == "rmse" else v != 0.0)
    return out


class FrameGraphs:
    """A frame of an odometry as the reference runs it, one dispatch a
    stage: the subclass's stages over static buffers, each replayed as a
    CUDA graph (`kernels.graphs.Graphed`, one memory pool for them all),
    around the ICP's `icp.loop.StaticAlign`. A frame replays:

      pre     `_pre_body(variant)`: the subclass's stage (what the source
              and the correspondence read, T0), then `_pre_icp`: trip 0 of
              the ICP, or all of it where it reads nothing back (K5 at
              `fused`, unroll_iters > 0, max_iters < 1) and then `post`
              too; one graph a key of PRE_VARIANTS, `_pre_variant` (a host
              read, where there is more than one) picks it;
      trip    one ICP trip, replayed while the reference's while condition,
              read once a trip, holds (`StaticAlign.go_on`);
      post    `_post_body`: the state advanced, the info row;

    then `_after_post` (scan-to-map's map insert). Host syncs a frame: the
    condition reads, one a trip (none after a trip that reaches
    max_iters), and the subclass's own reads. Spans (obs/profile.py):
    frame around each frame, step around `step`, graph.<stage> around
    each replay, read.<stage> around each host read.

    What stays eager, by a check on the config: the ICP of
    `icp.loop.eager_loop`'s configurations (degen_eps > 0), which
    `_whole_icp` runs between the pre and post graphs, unrolled or not. On
    a CPU device every stage runs eagerly over the same buffers.

    States are values: `load` copies a caller's state into the static
    buffers and `snapshot` returns clones, and each frame's info row is
    cloned, so nothing returned aliases a buffer a later replay writes. A
    subclass's `post` copies the new frame's buffers into the previous
    frame's, which the trip reads, and never aliases them."""

    INFO = ODOM_INFO  # the info row's fields after the pose
    INFO_INT = ("iters", "n_inliers")
    PRE_VARIANTS = (None,)

    def __init__(self, cfg: SlamConfig, state, src: PointCloud,
                 corr: Callable, device: torch.device, fused: bool = False):
        ic = cfg.icp
        self.cfg = cfg
        self.state = state
        self.corr = corr
        self.fused = fused
        self.eager_icp = not fused and eager_loop(ic)
        self.icp_in_pre = fused or (not self.eager_icp and (
            ic.unroll_iters > 0 or ic.max_iters < 1))
        # the ICP runs as trip 0 in `pre` and captured trips after it
        self.graphed_icp = not (fused or self.eager_icp)
        self.align = StaticAlign(ic, src, corr if self.graphed_icp else None)
        self.n = src.dim + 1
        self.device = torch.device(device)
        self.info = torch.zeros(self.n ** 2 + len(self.INFO),
                                dtype=torch.float32, device=self.device)
        self.pool = (torch.cuda.graph_pool_handle()
                     if self.device.type == "cuda" else None)
        self._pre_g = {v: self.graph(lambda v=v: self._pre_body(v), "pre")
                       for v in self.PRE_VARIANTS}
        self._trip_g = self.graph(self.align.later, "trip")
        self._post_g = self.graph(self._post_body, "post")

    def graph(self, fn: Callable[[], None], name: str) -> Graphed:
        """fn as one of this frame's graphs (the shared pool), its
        replays the span graph.<name>."""
        return Graphed(fn, self.device, name, self.pool)

    # ---- the subclass's stages ----

    def _inputs(self, *inputs) -> None:
        """A frame's inputs into their static buffers."""
        raise NotImplementedError

    def _pre_body(self, variant) -> None:
        raise NotImplementedError

    def _post_body(self) -> None:
        raise NotImplementedError

    def _pre_variant(self):
        return None

    def _after_post(self) -> None:
        pass

    def _whole_icp(self) -> ICPResult:
        """The ICP in one call, where it runs no captured trip: the eager
        loop (or, in scan-to-map, K5)."""
        return align_with_correspondence(self.align.src, self.corr,
                                         self.align.T0, self.cfg.icp)

    # ---- the frame ----

    def _pre_icp(self) -> None:
        """The ICP's part of `pre`, after the subclass's stage."""
        if self.fused:
            self.align.set_result(self._whole_icp())
        elif self.graphed_icp:
            self.align.first()
        if self.icp_in_pre:
            self._post_body()

    def _icp(self) -> None:
        """The ICP after `pre`: the trips after trip 0, or the eager loop."""
        if self.eager_icp:
            self.align.set_result(self._whole_icp())
            return
        trips = 1
        while self.align.go_on(trips):
            self._trip_g()
            trips += 1

    def _keep(self, state, info: dict) -> None:
        """A frame's new state into the static state, its info into the
        row."""
        copy_into(self.state, state)
        self.info.copy_(info_row(info, self.INFO))

    def load(self, state) -> None:
        copy_into(self.state, state)

    def snapshot(self):
        return clone(self.state)

    def frame(self, *inputs) -> torch.Tensor:
        """One frame from the loaded state, the span frame; returns its
        info row (a clone)."""
        with span("frame"):
            self._inputs(*inputs)
            self._pre_g[self._pre_variant()]()
            if not self.icp_in_pre:
                self._icp()
                self._post_g()
            self._after_post()
            return self.info.clone()

    def _unrow(self, rows: torch.Tensor) -> dict:
        return info_unrow(rows, self.n, self.INFO, self.INFO_INT)

    def run(self, state, *logs):
        """The frames of the stacked logs (a leading frame axis) from
        `state`: (the state after the last frame, infos stacked per
        frame)."""
        self.load(state)
        rows = torch.stack([self.frame(*inputs) for inputs in zip(*logs)])
        return self.snapshot(), self._unrow(rows)

    def step(self, state, *inputs):
        """One frame from `state`, the span step: (the new state, its
        info)."""
        with span("step"):
            self.load(state)
            row = self.frame(*inputs)
            return self.snapshot(), self._unrow(row)


GRAPH_CACHE = 8  # frame graphs kept a class, least recently used dropped first
_caches: dict = {}


def graphs_of(cls, *key) -> FrameGraphs:
    """cls(*key), made on first use and kept in the class's bounded cache,
    shared by every pipeline of that key."""
    return cached(_caches.setdefault(cls, collections.OrderedDict()),
                  GRAPH_CACHE, key, cls)


def clear() -> None:
    """Drop every cached frame graph (the next frame captures anew)."""
    _caches.clear()
