"""RGB-D odometry, config 3 (port of tpu_icp_slam/slam/rgbd.py): depth
backprojection and frame-to-frame point-to-plane ICP with projective
correspondence.

A step backprojects the new depth image, builds its vertex and normal maps
(`_maps`), takes the strided source cloud (`_source`), runs the projective
point-to-plane ICP loop against the previous frame's maps (K2 once an
iteration, through `gauss_newton_step`) from the motion model's pose and
composes the pose (`_advance`).

The reference runs the whole depth stack as one jitted `lax.scan`. On CUDA
`step` and `run_fused` run `RGBDFrameGraphs` (slam/frame_graphs.py): those
stages over static buffers, each replayed as a CUDA graph, so that a frame
is one `pre` dispatch, one `trip` replay a further ICP iteration and one
`post`, and its host syncs are the ICP's while-condition reads, one a trip.
The CPU runs `_step` eagerly, the graphs' reference; their results are
equal bit for bit.

As in the reference, the projective lookup gets no source normals, so
icp.normal_gate_cos (0.5 in configs/rgbd.json) never gates a pair.

The span upload (obs/profile.py) goes around the copy of a depth input to
the card in `init_state`, `step` and `run_fused`, where the input is not
already there; a whole log's stack is copied at once.
"""

from __future__ import annotations

import dataclasses
from contextlib import nullcontext

import torch

from tpu_icp_slam_torch.config import SlamConfig
from tpu_icp_slam_torch.core.pointcloud import PAD_COORD, PointCloud
from tpu_icp_slam_torch.icp.loop import ICPResult, align_with_correspondence
from tpu_icp_slam_torch.icp.projective import (
    CameraIntrinsics,
    backproject_depth,
    projective_correspondence,
)
from tpu_icp_slam_torch.mapping.normals import normals_from_depth
from tpu_icp_slam_torch.obs.profile import span
from tpu_icp_slam_torch.slam import frame_graphs
from tpu_icp_slam_torch.slam.frame_graphs import motion_init, odom_info


@dataclasses.dataclass(frozen=True)
class RGBDState:
    pose: torch.Tensor  # (4, 4) world <- camera
    T_rel: torch.Tensor  # (4, 4) last inter-frame motion
    prev_vertex: torch.Tensor  # (H, W, 3)
    prev_normal: torch.Tensor  # (H, W, 3)
    prev_valid: torch.Tensor  # (H, W) bool
    frame: torch.Tensor  # () int32


class RGBDOdometry:
    """Frame-to-frame projective point-to-plane odometry over depth
    images."""

    def __init__(self, cfg: SlamConfig, K: CameraIntrinsics,
                 device: torch.device | str = "cuda"):
        self.cfg = cfg
        self.K = K
        self.device = torch.device(device)

    def _depth(self, depth) -> torch.Tensor:
        """The depth input as float32 on the device; its copy from the host
        to a card is the span upload."""
        copied = self.device.type != "cpu" and not (
            isinstance(depth, torch.Tensor)
            and depth.device.type == self.device.type)
        with span("upload") if copied else nullcontext():
            return torch.as_tensor(depth, dtype=torch.float32,
                                   device=self.device)

    def init_state(self, first_depth) -> RGBDState:
        vmap, nmap, valid = _maps(self._depth(first_depth), self.K)
        eye = torch.eye(4, dtype=torch.float32, device=self.device)
        return RGBDState(pose=eye, T_rel=eye, prev_vertex=vmap,
                         prev_normal=nmap, prev_valid=valid,
                         frame=torch.zeros((), dtype=torch.int32,
                                           device=self.device))

    def _graphs(self, height: int, width: int):
        """The frame graphs on CUDA, None on the CPU (eager `_step`)."""
        if self.device.type != "cuda":
            return None
        return frame_graphs.graphs_of(RGBDFrameGraphs, self.cfg, self.K,
                                      height, width, self.device)

    def step(self, state: RGBDState, depth):
        """One frame: returns (new_state, info dict of tensors)."""
        depth = self._depth(depth)
        graphs = self._graphs(*depth.shape)
        if graphs is not None:
            return graphs.step(state, depth)
        return _step(state, depth, cfg=self.cfg, K=self.K)

    def run_fused(self, state: RGBDState, depths):
        """Step over a whole (F, H, W) depth stack; infos are stacked per
        frame."""
        depths = self._depth(depths)
        graphs = self._graphs(*depths.shape[1:])
        if graphs is not None:
            return graphs.run(state, depths)
        return frame_graphs.run_eager(_step, state, zip(depths),
                                      cfg=self.cfg, K=self.K)


def _maps(depth: torch.Tensor, K: CameraIntrinsics):
    """The frame's (H, W, 3) vertex and normal maps and their (H, W)
    validity."""
    vmap, valid = backproject_depth(depth, K)
    nmap, nvalid = normals_from_depth(vmap, valid)
    return vmap, nmap, valid & nvalid


def _source(vmap: torch.Tensor, valid: torch.Tensor,
            cfg: SlamConfig) -> PointCloud:
    """The source: the frame's valid vertices, flattened. A stride > 1
    decimates the source grid while the target maps stay at full
    resolution: the lookup still lands on exact pixels, only the residual
    set shrinks. reshape copies a strided view, so K2 gets contiguous
    rows."""
    s = max(int(cfg.pipeline.rgbd_src_stride), 1)
    vsrc = vmap[::s, ::s] if s > 1 else vmap
    msrc = valid[::s, ::s] if s > 1 else valid
    pts = vsrc.reshape(-1, 3)
    mask = msrc.reshape(-1)
    return PointCloud(points=torch.where(mask[:, None], pts,
                                         torch.full_like(pts, PAD_COORD)),
                      mask=mask)


def _corr(state: RGBDState, cfg: SlamConfig, K: CameraIntrinsics):
    """The projective lookup into the previous frame's maps."""
    ic = cfg.icp
    return projective_correspondence(
        K, state.prev_vertex, state.prev_normal, state.prev_valid,
        max_corr_dist=ic.max_corr_dist, normal_gate_cos=ic.normal_gate_cos)


def _advance(state: RGBDState, maps: tuple, res: ICPResult):
    """The pose composed and the frame's maps kept as the next frame's
    target: (new_state, info)."""
    vmap, nmap, valid = maps
    pose = state.pose @ res.T
    new_state = RGBDState(pose=pose, T_rel=res.T, prev_vertex=vmap,
                          prev_normal=nmap, prev_valid=valid,
                          frame=state.frame + 1)
    return new_state, odom_info(pose, res)


def _step(state: RGBDState, depth: torch.Tensor, *, cfg: SlamConfig,
          K: CameraIntrinsics):
    """One frame, eagerly: the CPU path and the graphs' reference."""
    maps = _maps(depth, K)
    res = align_with_correspondence(_source(maps[0], maps[2], cfg),
                                    _corr(state, cfg, K),
                                    motion_init(state, cfg), cfg.icp)
    return _advance(state, maps, res)


class RGBDFrameGraphs(frame_graphs.FrameGraphs):
    """The RGB-D frame (`_step`) as frame graphs: static buffers for the
    frame's depth, its vertex, normal and valid maps, the source cloud (the
    strided valid vertices, the mask as float weights) and the carried
    state (pose, T_rel, the previous frame's maps, frame). The projective
    lookup gathers from the state's static previous maps; `pre`
    backprojects the depth, computes its normals, takes the source and
    writes T0 (`motion_init`); `post` composes the pose and copies the new
    maps into the previous ones."""

    def __init__(self, cfg: SlamConfig, K: CameraIntrinsics, height: int,
                 width: int, device: torch.device):
        dev = torch.device(device)

        def buf(*shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=dev)

        h, w = height, width
        state = RGBDState(pose=buf(4, 4), T_rel=buf(4, 4),
                          prev_vertex=buf(h, w, 3), prev_normal=buf(h, w, 3),
                          prev_valid=buf(h, w, dtype=torch.bool),
                          frame=buf(dtype=torch.int32))
        self.K = K
        self.depth = buf(h, w)
        self.maps = (buf(h, w, 3), buf(h, w, 3), buf(h, w, dtype=torch.bool))
        s = max(int(cfg.pipeline.rgbd_src_stride), 1)
        m = len(range(0, h, s)) * len(range(0, w, s))
        super().__init__(cfg, state, PointCloud(points=buf(m, 3),
                                                mask=buf(m)),
                         _corr(state, cfg, K), dev)

    def _inputs(self, depth: torch.Tensor) -> None:
        self.depth.copy_(depth)

    def _pre_body(self, _) -> None:
        maps = _maps(self.depth, self.K)
        for b, v in zip(self.maps, maps):
            b.copy_(v)
        src = _source(maps[0], maps[2], self.cfg)
        self.align.src.points.copy_(src.points)
        self.align.src.mask.copy_(src.mask)
        self.align.set_T0(motion_init(self.state, self.cfg))
        self._pre_icp()

    def _post_body(self) -> None:
        self._keep(*_advance(self.state, self.maps, self.align.result()))
