"""Scan-to-scan ICP odometry (port of tpu_icp_slam/slam/pipeline.py), over
3D or 2D scans.

Per frame: the motion-model initial guess (the last inter-frame transform,
or identity), ICP of the scan against the previous scan, the pose composed
onto the trajectory and, in 2D with a grid, the scan folded into the
occupancy grid (mapping/occupancy2d.py). This is config 1's and config 2's
scan-to-scan pipeline and what `SlamConfig()`'s default
(`pipeline.mode="scan_to_scan"`, `icp.method="point_to_point"`) runs.

The reference runs the whole log as one jitted `lax.scan`. On CUDA
`step` and `run_fused` run `OdomFrameGraphs` (slam/frame_graphs.py): the
frame's stages over static buffers, each replayed as a CUDA graph, so that
a frame is one `pre` dispatch, one `trip` replay a further ICP iteration
and one `post`, and its host syncs are the ICP's while-condition reads, one
a trip. The CPU runs `_step` eagerly, the graphs' reference.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from tpu_icp_slam_torch.config import SlamConfig
from tpu_icp_slam_torch.core.pointcloud import PointCloud
from tpu_icp_slam_torch.icp.loop import (
    ICPResult,
    _nn_correspondence,
    _voxel_grid,
    align_with_correspondence,
)
from tpu_icp_slam_torch.kernels import voxel_nn
from tpu_icp_slam_torch.mapping import occupancy2d
from tpu_icp_slam_torch.slam import frame_graphs
from tpu_icp_slam_torch.slam.frame_graphs import motion_init, odom_info


@dataclasses.dataclass(frozen=True)
class OdomState:
    pose: torch.Tensor  # (D+1, D+1) world <- sensor
    T_rel: torch.Tensor  # (D+1, D+1) last inter-frame transform (motion)
    prev_points: torch.Tensor  # (C, D) previous scan (padded)
    prev_mask: torch.Tensor  # (C,)
    grid: Optional[occupancy2d.OccupancyGrid2D]  # 2D mode only
    frame: torch.Tensor  # () int32


def fold_scan(grid, cfg: SlamConfig, pose, points, mask):
    """occupancy2d.update with the config's mapping parameters."""
    m = cfg.mapping
    return occupancy2d.update(grid, pose, points, mask, hit=m.logodds_hit,
                              free=m.logodds_free, clip=m.logodds_clip,
                              ray_samples=m.ray_samples)


class OdometryPipeline:
    """Scan-to-scan ICP odometry over dim-D padded scans on `device`."""

    def __init__(self, cfg: SlamConfig, dim: int = 3,
                 device: torch.device | str = "cuda"):
        if dim not in (2, 3):
            raise ValueError(f"dim must be 2 or 3, got {dim}")
        self.cfg = cfg
        self.dim = dim
        self.device = torch.device(device)

    def _as_tensors(self, points, mask):
        return (torch.as_tensor(points, dtype=torch.float32,
                                device=self.device),
                torch.as_tensor(mask, dtype=torch.bool, device=self.device))

    def init_state(self, first_points, first_mask,
                   with_grid: Optional[bool] = None) -> OdomState:
        """Frame-0 state; a 2D pipeline keeps an occupancy grid unless
        with_grid=False (the grid is 2D only)."""
        d = self.dim
        if with_grid is None:
            with_grid = d == 2
        if with_grid and d != 2:
            raise ValueError("the occupancy grid is 2D only")
        pts, msk = self._as_tensors(first_points, first_mask)
        eye = torch.eye(d + 1, dtype=torch.float32, device=self.device)
        grid = None
        if with_grid:
            m = self.cfg.mapping
            grid = fold_scan(occupancy2d.create(m.grid_size,
                                                m.grid_resolution,
                                                device=self.device),
                             self.cfg, eye, pts, msk)
        return OdomState(pose=eye, T_rel=eye, prev_points=pts, prev_mask=msk,
                         grid=grid, frame=torch.zeros((), dtype=torch.int32,
                                                      device=self.device))

    def _graphs(self, state: OdomState, capacity: int):
        """The frame graphs on CUDA, None on the CPU (eager `_step`)."""
        if self.device.type != "cuda":
            return None
        grid = (None if state.grid is None
                else tuple(state.grid.logodds.shape))
        return frame_graphs.graphs_of(OdomFrameGraphs, self.cfg, capacity,
                                      self.dim, grid, self.device)

    def step(self, state: OdomState, points, mask):
        """One frame: returns (new_state, info dict of tensors)."""
        points, mask = self._as_tensors(points, mask)
        graphs = self._graphs(state, points.shape[0])
        if graphs is not None:
            return graphs.step(state, points, mask)
        return _step(state, points, mask, cfg=self.cfg)

    def run_fused(self, state: OdomState, all_points, all_masks):
        """Step over a whole (F, C, D) log; infos are stacked per frame."""
        pts, msk = self._as_tensors(all_points, all_masks)
        graphs = self._graphs(state, pts.shape[1])
        if graphs is not None:
            return graphs.run(state, pts, msk)
        return frame_graphs.run_eager(_step, state, zip(pts, msk),
                                      cfg=self.cfg)


def _advance(state: OdomState, points: torch.Tensor, mask: torch.Tensor,
             res: ICPResult, cfg: SlamConfig):
    """The pose composed, the scan folded into the grid and kept as the
    next frame's target: (new_state, info)."""
    pose = state.pose @ res.T
    grid = state.grid
    if grid is not None:
        grid = fold_scan(grid, cfg, pose, points, mask)
    new_state = OdomState(pose=pose, T_rel=res.T, prev_points=points,
                          prev_mask=mask, grid=grid, frame=state.frame + 1)
    return new_state, odom_info(pose, res)


def _step(state: OdomState, points: torch.Tensor, mask: torch.Tensor, *,
          cfg: SlamConfig):
    """One frame, eagerly: the CPU path and the graphs' reference."""
    src = PointCloud(points=points, mask=mask)
    dst = PointCloud(points=state.prev_points, mask=state.prev_mask)
    res = align_with_correspondence(src, _nn_correspondence(cfg.icp, dst),
                                    motion_init(state, cfg), cfg.icp)
    return _advance(state, points, mask, res, cfg)


class OdomFrameGraphs(frame_graphs.FrameGraphs):
    """The scan-to-scan frame (`_step`) as frame graphs: static buffers
    for the scan, the carried state (pose, T_rel, the previous scan, the
    NN's target, the occupancy grid where there is one, frame) and, at
    nn_backend="voxel", the previous scan's hash grid. `pre` takes the
    scan's mask as the source's weights, rebuilds the hash grid into its
    static table (the eager align builds it once an align) and writes T0
    (`motion_init`); `post` composes the pose, folds the scan into the grid
    and copies the scan into the previous scan's buffers."""

    def __init__(self, cfg: SlamConfig, capacity: int, dim: int,
                 grid_shape: Optional[tuple], device: torch.device):
        dev = torch.device(device)
        ic = cfg.icp

        def buf(*shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=dev)

        grid = (None if grid_shape is None else occupancy2d.OccupancyGrid2D(
            logodds=buf(*grid_shape), origin=buf(2), resolution=buf()))
        state = OdomState(pose=buf(dim + 1, dim + 1),
                          T_rel=buf(dim + 1, dim + 1),
                          prev_points=buf(capacity, dim),
                          prev_mask=buf(capacity, dtype=torch.bool),
                          grid=grid, frame=buf(dtype=torch.int32))
        self.points = buf(capacity, dim)
        self.mask = buf(capacity, dtype=torch.bool)
        self.grid = (voxel_nn.VoxelHashGrid(
            table=buf(ic.voxel_table_size, ic.voxel_bucket,
                      dtype=torch.int32), points=state.prev_points)
            if ic.nn_backend == "voxel" else None)
        dst = PointCloud(points=state.prev_points, mask=state.prev_mask)
        super().__init__(cfg, state,
                         PointCloud(points=self.points, mask=buf(capacity)),
                         _nn_correspondence(ic, dst, grid=self.grid), dev)

    def _inputs(self, points: torch.Tensor, mask: torch.Tensor) -> None:
        self.points.copy_(points)
        self.mask.copy_(mask)

    def _pre_body(self, _) -> None:
        st = self.state
        self.align.src.mask.copy_(self.mask)
        if self.grid is not None:
            self.grid.table.copy_(_voxel_grid(
                self.cfg.icp, st.prev_points, st.prev_mask).table)
        self.align.set_T0(motion_init(st, self.cfg))
        self._pre_icp()

    def _post_body(self) -> None:
        self._keep(*_advance(self.state, self.points, self.mask,
                             self.align.result(), self.cfg))
