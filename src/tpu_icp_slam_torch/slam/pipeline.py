"""Scan-to-scan ICP odometry (port of tpu_icp_slam/slam/pipeline.py), over
3D or 2D scans.

Per frame: the motion-model initial guess (the last inter-frame transform,
or identity), ICP of the scan against the previous scan, the pose composed
onto the trajectory and, in 2D with a grid, the scan folded into the
occupancy grid (mapping/occupancy2d.py). This is config 1's and config 2's
scan-to-scan pipeline and what `SlamConfig()`'s default
(`pipeline.mode="scan_to_scan"`, `icp.method="point_to_point"`) runs. The
reference's `lax.scan` over the log becomes a host loop over `step`, as in
`ScanToMapPipeline.run_fused`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from tpu_icp_slam_torch.config import SlamConfig
from tpu_icp_slam_torch.core.pointcloud import PointCloud
from tpu_icp_slam_torch.icp.loop import (
    _nn_correspondence,
    align_with_correspondence,
)
from tpu_icp_slam_torch.mapping import occupancy2d


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

    def step(self, state: OdomState, points, mask):
        """One frame: returns (new_state, info dict of tensors)."""
        return _step(state, *self._as_tensors(points, mask), cfg=self.cfg)

    def run_fused(self, state: OdomState, all_points, all_masks):
        """Step over a whole (F, C, D) log; infos are stacked per frame."""
        pts, msk = self._as_tensors(all_points, all_masks)
        infos = []
        for f in range(pts.shape[0]):
            state, info = _step(state, pts[f], msk[f], cfg=self.cfg)
            infos.append(info)
        stacked = {k: torch.stack([torch.as_tensor(i[k]) for i in infos])
                   for k in infos[0]}
        return state, stacked


def _step(state: OdomState, points: torch.Tensor, mask: torch.Tensor, *,
          cfg: SlamConfig):
    d = points.shape[-1]
    src = PointCloud(points=points, mask=mask)
    dst = PointCloud(points=state.prev_points, mask=state.prev_mask)
    init = (state.T_rel if cfg.pipeline.motion_model == "constant_velocity"
            else torch.eye(d + 1, dtype=torch.float32, device=points.device))
    res = align_with_correspondence(src, _nn_correspondence(cfg.icp, dst),
                                    init, cfg.icp)
    pose = state.pose @ res.T
    grid = state.grid
    if grid is not None:
        grid = fold_scan(grid, cfg, pose, points, mask)
    new_state = OdomState(pose=pose, T_rel=res.T, prev_points=points,
                          prev_mask=mask, grid=grid, frame=state.frame + 1)
    info = {
        "pose": pose,
        "rmse": res.rmse,
        "iters": res.iters,
        "n_inliers": res.n_inliers,
        "converged": res.converged,
    }
    return new_state, info
