"""Scan-to-scan ICP odometry (port of tpu_icp_slam/slam/pipeline.py, 3D).

Per frame: the motion-model initial guess (the last inter-frame transform,
or identity), ICP of the scan against the previous scan, and the pose
composed onto the trajectory. This is config 1's pipeline and what
`SlamConfig()`'s default (`pipeline.mode="scan_to_scan"`,
`icp.method="point_to_point"`) runs. The reference's `lax.scan` over the
log becomes a host loop over `step`, as in `ScanToMapPipeline.run_fused`.

The reference's 2D mode folds each scan into an occupancy grid; that is
config 2's pipeline, not ported yet: `dim=2` raises NotImplementedError.
"""

from __future__ import annotations

import dataclasses

import torch

from tpu_icp_slam_torch.config import SlamConfig
from tpu_icp_slam_torch.core.pointcloud import PointCloud
from tpu_icp_slam_torch.icp.loop import (
    _nn_correspondence,
    align_with_correspondence,
)


@dataclasses.dataclass(frozen=True)
class OdomState:
    pose: torch.Tensor  # (4, 4) world <- sensor
    T_rel: torch.Tensor  # (4, 4) last inter-frame transform (motion model)
    prev_points: torch.Tensor  # (C, 3) previous scan (padded)
    prev_mask: torch.Tensor  # (C,)
    frame: torch.Tensor  # () int32


class OdometryPipeline:
    """Scan-to-scan ICP odometry over 3D padded scans on `device`."""

    def __init__(self, cfg: SlamConfig, dim: int = 3,
                 device: torch.device | str = "cuda"):
        if dim != 3:
            raise NotImplementedError(
                "2D scan-to-scan odometry (occupancy grid, SE(2)) is config "
                "2's pipeline, not ported yet")
        self.cfg = cfg
        self.dim = dim
        self.device = torch.device(device)

    def _as_tensors(self, points, mask):
        return (torch.as_tensor(points, dtype=torch.float32,
                                device=self.device),
                torch.as_tensor(mask, dtype=torch.bool, device=self.device))

    def init_state(self, first_points, first_mask,
                   with_grid: bool = False) -> OdomState:
        if with_grid:
            raise NotImplementedError("the 2D occupancy grid is not ported "
                                      "yet")
        pts, msk = self._as_tensors(first_points, first_mask)
        eye = torch.eye(4, dtype=torch.float32, device=self.device)
        return OdomState(pose=eye, T_rel=eye, prev_points=pts, prev_mask=msk,
                         frame=torch.zeros((), dtype=torch.int32,
                                           device=self.device))

    def step(self, state: OdomState, points, mask):
        """One frame: returns (new_state, info dict of tensors)."""
        return _step(state, *self._as_tensors(points, mask), cfg=self.cfg)

    def run_fused(self, state: OdomState, all_points, all_masks):
        """Step over a whole (F, C, 3) log; infos are stacked per frame."""
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
    src = PointCloud(points=points, mask=mask)
    dst = PointCloud(points=state.prev_points, mask=state.prev_mask)
    init = (state.T_rel if cfg.pipeline.motion_model == "constant_velocity"
            else torch.eye(4, dtype=torch.float32, device=points.device))
    res = align_with_correspondence(src, _nn_correspondence(cfg.icp, dst),
                                    init, cfg.icp)
    pose = state.pose @ res.T
    new_state = OdomState(pose=pose, T_rel=res.T, prev_points=points,
                          prev_mask=mask, frame=state.frame + 1)
    info = {
        "pose": pose,
        "rmse": res.rmse,
        "iters": res.iters,
        "n_inliers": res.n_inliers,
        "converged": res.converged,
    }
    return new_state, info
