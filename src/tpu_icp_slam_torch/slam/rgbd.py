"""RGB-D odometry, config 3 (port of tpu_icp_slam/slam/rgbd.py): depth
backprojection and frame-to-frame point-to-plane ICP with projective
correspondence.

A step backprojects the new depth image, builds its vertex and normal maps,
runs the projective point-to-plane ICP loop against the previous frame's
maps (K2 once an iteration, through `gauss_newton_step`) and composes the
pose. `run_fused` steps over a whole depth stack with no host read between
frames (the ICP loop reads its stopping test once an iteration, as every
steps loop of the port does); its poses equal those of a loop of `step`.

As in the reference, the projective lookup gets no source normals, so
icp.normal_gate_cos (0.5 in configs/rgbd.json) never gates a pair.
"""

from __future__ import annotations

import dataclasses

import torch

from tpu_icp_slam_torch.config import SlamConfig
from tpu_icp_slam_torch.core.pointcloud import PAD_COORD, PointCloud
from tpu_icp_slam_torch.icp.loop import align_with_correspondence
from tpu_icp_slam_torch.icp.projective import (
    CameraIntrinsics,
    backproject_depth,
    projective_correspondence,
)
from tpu_icp_slam_torch.mapping.normals import normals_from_depth


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
        return torch.as_tensor(depth, dtype=torch.float32, device=self.device)

    def init_state(self, first_depth) -> RGBDState:
        vmap, valid = backproject_depth(self._depth(first_depth), self.K)
        nmap, nvalid = normals_from_depth(vmap, valid)
        eye = torch.eye(4, dtype=torch.float32, device=self.device)
        return RGBDState(pose=eye, T_rel=eye, prev_vertex=vmap,
                         prev_normal=nmap, prev_valid=valid & nvalid,
                         frame=torch.zeros((), dtype=torch.int32,
                                           device=self.device))

    def step(self, state: RGBDState, depth):
        """One frame: returns (new_state, info dict of tensors)."""
        return _step(state, self._depth(depth), cfg=self.cfg, K=self.K)

    def run_fused(self, state: RGBDState, depths):
        """Step over a whole (F, H, W) depth stack; infos are stacked per
        frame."""
        depths = self._depth(depths)
        infos = []
        for f in range(depths.shape[0]):
            state, info = _step(state, depths[f], cfg=self.cfg, K=self.K)
            infos.append(info)
        stacked = {k: torch.stack([torch.as_tensor(i[k]) for i in infos])
                   for k in infos[0]}
        return state, stacked


def _step(state: RGBDState, depth: torch.Tensor, *, cfg: SlamConfig,
          K: CameraIntrinsics):
    ic = cfg.icp
    vmap, valid = backproject_depth(depth, K)
    nmap, nvalid = normals_from_depth(vmap, valid)
    valid_all = valid & nvalid

    # the source: the new frame's valid vertices, flattened. A stride > 1
    # decimates the source grid while the target maps stay at full
    # resolution: the lookup still lands on exact pixels, only the residual
    # set shrinks. reshape copies a strided view, so K2 gets contiguous rows.
    s = max(int(cfg.pipeline.rgbd_src_stride), 1)
    vsrc = vmap[::s, ::s] if s > 1 else vmap
    msrc = valid_all[::s, ::s] if s > 1 else valid_all
    pts = vsrc.reshape(-1, 3)
    mask = msrc.reshape(-1)
    src = PointCloud(points=torch.where(mask[:, None], pts,
                                        torch.full_like(pts, PAD_COORD)),
                     mask=mask)

    corr = projective_correspondence(
        K, state.prev_vertex, state.prev_normal, state.prev_valid,
        max_corr_dist=ic.max_corr_dist, normal_gate_cos=ic.normal_gate_cos)
    init = (state.T_rel if cfg.pipeline.motion_model == "constant_velocity"
            else torch.eye(4, dtype=torch.float32, device=depth.device))
    res = align_with_correspondence(src, corr, init, ic)
    pose = state.pose @ res.T
    new_state = RGBDState(pose=pose, T_rel=res.T, prev_vertex=vmap,
                          prev_normal=nmap, prev_valid=valid_all,
                          frame=state.frame + 1)
    info = {
        "pose": pose,
        "rmse": res.rmse,
        "iters": res.iters,
        "n_inliers": res.n_inliers,
        "converged": res.converged,
    }
    return new_state, info
