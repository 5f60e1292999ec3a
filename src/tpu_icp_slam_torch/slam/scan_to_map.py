"""Scan-to-map odometry pipeline (port of tpu_icp_slam/slam/scan_to_map.py).

Per frame:
  extract the local model (nearest map points to the predicted pose)
    → point-to-plane ICP of the scan against the model, in the PREDICTED
      SENSOR frame (world coordinates wreck f32 conditioning)
    → keyframe and map-health gates
    → on map inserts only: k-NN normals + voxel-dedup insert of the scan.

The reference's two `lax.cond`s (re-extract with hysteresis, map insert)
become host branches. Its ICP runs one of two ways, as in the reference:
`icp.loop_backend="steps"` is a host loop (one host sync per ICP iteration);
`"fused"` (for point-to-plane without degen_eps or corr_range_rate) is one
launch of the whole-loop kernel K5 with no host sync. Either way one more
host sync per frame decides the map insert (two with extract hysteresis).
"""

from __future__ import annotations

import dataclasses

import torch

from tpu_icp_slam.config import SlamConfig
from tpu_icp_slam_torch.core import se3
from tpu_icp_slam_torch.core.pointcloud import PAD_COORD, PointCloud
from tpu_icp_slam_torch.icp.loop import (
    ICPResult,
    _nn_correspondence,
    align_with_correspondence,
)
from tpu_icp_slam_torch.kernels.icp_fused import fused_args, icp_fused
from tpu_icp_slam_torch.mapping import voxel_map
from tpu_icp_slam_torch.mapping.normals import normals_knn


@dataclasses.dataclass(frozen=True)
class MapOdomState:
    pose: torch.Tensor  # (4, 4) world <- sensor
    T_rel: torch.Tensor  # (4, 4) last inter-frame motion (constant-velocity)
    last_kf_pose: torch.Tensor  # (4, 4) pose at the last keyframe
    vmap: voxel_map.VoxelMap
    frame: torch.Tensor  # () int32
    n_keyframes: torch.Tensor  # () int32
    # carried local model (world frame) for extract hysteresis
    loc_pts: torch.Tensor  # (L, 3)
    loc_nrm: torch.Tensor  # (L, 3)
    loc_msk: torch.Tensor  # (L,) bool
    r_cover: torch.Tensor  # () f32 coverage radius of the carried model
    extract_center: torch.Tensor  # (3,) world position of the extraction
    need_extract: torch.Tensor  # () bool; set after map inserts


def _check_supported(cfg: SlamConfig) -> None:
    if cfg.mapping.insert_backend == "hash":
        raise NotImplementedError("mapping.insert_backend='hash' is not "
                                  "ported yet")
    if cfg.mapping.extract_approx:
        raise NotImplementedError("mapping.extract_approx is not ported yet")


class ScanToMapPipeline:
    """3D scan-to-map ICP odometry against a voxel-deduplicated map."""

    def __init__(self, cfg: SlamConfig, device: torch.device | str = "cpu"):
        _check_supported(cfg)
        self.cfg = cfg
        self.device = torch.device(device)

    def _as_tensors(self, points, mask):
        return (torch.as_tensor(points, dtype=torch.float32,
                                device=self.device),
                torch.as_tensor(mask, dtype=torch.bool, device=self.device))

    def init_state(self, first_points, first_mask) -> MapOdomState:
        return init_state(*self._as_tensors(first_points, first_mask),
                          self.cfg)

    def step(self, state: MapOdomState, points, mask):
        return _step(state, *self._as_tensors(points, mask), cfg=self.cfg)

    def run_fused(self, state: MapOdomState, all_points, all_masks):
        """Step over a whole (F, C, 3) log; infos are stacked per frame."""
        pts, msk = self._as_tensors(all_points, all_masks)
        infos = []
        for f in range(pts.shape[0]):
            state, info = _step(state, pts[f], msk[f], cfg=self.cfg)
            infos.append(info)
        stacked = {k: torch.stack([torch.as_tensor(i[k]) for i in infos])
                   for k in infos[0]}
        return state, stacked


def init_state(first_points: torch.Tensor, first_mask: torch.Tensor,
               cfg: SlamConfig) -> MapOdomState:
    """Frame-0 state: map seeded with the first scan, identity pose."""
    m, p = cfg.mapping, cfg.pipeline
    dev = first_points.device
    vm = voxel_map.create(m.map_capacity, device=dev)
    nrm = normals_knn(first_points, first_mask, k=p.normal_k,
                      ref_stride=p.normal_ref_stride, approx=p.normal_approx,
                      oversample=p.normal_oversample)
    vm = voxel_map.insert(vm, first_points, first_mask, nrm, voxel=m.map_voxel)
    size = m.local_model_size
    eye = torch.eye(4, dtype=torch.float32, device=dev)
    return MapOdomState(
        pose=eye, T_rel=eye, last_kf_pose=eye, vmap=vm,
        frame=torch.zeros((), dtype=torch.int32, device=dev),
        n_keyframes=torch.ones((), dtype=torch.int32, device=dev),
        loc_pts=torch.full((size, 3), PAD_COORD, dtype=torch.float32,
                           device=dev),
        loc_nrm=torch.zeros((size, 3), dtype=torch.float32, device=dev),
        loc_msk=torch.zeros(size, dtype=torch.bool, device=dev),
        r_cover=torch.zeros((), dtype=torch.float32, device=dev),
        extract_center=torch.zeros(3, dtype=torch.float32, device=dev),
        need_extract=torch.ones((), dtype=torch.bool, device=dev),
    )


def _predict(state: MapOdomState, cfg: SlamConfig) -> torch.Tensor:
    """Damped constant-velocity prediction of the frame's pose."""
    p = cfg.pipeline
    if p.motion_model != "constant_velocity":
        return state.pose
    alpha = p.motion_damping
    alpha_r = p.motion_damping_rot if p.motion_damping_rot >= 0 else alpha
    if alpha >= 1.0 and alpha_r >= 1.0:
        return state.pose @ state.T_rel
    if alpha <= 0.0 and alpha_r <= 0.0:
        return state.pose
    xi = se3.log(state.T_rel)
    return state.pose @ se3.exp(torch.cat([alpha * xi[:3], alpha_r * xi[3:]]))


def _step(state: MapOdomState, points: torch.Tensor, mask: torch.Tensor, *,
          cfg: SlamConfig):
    m, p, ic = cfg.mapping, cfg.pipeline, cfg.icp
    init = _predict(state, cfg)
    center = init[:3, 3]
    if m.extract_hysteresis > 0.0:
        # reuse the carried model while fresh enough; the coverage gate
        # below shrinks by the staleness offset
        moved = (torch.linalg.vector_norm(center - state.extract_center)
                 > m.extract_hysteresis)
        if bool(state.need_extract | moved):
            loc_pts, loc_nrm, loc_msk, r_cover = voxel_map.extract_local(
                state.vmap, center, m.local_model_size)
            ex_center = center
        else:
            loc_pts, loc_nrm, loc_msk, r_cover, ex_center = (
                state.loc_pts, state.loc_nrm, state.loc_msk, state.r_cover,
                state.extract_center)
        stale_off = torch.linalg.vector_norm(center - ex_center)
    else:
        loc_pts, loc_nrm, loc_msk, r_cover = voxel_map.extract_local(
            state.vmap, center, m.local_model_size)
        ex_center = center
        stale_off = torch.zeros((), dtype=torch.float32, device=center.device)
    # move the small model into the predicted sensor frame once; the hot
    # loop then sees scene-scale magnitudes and starts at identity
    init_inv = se3.inverse(init)
    loc_local = loc_pts @ init_inv[:3, :3].T + init_inv[:3, 3]
    loc_local = torch.where(loc_msk[:, None], loc_local,
                            torch.full_like(loc_local, PAD_COORD))
    nrm_local = loc_nrm @ init_inv[:3, :3].T
    # coverage gate: scan points beyond the model's guaranteed radius have
    # no genuine counterpart and would latch onto its boundary
    r_gate = torch.clamp(r_cover - stale_off - ic.max_corr_dist, min=0.0)
    if (ic.loop_backend == "fused" and ic.method == "point_to_plane"
            and ic.degen_eps == 0.0 and ic.corr_range_rate == 0.0):
        # whole-loop kernel K5: one launch per align
        precision, kw = fused_args(ic)
        T, rmse, iters, n_inl, conv = icp_fused(
            points, mask, loc_local, nrm_local, loc_msk, init_T=None,
            r_gate=r_gate, precision=precision, **kw)
        res = ICPResult(T=T, rmse=rmse, iters=iters, n_inliers=n_inl,
                        converged=conv)
    else:
        dst = PointCloud(points=loc_local, mask=loc_msk, normals=nrm_local)
        nn_corr = _nn_correspondence(ic, dst)

        def corr(cur_pts):
            q, n, gate, d2 = nn_corr(cur_pts)
            in_cover = torch.sum(cur_pts * cur_pts, dim=-1) <= r_gate * r_gate
            return q, n, gate * in_cover.to(gate.dtype), d2

        res = align_with_correspondence(PointCloud(points=points, mask=mask),
                                        corr, None, ic)
    pose = init @ res.T  # world pose = prediction ∘ sensor-frame correction
    T_rel = se3.inverse(state.pose) @ pose

    # post-hoc trust-region binding flag: the correction sits on the ball
    clamped = torch.zeros((), dtype=torch.bool, device=pose.device)
    if ic.max_total_trans > 0.0 or ic.max_total_rot > 0.0:
        xi_corr = se3.log(res.T)
        if ic.max_total_trans > 0.0:
            clamped = (torch.linalg.vector_norm(xi_corr[:3])
                       >= 0.995 * ic.max_total_trans)
        if ic.max_total_rot > 0.0:
            clamped = clamped | (torch.linalg.vector_norm(xi_corr[3:])
                                 >= 0.995 * ic.max_total_rot)

    dK = se3.inverse(state.last_kf_pose) @ pose
    trans = torch.linalg.vector_norm(dK[:3, 3])
    rot = se3.rotation_geodesic(dK[:3, :3], torch.eye(3, dtype=dK.dtype,
                                                       device=dK.device))
    moved = (trans > p.keyframe_trans) | (rot > p.keyframe_rot)
    # map-hygiene gate over the points the gate could possibly accept
    cur_aligned = points @ res.T[:3, :3].T + res.T[:3, 3]
    in_cov = torch.sum(cur_aligned * cur_aligned, dim=-1) <= r_gate * r_gate
    n_total = torch.clamp(torch.sum(mask.to(torch.int32)), min=1)
    n_valid = torch.clamp(torch.sum((mask & in_cov).to(torch.int32)), min=1)
    enough_testable = n_valid * 10 >= n_total
    quality = res.converged | (res.rmse < p.keyframe_max_rmse)
    healthy = quality & enough_testable & (
        res.n_inliers
        >= (n_valid * p.keyframe_min_inlier_frac).to(torch.int32))
    is_kf = moved & healthy
    if p.frontier_insert:
        # frontier pressure: coverage collapsing or mid-turn, with some
        # motion so a parked sensor does not re-insert
        pressure = (n_valid < n_total * p.frontier_cov_frac) | (
            rot > 0.5 * p.keyframe_rot)
        moved_a_bit = (trans > 0.3) | (rot > 0.05)
        is_map_insert = healthy & (moved | (pressure & moved_a_bit))
    else:
        is_map_insert = is_kf

    vm = state.vmap
    if bool(is_map_insert):
        world_pts = points @ pose[:3, :3].T + pose[:3, 3]
        world_pts = torch.where(mask[:, None], world_pts,
                                torch.full_like(world_pts, PAD_COORD))
        nrm = normals_knn(points, mask, k=p.normal_k,
                          ref_stride=p.normal_ref_stride,
                          approx=p.normal_approx,
                          oversample=p.normal_oversample) @ pose[:3, :3].T
        vm = voxel_map.insert(vm, world_pts, mask, nrm, voxel=m.map_voxel,
                              center=pose[:3, 3])
    new_state = MapOdomState(
        pose=pose,
        T_rel=T_rel,
        last_kf_pose=torch.where(is_kf, pose, state.last_kf_pose),
        vmap=vm,
        frame=state.frame + 1,
        n_keyframes=state.n_keyframes + is_kf.to(torch.int32),
        loc_pts=loc_pts,
        loc_nrm=loc_nrm,
        loc_msk=loc_msk,
        r_cover=r_cover,
        extract_center=ex_center,
        need_extract=is_map_insert,
    )
    info = {
        "pose": pose,
        "rmse": res.rmse,
        "iters": res.iters,
        "n_inliers": res.n_inliers,
        "converged": res.converged,
        "clamped": clamped,
        "is_keyframe": is_kf,
        "map_inserted": is_map_insert,
        "map_points": voxel_map.count(vm),
    }
    return new_state, info
