"""Scan-to-map odometry pipeline (port of tpu_icp_slam/slam/scan_to_map.py).

Per frame:
  extract the local model (nearest map points to the predicted pose)
    → point-to-plane ICP of the scan against the model, in the PREDICTED
      SENSOR frame (world coordinates wreck f32 conditioning)
    → keyframe and map-health gates
    → on map inserts only: k-NN normals + voxel-dedup insert of the scan
      (`insert`, or `insert_hash` with mapping.insert_backend="hash").

The frame is `_step`, the composition of pure stages: `_pre` (prediction,
extract, the model moved into the predicted sensor frame, the coverage
gate), `_icp`, `_post` (pose, T_rel, the keyframe and health gates) and, on
map inserts only, `_insert`. The reference's two `lax.cond`s (re-extract
with hysteresis, map insert) are host reads between the stages. Its ICP
runs one of two ways, as in the reference: `icp.loop_backend="steps"`
iterates with the while condition read once an iteration; `"fused"` (for
point-to-plane without degen_eps or corr_range_rate) is one launch of the
whole-loop kernel K5.

The reference runs a frame as one jitted program. On CUDA the port runs it
as `FrameGraphs` (on slam/frame_graphs.py's frame loop): each stage over
static buffers, replayed as a CUDA graph, so a frame is a handful of graph
launches, and its host syncs are the ICP trips' condition reads and the
insert read: trips + 1 at "steps", 1 at "fused" (+1 each with extract
hysteresis). On the CPU `step` and `run_fused` run `_step` eagerly.
"""

from __future__ import annotations

import dataclasses

import torch

from tpu_icp_slam_torch.config import SlamConfig
from tpu_icp_slam_torch.core import se3
from tpu_icp_slam_torch.core.pointcloud import PAD_COORD, PointCloud
from tpu_icp_slam_torch.icp.loop import (
    ICPResult,
    _nn_correspondence,
    _voxel_grid,
    align_with_correspondence,
)
# `_clone`: the name under which this module's tests copy a state
from tpu_icp_slam_torch.kernels.graphs import clone as _clone  # noqa: F401
from tpu_icp_slam_torch.kernels.graphs import copy_into as _copy_into
from tpu_icp_slam_torch.kernels import voxel_nn
from tpu_icp_slam_torch.kernels.icp_fused import fused_args, icp_fused
from tpu_icp_slam_torch.mapping import voxel_map
from tpu_icp_slam_torch.mapping.normals import normals_knn
from tpu_icp_slam_torch.obs.profile import span
from tpu_icp_slam_torch.slam import frame_graphs


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


class ScanToMapPipeline:
    """3D scan-to-map ICP odometry against a voxel-deduplicated map."""

    def __init__(self, cfg: SlamConfig, device: torch.device | str = "cuda"):
        self.cfg = cfg
        self.device = torch.device(device)

    def _as_tensors(self, points, mask):
        return (torch.as_tensor(points, dtype=torch.float32,
                                device=self.device),
                torch.as_tensor(mask, dtype=torch.bool, device=self.device))

    def init_state(self, first_points, first_mask) -> MapOdomState:
        return init_state(*self._as_tensors(first_points, first_mask),
                          self.cfg)

    def _graphs(self, capacity: int) -> FrameGraphs | None:
        """The frame graphs on CUDA, None on the CPU (eager `_step`)."""
        if self.device.type != "cuda":
            return None
        return frame_graphs.graphs_of(FrameGraphs, self.cfg, capacity,
                                      self.device)

    def step(self, state: MapOdomState, points, mask):
        points, mask = self._as_tensors(points, mask)
        graphs = self._graphs(points.shape[0])
        if graphs is not None:
            return graphs.step(state, points, mask)
        return _step(state, points, mask, cfg=self.cfg)

    def run_fused(self, state: MapOdomState, all_points, all_masks):
        """Step over a whole (F, C, 3) log; infos are stacked per frame."""
        pts, msk = self._as_tensors(all_points, all_masks)
        graphs = self._graphs(pts.shape[1])
        if graphs is not None:
            return graphs.run(state, pts, msk)
        return frame_graphs.run_eager(_step, state, zip(pts, msk),
                                      cfg=self.cfg)


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


@dataclasses.dataclass(frozen=True)
class _Pre:
    """What a frame knows before its ICP."""
    init: torch.Tensor  # (4, 4) predicted pose
    loc_pts: torch.Tensor  # (L, 3) local model, world frame
    loc_nrm: torch.Tensor  # (L, 3)
    loc_msk: torch.Tensor  # (L,) bool
    r_cover: torch.Tensor  # () coverage radius of the model
    ex_center: torch.Tensor  # (3,) where the model was extracted
    loc_local: torch.Tensor  # (L, 3) the model in the predicted sensor frame
    nrm_local: torch.Tensor  # (L, 3)
    r_gate: torch.Tensor  # () coverage gate of the ICP and the health gate


@dataclasses.dataclass(frozen=True)
class _Post:
    """The frame's pose and gates, after its ICP."""
    pose: torch.Tensor  # (4, 4)
    T_rel: torch.Tensor  # (4, 4)
    clamped: torch.Tensor  # () bool
    is_kf: torch.Tensor  # () bool
    is_map_insert: torch.Tensor  # () bool


def _extract_needed(state: MapOdomState, init: torch.Tensor,
                    cfg: SlamConfig) -> torch.Tensor:
    """Extract hysteresis: re-extract after a map insert or once the
    prediction moved farther than mapping.extract_hysteresis from where the
    carried model was extracted (the reference's lax.cond at :154)."""
    moved = (torch.linalg.vector_norm(init[:3, 3] - state.extract_center)
             > cfg.mapping.extract_hysteresis)
    return state.need_extract | moved


def _pre(state: MapOdomState, init: torch.Tensor, cfg: SlamConfig,
         extract: bool) -> _Pre:
    """The local model (extracted at the prediction, or the carried one
    with extract False), moved into the predicted sensor frame, and the
    coverage gate."""
    m, ic = cfg.mapping, cfg.icp
    center = init[:3, 3]
    if extract:
        loc_pts, loc_nrm, loc_msk, r_cover = voxel_map.extract_local(
            state.vmap, center, m.local_model_size, approx=m.extract_approx)
        ex_center = center
    else:
        loc_pts, loc_nrm, loc_msk, r_cover, ex_center = (
            state.loc_pts, state.loc_nrm, state.loc_msk, state.r_cover,
            state.extract_center)
    if m.extract_hysteresis > 0.0:
        # the coverage gate shrinks by the carried model's staleness
        stale_off = torch.linalg.vector_norm(center - ex_center)
    else:
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
    return _Pre(init=init, loc_pts=loc_pts, loc_nrm=loc_nrm, loc_msk=loc_msk,
                r_cover=r_cover, ex_center=ex_center, loc_local=loc_local,
                nrm_local=nrm_local, r_gate=r_gate)


def _fused(ic) -> bool:
    """The whole-loop kernel K5 runs the ICP (the reference's fused branch:
    point-to-plane without degen_eps or corr_range_rate)."""
    return (ic.loop_backend == "fused" and ic.method == "point_to_plane"
            and ic.degen_eps == 0.0 and ic.corr_range_rate == 0.0)


def _coverage_corr(ic, pre: _Pre, grid=None):
    """NN into the sensor-frame model, gated by the coverage radius
    (nn_backend="voxel": into `grid`, or a grid built here)."""
    nn_corr = _nn_correspondence(ic, PointCloud(
        points=pre.loc_local, mask=pre.loc_msk, normals=pre.nrm_local),
        grid=grid)
    r_gate = pre.r_gate

    def corr(cur_pts):
        q, n, gate, d2 = nn_corr(cur_pts)
        in_cover = torch.sum(cur_pts * cur_pts, dim=-1) <= r_gate * r_gate
        return q, n, gate * in_cover, d2  # the bool promotes: one launch

    return corr


def _icp(points: torch.Tensor, mask: torch.Tensor, pre: _Pre, ic
         ) -> ICPResult:
    """The scan against the model in the predicted sensor frame, from I:
    one K5 launch, or the steps loop."""
    if _fused(ic):
        precision, kw = fused_args(ic)
        T, rmse, iters, n_inl, conv = icp_fused(
            points, mask, pre.loc_local, pre.nrm_local, pre.loc_msk,
            init_T=None, r_gate=pre.r_gate, precision=precision, **kw)
        return ICPResult(T=T, rmse=rmse, iters=iters, n_inliers=n_inl,
                         converged=conv)
    return align_with_correspondence(PointCloud(points=points, mask=mask),
                                     _coverage_corr(ic, pre), None, ic)


def _post(state: MapOdomState, points: torch.Tensor, mask: torch.Tensor,
          pre: _Pre, res: ICPResult, cfg: SlamConfig) -> _Post:
    """Pose, T_rel, the trust-region flag and the keyframe and map-health
    gates."""
    p, ic = cfg.pipeline, cfg.icp
    pose = pre.init @ res.T  # world pose = prediction ∘ sensor correction
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
    in_cov = (torch.sum(cur_aligned * cur_aligned, dim=-1)
              <= pre.r_gate * pre.r_gate)
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
    return _Post(pose=pose, T_rel=T_rel, clamped=clamped, is_kf=is_kf,
                 is_map_insert=is_map_insert)


def _insert(vm: voxel_map.VoxelMap, points: torch.Tensor, mask: torch.Tensor,
            pose: torch.Tensor, cfg: SlamConfig) -> voxel_map.VoxelMap:
    """The scan, with its k-NN normals, into the map at `pose`."""
    m, p = cfg.mapping, cfg.pipeline
    world_pts = points @ pose[:3, :3].T + pose[:3, 3]
    world_pts = torch.where(mask[:, None], world_pts,
                            torch.full_like(world_pts, PAD_COORD))
    nrm = normals_knn(points, mask, k=p.normal_k,
                      ref_stride=p.normal_ref_stride, approx=p.normal_approx,
                      oversample=p.normal_oversample) @ pose[:3, :3].T
    insert = (voxel_map.insert_hash if m.insert_backend == "hash"
              else voxel_map.insert)
    return insert(vm, world_pts, mask, nrm, voxel=m.map_voxel,
                  center=pose[:3, 3])


def _advance(state: MapOdomState, pre: _Pre, post: _Post,
             vm: voxel_map.VoxelMap) -> MapOdomState:
    return MapOdomState(
        pose=post.pose,
        T_rel=post.T_rel,
        last_kf_pose=torch.where(post.is_kf, post.pose, state.last_kf_pose),
        vmap=vm,
        frame=state.frame + 1,
        n_keyframes=state.n_keyframes + post.is_kf.to(torch.int32),
        loc_pts=pre.loc_pts,
        loc_nrm=pre.loc_nrm,
        loc_msk=pre.loc_msk,
        r_cover=pre.r_cover,
        extract_center=pre.ex_center,
        need_extract=post.is_map_insert,  # map changed: re-extract next
    )


def _info(res: ICPResult, post: _Post, vm: voxel_map.VoxelMap) -> dict:
    return {
        "pose": post.pose,
        "rmse": res.rmse,
        "iters": res.iters,
        "n_inliers": res.n_inliers,
        "converged": res.converged,
        "clamped": post.clamped,
        "is_keyframe": post.is_kf,
        "map_inserted": post.is_map_insert,
        "map_points": voxel_map.count(vm),
    }


def _step(state: MapOdomState, points: torch.Tensor, mask: torch.Tensor, *,
          cfg: SlamConfig):
    """One frame, eagerly: the composition of the stages, with the
    reference's two lax.conds (extract hysteresis, the map insert) as host
    branches. The pure reference the frame graphs are held against."""
    init = _predict(state, cfg)
    extract = (cfg.mapping.extract_hysteresis <= 0.0
               or bool(_extract_needed(state, init, cfg)))
    pre = _pre(state, init, cfg, extract)
    res = _icp(points, mask, pre, cfg.icp)
    post = _post(state, points, mask, pre, res, cfg)
    vm = (_insert(state.vmap, points, mask, post.pose, cfg)
          if bool(post.is_map_insert) else state.vmap)
    return _advance(state, pre, post, vm), _info(res, post, vm)


class FrameGraphs(frame_graphs.FrameGraphs):
    """The scan-to-map frame as the reference runs it, one dispatch a stage
    (slam/frame_graphs.py): `_step`'s stages over static buffers, each
    replayed as a CUDA graph.

    Static buffers hold the carried state (pose, T_rel, last_kf_pose, the
    map, frame, n_keyframes, the carried local model, r_cover,
    extract_center, need_extract), the frame's scan, the `_Pre` and `_Post`
    of the frame, the ICP's state (`icp.loop.StaticAlign`, from T0 = I:
    the model is moved into the predicted sensor frame) and the frame's
    info as one row. A frame replays:

      need    (extract hysteresis only) the prediction and whether to
              re-extract; its one host read picks one of two `pre`s (the
              reference's lax.cond at :154);
      pre     `_pre`, then trip 0 of the ICP, or all of it where it reads
              nothing back (K5 at loop_backend="fused", unroll_iters > 0),
              and then `post` too;
      trip    one ICP trip, replayed while the reference's while condition,
              read once a trip, holds;
      post    `_post`, the state advanced, the info row;
      insert  `_insert` into the static map, only when the host read of
              is_map_insert (the reference's lax.cond at :326) is true.

    Host syncs a frame: ICP trips + 1 at loop_backend="steps", 1 at
    "fused" (+1 each with extract hysteresis). The ICP of
    `icp.loop.eager_loop`'s configurations (degen_eps > 0) runs eagerly
    between the pre and post graphs."""

    INFO = ("rmse", "iters", "n_inliers", "converged", "clamped",
            "is_keyframe", "map_inserted", "map_points")
    INFO_INT = ("iters", "n_inliers", "map_points")
    PRE_VARIANTS = (True, False)  # extract the local model, or carry it

    def __init__(self, cfg: SlamConfig, capacity: int, device: torch.device):
        m, ic = cfg.mapping, cfg.icp
        dev = torch.device(device)

        def buf(*shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=dev)

        size, cap = m.local_model_size, m.map_capacity
        state = MapOdomState(
            pose=buf(4, 4), T_rel=buf(4, 4), last_kf_pose=buf(4, 4),
            vmap=voxel_map.VoxelMap(points=buf(cap, 3), normals=buf(cap, 3),
                                    mask=buf(cap, dtype=torch.bool)),
            frame=buf(dtype=torch.int32), n_keyframes=buf(dtype=torch.int32),
            loc_pts=buf(size, 3), loc_nrm=buf(size, 3),
            loc_msk=buf(size, dtype=torch.bool), r_cover=buf(),
            extract_center=buf(3), need_extract=buf(dtype=torch.bool))
        self.points = buf(capacity, 3)
        self.mask = buf(capacity, dtype=torch.bool)
        self.pre = _Pre(init=buf(4, 4), loc_pts=buf(size, 3),
                        loc_nrm=buf(size, 3),
                        loc_msk=buf(size, dtype=torch.bool), r_cover=buf(),
                        ex_center=buf(3), loc_local=buf(size, 3),
                        nrm_local=buf(size, 3), r_gate=buf())
        self.post = _Post(pose=buf(4, 4), T_rel=buf(4, 4),
                          clamped=buf(dtype=torch.bool),
                          is_kf=buf(dtype=torch.bool),
                          is_map_insert=buf(dtype=torch.bool))
        self.need = buf(dtype=torch.bool)
        self.hysteresis = m.extract_hysteresis > 0.0
        fused = _fused(ic)
        # nn_backend="voxel": the model's hash grid, rebuilt by `pre`
        self.grid = (voxel_nn.VoxelHashGrid(
            table=buf(ic.voxel_table_size, ic.voxel_bucket,
                      dtype=torch.int32), points=self.pre.loc_local)
            if ic.nn_backend == "voxel" else None)
        # the scan's mask as float weights, which the trip reads in place
        super().__init__(cfg, state,
                         PointCloud(points=self.points, mask=buf(capacity)),
                         None if fused else _coverage_corr(ic, self.pre,
                                                           self.grid),
                         dev, fused=fused)
        self._need_g = self.graph(self._need_body, "need")
        self._insert_g = self.graph(self._insert_body, "insert")

    def _need_body(self) -> None:
        self.pre.init.copy_(_predict(self.state, self.cfg))
        self.need.copy_(_extract_needed(self.state, self.pre.init, self.cfg))

    def _inputs(self, points: torch.Tensor, mask: torch.Tensor) -> None:
        self.points.copy_(points)
        self.mask.copy_(mask)

    def _pre_variant(self) -> bool:
        if not self.hysteresis:
            return True
        self._need_g()
        with span("read.need"):
            return bool(self.need)

    def _pre_body(self, extract: bool) -> None:
        self.align.src.mask.copy_(self.mask)
        init = (self.pre.init if self.hysteresis
                else _predict(self.state, self.cfg))
        _copy_into(self.pre, _pre(self.state, init, self.cfg, extract))
        if self.grid is not None and self.graphed_icp:
            self.grid.table.copy_(_voxel_grid(
                self.cfg.icp, self.pre.loc_local, self.pre.loc_msk).table)
        self._pre_icp()

    def _whole_icp(self) -> ICPResult:
        return _icp(self.points, self.mask, self.pre, self.cfg.icp)

    def _post_body(self) -> None:
        st = self.state
        res = self.align.result()
        post = _post(st, self.points, self.mask, self.pre, res, self.cfg)
        new = _advance(st, self.pre, post, st.vmap)
        row = frame_graphs.info_row(_info(res, post, st.vmap), self.INFO)
        _copy_into(self.post, post)
        for f in dataclasses.fields(st):
            if f.name != "vmap":
                getattr(st, f.name).copy_(getattr(new, f.name))
        self.info.copy_(row)

    def _insert_body(self) -> None:
        vm = _insert(self.state.vmap, self.points, self.mask, self.post.pose,
                     self.cfg)
        _copy_into(self.state.vmap, vm)
        self.info[-1].copy_(voxel_map.count(vm).to(torch.float32))

    def _after_post(self) -> None:
        with span("read.insert"):
            insert = bool(self.post.is_map_insert)
        if insert:
            self._insert_g()
