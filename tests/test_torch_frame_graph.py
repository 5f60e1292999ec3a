"""The scan-to-map frame as stages and as frame graphs, on the CPU.

`_step` is the composition of `_pre`, `_icp`, `_post` and `_insert`; it is
held bit for bit against `_step_before_split`, a verbatim copy of the
monolithic frame it replaced. `FrameGraphs` runs those stages over static
buffers (on CUDA each is captured as a graph; on the CPU the same code runs
eagerly) and is held bit for bit against `_step`, frame after frame, with
map inserts; its infos and states alias none of its buffers; the
configurations whose ICP reads the host are routed to the eager loop by
`icp.loop.eager_loop`; and the frame graphs' slice agrees with the JAX
reference's ScanToMapPipeline within test_torch_slice's bounds. Small
shapes: 1,024-point scans, an 8,192-point map, six or seven frames.
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from test_scan_to_map import _s2m_cfg
from test_torch_slice import GAPS, _assert_slice_agrees
from tpu_icp_slam.config import to_json as jto_json
from tpu_icp_slam.core.pointcloud import voxel_downsample_np
from tpu_icp_slam.datasets import synthetic as jsyn
from tpu_icp_slam.slam.runner import pad_scans
from tpu_icp_slam.slam.scan_to_map import ScanToMapPipeline as JaxPipeline
from tpu_icp_slam_torch import (
    ICPConfig, MappingConfig, PipelineConfig, SlamConfig,
)
from tpu_icp_slam_torch.config import from_json
from tpu_icp_slam_torch.core import se3
from tpu_icp_slam_torch.core.pointcloud import PAD_COORD, PointCloud
from tpu_icp_slam_torch.icp.loop import (
    ICPResult, _nn_correspondence, align_with_correspondence, eager_loop,
)
from tpu_icp_slam_torch.kernels.icp_fused import fused_args, icp_fused
from tpu_icp_slam_torch.mapping import voxel_map
from tpu_icp_slam_torch.mapping.normals import normals_knn
from tpu_icp_slam_torch.slam import scan_to_map as s2m
from tpu_icp_slam_torch.slam.scan_to_map import MapOdomState

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")


def _step_before_split(state, points, mask, *, cfg):
    """scan_to_map._step as it was before the stage split (commit
    dd9e8b2), verbatim: the oracle of the split."""
    m, p, ic = cfg.mapping, cfg.pipeline, cfg.icp
    init = s2m._predict(state, cfg)
    center = init[:3, 3]
    if m.extract_hysteresis > 0.0:
        moved = (torch.linalg.vector_norm(center - state.extract_center)
                 > m.extract_hysteresis)
        if bool(state.need_extract | moved):
            loc_pts, loc_nrm, loc_msk, r_cover = voxel_map.extract_local(
                state.vmap, center, m.local_model_size,
                approx=m.extract_approx)
            ex_center = center
        else:
            loc_pts, loc_nrm, loc_msk, r_cover, ex_center = (
                state.loc_pts, state.loc_nrm, state.loc_msk, state.r_cover,
                state.extract_center)
        stale_off = torch.linalg.vector_norm(center - ex_center)
    else:
        loc_pts, loc_nrm, loc_msk, r_cover = voxel_map.extract_local(
            state.vmap, center, m.local_model_size, approx=m.extract_approx)
        ex_center = center
        stale_off = torch.zeros((), dtype=torch.float32, device=center.device)
    init_inv = se3.inverse(init)
    loc_local = loc_pts @ init_inv[:3, :3].T + init_inv[:3, 3]
    loc_local = torch.where(loc_msk[:, None], loc_local,
                            torch.full_like(loc_local, PAD_COORD))
    nrm_local = loc_nrm @ init_inv[:3, :3].T
    r_gate = torch.clamp(r_cover - stale_off - ic.max_corr_dist, min=0.0)
    if (ic.loop_backend == "fused" and ic.method == "point_to_plane"
            and ic.degen_eps == 0.0 and ic.corr_range_rate == 0.0):
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
    pose = init @ res.T
    T_rel = se3.inverse(state.pose) @ pose
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
        insert = (voxel_map.insert_hash if m.insert_backend == "hash"
                  else voxel_map.insert)
        vm = insert(vm, world_pts, mask, nrm, voxel=m.map_voxel,
                    center=pose[:3, 3])
    new_state = MapOdomState(
        pose=pose, T_rel=T_rel,
        last_kf_pose=torch.where(is_kf, pose, state.last_kf_pose), vmap=vm,
        frame=state.frame + 1,
        n_keyframes=state.n_keyframes + is_kf.to(torch.int32),
        loc_pts=loc_pts, loc_nrm=loc_nrm, loc_msk=loc_msk, r_cover=r_cover,
        extract_center=ex_center, need_extract=is_map_insert)
    info = {"pose": pose, "rmse": res.rmse, "iters": res.iters,
            "n_inliers": res.n_inliers, "converged": res.converged,
            "clamped": clamped, "is_keyframe": is_kf,
            "map_inserted": is_map_insert, "map_points": voxel_map.count(vm)}
    return new_state, info


def _slice_cfg(icp=None, **mapping):
    """chip_smoke.slice_config() (the flagship) cut to 1,024-point scans, an
    8,192-point map and a 2,048-point local model."""
    return SlamConfig(
        icp=ICPConfig(
            method="point_to_plane", max_iters=18, max_corr_dist=1.0,
            damping=1e-3, max_step_trans=1.0, max_step_rot=0.3,
            min_inliers=100, huber_delta=0.3, tol=1e-5, step_scale=1.4,
            tol_update=0.01, prior_trans_weight=0.004, prior_rot_weight=0.04,
            max_total_trans=1.5, max_total_rot=0.5, **(icp or {})),
        mapping=MappingConfig(map_capacity=8192, local_model_size=2048,
                              map_voxel=0.2, **mapping),
        pipeline=PipelineConfig(
            mode="scan_to_map", scan_capacity=1024, keyframe_trans=2.5,
            keyframe_rot=0.3, normal_ref_stride=4, normal_approx=True,
            normal_oversample=8))


def _lifted_cfg():
    """configs/lidar2d_scan_to_map.json's front end (config 2's z = 0 lift,
    point-to-point), as test_torch_state2d's lift test runs it."""
    return SlamConfig(
        icp=ICPConfig(method="point_to_point", max_iters=25,
                      max_corr_dist=0.7, damping=1e-3, max_step_trans=0.5,
                      max_step_rot=0.3, min_inliers=50, huber_delta=0.3,
                      step_scale=1.4, tol_update=0.002),
        mapping=MappingConfig(map_capacity=8192, local_model_size=2048,
                              map_voxel=0.08),
        pipeline=PipelineConfig(mode="scan_to_map", scan_capacity=512,
                                keyframe_trans=0.8, keyframe_rot=0.2))


def _velodyne(n_frames=7):
    scans, gt = jsyn.velodyne_log(n_frames=n_frames, n_rings=16,
                                  n_azimuth=320, path_fraction=0.14)
    pts, msk = pad_scans([voxel_downsample_np(s, 0.4) for s in scans], 1024)
    return pts, msk, gt


def _lidar2d_lifted(n_frames=7):
    log = jsyn.lidar2d_log(n_frames=60, n_beams=360, seed=0, noise=0.005,
                           loop=True)
    scans = [jsyn.scan_to_points(log.ranges[i], log.angles, log.max_range)
             for i in range(n_frames)]
    pts, msk = pad_scans(scans, 512)
    return (np.concatenate([pts, np.zeros_like(pts[..., :1])], -1)
            .astype(np.float32), msk)


CASES = {
    "steps": (_slice_cfg, _velodyne),
    "fused": (lambda: _slice_cfg({"loop_backend": "fused"}), _velodyne),
    "lifted-point-to-point": (_lifted_cfg, _lidar2d_lifted),
}
# FrameGraphs' own options: extract hysteresis (its `need` stage), the
# unrolled loop and K5 inside `pre`, Anderson's trip 0, the ICP that
# eager_loop routes between the graphs, the voxel NN's grid rebuilt by
# `pre`, and the hash insert
GRAPH_CASES = {
    **CASES,
    "hysteresis": (lambda: _slice_cfg(extract_hysteresis=3.0), _velodyne),
    "unrolled": (lambda: _slice_cfg({"unroll_iters": 8}), _velodyne),
    "anderson": (lambda: _slice_cfg({"anderson": True}), _velodyne),
    "degen-eps-eager": (lambda: _slice_cfg({"degen_eps": 1e-3}), _velodyne),
    "voxel-nn": (lambda: _slice_cfg({"nn_backend": "voxel"}), _velodyne),
    "insert-hash": (lambda: _slice_cfg(insert_backend="hash"), _velodyne),
}


def _t(x, dtype=torch.float32):
    return torch.as_tensor(x, dtype=dtype)


def _assert_equal(a, b, what):
    if dataclasses.is_dataclass(a):
        for f in dataclasses.fields(a):
            _assert_equal(getattr(a, f.name), getattr(b, f.name),
                          f"{what}.{f.name}")
        return
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    assert torch.equal(a.to(b.dtype), b), (what, a, b)


def _problem(case, cases=CASES):
    make_cfg, make_log = cases[case]
    cfg = make_cfg()
    pts, msk = make_log()[:2]
    pipe = s2m.ScanToMapPipeline(cfg, device="cpu")
    return cfg, pts, msk, pipe.init_state(pts[0], msk[0])


@pytest.mark.parametrize("case", list(CASES))
def test_stages_compose_to_the_frame_before_the_split(case):
    """_step, as the composition of its stages, equals the monolithic
    frame bit for bit: every info and every state field, frame after frame,
    map inserts included."""
    cfg, pts, msk, state = _problem(case)
    old, inserts = state, 0
    for f in range(1, len(pts)):
        state, info = s2m._step(state, _t(pts[f]), _t(msk[f], bool), cfg=cfg)
        old, want = _step_before_split(old, _t(pts[f]), _t(msk[f], bool),
                                       cfg=cfg)
        for k in want:
            _assert_equal(info[k], want[k], f"frame {f} info {k}")
        _assert_equal(state, old, f"frame {f} state")
        inserts += bool(info["map_inserted"])
    assert inserts >= 1


@pytest.mark.parametrize("case", list(GRAPH_CASES))
def test_frame_graphs_equal_step_frame_by_frame(case):
    """FrameGraphs over its static buffers, run eagerly on the CPU (the
    code the card captures), equals the eager _step frame after frame:
    run() over the whole log, and step() frame by frame from each of
    _step's states, infos and states bit for bit."""
    cfg, pts, msk, state0 = _problem(case, GRAPH_CASES)
    graphs = s2m.FrameGraphs(cfg, pts.shape[1], CPU)
    assert graphs.eager_icp == (case == "degen-eps-eager")
    got_state, got = graphs.run(state0, _t(pts[1:]), _t(msk[1:], bool))
    state, inserts = state0, 0
    for f in range(1, len(pts)):
        g_state, g_info = graphs.step(state, _t(pts[f]), _t(msk[f], bool))
        state, info = s2m._step(state, _t(pts[f]), _t(msk[f], bool),
                                cfg=cfg)
        _assert_equal(g_state, state, f"frame {f} step() state")
        for k in info:
            _assert_equal(g_info[k], info[k], f"frame {f} step() {k}")
            _assert_equal(got[k][f - 1], info[k], f"frame {f} run() {k}")
        inserts += bool(info["map_inserted"])
    _assert_equal(got_state, state, "run() state")
    assert inserts >= 1 and set(got) == set(info)


def _storages(x):
    if dataclasses.is_dataclass(x):
        return {p for f in dataclasses.fields(x)
                for p in _storages(getattr(x, f.name))}
    if isinstance(x, dict):
        return {p for v in x.values() for p in _storages(v)}
    if isinstance(x, (tuple, list)):
        return {p for v in x for p in _storages(v)}
    if isinstance(x, torch.Tensor):
        return {x.untyped_storage().data_ptr()}
    return set()


def test_frame_graph_results_alias_no_buffer():
    """States are values: nothing run() or step() returns shares memory
    with the static buffers or with another frame's result, and a returned
    state and info read after later frames are unchanged; two runs from
    one state are equal."""
    cfg, pts, msk, state0 = _problem("steps")
    graphs = s2m.FrameGraphs(cfg, pts.shape[1], CPU)
    buffers = _storages((graphs.state, graphs.pre, graphs.post, graphs.info,
                         graphs.points, graphs.mask, graphs.align.state,
                         graphs.align.src, graphs.need))
    st1, info1 = graphs.step(state0, _t(pts[1]), _t(msk[1], bool))
    kept = (s2m._clone(st1), {k: v.clone() for k, v in info1.items()})
    st2, info2 = graphs.step(st1, _t(pts[2]), _t(msk[2], bool))
    end, infos = graphs.run(st2, _t(pts[3:]), _t(msk[3:], bool))
    for result in (st1, info1, st2, info2, end, infos):
        assert not _storages(result) & buffers
    assert not _storages((st1, info1)) & _storages((st2, info2))
    _assert_equal(st1, kept[0], "state after later frames")
    for k, v in kept[1].items():
        _assert_equal(info1[k], v, f"info {k} after later frames")
    assert len(set(infos["pose"][:, 0, 3].tolist())) == len(pts) - 3
    again, infos2 = graphs.run(st2, _t(pts[3:]), _t(msk[3:], bool))
    _assert_equal(again, end, "second run's state")
    for k in infos:
        _assert_equal(infos2[k], infos[k], f"second run's {k}")


def _presets():
    out = {}
    for path in sorted((ROOT / "configs").glob("*.json")):
        cfg = from_json(path.read_text())
        if cfg.pipeline.mode == "scan_to_map":
            out[path.name] = cfg
    return out


def test_only_host_reading_icp_configs_leave_the_graphs():
    """eager_loop routes exactly the ICP configurations whose iteration
    reads the host (degen_eps > 0: eigh); every scan-to-map preset and the flagship slice at each
    loop_backend and nn_precision keep their ICP in the graphs."""
    presets = _presets()
    assert set(presets) == {"kitti_full_res.json", "kitti_scan_to_map.json",
                            "lidar2d_scan_to_map.json", "sim3d_loop.json"}
    cfgs = list(presets.values()) + [
        _slice_cfg({"loop_backend": b, "nn_precision": p})
        for b in ("steps", "fused") for p in ("highest", "bf16", "rescore")]
    for cfg in cfgs:
        assert not eager_loop(cfg.icp), cfg.icp
    for icp, eager in (({"degen_eps": 1e-3}, True),
                       ({"nn_backend": "voxel"}, False),
                       ({"nn_backend": "xla"}, False),
                       ({"unroll_iters": 4}, False),
                       ({"corr_range_rate": 0.01}, False),
                       ({"loop_backend": "fused", "degen_eps": 1e-3}, True)):
        cfg = _slice_cfg(icp)
        assert eager_loop(cfg.icp) == eager, icp
        graphs = s2m.FrameGraphs(cfg, 1024, CPU)
        assert graphs.eager_icp == eager and graphs.fused == s2m._fused(
            cfg.icp), icp
        assert (graphs.align.corr_fn is None) == (eager or graphs.fused)


def test_frame_graph_slice_matches_reference():
    """The frame graphs' slice (the code the card captures, run on the CPU)
    against the JAX reference's ScanToMapPipeline on the same numpy log,
    within test_torch_slice's bounds (10x the measured 2.96e-5 m and
    6.1e-6 rad, iterations within 2), the flagship test config cut to 1,024-point scans and an
    8,192-point map."""
    jcfg = _s2m_cfg()
    jcfg = dataclasses.replace(
        jcfg,
        mapping=dataclasses.replace(jcfg.mapping, map_capacity=8192,
                                    local_model_size=2048),
        pipeline=dataclasses.replace(jcfg.pipeline, scan_capacity=1024))
    pts, msk, gt = _velodyne(8)
    jp = JaxPipeline(jcfg)
    _, ji = jp.run_fused(jp.init_state(pts[0], msk[0]), pts[1:], msk[1:])
    cfg = from_json(jto_json(jcfg))
    state0 = s2m.ScanToMapPipeline(cfg, device="cpu").init_state(pts[0],
                                                                  msk[0])
    _, ti = s2m.FrameGraphs(cfg, 1024, CPU).run(state0, _t(pts[1:]),
                                                _t(msk[1:], bool))
    ji = {k: np.asarray(v) for k, v in ji.items()}
    ti = {k: v.numpy() for k, v in ti.items()}
    _assert_slice_agrees(ji, ti, gt, GAPS["main"])
    assert ti["map_inserted"].sum() >= 1
    # ICP iterations may differ by the slice's measured ±1-2 (ROADMAP §3):
    # the convergence test at tol 1e-5 sits on float32 rounding
    assert np.abs(ti["iters"] - ji["iters"]).max() <= 2

