"""The frame-to-frame odometries as stages and as frame graphs, on the CPU.

RGB-D odometry (slam/rgbd.py) and scan-to-scan odometry (slam/pipeline.py)
run a frame as `_step`, the composition of their stages; each is held bit
for bit against a verbatim copy of the monolithic `_step` it replaced.
`RGBDFrameGraphs` and `OdomFrameGraphs` run those stages over static
buffers (on CUDA each stage is captured as a graph; on the CPU the same
code runs eagerly) and are held bit for bit against `_step`, frame after
frame, over both motion models, a prior and a trust region (T0⁻¹ read), the
strided RGB-D source, the 2D grid and none, 3D scans, the voxel NN and the
unrolled loop; `degen_eps > 0` keeps its ICP eager, unrolled or not (in
scan-to-map too). Their results alias none of their buffers, and their
runs agree with the JAX reference's run_fused within test_torch_rgbd's and
test_torch_2d's bounds. Small shapes: 64 x 48 depth images, 512-point 2D
scans, 1,024-point 3D scans.
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_2d import _cfg2d
from test_torch_frame_graph import _slice_cfg, _storages, _velodyne
from test_torch_rgbd import _assert_poses_agree, _cfg, _intrinsics
from tpu_icp_slam.config import to_json as jto_json
from tpu_icp_slam.datasets import synthetic as jsyn
from tpu_icp_slam.slam.pipeline import OdometryPipeline as JOdometry
from tpu_icp_slam.slam.rgbd import RGBDOdometry as JaxRGBD
from tpu_icp_slam_torch import SlamConfig
from tpu_icp_slam_torch.config import from_json
from tpu_icp_slam_torch.core.pointcloud import PAD_COORD, PointCloud
from tpu_icp_slam_torch.icp import projective as tproj
from tpu_icp_slam_torch.icp.loop import (
    _nn_correspondence, align_with_correspondence,
)
from tpu_icp_slam_torch.interop import rgbd_state_from_numpy
from tpu_icp_slam_torch.kernels.graphs import clone
from tpu_icp_slam_torch.mapping import normals
from tpu_icp_slam_torch.slam import pipeline, rgbd, runner
from tpu_icp_slam_torch.slam import scan_to_map as s2m

CPU = torch.device("cpu")
ROOT_CFG = Path(__file__).resolve().parents[1] / "configs" / "rgbd.json"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Test files run in parallel worker processes: one torch thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _replace(cfg, icp=None, **pipe):
    return dataclasses.replace(
        cfg, icp=dataclasses.replace(cfg.icp, **(icp or {})),
        pipeline=dataclasses.replace(cfg.pipeline, **pipe))


def _rgbd_json():
    with open(ROOT_CFG) as fh:
        return from_json(fh.read())


def _rgbd_step_before_split(state, depth, *, cfg, K):
    """rgbd._step before the stage split (commit 2366300), verbatim."""
    ic = cfg.icp
    vmap, valid = tproj.backproject_depth(depth, K)
    nmap, nvalid = normals.normals_from_depth(vmap, valid)
    valid_all = valid & nvalid
    s = max(int(cfg.pipeline.rgbd_src_stride), 1)
    vsrc = vmap[::s, ::s] if s > 1 else vmap
    msrc = valid_all[::s, ::s] if s > 1 else valid_all
    pts = vsrc.reshape(-1, 3)
    mask = msrc.reshape(-1)
    src = PointCloud(points=torch.where(mask[:, None], pts,
                                        torch.full_like(pts, PAD_COORD)),
                     mask=mask)
    corr = tproj.projective_correspondence(
        K, state.prev_vertex, state.prev_normal, state.prev_valid,
        max_corr_dist=ic.max_corr_dist, normal_gate_cos=ic.normal_gate_cos)
    init = (state.T_rel if cfg.pipeline.motion_model == "constant_velocity"
            else torch.eye(4, dtype=torch.float32, device=depth.device))
    res = align_with_correspondence(src, corr, init, ic)
    pose = state.pose @ res.T
    new_state = rgbd.RGBDState(pose=pose, T_rel=res.T, prev_vertex=vmap,
                               prev_normal=nmap, prev_valid=valid_all,
                               frame=state.frame + 1)
    return new_state, {"pose": pose, "rmse": res.rmse, "iters": res.iters,
                       "n_inliers": res.n_inliers,
                       "converged": res.converged}


def _odom_step_before_split(state, points, mask, *, cfg):
    """pipeline._step before the stage split (commit 2366300), verbatim."""
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
        grid = pipeline.fold_scan(grid, cfg, pose, points, mask)
    new_state = pipeline.OdomState(pose=pose, T_rel=res.T, prev_points=points,
                                   prev_mask=mask, grid=grid,
                                   frame=state.frame + 1)
    return new_state, {"pose": pose, "rmse": res.rmse, "iters": res.iters,
                       "n_inliers": res.n_inliers,
                       "converged": res.converged}


def _normals_before_fill(vertex_map, valid):
    """normals_from_depth with its border written element-wise (commit
    2366300), verbatim."""
    dx = torch.roll(vertex_map, -1, dims=1) - torch.roll(vertex_map, 1, dims=1)
    dy = torch.roll(vertex_map, -1, dims=0) - torch.roll(vertex_map, 1, dims=0)
    n = torch.linalg.cross(dx, dy, dim=-1)
    norm = torch.sqrt(torch.sum(n * n, dim=-1, keepdim=True))
    n = n / torch.clamp(norm, min=1e-12)
    flip = torch.sum(n * vertex_map, dim=-1, keepdim=True) > 0
    n = torch.where(flip, -n, n)
    ok = (valid
          & torch.roll(valid, -1, dims=1) & torch.roll(valid, 1, dims=1)
          & torch.roll(valid, -1, dims=0) & torch.roll(valid, 1, dims=0)
          & (norm[..., 0] > 1e-12))
    ok[0, :] = False
    ok[-1, :] = False
    ok[:, 0] = False
    ok[:, -1] = False
    return torch.where(ok[..., None], n, torch.zeros_like(n)), ok


# ---- the problems ----------------------------------------------------------

_PRIOR_TRUST = {"prior_trans_weight": 0.004, "prior_rot_weight": 0.04,
                "max_total_trans": 0.5, "max_total_rot": 0.3}

RGBD_CASES = {
    "rgbd.json stride 1": lambda c: c,
    "rgbd.json stride 2": lambda c: _replace(c, rgbd_src_stride=2),
    "identity motion": lambda c: _replace(c, motion_model="identity"),
    "prior and trust region": lambda c: _replace(c, _PRIOR_TRUST),
    "anderson": lambda c: _replace(c, {"anderson": True}),
    "unrolled": lambda c: _replace(c, {"unroll_iters": 8}),
    "degen-eps-eager": lambda c: _replace(c, {"degen_eps": 1e-3}),
    "degen-eps-eager unrolled": lambda c: _replace(
        c, {"degen_eps": 1e-3, "unroll_iters": 8}),
}


def _rgbd_problem(case, n_frames=6):
    cfg = RGBD_CASES[case](_rgbd_json())
    ki = jsyn.Intrinsics.tum_default(64, 48)
    depths, _, _ = jsyn.rgbd_log(n_frames=n_frames, K=ki, seed=2)
    K = tproj.CameraIntrinsics(ki.fx, ki.fy, ki.cx, ki.cy, ki.width,
                               ki.height)
    D = torch.as_tensor(depths, dtype=torch.float32)
    state0 = rgbd.RGBDOdometry(cfg, K, device="cpu").init_state(D[0])
    graphs = rgbd.RGBDFrameGraphs(cfg, K, 48, 64, CPU)
    return cfg, K, graphs, state0, (D,)


def _s2s_2d_cfg(icp=None, **pipe):
    """SlamConfig()'s 2D scan-to-scan cut to 512-point scans and a 256-cell
    grid."""
    cfg = SlamConfig()
    cfg = dataclasses.replace(cfg, mapping=dataclasses.replace(
        cfg.mapping, grid_size=256, ray_samples=64))
    return _replace(cfg, icp, scan_capacity=512, **pipe)


ODOM_CASES = {
    "2D grid": (lambda: _s2s_2d_cfg(), 2, True),
    "2D no grid": (lambda: _s2s_2d_cfg(), 2, False),
    "identity motion": (lambda: _s2s_2d_cfg(motion_model="identity"), 2,
                        True),
    "trust region": (lambda: _s2s_2d_cfg({"max_total_trans": 0.3,
                                          "max_total_rot": 0.2}), 2, True),
    "voxel NN": (lambda: _s2s_2d_cfg({"nn_backend": "voxel",
                                      "max_corr_dist": 0.5}), 2, True),
    "unrolled": (lambda: _s2s_2d_cfg({"unroll_iters": 12}), 2, True),
    "degen-eps-eager": (lambda: _s2s_2d_cfg({"degen_eps": 1e-3}), 2, True),
    "degen-eps-eager unrolled": (lambda: _s2s_2d_cfg(
        {"degen_eps": 1e-3, "unroll_iters": 12}), 2, True),
    "3D": (lambda: _replace(SlamConfig(), {"max_corr_dist": 1.0},
                            scan_capacity=1024), 3, False),
}


def _odom_problem(case, n_frames=6):
    make_cfg, dim, with_grid = ODOM_CASES[case]
    cfg = make_cfg()
    if dim == 2:
        data = runner.load_dataset("sim2d", n_frames)
        pts, msk = runner.pad_scans(data.scans, 512)
    else:
        pts, msk = _velodyne(n_frames)[:2]
    P, M = torch.as_tensor(pts), torch.as_tensor(msk)
    pipe = pipeline.OdometryPipeline(cfg, dim=dim, device="cpu")
    state0 = pipe.init_state(P[0], M[0], with_grid=with_grid)
    grid = None if state0.grid is None else tuple(state0.grid.logodds.shape)
    graphs = pipeline.OdomFrameGraphs(cfg, P.shape[1], dim, grid, CPU)
    return cfg, graphs, state0, (P, M)


def _assert_equal(a, b, what):
    if dataclasses.is_dataclass(a):
        for f in dataclasses.fields(a):
            _assert_equal(getattr(a, f.name), getattr(b, f.name),
                          f"{what}.{f.name}")
        return
    if a is None or b is None:
        assert a is None and b is None, what
        return
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    assert torch.equal(a.to(b.dtype), b), (what, a, b)


def _against_step(graphs, step, state0, logs, **kw):
    """graphs.run() over the log and graphs.step() from each of step's
    states, against step frame by frame: infos and states bit for bit."""
    got_state, got = graphs.run(state0, *(x[1:] for x in logs))
    state = state0
    for f in range(1, len(logs[0])):
        inputs = [x[f] for x in logs]
        g_state, g_info = graphs.step(state, *inputs)
        state, info = step(state, *inputs, **kw)
        _assert_equal(g_state, state, f"frame {f} step() state")
        for k in info:
            _assert_equal(g_info[k], info[k], f"frame {f} step() {k}")
            _assert_equal(got[k][f - 1], info[k], f"frame {f} run() {k}")
    _assert_equal(got_state, state, "run() state")
    assert set(got) == set(info)
    return got


# ---- the stage split ---------------------------------------------------------

def test_normals_border_fill_equals_element_writes():
    """normals_from_depth's border written by fill_ on its views equals the
    element-wise writes it replaced, bit for bit."""
    rng = np.random.default_rng(5)
    vmap = torch.as_tensor(rng.uniform(-2, 2, (48, 64, 3)), dtype=torch.float32)
    valid = torch.as_tensor(rng.uniform(size=(48, 64)) > 0.1)
    got, want = normals.normals_from_depth(vmap, valid), \
        _normals_before_fill(vmap, valid)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert not got[1][[0, -1]].any() and not got[1][:, [0, -1]].any()
    assert got[1].sum() > 0


@pytest.mark.parametrize("kind", ["rgbd", "scan-to-scan 2D",
                                  "scan-to-scan 3D"])
def test_stages_compose_to_the_frame_before_the_split(kind):
    """Each _step, as the composition of its stages, equals the monolithic
    frame it replaced bit for bit: every info and state field."""
    if kind == "rgbd":
        cfg, K, _, state, (D,) = _rgbd_problem("rgbd.json stride 1")
        old = state
        for f in range(1, len(D)):
            state, info = rgbd._step(state, D[f], cfg=cfg, K=K)
            old, want = _rgbd_step_before_split(old, D[f], cfg=cfg, K=K)
            _assert_equal(state, old, f"frame {f} state")
            for k in want:
                _assert_equal(info[k], want[k], f"frame {f} {k}")
        return
    cfg, _, state, (P, M) = _odom_problem("2D grid" if kind.endswith("2D")
                                          else "3D")
    old = state
    for f in range(1, len(P)):
        state, info = pipeline._step(state, P[f], M[f], cfg=cfg)
        old, want = _odom_step_before_split(old, P[f], M[f], cfg=cfg)
        _assert_equal(state, old, f"frame {f} state")
        for k in want:
            _assert_equal(info[k], want[k], f"frame {f} {k}")


# ---- the frame graphs against the eager frame --------------------------------

@pytest.mark.parametrize("case", list(RGBD_CASES))
def test_rgbd_graphs_equal_step_frame_by_frame(case):
    """RGBDFrameGraphs over its static buffers, run eagerly on the CPU (the
    code the card captures), equals rgbd._step frame after frame."""
    cfg, K, graphs, state0, logs = _rgbd_problem(case)
    assert graphs.eager_icp == case.startswith("degen-eps-eager")
    assert graphs.icp_in_pre == (case == "unrolled")
    got = _against_step(graphs, rgbd._step, state0, logs, cfg=cfg, K=K)
    assert (got["iters"] > 1).all()


@pytest.mark.parametrize("case", list(ODOM_CASES))
def test_odom_graphs_equal_step_frame_by_frame(case):
    """OdomFrameGraphs over its static buffers, run eagerly on the CPU,
    equals pipeline._step frame after frame (the occupancy grid too)."""
    cfg, graphs, state0, logs = _odom_problem(case)
    assert graphs.eager_icp == case.startswith("degen-eps-eager")
    assert graphs.icp_in_pre == (case == "unrolled")
    assert (graphs.grid is not None) == (case == "voxel NN")
    got = _against_step(graphs, pipeline._step, state0, logs, cfg=cfg)
    assert (got["iters"] > 1).all()


def test_trust_region_moves_T0_inverse():
    """The prior and trust-region cases read T0⁻¹: StaticAlign keeps it in
    a buffer that `pre` rewrites from each frame's T_rel."""
    cfg, K, graphs, state0, (D,) = _rgbd_problem("prior and trust region")
    assert graphs.align.T0_inv is not None
    assert graphs.align.prior_scale is not None
    st, _ = graphs.step(state0, D[1])
    graphs.step(st, D[2])
    want = torch.linalg.inv_ex(st.T_rel)[0]
    assert torch.equal(graphs.align.T0_inv, want)
    assert not torch.equal(want, torch.eye(4))


@pytest.mark.parametrize("kind", ["rgbd", "scan-to-scan 2D"])
def test_odom_graph_results_alias_no_buffer(kind):
    """States are values: nothing run() or step() returns shares memory
    with the static buffers or with another frame's result, a returned
    state and info read after later frames are unchanged, and two runs
    from one state are equal."""
    if kind == "rgbd":
        *_, graphs, state0, logs = _rgbd_problem("rgbd.json stride 1")
        extra = (graphs.depth, graphs.maps)
    else:
        _, graphs, state0, logs = _odom_problem("2D grid")
        extra = (graphs.points, graphs.mask)
    buffers = _storages((graphs.state, graphs.info, graphs.align.state,
                         graphs.align.src, graphs.align.T0, *extra))
    st1, info1 = graphs.step(state0, *(x[1] for x in logs))
    kept = (clone(st1), {k: v.clone() for k, v in info1.items()})
    st2, info2 = graphs.step(st1, *(x[2] for x in logs))
    end, infos = graphs.run(st2, *(x[3:] for x in logs))
    for result in (st1, info1, st2, info2, end, infos):
        assert not _storages(result) & buffers
    assert not _storages((st1, info1)) & _storages((st2, info2))
    _assert_equal(st1, kept[0], "state after later frames")
    for k, v in kept[1].items():
        _assert_equal(info1[k], v, f"info {k} after later frames")
    again, infos2 = graphs.run(st2, *(x[3:] for x in logs))
    _assert_equal(again, end, "second run's state")
    for k in infos:
        _assert_equal(infos2[k], infos[k], f"second run's {k}")


def test_only_host_reading_icp_configs_leave_the_graphs():
    """eager_loop's configurations (degen_eps > 0) run their ICP eagerly
    between the graphs, with no trip; configs/rgbd.json and SlamConfig()
    keep theirs in the graphs."""
    for cfg, eager in ((_rgbd_json(), False), (SlamConfig(), False),
                       (_replace(SlamConfig(), {"degen_eps": 1e-3}), True)):
        K = tproj.CameraIntrinsics(50.0, 50.0, 32.0, 24.0, 64, 48)
        for graphs in (rgbd.RGBDFrameGraphs(cfg, K, 48, 64, CPU),
                       pipeline.OdomFrameGraphs(cfg, 512, 2, (64, 64), CPU)):
            assert graphs.eager_icp == eager
            assert (graphs.align.corr_fn is None) == eager
            assert graphs.corr is not None


def test_scan_to_map_unrolled_eager_icp_equals_step():
    """A host-reading ICP (degen_eps > 0) keeps its eager loop between the
    scan-to-map graphs when it is unrolled too: `pre` runs no ICP and no
    `post`, and the frames equal s2m._step bit for bit."""
    cfg = _slice_cfg({"degen_eps": 1e-3, "unroll_iters": 8})
    pts, msk = _velodyne(6)[:2]
    P, M = torch.as_tensor(pts), torch.as_tensor(msk)
    state0 = s2m.ScanToMapPipeline(cfg, device="cpu").init_state(P[0], M[0])
    graphs = s2m.FrameGraphs(cfg, P.shape[1], CPU)
    assert graphs.eager_icp and not graphs.icp_in_pre
    got = _against_step(graphs, s2m._step, state0, (P, M), cfg=cfg)
    assert (got["iters"] > 1).all()


# ---- the frame graphs against the JAX reference ------------------------------

@pytest.mark.parametrize("stride", [1, 2])
def test_rgbd_graphs_match_reference(stride):
    """RGBDFrameGraphs (the code the card captures, run on the CPU) against
    the reference's RGBDOdometry.run_fused on simrgbd, 8 frames, from the
    reference's frame-0 state carried over through interop: poses within
    test_torch_rgbd's POSE_GAPS, the same ICP iterations."""
    depths, _, ki = jsyn.rgbd_log(n_frames=8)
    jK, tK = _intrinsics(ki)
    cfg, tcfg = _cfg(rgbd_src_stride=stride)
    jodo = JaxRGBD(cfg, jK)
    js0 = jodo.init_state(depths[0])
    _, jinfo = jodo.run_fused(js0, depths[1:])
    ts0 = rgbd_state_from_numpy({f.name: np.asarray(getattr(js0, f.name))
                                 for f in dataclasses.fields(js0)},
                                device="cpu")
    graphs = rgbd.RGBDFrameGraphs(tcfg, tK, ki.height, ki.width, CPU)
    tst, tinfo = graphs.run(ts0, torch.as_tensor(depths[1:],
                                                 dtype=torch.float32))
    _assert_poses_agree(tinfo["pose"].numpy(), np.asarray(jinfo["pose"]))
    np.testing.assert_array_equal(tinfo["iters"].numpy(),
                                  np.asarray(jinfo["iters"]))
    assert set(tinfo) == set(jinfo) and int(tst.frame) == 7


def test_odom_graphs_match_reference():
    """OdomFrameGraphs with its grid (run on the CPU) against the
    reference's OdometryPipeline.run_fused on test_torch_2d's 12 frames of
    sim2d: the same iterations, poses within its 2e-5."""
    data = runner.load_dataset("sim2d", 12)
    pts, msk = runner.pad_scans(data.scans, 512)
    jcfg = _cfg2d()
    jp = JOdometry(jcfg, dim=2)
    _, ji = jp.run_fused(jp.init_state(pts[0], msk[0]), pts[1:], msk[1:])
    cfg = from_json(jto_json(jcfg))
    P, M = torch.as_tensor(pts), torch.as_tensor(msk)
    state0 = pipeline.OdometryPipeline(cfg, dim=2, device="cpu").init_state(
        P[0], M[0])
    graphs = pipeline.OdomFrameGraphs(cfg, 512, 2,
                                      tuple(state0.grid.logodds.shape), CPU)
    _, ti = graphs.run(state0, P[1:], M[1:])
    np.testing.assert_array_equal(ti["iters"].numpy(), np.asarray(ji["iters"]))
    tposes, jposes = ti["pose"].numpy(), np.asarray(ji["pose"])
    np.testing.assert_allclose(tposes[:, :2, 2], jposes[:, :2, 2], atol=2e-5)
    np.testing.assert_allclose(tposes[:, :2, :2], jposes[:, :2, :2],
                               atol=2e-5)
