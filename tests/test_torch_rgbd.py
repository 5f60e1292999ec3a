"""Config 3, RGB-D projective odometry: the port (datasets/synthetic's depth
camera, icp/projective.py, mapping/normals.normals_from_depth,
slam/rgbd.py, the runner's RGB-D branch) against the reference on the CPU.

Tolerances:
- the depth camera (Intrinsics, depth_scene, rgbd_log): bit for bit, both
  are the same float64 numpy;
- backprojection, the projective lookup (q, n, gate, d2): bit for bit on
  the CPU (the same float32 operations, round half to even, true
  division); the depth normals within 2 float32 ulps of 1 (2.4e-7: the
  norm's sum in another order), their validity equal;
- RGBDOdometry poses within 1e-5 m and 1e-5 rad a frame of the
  reference's, the same ICP iterations (float32 Gauss-Newton sums in
  another order; the gaps seen are ~1.3e-6); run_fused equal to a loop of
  step bit for bit;
- run_slam's ate_rmse and rpe_trans within 1e-5 m of the reference's,
  rpe_rot within 1e-3 rad: it is the arccos of a float32 rotation's trace
  near 1, where one float32 ulp of the trace moves the angle by ~4e-4.
"""

import dataclasses
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_slice import _rot_gap
from tpu_icp_slam.config import SlamConfig, override
from tpu_icp_slam.config import from_json as jfrom_json
from tpu_icp_slam.config import to_json as jto_json
from tpu_icp_slam.core import pointcloud as jpc
from tpu_icp_slam.datasets import synthetic as jsyn
from tpu_icp_slam.icp import loop as jloop
from tpu_icp_slam.icp import projective as jproj
from tpu_icp_slam.mapping.normals import normals_from_depth as j_normals
from tpu_icp_slam.slam import runner as jrunner
from tpu_icp_slam.slam.rgbd import RGBDOdometry as JaxRGBD
from tpu_icp_slam_torch.config import from_json as tfrom_json
from tpu_icp_slam_torch.core.pointcloud import PointCloud
from tpu_icp_slam_torch.datasets import synthetic as tsyn
from tpu_icp_slam_torch.icp import loop as tloop
from tpu_icp_slam_torch.icp import projective as tproj
from tpu_icp_slam_torch.interop import (
    rgbd_state_from_numpy,
    rgbd_state_to_numpy,
)
from tpu_icp_slam_torch.mapping.normals import normals_from_depth as t_normals
from tpu_icp_slam_torch.slam import runner as trunner
from tpu_icp_slam_torch.slam.rgbd import RGBDOdometry

ROOT = Path(__file__).resolve().parents[1]
POSE_GAPS = (1e-5, 1e-5)  # m, rad a frame
NORMAL_GAP = 2.4e-7
ATE_GAP = 1e-5  # m (ate_rmse, rpe_trans)
RPE_ROT_GAP = 1e-3  # rad


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Test files run in parallel worker processes: one torch thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(**pipeline):
    """test_rgbd.py's odometry config (SlamConfig() with its ICP
    overrides), as JAX and port configs."""
    cfg = override(SlamConfig(), {"icp.max_corr_dist": 0.15,
                                  "icp.max_iters": 15,
                                  "icp.method": "point_to_plane"})
    cfg = dataclasses.replace(cfg, pipeline=dataclasses.replace(
        cfg.pipeline, **pipeline))
    return cfg, tfrom_json(jto_json(cfg))


def _intrinsics(ki):
    k = (ki.fx, ki.fy, ki.cx, ki.cy, ki.width, ki.height)
    return jproj.CameraIntrinsics(*k), tproj.CameraIntrinsics(*k)


def _t(a):
    return torch.as_tensor(np.array(a))


@pytest.mark.parametrize("size", [(64, 48), (160, 120)])
def test_depth_camera_bit_equal(size):
    jk, tk = (m.Intrinsics.tum_default(*size) for m in (jsyn, tsyn))
    assert dataclasses.asdict(jk) == dataclasses.asdict(tk)
    pose = np.linalg.inv(jsyn.rgbd_log(n_frames=2, K=jk)[1][1])
    np.testing.assert_array_equal(tsyn.depth_scene(pose, tk, seed=3),
                                  jsyn.depth_scene(pose, jk, seed=3))
    jd, jp, jki = jsyn.rgbd_log(n_frames=4, K=jk, seed=1)
    td, tp, tki = tsyn.rgbd_log(n_frames=4, K=tk, seed=1)
    assert td.dtype == jd.dtype == np.float64
    np.testing.assert_array_equal(td, jd)
    np.testing.assert_array_equal(tp, jp)
    assert dataclasses.asdict(tki) == dataclasses.asdict(jki)
    assert (td > 0).mean() > 0.5


def test_default_log_is_the_reference_one():
    """rgbd_log without intrinsics: the 160x120 stand-in, as the
    reference's."""
    jd, jp, jki = jsyn.rgbd_log(n_frames=2)
    td, tp, tki = tsyn.rgbd_log(n_frames=2)
    assert td.shape == (2, 120, 160)
    np.testing.assert_array_equal(td, jd)
    np.testing.assert_array_equal(tp, jp)


def test_backprojection_and_depth_normals_match_reference():
    depths, _, ki = jsyn.rgbd_log(n_frames=3)
    jK, tK = _intrinsics(ki)
    for depth in depths:
        d32 = depth.astype(np.float32)
        jv, jval = jproj.backproject_depth(jnp.asarray(d32), jK)
        tv, tval = tproj.backproject_depth(torch.as_tensor(d32), tK)
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(tval.numpy(), np.asarray(jval))
        jn, jok = j_normals(jv, jval)
        tn, tok = t_normals(tv, tval)
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
        np.testing.assert_allclose(tn.numpy(), np.asarray(jn), rtol=0,
                                   atol=NORMAL_GAP)
        assert not tok[0].any() and not tok[:, -1].any()
        n = tn.numpy()[tok.numpy()]
        np.testing.assert_allclose(np.linalg.norm(n, axis=1), 1.0, atol=1e-6)


def _moved_source(seed):
    """Frame 1's valid vertices (invalid ones at the sentinel) moved by a
    small random SE(3), and frame 0's target maps, as numpy float32."""
    depths, _, ki = jsyn.rgbd_log(n_frames=2)
    jK, _ = _intrinsics(ki)
    v0, val0 = jproj.backproject_depth(jnp.asarray(depths[0], jnp.float32),
                                       jK)
    n0, ok0 = j_normals(v0, val0)
    v1, val1 = jproj.backproject_depth(jnp.asarray(depths[1], jnp.float32),
                                       jK)
    T = tsyn.rigid_transform(3, np.random.default_rng(seed), rot_scale=0.03,
                             trans_scale=0.05)
    pts = (np.asarray(v1).reshape(-1, 3) @ T[:3, :3].T + T[:3, 3]).astype(
        np.float32)
    pts[~np.asarray(val1).reshape(-1)] = 1.0e6
    return ki, pts, np.asarray(v0), np.asarray(n0), np.asarray(val0 & ok0)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_projective_correspondence_matches_reference(seed):
    """q, n, gate and d2 bit for bit on the CPU. Points on a pixel boundary
    (u or v within float32 rounding of k + 0.5) could round to either
    pixel if the two computed u differently; they compute it with the same
    operations in the same order, so none does here."""
    ki, pts, v0, n0, ok0 = _moved_source(seed)
    jK, tK = _intrinsics(ki)
    jq, jn, jg, jd2 = jproj.projective_correspondence(
        jK, jnp.asarray(v0), jnp.asarray(n0), jnp.asarray(ok0),
        max_corr_dist=0.1)(jnp.asarray(pts))
    tq, tn, tg, td2 = tproj.projective_correspondence(
        tK, _t(v0), _t(n0), _t(ok0), max_corr_dist=0.1)(_t(pts))
    for got, want in ((tq, jq), (tn, jn), (tg, jg), (td2, jd2)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert tg.dtype == torch.float32 and 0.1 * len(pts) < tg.sum()


def test_projective_normal_gate_applies_only_with_source_normals():
    ki, pts, v0, n0, ok0 = _moved_source(0)
    jK, tK = _intrinsics(ki)
    src_n = np.zeros_like(pts)
    src_n[:, 0] = 1.0  # at right angles to most target normals
    jg = jproj.projective_correspondence(
        jK, jnp.asarray(v0), jnp.asarray(n0), jnp.asarray(ok0), 0.1,
        normal_gate_cos=0.5, src_normals=jnp.asarray(src_n))(
            jnp.asarray(pts))[2]
    corr = tproj.projective_correspondence(tK, _t(v0), _t(n0), _t(ok0), 0.1,
                                           normal_gate_cos=0.5,
                                           src_normals=_t(src_n))
    tg = corr(_t(pts))[2]
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    plain = tproj.projective_correspondence(tK, _t(v0), _t(n0), _t(ok0), 0.1,
                                            normal_gate_cos=0.5)(_t(pts))[2]
    assert tg.sum() < 0.5 * plain.sum()


def test_align_projective_method_matches_reference():
    """align_with_correspondence with the projective lookup at
    icp.method="projective": the reference's point-to-point (Umeyama)
    branch; the same iterations, T within 1e-5."""
    ki, pts, v0, n0, ok0 = _moved_source(1)
    jK, tK = _intrinsics(ki)
    cfg, tcfg = _cfg()
    cfg = override(cfg, {"icp.method": "projective", "icp.max_iters": 10})
    tcfg = tfrom_json(jto_json(cfg))
    mask = pts[:, 0] < 1.0e5
    jres = jloop.align_with_correspondence(
        jpc.PointCloud(points=jnp.asarray(pts), mask=jnp.asarray(mask)),
        jproj.projective_correspondence(jK, jnp.asarray(v0), jnp.asarray(n0),
                                        jnp.asarray(ok0), 0.15),
        None, cfg.icp)
    tres = tloop.align_with_correspondence(
        PointCloud(points=_t(pts), mask=_t(mask)),
        tproj.projective_correspondence(tK, _t(v0), _t(n0), _t(ok0), 0.15),
        None, tcfg.icp)
    assert tres.iters == int(jres.iters) > 1
    assert int(tres.n_inliers) == int(jres.n_inliers)
    np.testing.assert_allclose(tres.T.numpy(), np.asarray(jres.T), atol=1e-5)


def _assert_poses_agree(got, want):
    pos = np.linalg.norm(got[:, :3, 3] - want[:, :3, 3], axis=1)
    assert pos.max() <= POSE_GAPS[0], pos
    rot = _rot_gap(got, want)
    assert rot.max() <= POSE_GAPS[1], rot


@pytest.mark.parametrize("stride", [1, 2])
def test_rgbd_odometry_matches_reference(stride):
    """simrgbd, 8 frames: the port's step loop and run_fused against the
    reference's run_fused, from the reference's frame-0 state carried over
    through interop."""
    depths, _, ki = jsyn.rgbd_log(n_frames=8)
    jK, tK = _intrinsics(ki)
    cfg, tcfg = _cfg(rgbd_src_stride=stride)
    jodo = JaxRGBD(cfg, jK)
    js0 = jodo.init_state(depths[0])
    leaves = {f.name: np.asarray(getattr(js0, f.name))
              for f in dataclasses.fields(js0)}
    ts0 = rgbd_state_from_numpy(leaves, device="cpu")
    back = rgbd_state_to_numpy(ts0)
    for k, v in leaves.items():
        np.testing.assert_array_equal(back[k], v)
    todo = RGBDOdometry(tcfg, tK, device="cpu")
    own = rgbd_state_to_numpy(todo.init_state(depths[0]))
    for k, v in leaves.items():  # the port's own frame-0 state
        if k == "prev_normal":
            np.testing.assert_allclose(own[k], v, rtol=0, atol=NORMAL_GAP)
        else:
            np.testing.assert_array_equal(own[k], v)
    jst, jinfo = jodo.run_fused(js0, depths[1:])
    tst, tinfo = todo.run_fused(ts0, depths[1:])
    jposes = np.asarray(jinfo["pose"])
    _assert_poses_agree(tinfo["pose"].numpy(), jposes)
    np.testing.assert_array_equal(tinfo["iters"].numpy(),
                                  np.asarray(jinfo["iters"]))
    assert set(tinfo) == set(jinfo)
    assert int(tst.frame) == int(jst.frame) == 7
    np.testing.assert_array_equal(tst.prev_valid.numpy(),
                                  np.asarray(jst.prev_valid))
    st = ts0
    for f in range(1, 8):
        st, info = todo.step(st, depths[f])
        assert torch.equal(info["pose"], tinfo["pose"][f - 1])
    assert torch.equal(st.pose, tst.pose)


def test_run_slam_rgbd_report_matches_reference(tmp_path):
    cfg, tcfg = _cfg()
    jposes, jrep = jrunner.run_slam(cfg, jrunner.load_dataset("simrgbd", 8),
                                    out_dir=None, mode="fused")
    data = trunner.load_dataset("simrgbd", 8)
    ref = jrunner.load_dataset("simrgbd", 8)
    assert (data.kind, data.dim, data.name, data.scans) == (
        ref.kind, ref.dim, ref.name, ref.scans)
    assert data.intrinsics == ref.intrinsics
    np.testing.assert_array_equal(data.depths, ref.depths)
    np.testing.assert_array_equal(data.gt_poses, ref.gt_poses)
    out = tmp_path / "run"
    tposes, trep = trunner.run_slam(tcfg, data, out_dir=str(out),
                                    mode="fused", device="cpu")
    assert list(trep) == list(jrep)
    assert trep["config_hash"] == jrep["config_hash"]
    assert trep["timers"].keys() == jrep["timers"].keys()
    _assert_poses_agree(tposes, jposes)
    assert abs(trep["ate_rmse"] - jrep["ate_rmse"]) <= ATE_GAP
    assert abs(trep["rpe_trans"] - jrep["rpe_trans"]) <= ATE_GAP
    assert abs(trep["rpe_rot"] - jrep["rpe_rot"]) <= RPE_ROT_GAP
    assert trep["ate_rmse"] < 0.03
    for name in ("trajectory.npz", "trajectory_tum.txt",
                 "trajectory_kitti.txt", "report.json", "metrics.jsonl"):
        assert (out / name).exists(), name
    sposes, srep = trunner.run_slam(tcfg, data, mode="streaming",
                                    device="cpu")
    np.testing.assert_array_equal(sposes, tposes)
    assert srep["mode"] == "streaming"


def test_run_rgbd_rewrites_the_method_to_point_to_plane():
    """As the reference's run_rgbd: any icp.method runs point-to-plane
    (configs/rgbd.json with SlamConfig()'s point_to_point here)."""
    with open(ROOT / "configs" / "rgbd.json") as fh:
        cfg = override(jfrom_json(fh.read()), {"icp.method": "point_to_point"})
    data = trunner.load_dataset("simrgbd", 8)
    tposes, trep = trunner.run_slam(tfrom_json(jto_json(cfg)), data,
                                    device="cpu")
    jposes, jrep = jrunner.run_slam(cfg, jrunner.load_dataset("simrgbd", 8))
    assert trep["config_hash"] == jrep["config_hash"]
    _assert_poses_agree(tposes, jposes)
