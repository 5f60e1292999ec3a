"""The port's own copies of the reference's numpy modules — trajectory_io,
the KITTI reader, the golden oracle, `two_scan_pair` — against the
reference on the same inputs, and the port's obs/ (Timer, MetricsLogger,
realize, trace).

Tolerances: the copies are the same numpy code, so every output is held
bit for bit (files byte for byte); round trips through text hold 1e-7 (TUM,
9 decimals of a quaternion) and 1e-9 (KITTI, 9 significant digits).
"""

import json

import numpy as np
import pytest
import torch

from tpu_icp_slam.datasets import kitti as jkitti
from tpu_icp_slam.datasets import synthetic as jsyn
from tpu_icp_slam.eval import golden as jgolden
from tpu_icp_slam.eval import trajectory_io as jtio
from tpu_icp_slam_torch.datasets import kitti, synthetic
from tpu_icp_slam_torch.eval import golden
from tpu_icp_slam_torch.eval import trajectory_io as tio
from tpu_icp_slam_torch.obs import MetricsLogger, Timer, realize, timed, trace


def _trajectory(n=17, seed=3):
    """A random SE(3) walk (float64), rotations built with Rodrigues."""
    rng = np.random.default_rng(seed)
    poses = [np.eye(4)]
    for _ in range(n - 1):
        poses.append(poses[-1] @ synthetic.rigid_transform(3, rng, 0.2, 0.5))
    return np.stack(poses)


def _se2(n=8):
    th = np.linspace(0, 1.2, n)
    p = np.tile(np.eye(3), (n, 1, 1))
    p[:, 0, 0], p[:, 0, 1] = np.cos(th), -np.sin(th)
    p[:, 1, 0], p[:, 1, 1] = np.sin(th), np.cos(th)
    p[:, 0, 2] = np.arange(n) * 0.7
    return p


@pytest.mark.parametrize("fmt", ["tum", "kitti"])
@pytest.mark.parametrize("dim", [3, 2])
def test_trajectory_files_match_reference_and_round_trip(tmp_path, fmt, dim):
    poses = _trajectory() if dim == 3 else _se2()
    mine, ref = tmp_path / "port.txt", tmp_path / "ref.txt"
    getattr(tio, f"write_{fmt}")(str(mine), poses)
    getattr(jtio, f"write_{fmt}")(str(ref), poses)
    assert mine.read_bytes() == ref.read_bytes()
    back = getattr(tio, f"read_{fmt}")(str(mine))
    if fmt == "tum":
        ts, back = back
        np.testing.assert_array_equal(ts, np.arange(len(poses)))
        _, jback = jtio.read_tum(str(ref))
    else:
        jback = jtio.read_kitti(str(ref))
    np.testing.assert_array_equal(back, jback)
    lifted = tio._lift(poses)
    np.testing.assert_allclose(back, lifted,
                               atol=1e-7 if fmt == "tum" else 1e-9)


@pytest.mark.parametrize("with_tr", [False, True])
def test_kitti_sequence_round_trip_matches_reference(tmp_path, with_tr):
    scans, gt = synthetic.velodyne_log(n_frames=3, n_rings=4, n_azimuth=64,
                                       path_fraction=0.05)
    Tr = synthetic.rigid_transform(3, np.random.default_rng(1)) \
        if with_tr else None
    kitti.write_sequence(str(tmp_path / "port"), scans, gt, Tr=Tr)
    jkitti.write_sequence(str(tmp_path / "ref"), scans, gt, Tr=Tr)
    for name in ["poses.txt"] + (["calib.txt"] if with_tr else []) + [
            f"velodyne/{i:06d}.bin" for i in range(3)]:
        assert ((tmp_path / "port" / name).read_bytes()
                == (tmp_path / "ref" / name).read_bytes()), name
    got, poses = kitti.load_sequence(str(tmp_path / "port"), max_frames=2)
    jgot, jposes = jkitti.load_sequence(str(tmp_path / "port"), max_frames=2)
    assert len(got) == 2
    for a, b, s in zip(got, jgot, scans):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, s.astype(np.float32))
    np.testing.assert_array_equal(poses, jposes)
    np.testing.assert_allclose(poses, gt[:2], atol=1e-9)
    if with_tr:
        np.testing.assert_array_equal(
            kitti.read_calib_tr(str(tmp_path / "port" / "calib.txt")),
            jkitti.read_calib_tr(str(tmp_path / "port" / "calib.txt")))


@pytest.mark.parametrize("kw", [
    dict(n=4096, seed=0),
    dict(n=2000, seed=3, rot_scale=0.2, trans_scale=0.3),
    dict(n=1500, seed=4, dim=2, rot_scale=0.15, trans_scale=0.3),
    dict(n=777, seed=5, noise=0.01),
])
def test_two_scan_pair_bit_equal(kw):
    for a, b in zip(synthetic.two_scan_pair(**kw), jsyn.two_scan_pair(**kw)):
        np.testing.assert_array_equal(a, b)


def _assert_same_result(a, b):
    np.testing.assert_array_equal(a.T, b.T)
    assert (a.rmse, a.iters, a.n_inliers) == (b.rmse, b.iters, b.n_inliers)


@pytest.mark.parametrize("dim,seed,n,iters", [(3, 3, 2000, 60),
                                              (2, 4, 1500, 80)])
def test_golden_point_to_point_bit_equal(dim, seed, n, iters):
    """test_golden_and_metrics.py's cases."""
    src, dst, _ = jsyn.two_scan_pair(n=n, seed=seed, dim=dim, rot_scale=0.2,
                                     trans_scale=0.3)
    _assert_same_result(golden.icp_point_to_point(src, dst, max_iters=iters),
                        jgolden.icp_point_to_point(src, dst, max_iters=iters))


def test_golden_point_to_plane_bit_equal():
    rng = np.random.default_rng(5)
    pts, nrms = [], []
    for n, d in [((0, 0, 1.0), 0.0), ((0, 1.0, 0), 3.0), ((1.0, 0, 0), 2.0)]:
        n = np.asarray(n, dtype=np.float64)
        basis = np.linalg.svd(n[None])[2][1:]
        pts.append(rng.uniform(-2, 2, size=(500, 2)) @ basis + d * n)
        nrms.append(np.tile(n, (500, 1)))
    dst, dst_n = np.concatenate(pts), np.concatenate(nrms)
    T_gt = jsyn.rigid_transform(3, rng, rot_scale=0.05, trans_scale=0.1)
    Ti = np.linalg.inv(T_gt)
    src = dst @ Ti[:3, :3].T + Ti[:3, 3]
    _assert_same_result(
        golden.icp_point_to_plane(src, dst, dst_n, max_iters=30),
        jgolden.icp_point_to_plane(src, dst, dst_n, max_iters=30))


def test_golden_odometry_bit_equal():
    log = jsyn.lidar2d_log(n_frames=20, n_beams=360, seed=0, noise=0.002)
    scans = [jsyn.scan_to_points(log.ranges[i], log.angles, log.max_range)
             for i in range(len(log.ranges))]
    np.testing.assert_array_equal(
        golden.odometry(scans, max_iters=50, max_corr_dist=0.5),
        jgolden.odometry(scans, max_iters=50, max_corr_dist=0.5))


def test_timer_spans_and_summary():
    t = Timer()
    for _ in range(3):
        with t.span("a"):
            pass
    with timed("b", t):
        pass
    s = t.summary()
    assert s["a"]["n"] == 3 and s["b"]["n"] == 1
    assert t.total("a") == pytest.approx(s["a"]["total_s"])
    assert s["a"]["mean_s"] == pytest.approx(s["a"]["total_s"] / 3)
    assert "never" not in s and t.total("never") == 0


def test_metrics_logger_writes_jsonl(tmp_path):
    path = tmp_path / "sub" / "m.jsonl"
    with MetricsLogger(str(path), static_fields={"run": "x"}) as log:
        rec = log.log("step", frame=1, rmse=0.5)
        log.log("done")
    assert rec["event"] == "step" and rec["run"] == "x"
    lines = [json.loads(x) for x in path.read_text().splitlines()]
    assert [r["event"] for r in lines] == ["step", "done"]
    assert lines[0]["frame"] == 1 and lines[1]["run"] == "x"
    assert MetricsLogger().log("e", a=1)["a"] == 1  # no file: records only


def test_realize_and_trace(tmp_path):
    out = realize({"T": torch.eye(4), "n": [torch.tensor(3), 2.0]})
    assert isinstance(out["T"], np.ndarray) and out["T"].shape == (4, 4)
    assert out["n"][0] == 3 and out["n"][1] == 2.0
    with trace(None):
        pass
    with trace(str(tmp_path / "prof")):
        torch.ones(8).sum()
    assert (tmp_path / "prof" / "trace.json").stat().st_size > 0
