"""The port's runner (slam/runner.py) and scan-to-scan odometry
(slam/pipeline.py) against the reference's, on small 3D logs, the reference
run as its tests run it (CPU, nn_backend="xla").

Tolerances: scan-to-scan poses within 1e-4 m and 1e-4 rad a frame (float32
point-to-point ICP in another summation order, the port's CPU NN scoring
the difference form and the reference's "xla" NN the factored form; the
gaps seen are ~1e-6); run_slam's poses within the same bounds and its ATE
within 1e-4 m of the reference's, with the same report keys. The port's
streaming steps equal its fused run bit for bit.
"""

import json
import os
import struct
import zlib

import numpy as np
import pytest
import torch

from test_torch_slice import _rot_gap
from tpu_icp_slam.config import (
    BackendConfig,
    ICPConfig,
    MappingConfig,
    PipelineConfig,
    SlamConfig,
)
from tpu_icp_slam.config import to_json as jto_json
from tpu_icp_slam.core.pointcloud import voxel_downsample_np
from tpu_icp_slam.datasets import synthetic
from tpu_icp_slam.slam import runner as jrunner
from tpu_icp_slam.slam.pipeline import OdometryPipeline as JaxOdometry
from tpu_icp_slam_torch.config import from_json as tfrom_json
from tpu_icp_slam_torch.datasets import kitti, tum
from tpu_icp_slam_torch.eval import trajectory_io as tio
from tpu_icp_slam_torch.slam import runner
from tpu_icp_slam_torch.slam.pipeline import OdometryPipeline

POSE_GAPS = (1e-4, 1e-4)  # m, rad per frame
ATE_GAP = 1e-4  # m


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Test files run in parallel worker processes: one torch thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(mode="scan_to_scan", backend=False):
    """test_fault_tolerance.py's 3D config (scan-to-map with the backend for
    full SLAM, without it for the odometry branch), scan-to-scan at its
    ICP settings."""
    return SlamConfig(
        icp=ICPConfig(method="point_to_point", max_iters=8, max_corr_dist=2.0,
                      nn_backend="xla"),
        mapping=MappingConfig(map_capacity=4096, local_model_size=1024,
                              map_voxel=0.5),
        pipeline=PipelineConfig(mode=mode, scan_capacity=512,
                                keyframe_trans=1.0, keyframe_rot=0.3,
                                downsample_voxel=0.6),
        backend=BackendConfig(enabled=backend, min_loop_separation=4,
                              candidate_topk=2),
    )


def _port(cfg):
    return tfrom_json(jto_json(cfg))


@pytest.fixture(scope="module")
def data():
    """test_fault_tolerance.py's 3D log. At ~2.4 m a frame it is a parity
    fixture, not an accuracy one (ATE ~7 m in both packages). At 0.15 of
    the route (ATE ~0.15 m) frame 1 of the scan-to-map branches lands
    3.9e-3 m apart in the two packages and the rest within 1.1e-6 m: the
    NN's near-ties in the reference's factored and the port's
    difference-form scores can take an 8-iteration ICP another way."""
    scans, gt = synthetic.velodyne_log(n_frames=10, n_rings=8, n_azimuth=128,
                                       path_fraction=0.3, seed=1)
    return scans, gt


def _assert_poses_close(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape and np.isfinite(a).all()
    gap = np.linalg.norm(a[:, :3, 3] - b[:, :3, 3], axis=1)
    assert gap.max() <= POSE_GAPS[0], gap
    assert _rot_gap(a, b).max() <= POSE_GAPS[1]


@pytest.mark.parametrize("mode", ["fused", "streaming"])
def test_odometry_pipeline_matches_reference(data, mode):
    scans, _ = data
    pts, msk = runner.pad_scans([voxel_downsample_np(s, 0.6) for s in scans],
                                512)
    cfg = _cfg()
    jp = JaxOdometry(cfg, dim=3)
    tp = OdometryPipeline(_port(cfg), dim=3, device="cpu")
    js, ts = jp.init_state(pts[0], msk[0]), tp.init_state(pts[0], msk[0])
    if mode == "fused":
        _, ji = jp.run_fused(js, pts[1:], msk[1:])
        _, ti = tp.run_fused(ts, pts[1:], msk[1:])
        jposes, tposes = np.asarray(ji["pose"]), ti["pose"].numpy()
        np.testing.assert_array_equal(ti["iters"].numpy(),
                                      np.asarray(ji["iters"]))
        np.testing.assert_array_equal(ti["n_inliers"].numpy(),
                                      np.asarray(ji["n_inliers"]))
    else:
        jposes, tposes = [], []
        for i in range(1, len(pts)):
            js, jinfo = jp.step(js, pts[i], msk[i])
            ts, tinfo = tp.step(ts, pts[i], msk[i])
            jposes.append(np.asarray(jinfo["pose"]))
            tposes.append(tinfo["pose"].numpy())
            assert int(tinfo["iters"]) == int(jinfo["iters"])
        assert int(ts.frame) == int(js.frame) == len(pts) - 1
        # the streaming steps are the fused run, bit for bit
        _, ti = tp.run_fused(tp.init_state(pts[0], msk[0]), pts[1:], msk[1:])
        assert torch.equal(ti["pose"], torch.as_tensor(np.stack(tposes)))
    _assert_poses_close(tposes, jposes)


def test_odometry_pipeline_refuses_2d():
    """2D scan-to-scan odometry is ported (tests/test_torch_2d.py): a 2D
    pipeline keeps an occupancy grid by default. What it still refuses:
    other dimensions, and a grid on 3D scans."""
    pipe2 = OdometryPipeline(_port(_cfg()), dim=2, device="cpu")
    st = pipe2.init_state(np.zeros((4, 2)), np.ones(4, bool))
    assert st.grid is not None and st.pose.shape == (3, 3)
    with pytest.raises(ValueError):
        OdometryPipeline(_port(_cfg()), dim=4, device="cpu")
    pipe = OdometryPipeline(_port(_cfg()), dim=3, device="cpu")
    assert pipe.init_state(np.zeros((4, 3)), np.ones(4, bool)).grid is None
    with pytest.raises(ValueError):
        pipe.init_state(np.zeros((4, 3)), np.ones(4, bool), with_grid=True)


def _png_size(path):
    """(width, height) of a PNG whose IDAT inflates to exactly one filter
    byte and 3 bytes a pixel per row (8-bit RGB); raises otherwise."""
    raw = open(path, "rb").read()
    assert raw[:8] == b"\x89PNG\r\n\x1a\n"
    pos, chunks = 8, {}
    while pos < len(raw):
        n, tag = struct.unpack(">I4s", raw[pos:pos + 8])
        body = raw[pos + 8:pos + 8 + n]
        crc = struct.unpack(">I", raw[pos + 8 + n:pos + 12 + n])[0]
        assert zlib.crc32(tag + body) & 0xFFFFFFFF == crc, tag
        chunks[tag] = chunks.get(tag, b"") + body
        pos += 12 + n
    w, h, depth, color = struct.unpack(">IIBB", chunks[b"IHDR"][:10])
    assert (depth, color) == (8, 2) and b"IEND" in chunks
    assert len(zlib.decompress(chunks[b"IDAT"])) == h * (1 + 3 * w)
    return w, h


@pytest.mark.parametrize("branch", ["slam3d", "scan_to_map", "odometry"])
def test_run_slam_branches_match_reference(tmp_path, data, branch):
    """run_slam's three 3D branches against the reference's run_slam: the
    same report keys, poses and ATE, and the artifacts (mirrors
    test_trajectory_io.py::test_runner_writes_standard_formats)."""
    scans, gt = data
    cfg = {"slam3d": _cfg("scan_to_map", backend=True),
           "scan_to_map": _cfg("scan_to_map"),
           "odometry": _cfg()}[branch]
    kw = {"save_map_path": str(tmp_path / "map.npz")} \
        if branch == "slam3d" else {}
    jposes, jrep = jrunner.run_slam(
        cfg, jrunner.LoadedDataset(scans=scans, gt_poses=gt, dim=3,
                                   name="t"), out_dir=None, mode="fused")
    out = tmp_path / "out"
    poses, rep = runner.run_slam(
        _port(cfg), runner.LoadedDataset(scans=scans, gt_poses=gt, dim=3,
                                         name="t"),
        out_dir=str(out), mode="fused", device="cpu", **kw)
    jkeys = set(jrep) | ({"map_png"} if branch != "odometry" else set()) \
        | ({"map_file"} if branch == "slam3d" else set())
    assert set(rep) == jkeys
    assert rep["mode"] == jrep["mode"] and rep["frames"] == jrep["frames"]
    assert rep["config_hash"] == jrep["config_hash"]
    _assert_poses_close(poses, jposes)
    assert abs(rep["ate_rmse"] - jrep["ate_rmse"]) <= ATE_GAP
    for k in ("n_keyframes", "n_loop_candidates", "n_loop_closures"):
        assert rep.get(k) == jrep.get(k), k
    # artifacts: standard-format trajectories, report, metrics, map render
    _, back = tio.read_tum(str(out / "trajectory_tum.txt"))
    np.testing.assert_allclose(back[:, :3, 3], poses[:, :3, 3], atol=1e-6)
    kb = tio.read_kitti(str(out / "trajectory_kitti.txt"))
    np.testing.assert_allclose(kb, poses, atol=1e-6)
    np.testing.assert_array_equal(np.load(out / "trajectory.npz")["poses"],
                                  poses)
    assert json.loads((out / "report.json").read_text())["frames"] == 10
    events = [json.loads(x)["event"]
              for x in (out / "metrics.jsonl").read_text().splitlines()]
    assert events[-1] == "done"
    if branch == "odometry":
        assert not (out / "map.png").exists()
    else:
        w, h = _png_size(out / "map.png")
        assert max(w, h) == 1024 and min(w, h) >= 1
    if branch == "slam3d":
        assert (tmp_path / "map.npz").exists()


def test_streaming_skips_nan_frame(tmp_path, data):
    """Mirrors test_fault_tolerance.py::test_streaming_skips_nan_frame on the
    3D scan-to-scan branch."""
    scans, _ = data
    scans = list(scans)
    scans[5] = np.full_like(scans[5], np.nan)
    d = runner.LoadedDataset(scans=scans, gt_poses=None, dim=3, name="faulty")
    cfg = _port(_cfg())
    poses, report = runner.run_slam(cfg, d, out_dir=str(tmp_path),
                                    mode="streaming", device="cpu")
    assert np.isfinite(poses).all(), "corrupt frame poisoned the trajectory"
    assert len(poses) == 10 and "ate_rmse" not in report
    np.testing.assert_allclose(poses[5], poses[4])
    logged = (tmp_path / "metrics.jsonl").read_text()
    assert "frame_skipped_degenerate" in logged or "frame_error" in logged
    assert not np.allclose(poses[6], poses[5]), "tracking did not resume"


def test_odometry_resume_from_checkpoint(tmp_path, data):
    """run_slam's streaming checkpoint of the odometry branch, then a
    resume, equal to the uninterrupted streaming run."""
    scans, gt = data
    cfg = _port(_cfg())
    full, _ = runner.run_slam(
        cfg, runner.LoadedDataset(scans, gt, 3, "t"), out_dir=None,
        mode="streaming", device="cpu")
    runner.run_slam(cfg, runner.LoadedDataset(scans[:7], gt[:7], 3, "t"),
                    out_dir=str(tmp_path), mode="streaming",
                    checkpoint_every=3, device="cpu")
    res, _ = runner.run_slam(cfg, runner.LoadedDataset(scans, gt, 3, "t"),
                             out_dir=str(tmp_path), mode="streaming",
                             resume=True, device="cpu")
    np.testing.assert_allclose(res, full, rtol=1e-5, atol=1e-6)
    assert "resume" in (tmp_path / "metrics.jsonl").read_text()


def test_load_dataset_reads_kitti_dir(tmp_path, data):
    scans, gt = data
    kitti.write_sequence(str(tmp_path / "00"), scans[:4], gt[:4])
    d = runner.load_dataset(str(tmp_path / "00"), 3)
    assert (d.dim, d.name, len(d.scans)) == (3, "00", 3)
    np.testing.assert_array_equal(d.scans[1], scans[1].astype(np.float32))
    np.testing.assert_allclose(d.gt_poses, gt[:3], atol=1e-9)
    sim = runner.load_dataset("sim3d", 4)
    ref = jrunner.load_dataset("sim3d", 4)
    for a, b in zip(sim.scans, ref.scans):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(sim.gt_poses, ref.gt_poses)
    with pytest.raises(ValueError):
        runner.load_dataset(str(tmp_path / "nothing"), 3)


@pytest.mark.parametrize("spec", ["sim2d", "sim2d_loop", "simrgbd",
                                  "simrgbd_fullres", "tum", "log.clf"])
def test_2d_and_rgbd_datasets_raise(tmp_path, spec):
    """No dataset spec is refused any more: the 2D ones (config 2) and the
    RGB-D ones (config 3: simrgbd, simrgbd_fullres, a TUM directory) load
    as the reference's do (tests/test_torch_state2d.py runs the 2D ones,
    tests/test_torch_rgbd.py and tests/test_torch_tum.py the RGB-D
    ones)."""
    if spec == "tum":
        depths, poses, _ = synthetic.rgbd_log(n_frames=3)
        tum.write_sequence(str(tmp_path), depths, gt_poses=poses)
        spec = str(tmp_path)
    if spec == "log.clf":
        from tpu_icp_slam.datasets import carmen

        log = synthetic.lidar2d_log(n_frames=4, n_beams=90, seed=0)
        spec = str(tmp_path / spec)
        carmen.write_clf(spec, log.ranges, np.zeros((4, 3)),
                         max_range=log.max_range)
    if spec.startswith("sim2d") or spec.endswith(".clf"):
        got, want = runner.load_dataset(spec, 4), jrunner.load_dataset(spec, 4)
        assert (got.dim, got.name) == (want.dim, want.name) == (
            2, os.path.basename(spec))
        for a, b in zip(got.scans, want.scans):
            np.testing.assert_array_equal(a, b)
        return
    got, want = runner.load_dataset(spec, 3), jrunner.load_dataset(spec, 3)
    assert (got.kind, got.dim, got.name, got.scans, got.intrinsics) == (
        want.kind, want.dim, want.name, want.scans, want.intrinsics)
    assert got.kind == "rgbd" and got.depths.shape[0] == 3
    np.testing.assert_array_equal(got.depths, want.depths)
    np.testing.assert_array_equal(got.gt_poses, want.gt_poses)
