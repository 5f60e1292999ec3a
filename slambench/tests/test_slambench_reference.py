"""The plain reference on tiny logs, on the CPU, against the port's eager
path: run free it reproduces the front end bit for bit; following the
port's own poses every gap is 0; full SLAM's closures and poses agree.
And the copied generator gives the port's scans."""

import json

import numpy as np
import pytest
import torch

from conftest import small_config
from slambench import check, gen, harness
from slambench.reference import odometry, slam

GROUPS = harness.GROUPS


def _port_config(cfg):
    return harness.slam_config(cfg)


def _log(seed=3, out_and_back=True):
    scans, gt = gen.velodyne_log(n_frames=8, n_rings=10, n_azimuth=192,
                                 path_fraction=0.1, seed=seed)
    scans = [gen.voxel_downsample_np(s, 0.5) for s in scans]
    if out_and_back:
        scans = scans + scans[::-1][1:]
    return gen.pad_scans(scans, 768)


@pytest.fixture(scope="module")
def odom_cfg():
    cfg = small_config(harness.config("kitti-odom"))
    cfg["pipeline"]["keyframe_trans"] = 1.6
    return cfg


def test_generator_is_the_ports():
    from tpu_icp_slam_torch.core.pointcloud import voxel_downsample_np
    from tpu_icp_slam_torch.datasets import synthetic
    from tpu_icp_slam_torch.slam.runner import pad_scans

    for kw in ({"n_frames": 3, "n_rings": 6, "n_azimuth": 64,
                "seed": 2**31 + 9},
               {"n_frames": 4, "n_rings": 5, "n_azimuth": 48, "seed": 4,
                "waypoints": gen.LOOP_WAYPOINTS}):
        a, ga = gen.velodyne_log(**kw)
        b, gb = synthetic.velodyne_log(**kw)
        assert np.array_equal(ga, gb)
        assert all(np.array_equal(x, y) for x, y in zip(a, b))
        da = [gen.voxel_downsample_np(s, 0.3) for s in a]
        db = [voxel_downsample_np(s, 0.3) for s in b]
        assert all(np.array_equal(x, y) for x, y in zip(da, db))
        for p, q in zip(gen.pad_scans(da, 200), pad_scans(db, 200)):
            assert np.array_equal(p, q)


def test_world_seed_fixes_the_streets_and_not_the_noise():
    a, _ = gen.velodyne_log(n_frames=2, n_rings=4, n_azimuth=64, seed=1,
                            world_seed=0)
    b, _ = gen.velodyne_log(n_frames=2, n_rings=4, n_azimuth=64, seed=2,
                            world_seed=0)
    c, _ = gen.velodyne_log(n_frames=2, n_rings=4, n_azimuth=64, seed=1,
                            world_seed=5)
    assert len(a[0]) == len(b[0]) and not np.array_equal(a[0], b[0])
    assert np.abs(a[0] - b[0]).max() < 0.1  # range noise of 1 cm
    assert len(a[0]) != len(c[0]) or not np.allclose(a[0], c[0], atol=0.1)
    s1 = gen.sequences({"route": "straight", "worlds": [0, 1], "frames": 2,
                        "rings": 4, "azimuth": 64, "path_fraction": 0.1},
                       0.3, 512, 2**31 + 77)
    s2 = gen.sequences({"route": "straight", "worlds": [0, 1], "frames": 2,
                        "rings": 4, "azimuth": 64, "path_fraction": 0.1},
                       0.3, 512, 2**31 + 77)
    assert len(s1) == 2
    assert all(np.array_equal(x[0], y[0]) for x, y in zip(s1, s2))


# the test process has torch's threads; run.py forks before torch loads
@pytest.mark.filterwarnings("ignore:This process .* is multi-threaded")
def test_prefetch_makes_the_same_sequences_and_ends_its_workers():
    import multiprocessing

    mix = {"route": "loop", "worlds": [0, 1, 2], "frames": 2, "rings": 4,
           "azimuth": 64, "path_fraction": 1.0}
    want = gen.sequences(mix, 0.3, 512, 2**31 + 78)
    got = gen.Prefetch(mix, 0.3, 512, 2**31 + 78).result()
    assert len(got) == 3
    for a, b in zip(want, got):
        assert all(np.array_equal(x, y) for x, y in zip(a, b))
    unused = gen.Prefetch(mix, 0.3, 512, 5)
    unused.close()
    assert multiprocessing.active_children() == []


def test_odometry_reference_reproduces_the_port(odom_cfg):
    from tpu_icp_slam_torch.slam.scan_to_map import ScanToMapPipeline

    pts, msk = _log()
    pipe = ScanToMapPipeline(_port_config(odom_cfg), device="cpu")
    _, infos = pipe.run_fused(pipe.init_state(pts[0], msk[0]), pts[1:],
                              msk[1:])
    ref = odometry.run(odom_cfg, pts, msk, "cpu")
    assert np.array_equal(infos["pose"].numpy(), ref["pose"])
    assert np.array_equal(infos["iters"].numpy(), ref["iters"])
    assert np.array_equal(infos["map_inserted"].numpy(), ref["map_inserted"])
    assert np.array_equal(infos["map_points"].numpy(), ref["map_points"])
    # following the port's own poses, every frame's gap is 0
    forced = odometry.run(odom_cfg, pts, msk, "cpu", forced=(
        infos["pose"].numpy(), infos["is_keyframe"].numpy(),
        infos["map_inserted"].numpy()))
    assert np.array_equal(forced["pose"], ref["pose"])
    rec = {"poses": infos["pose"].numpy(), "rmse": infos["rmse"].numpy()}
    rec.update(is_keyframe=infos["is_keyframe"].numpy(),
               map_inserted=infos["map_inserted"].numpy())
    got = check.numbers(rec, dict(forced, frame_poses=forced["pose"]))
    assert got["frame_gap_max_m"] == 0.0 and got["rmse_gap_max"] == 0.0
    assert got["decisions_differ"] == 0.0


def test_forced_reference_starts_each_frame_from_the_given_poses(odom_cfg):
    pts, msk = _log(out_and_back=False)
    free = odometry.run(odom_cfg, pts, msk, "cpu")
    shifted = free["pose"].copy()
    shifted[3, 0, 3] += 0.05  # frame 4's pose 5 cm off
    forced = odometry.run(odom_cfg, pts, msk, "cpu", forced=(
        shifted, free["is_keyframe"], free["map_inserted"]))
    assert np.array_equal(forced["pose"][:4], free["pose"][:4])
    gaps = np.linalg.norm(forced["pose"][:, :3, 3] - shifted[:, :3, 3], axis=1)
    assert gaps[3] == pytest.approx(0.05, abs=1e-6)
    # frame 5 starts from the shifted pose: its own ICP pulls it back
    assert not np.array_equal(forced["pose"][4], free["pose"][4])


def test_slam_reference_agrees_with_the_port():
    from tpu_icp_slam_torch.slam.slam3d import Slam3D

    cfg = small_config(harness.config("kitti-slam"))
    cfg["pipeline"]["keyframe_trans"] = 1.6
    cfg["backend"].update(verify_max_rmse=0.6)
    pts, msk = _log()
    s3 = Slam3D(_port_config(cfg), device="cpu")
    poses, _ = s3.run(pts, msk, mode="fused")
    assert len(s3.closures_kept) >= 2
    free = slam.run(cfg, pts, msk, "cpu")
    assert sorted((c.i, c.j) for c in s3.closures_kept) == free["closures"]
    assert s3.detector.verify_iters == free["verify_iters"]
    assert np.abs(poses[:, :3, 3] - free["poses"][:, :3, 3]).max() < 1e-5
    kf = np.zeros(len(pts) - 1, bool)
    kf[[f - 1 for f in s3.kf_frames[1:]]] = True
    forced = slam.run(cfg, pts, msk, "cpu", forced=(
        s3.frontend_poses, kf, free["map_inserted"]),
        kf_frames=s3.kf_frames)
    assert forced["own_kf_frames"] == s3.kf_frames
    assert forced["closures"] == free["closures"]
    assert np.abs(poses[:, :3, 3] - forced["poses"][:, :3, 3]).max() < 1e-5


def test_reference_refuses_options_it_does_not_implement(odom_cfg):
    cfg = json.loads(json.dumps(odom_cfg))
    cfg["icp"]["anderson"] = True
    pts, msk = _log()
    with pytest.raises(ValueError):
        odometry.run(cfg, pts[:2], msk[:2], "cpu")


def test_tf32_rounds_operands_to_ten_mantissa_bits():
    from slambench.reference.nn import Arith, _to_tf32

    x = torch.tensor([1.0 + 2.0 ** -10, 1.0 + 2.0 ** -11, 1.0 + 2.0 ** -12,
                      3600.7, -1.0 - 2.0 ** -12])
    assert _to_tf32(x).tolist() == [1.0 + 2.0 ** -10, 1.0 + 2.0 ** -10, 1.0,
                                    3600.0, -1.0]
    a = torch.tensor([[1.0 + 2.0 ** -12]])
    assert Arith("float32").mm(a, a).item() != 1.0
    assert Arith("tf32").mm(a, a).item() == 1.0
