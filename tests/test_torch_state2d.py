"""Config 2's state and I/O in the torch port against the reference's: 2D
checkpoints (the odometry state with its occupancy grid, the Slam2D
session) and 2D maps crossing both ways, a Slam2D resume against the
uninterrupted run, the CARMEN reader and writer, `load_dataset` on a `.clf`
file, `cli run`/`cli eval` on `sim2d` (the default dataset again), and
Slam2D's z = 0 lift onto the scan-to-map pipeline. The reference runs as
its tests run it (CPU, nn_backend="xla").

Tolerances: a checkpoint or map stores arrays as they are, so what crosses
is bit for bit (after the dtype the state needs: float32, bool, int32); a
resume equals the uninterrupted run bit for bit (the same steps on the
same state); files written by both packages' `write_clf` are byte-equal;
the two packages' localized poses within 1e-3 m with the same keyframe
(test_torch_backend.py's relocalize tolerance); `cli eval`'s golden ATE
bit for bit and its run's ATE within 1e-4 m (measured 2.2e-5 m on 8
frames of sim2d at 2.9 m a frame).

The lift (the first 16 frames of test_slam2d_backend.py's 60-frame loop):
frames 1-6 within 1e-5 m; at frame 7 one NN decision at a near-tie (13 ICP
iterations against the reference's 17) moves the pose by 1.2e-2 m, and the
map-based chain carries it, so all 16 frames are held within 3e-2 m and
to ground truth within 0.25 m (the reference test's bound). The same
frame-7 ICP with the reference's factored NN scores injected lands 1.1e-5
m from the reference's.
"""

import json

import numpy as np
import pytest
import torch

from test_torch_slam2d import _rot, backend_cfg, out_and_back
from tpu_icp_slam import cli as jcli
from tpu_icp_slam.backend.loop_closure import LoopDetector as JDetector
from tpu_icp_slam.config import BackendConfig as JBackendConfig
from tpu_icp_slam.config import (
    ICPConfig,
    MappingConfig,
    PipelineConfig,
    SlamConfig,
    override,
    to_json,
)
from tpu_icp_slam.datasets import carmen as jcarmen
from tpu_icp_slam.datasets import synthetic as jsyn
from tpu_icp_slam.slam import checkpoint as jck
from tpu_icp_slam.slam import map_io as jmap_io
from tpu_icp_slam.slam import runner as jrunner
from tpu_icp_slam.slam.pipeline import OdometryPipeline as JOdometry
from tpu_icp_slam.slam.slam2d import Slam2D as JaxSlam2D
from tpu_icp_slam_torch import cli
from tpu_icp_slam_torch.config import BackendConfig, from_json
from tpu_icp_slam_torch.datasets import carmen
from tpu_icp_slam_torch.slam import checkpoint as tck
from tpu_icp_slam_torch.slam import map_io, runner
from tpu_icp_slam_torch.slam.pipeline import OdometryPipeline
from tpu_icp_slam_torch.slam.slam2d import Slam2D


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread a worker: the suite runs files in parallel."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port(cfg):
    return from_json(to_json(cfg))


def _cfg2d():
    """tests/test_pipeline_2d.py::_cfg2d."""
    return override(SlamConfig(), {
        "icp.max_corr_dist": 0.5, "icp.max_iters": 30,
        "icp.nn_backend": "xla", "pipeline.scan_capacity": 512,
        "mapping.grid_size": 256, "mapping.grid_resolution": 0.1,
        "mapping.ray_samples": 64})


def _jax_leaves(state):
    import jax

    return [np.asarray(v) for v in jax.tree_util.tree_leaves(state)]


def _assert_leaves_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        np.testing.assert_array_equal(a, b.astype(a.dtype))


@pytest.fixture(scope="module")
def sim2d():
    pts, msk = runner.pad_scans(runner.load_dataset("sim2d", 6).scans, 512)
    return pts, msk


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_odometry_2d_checkpoint_crosses_packages(tmp_path, sim2d, writer):
    """The 2D odometry state, grid and all (8 leaves), written by either
    package loads in the other; the next step from the loaded state equals
    the next step from the live one."""
    pts, msk = sim2d
    cfg = _cfg2d()
    ck = str(tmp_path / "ck.npz")
    if writer == "port":
        pipe = OdometryPipeline(_port(cfg), dim=2, device="cpu")
        st = pipe.init_state(pts[0], msk[0])
        for i in (1, 2):
            st, info = pipe.step(st, pts[i], msk[i])
        tck.save_checkpoint(ck, st, 3, [np.eye(3)] * 3, cfg=_port(cfg))
        st2, nxt, _ = jck.load_checkpoint(ck, cfg)
        _assert_leaves_equal(tck._flatten(st), _jax_leaves(st2))
        assert st2.grid is not None and nxt == 3
        back = str(tmp_path / "back.npz")
        tck.save_checkpoint(back, tck.load_checkpoint(ck, None, "cpu")[0], 3,
                            [np.eye(3)] * 3)
        a, _ = pipe.step(st, pts[3], msk[3])
        b, _ = pipe.step(tck.load_checkpoint(back, None, "cpu")[0], pts[3],
                         msk[3])
        _assert_leaves_equal(tck._flatten(b), tck._flatten(a))
    else:
        pipe = JOdometry(cfg, dim=2)
        st = pipe.init_state(pts[0], msk[0])
        for i in (1, 2):
            st, info = pipe.step(st, pts[i], msk[i])
        jck.save_checkpoint(ck, st, 3, [np.eye(3)] * 3, cfg=cfg)
        st2, nxt, _ = tck.load_checkpoint(ck, _port(cfg), device="cpu")
        assert st2.grid is not None and st2.pose.shape == (3, 3)
        _assert_leaves_equal(tck._flatten(st2), _jax_leaves(st))
        assert [leaf.dtype for leaf in tck._flatten(st2)] == [
            np.float32, np.float32, np.float32, np.bool_, np.float32,
            np.float32, np.float32, np.int32]


def test_odometry_2d_without_grid_has_five_leaves(tmp_path, sim2d):
    pts, msk = sim2d
    st = OdometryPipeline(_port(_cfg2d()), dim=2, device="cpu").init_state(
        pts[0], msk[0], with_grid=False)
    ck = str(tmp_path / "ck.npz")
    tck.save_checkpoint(ck, st, 1, [np.eye(3)])
    assert int(np.load(ck)["n_leaves"]) == 5
    assert jck.load_checkpoint(ck, None)[0].grid is None
    assert tck.load_checkpoint(ck, None, device="cpu")[0].grid is None


@pytest.fixture(scope="module")
def corridor():
    return out_and_back(16)


def test_slam2d_resume_equals_uninterrupted(tmp_path, corridor):
    """A streaming Slam2D checkpointing every 6 frames, cut at frame 15,
    then resumed by a fresh Slam2D from frame 13: the same poses, keyframes
    and closures as the uninterrupted run, bit for bit."""
    pts, msk, rng = corridor
    cfg = _port(backend_cfg())
    full = Slam2D(cfg, sensor_max_range=rng, device="cpu")
    want, wrep = full.run(pts, msk, mode="streaming")
    ck = str(tmp_path / "slam2d.npz")
    Slam2D(cfg, sensor_max_range=rng, device="cpu").run(
        pts[:16], msk[:16], checkpoint_path=ck, checkpoint_every=6)
    data = np.load(ck)
    assert str(data["fe_kind"]) == "odom" and int(data["next_frame"]) == 13
    again = Slam2D(cfg, sensor_max_range=rng, device="cpu")
    got, grep = again.run(pts, msk, checkpoint_path=ck, resume=True)
    np.testing.assert_array_equal(got, want)
    assert again.kf_frames == full.kf_frames
    assert [(c.i, c.j) for c in again.closures] == [
        (c.i, c.j) for c in full.closures]
    assert grep.n_loop_closures == wrep.n_loop_closures >= 1
    # the reference reads the port's Slam2D session
    ref = jck.load_slam_checkpoint(ck)
    assert ref["next_frame"] == 13 and ref["kf_poses"][0].shape == (3, 3)
    _assert_leaves_equal(tck._flatten(
        tck.load_slam_checkpoint(ck, device="cpu")["fe_state"]),
        _jax_leaves(ref["fe_state"]))


def test_reference_slam2d_session_loads_in_port(tmp_path, corridor):
    pts, msk, rng = corridor
    ck = str(tmp_path / "ref.npz")
    JaxSlam2D(backend_cfg(), sensor_max_range=rng).run(
        pts[:9], msk[:9], checkpoint_path=ck, checkpoint_every=4)
    ref = jck.load_slam_checkpoint(ck)
    got = tck.load_slam_checkpoint(ck, device="cpu")
    assert got["next_frame"] == ref["next_frame"] == 9
    assert got["kf_frames"] == ref["kf_frames"]
    np.testing.assert_array_equal(np.stack(got["poses"]),
                                  np.stack(ref["poses"]))
    _assert_leaves_equal(tck._flatten(got["fe_state"]),
                         _jax_leaves(ref["fe_state"]))
    assert got["fe_state"].grid is None


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_2d_map_crosses_packages(tmp_path, corridor, writer):
    """A 2D map (3×3 keyframe poses, 2D scans, occupancy descriptors at the
    sensor's 12 m range) written by either package localizes a frame in
    both, to the same keyframe and within 1e-3 m."""
    pts, msk, rng = corridor
    path = str(tmp_path / "map2d.npz")
    kw = dict(verify_max_rmse=0.25, descriptor_rings=12,
              descriptor_sectors=48, verify_yaws=4)
    kf = list(range(0, 16, 2))
    log = jsyn.lidar2d_log(n_frames=16, n_beams=360, seed=0, noise=0.01)
    poses = np.einsum("ij,fjk->fik", np.linalg.inv(log.gt_poses[0]),
                      log.gt_poses[kf])
    if writer == "port":
        det = map_io.LoopDetector(BackendConfig(**kw), max_range=rng,
                                  device="cpu")
        for f, p in zip(kf, poses):
            det.add_keyframe(pts[f], msk[f], position=p[:2, 2])
        map_io.save_map(path, [(pts[f], msk[f]) for f in kf], poses,
                        detector=det)
    else:
        det = JDetector(JBackendConfig(**kw), max_range=rng)
        for f, p in zip(kf, poses):
            det.add_keyframe(pts[f], msk[f], position=p[:2, 2])
        jmap_io.save_map(path, [(pts[f], msk[f]) for f in kf], poses,
                         detector=det)
    saved = map_io.load_map(path, BackendConfig(**kw), device="cpu")
    jsaved = jmap_io.load_map(path, JBackendConfig(**kw))
    assert saved.detector.max_range == rng and saved.kf_poses.shape[1:] == (
        3, 3)
    for a, b in zip(saved.detector._descs, jsaved.detector._descs):
        np.testing.assert_array_equal(a, b)
    got = map_io.localize_in_map(saved, pts[5], msk[5])
    want = jmap_io.localize_in_map(jsaved, pts[5], msk[5])
    assert got is not None and want is not None
    # (the corridor's door columns repeat: both packages may lock onto an
    # aliased keyframe, and must lock onto the same one)
    assert got[1] == want[1] and got[0].shape == (3, 3)
    assert np.linalg.norm(got[0][:2, 2] - want[0][:2, 2]) < 1e-3


def test_carmen_round_trip_and_clf_dataset(tmp_path):
    """test_pipeline_2d.py::test_carmen_roundtrip / test_run_clf_file: the
    port's writer and reader against the reference's, and a .clf file
    through load_dataset and run_slam."""
    log = jsyn.lidar2d_log(n_frames=8, n_beams=360, seed=0, noise=0.002)
    xyt = np.stack([log.gt_poses[:, 0, 2], log.gt_poses[:, 1, 2],
                    np.arctan2(log.gt_poses[:, 1, 0], log.gt_poses[:, 0, 0])],
                   axis=1)
    a, b = str(tmp_path / "port.clf"), str(tmp_path / "ref.clf")
    carmen.write_clf(a, log.ranges, xyt, max_range=log.max_range)
    jcarmen.write_clf(b, log.ranges, xyt, max_range=log.max_range)
    assert open(a, "rb").read() == open(b, "rb").read()
    parsed, want = carmen.load_clf(a), jcarmen.load_clf(a)
    for k in ("ranges", "angles", "odometry", "timestamps"):
        np.testing.assert_array_equal(getattr(parsed, k), getattr(want, k))
    assert (parsed.max_range, parsed.fov) == (want.max_range, want.fov)
    np.testing.assert_allclose(parsed.ranges, log.ranges, atol=1e-3)
    data = runner.load_dataset(a, frames=8)
    ref = jrunner.load_dataset(a, frames=8)
    assert (data.dim, data.name, data.gt_poses) == (2, "port.clf", None)
    for x, y in zip(data.scans, ref.scans):
        np.testing.assert_array_equal(x, y)
    poses, rep = runner.run_slam(_port(_cfg2d()), data, mode="fused",
                                 device="cpu")
    assert poses.shape == (8, 3, 3) and np.isfinite(poses).all()
    assert "ate_rmse" not in rep


def test_synthetic_2d_logs_are_the_reference_bit_for_bit():
    from tpu_icp_slam_torch.datasets import synthetic

    for loop in (False, True):
        a = synthetic.lidar2d_log(n_frames=7, n_beams=90, seed=3, loop=loop)
        b = jsyn.lidar2d_log(n_frames=7, n_beams=90, seed=3, loop=loop)
        for k in ("ranges", "angles", "gt_poses"):
            np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
        np.testing.assert_array_equal(
            synthetic.scan_to_points(a.ranges[2], a.angles, a.max_range),
            jsyn.scan_to_points(b.ranges[2], b.angles, b.max_range))


def test_cli_run_and_eval_default_to_sim2d(tmp_path, capsys):
    """`cli run` and `cli eval` default to the reference's `--dataset sim2d`
    (SlamConfig()'s scan-to-scan pipeline with its occupancy grid)."""
    args = ["--frames", "8", "pipeline.scan_capacity=512",
            "icp.max_iters=20"]
    out = str(tmp_path / "run")
    assert cli.main(["run", "--out", out, "--device", "cpu", *args]) == 0
    rep = json.loads(capsys.readouterr().out)
    assert rep["dataset"] == "sim2d" and rep["mode"] == "fused"
    assert np.load(out + "/trajectory.npz")["poses"].shape == (8, 3, 3)
    assert open(out + "/map.png", "rb").read(4) == b"\x89PNG"
    assert jcli.main(["eval", *args, "icp.nn_backend=xla"]) == 0
    want = json.loads(capsys.readouterr().out)
    assert cli.main(["eval", "--device", "cpu", *args]) == 0
    got = json.loads(capsys.readouterr().out)
    assert set(got) == set(want) and got["dataset"] == "sim2d"
    assert got["golden_ate"] == want["golden_ate"]
    assert abs(got["tpu_ate"] - want["tpu_ate"]) <= 1e-4
    assert abs(got["tpu_vs_golden_ate"] - want["tpu_vs_golden_ate"]) <= 1e-4


def lifted_cfg():
    """test_slam2d_scan_to_map_mode_tracks_tightly's config."""
    return SlamConfig(
        icp=ICPConfig(method="point_to_point", max_iters=25,
                      max_corr_dist=0.7, nn_backend="xla", damping=1e-3,
                      max_step_trans=0.5, max_step_rot=0.3, min_inliers=50,
                      huber_delta=0.3, step_scale=1.4, tol_update=0.002),
        mapping=MappingConfig(map_capacity=16384, local_model_size=2048,
                              map_voxel=0.08),
        pipeline=PipelineConfig(mode="scan_to_map", scan_capacity=512,
                                keyframe_trans=0.8, keyframe_rot=0.2),
        backend=JBackendConfig(enabled=False),
    )


def test_slam2d_scan_to_map_lift_matches_reference():
    # the first 16 frames of the reference test's 60-frame loop
    log = jsyn.lidar2d_log(n_frames=60, n_beams=360, seed=0,
                                noise=0.005, loop=True)
    scans = [jsyn.scan_to_points(log.ranges[i], log.angles,
                                      log.max_range) for i in range(16)]
    pts, msk = runner.pad_scans(scans, 512)
    jp, _ = JaxSlam2D(lifted_cfg(), sensor_max_range=log.max_range).run(
        pts, msk)
    ts = Slam2D(_port(lifted_cfg()), sensor_max_range=log.max_range,
                device="cpu")
    tp, rep = ts.run(pts, msk)
    assert tp.shape == (16, 3, 3) and rep.n_loop_closures == 0
    np.testing.assert_allclose(tp[:7, :2, 2], jp[:7, :2, 2], atol=1e-5)
    np.testing.assert_allclose(_rot(tp[:7]), _rot(jp[:7]), atol=1e-5)
    np.testing.assert_allclose(tp[:, :2, 2], jp[:, :2, 2], atol=3e-2)
    np.testing.assert_allclose(_rot(tp), _rot(jp), atol=1e-2)
    gt = np.einsum("ij,fjk->fik", np.linalg.inv(log.gt_poses[0]),
                   log.gt_poses)
    assert np.abs(tp[:, :2, 2] - gt[:16, :2, 2]).max() < 0.25
    sp, _ = Slam2D(_port(lifted_cfg()),
                   sensor_max_range=log.max_range, device="cpu").run(
        pts, msk, mode="streaming")
    np.testing.assert_array_equal(sp, tp)


def test_run_slam_2d_branch_writes_the_map_and_artifacts(tmp_path, corridor):
    """run_slam's Slam2D branch (a 2D log with the backend on): the report's
    keys, the occupancy map.png rebuilt from the corrected poses, the
    slam2d_run event, and a 2D map (3×3 poses, the 12 m descriptor
    geometry) that the reference loads."""
    pts, msk, rng = corridor
    scans = [p[m] for p, m in zip(pts, msk)]
    data = runner.LoadedDataset(scans=scans, gt_poses=None, dim=2,
                                name="corridor")
    out, path = str(tmp_path / "run"), str(tmp_path / "map.npz")
    poses, rep = runner.run_slam(_port(backend_cfg()), data, out_dir=out,
                                 save_map_path=path, device="cpu")
    assert poses.shape == (len(pts), 3, 3) and rep["mode"] == "slam2d"
    assert rep["n_loop_closures"] >= 1 and rep["map_file"] == path
    assert open(out + "/map.png", "rb").read(4) == b"\x89PNG"
    events = [json.loads(line) for line in open(out + "/metrics.jsonl")]
    run = next(e for e in events if e["event"] == "slam2d_run")
    assert run["icp_iters"] > 0 and run["verify_iters"] > 0
    saved = jmap_io.load_map(path, JBackendConfig())
    assert saved.kf_poses.shape[1:] == (3, 3)
    assert saved.detector.max_range == rng
    assert saved.detector.cfg.descriptor_sectors == 48
