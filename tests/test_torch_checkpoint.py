"""The port's checkpoint/resume (slam/checkpoint.py, Slam3D.run's
checkpoint_path / checkpoint_every / resume) against the reference's, on the
reference's own fixtures (tests/test_fault_tolerance.py,
tests/test_endurance_mechanics.py), the reference run as its tests run it
(CPU, nn_backend="xla").

Tolerances: a checkpoint stores the state's arrays as they are, so a
round trip is bit for bit and the next step from a loaded state equals the
next step from the live one bit for bit; leaves crossing packages are equal
after the dtype the state needs (float32, bool, int32). A resumed run equals
the uninterrupted one within the reference's resume tolerance (rtol 1e-5,
atol 1e-6); the port's resumed poses equal the reference's resumed poses
within test_torch_slam3d.py's 1e-4 m / 1e-4 rad.
"""

import dataclasses
import functools
import os

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
from tpu_icp_slam.slam import checkpoint as jck
from tpu_icp_slam.slam.pipeline import OdometryPipeline as JaxOdometry
from tpu_icp_slam.slam.runner import pad_scans
from tpu_icp_slam.slam.scan_to_map import ScanToMapPipeline as JaxPipeline
from tpu_icp_slam.slam.slam3d import Slam3D as JaxSlam3D
from tpu_icp_slam_torch.backend.loop_closure import LoopClosure
from tpu_icp_slam_torch.config import from_json as tfrom_json
from tpu_icp_slam_torch.slam import checkpoint as tck
from tpu_icp_slam_torch.slam.pipeline import OdometryPipeline, OdomState
from tpu_icp_slam_torch.slam.scan_to_map import ScanToMapPipeline
from tpu_icp_slam_torch.slam.slam3d import Slam3D

POSE_GAPS = (1e-4, 1e-4)  # m, rad: test_torch_slam3d.py's


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Test files run in parallel worker processes: one torch thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(mode="scan_to_map", backend=True):
    """test_fault_tolerance.py's 3D config."""
    return SlamConfig(
        icp=ICPConfig(method="point_to_point", max_iters=8, max_corr_dist=2.0,
                      nn_backend="xla"),
        mapping=MappingConfig(map_capacity=4096, local_model_size=1024,
                              map_voxel=0.5),
        pipeline=PipelineConfig(mode=mode, scan_capacity=512,
                                keyframe_trans=1.0, keyframe_rot=0.3),
        backend=BackendConfig(enabled=backend, min_loop_separation=4,
                              candidate_topk=2),
    )


def _port(cfg):
    return tfrom_json(jto_json(cfg))


@pytest.fixture(scope="module")
def log10():
    scans, _ = synthetic.velodyne_log(n_frames=10, n_rings=8, n_azimuth=128,
                                      path_fraction=0.3, seed=1)
    return pad_scans([voxel_downsample_np(s, 0.6) for s in scans], 512)


def _leaves_np(state):
    """A state's leaves in flatten order, as numpy."""
    return tck._flatten(state)


def _jax_leaves(state):
    import jax

    return [np.asarray(v) for v in jax.tree_util.tree_leaves(state)]


def _assert_leaves_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b.astype(a.dtype))


def test_checkpoint_round_trip_next_step_equal(tmp_path, log10):
    """Mirrors test_fault_tolerance.py::test_checkpoint_resume_scan_to_map."""
    pts, msk = log10
    pipe = ScanToMapPipeline(_port(_cfg(backend=False)), device="cpu")
    st = pipe.init_state(pts[0], msk[0])
    hist = [np.eye(4)]
    for i in range(1, 3):
        st, info = pipe.step(st, pts[i], msk[i])
        hist.append(info["pose"].numpy())
    ck = str(tmp_path / "ck.npz")
    tck.save_checkpoint(ck, st, 3, hist, cfg=pipe.cfg)
    st2, nxt, hist2 = tck.load_checkpoint(ck, pipe.cfg, device="cpu")
    assert nxt == 3 and len(hist2) == 3
    assert len(_leaves_np(st2)) == 14
    for a, b in zip(_leaves_np(st2), _leaves_np(st)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    _, info_a = pipe.step(st, pts[3], msk[3])
    _, info_b = pipe.step(st2, pts[3], msk[3])
    for k in info_a:
        assert torch.equal(torch.as_tensor(info_a[k]),
                           torch.as_tensor(info_b[k])), k


def _reference_state(kind, pts, msk):
    # the scan-to-map step is compiled once for this config (Slam3D's)
    cfg = _cfg() if kind == "scan_to_map" else _cfg("scan_to_scan")
    if kind == "scan_to_map":
        pipe = JaxPipeline(cfg)
    else:
        pipe = JaxOdometry(cfg, dim=3)
    st = pipe.init_state(pts[0], msk[0])
    hist = [np.eye(4)]
    for i in range(1, 3):
        st, info = pipe.step(st, pts[i], msk[i])
        hist.append(np.asarray(info["pose"], np.float64))
    return cfg, st, hist


def _port_state(kind, pts, msk):
    cfg = _port(_cfg() if kind == "scan_to_map" else _cfg("scan_to_scan"))
    if kind == "scan_to_map":
        pipe = ScanToMapPipeline(cfg, device="cpu")
    else:
        pipe = OdometryPipeline(cfg, dim=3, device="cpu")
    st = pipe.init_state(pts[0], msk[0])
    hist = [np.eye(4)]
    for i in range(1, 3):
        st, info = pipe.step(st, pts[i], msk[i])
        hist.append(info["pose"].numpy().astype(np.float64))
    return cfg, st, hist


@pytest.mark.parametrize("kind", ["scan_to_map", "odom"])
def test_reference_checkpoint_loads_in_port(tmp_path, log10, kind):
    pts, msk = log10
    cfg, st, hist = _reference_state(kind, pts, msk)
    ck = str(tmp_path / "ref.npz")
    jck.save_checkpoint(ck, st, 3, hist, cfg=cfg)
    st2, nxt, hist2 = tck.load_checkpoint(ck, _port(cfg), device="cpu")
    assert isinstance(st2, OdomState) == (kind == "odom")
    assert nxt == 3
    np.testing.assert_array_equal(np.stack(hist2), np.stack(hist))
    _assert_leaves_equal(_leaves_np(st2), _jax_leaves(st))
    for leaf in _leaves_np(st2):
        assert leaf.dtype in (np.float32, np.bool_, np.int32), leaf.dtype


@pytest.mark.parametrize("kind", ["scan_to_map", "odom"])
def test_port_checkpoint_loads_in_reference(tmp_path, log10, kind):
    pts, msk = log10
    cfg, st, hist = _port_state(kind, pts, msk)
    ck = str(tmp_path / "port.npz")
    tck.save_checkpoint(ck, st, 3, hist, cfg=cfg)
    st2, nxt, hist2 = jck.load_checkpoint(ck, None)
    assert type(st2).__name__ == ("MapOdomState" if kind == "scan_to_map"
                                  else "OdomState")
    assert nxt == 3
    np.testing.assert_array_equal(np.stack(hist2), np.stack(hist))
    _assert_leaves_equal(_leaves_np(st), _jax_leaves(st2))


def _closures():
    rng = np.random.default_rng(2)
    return [LoopClosure(i=0, j=5, T_ij=synthetic.rigid_transform(3, rng),
                        rmse=0.12, n_inliers=321),
            LoopClosure(i=1, j=6, T_ij=synthetic.rigid_transform(3, rng),
                        rmse=0.2, n_inliers=77)]


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_slam_checkpoint_crosses_packages(tmp_path, log10, writer):
    """A full-SLAM record (front end, keyframe database, closures, strain)
    written by either package loads in the other with the same contents."""
    pts, msk = log10
    if writer == "port":
        _, st, hist = _port_state("scan_to_map", pts, msk)
        save, load = tck.save_slam_checkpoint, jck.load_slam_checkpoint
    else:
        _, st, hist = _reference_state("scan_to_map", pts, msk)
        save = jck.save_slam_checkpoint
        load = functools.partial(tck.load_slam_checkpoint, device="cpu")
    rng = np.random.default_rng(3)
    descs = [rng.uniform(0, 3, (20, 60)).astype(np.float32) for _ in range(3)]
    positions = [np.zeros(3), None, np.array([1.0, 2.0, 0.5])]
    closures = _closures()
    strain = [False, True, False]
    ck = str(tmp_path / "slam.npz")
    save(ck, "scan_to_map", st, 3, hist, [0, 1, 2], hist, [0, 1, 2], descs,
         positions, closures, 9, strain=strain)
    assert not os.path.exists(ck + ".tmp.npz")  # written atomically
    out = load(ck)
    assert out["next_frame"] == 3 and out["n_cands"] == 9
    assert out["kf_frames"] == [0, 1, 2] and out["anchor_kf"] == [0, 1, 2]
    assert out["strain"] == strain
    np.testing.assert_array_equal(np.stack(out["poses"]), np.stack(hist))
    for a, b in zip(out["descs"], descs):
        np.testing.assert_array_equal(a, b)
    assert out["positions"][1] is None
    np.testing.assert_array_equal(out["positions"][2], positions[2])
    assert [(c.i, c.j, c.rmse, c.n_inliers) for c in out["closures"]] == [
        (c.i, c.j, c.rmse, c.n_inliers) for c in closures]
    for a, b in zip(out["closures"], closures):
        np.testing.assert_array_equal(a.T_ij, b.T_ij)
    fe = out["fe_state"]
    got = _leaves_np(fe) if writer == "reference" else _jax_leaves(fe)
    want = _jax_leaves(st) if writer == "reference" else _leaves_np(st)
    _assert_leaves_equal(got, want)


def test_slam_checkpoint_strain_roundtrip(tmp_path):
    """Mirrors test_fault_tolerance.py::test_slam_checkpoint_strain_roundtrip
    (the strain flags weight the odometry factors; a resume must keep them)."""
    state = OdomState(pose=torch.eye(4), T_rel=torch.eye(4),
                      prev_points=torch.zeros(4, 3),
                      prev_mask=torch.ones(4, dtype=torch.bool), grid=None,
                      frame=torch.tensor(3, dtype=torch.int32))
    strain = [False, True, False, True]
    ck = str(tmp_path / "ck.npz")
    tck.save_slam_checkpoint(ck, "odom", state, 4, [np.eye(4)] * 4, [0],
                             [np.eye(4)], [0, 0, 0, 0], [], [], [], 0,
                             strain=strain)
    out = tck.load_slam_checkpoint(ck, device="cpu")
    assert out["strain"] == strain
    assert torch.equal(out["fe_state"].frame, state.frame)
    assert jck.load_slam_checkpoint(ck)["strain"] == strain


@pytest.fixture(scope="module")
def reference_resume(log10, tmp_path_factory):
    """The reference's crashed-then-resumed run of the fixture."""
    pts, msk = log10
    ck = str(tmp_path_factory.mktemp("ref") / "slam3d_ck.npz")
    JaxSlam3D(_cfg()).run(pts[:7], msk[:7], checkpoint_path=ck,
                          checkpoint_every=3)
    return JaxSlam3D(_cfg()).run(pts, msk, checkpoint_path=ck, resume=True)


def test_slam3d_resume_equals_uninterrupted(tmp_path, log10,
                                            reference_resume):
    """Mirrors test_fault_tolerance.py::test_backend_checkpoint_resume_slam3d,
    and holds the port's resumed poses to the reference's."""
    pts, msk = log10
    cfg = _port(_cfg())
    ck = str(tmp_path / "slam3d_ck.npz")
    ref_poses, ref_rep = Slam3D(cfg, device="cpu").run(pts, msk,
                                                       mode="streaming")
    Slam3D(cfg, device="cpu").run(pts[:7], msk[:7], checkpoint_path=ck,
                                  checkpoint_every=3)
    assert tck.load_slam_checkpoint(ck, device="cpu")["next_frame"] == 7
    slam = Slam3D(cfg, device="cpu")
    res_poses, res_rep = slam.run(pts, msk, checkpoint_path=ck, resume=True)
    assert res_rep.n_keyframes == ref_rep.n_keyframes
    assert res_rep.n_loop_closures == ref_rep.n_loop_closures
    np.testing.assert_allclose(res_poses, ref_poses, rtol=1e-5, atol=1e-6)
    # the resumed run took the restored keyframe store: three frames ran
    assert len(slam.frontend_iters) == 3
    assert len(slam.detector._descs) == res_rep.n_keyframes
    jposes, jrep = reference_resume
    assert res_rep.n_keyframes == jrep.n_keyframes
    gap = np.linalg.norm(res_poses[:, :3, 3] - jposes[:, :3, 3], axis=1)
    assert gap.max() <= POSE_GAPS[0], gap
    assert _rot_gap(res_poses, jposes).max() <= POSE_GAPS[1]


def test_chunked_fused_checkpoints_between_chunks(tmp_path):
    """Mirrors test_endurance_mechanics.py::
    test_chunked_fused_matches_single_dispatch: the chunked run equals the
    single fused run, and its checkpoint after the last chunk resumes
    nothing left to do and reproduces the same trajectory."""
    scans, _ = synthetic.velodyne_log(n_frames=14, n_rings=8, n_azimuth=128,
                                      path_fraction=0.15, seed=1)
    pts, msk = pad_scans([voxel_downsample_np(s, 0.6) for s in scans], 512)
    cfg = _port(dataclasses.replace(_cfg(), pipeline=dataclasses.replace(
        _cfg().pipeline, keyframe_trans=0.6, keyframe_rot=0.2)))
    ref_poses, ref_rep = Slam3D(cfg, device="cpu").run(pts, msk, mode="fused")
    slam = Slam3D(cfg, device="cpu")
    ck = str(tmp_path / "chunk_ck.npz")
    chk_poses, chk_rep = slam.run(pts, msk, mode="fused", chunk_frames=5,
                                  checkpoint_path=ck)
    np.testing.assert_allclose(chk_poses, ref_poses, rtol=1e-5, atol=1e-6)
    assert chk_rep.n_keyframes == ref_rep.n_keyframes
    assert [c[1] for c in slam.chunk_stats] == [5, 5, 3]
    rec = tck.load_slam_checkpoint(ck, device="cpu")
    assert rec["next_frame"] == 14 and len(rec["strain"]) == 14
    assert rec["kf_frames"] == slam.kf_frames
    res_poses, res_rep = Slam3D(cfg, device="cpu").run(
        pts, msk, checkpoint_path=ck, resume=True)
    np.testing.assert_allclose(res_poses, chk_poses, rtol=1e-5, atol=1e-6)
    assert res_rep.n_keyframes == chk_rep.n_keyframes
