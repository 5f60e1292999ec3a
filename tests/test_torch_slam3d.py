"""The torch port's full config-4 SLAM (`Slam3D`: scan-to-map front end,
loop closure, pose graph) against the JAX reference, and one scan-to-map
steps run at nn_precision="rescore" on both sides.

The log drives out and back along the reference route (8 frames out, 7
back), so the return leg revisits every keyframe of the way out: the
reference accepts closures on it. Tolerances: keyframes, candidates and
accepted closures equal; poses within 1e-4 m and 1e-4 rad per frame (the
front ends differ by float32 summation order and the NN's difference-form
vs factored-form scores, observed 1.6e-6 m; the pose graph then runs in
float64 on both sides).
"""

import collections
import dataclasses
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from test_scan_to_map import _s2m_cfg
from test_torch_slice import _assert_slice_agrees, _log, _rot_gap, _run_both
from tpu_icp_slam.config import BackendConfig, DistConfig
from tpu_icp_slam.core.pointcloud import voxel_downsample_np
from tpu_icp_slam.datasets import synthetic
from tpu_icp_slam.slam.runner import pad_scans
from tpu_icp_slam.slam.slam3d import Slam3D as JaxSlam3D
from tpu_icp_slam_torch.slam.slam3d import Slam3D

POSE_GAPS = (1e-4, 1e-4)  # m, rad per frame
# the steps slice at rescore: the observed gaps of the highest slice
# (tests/test_torch_slice.py GAPS["main"]) hold at 10x, since selection is
# exact on both sides and d² is recomputed in difference form either way
RESCORE_GAPS = (3e-4, 6e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs test files in parallel worker processes: torch's own
    thread pool in each would oversubscribe the cores (this file took ~8x
    its serial time under six workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _slam_cfg():
    cfg = _s2m_cfg()
    return dataclasses.replace(
        cfg,
        mapping=dataclasses.replace(cfg.mapping, local_model_size=2048,
                                    map_capacity=8192),
        pipeline=dataclasses.replace(cfg.pipeline, scan_capacity=768,
                                     keyframe_trans=1.6),
        backend=BackendConfig(enabled=True, min_loop_separation=2,
                              candidate_topk=1, verify_yaws=4,
                              verify_max_rmse=0.6, gating_radius=10.0))


def _out_and_back():
    scans, _ = synthetic.velodyne_log(n_frames=8, n_rings=10, n_azimuth=192,
                                      path_fraction=0.1)
    scans = [voxel_downsample_np(s, 0.5) for s in scans]
    return pad_scans(scans + scans[::-1][1:], 768)


@pytest.fixture(scope="module")
def reference():
    """The reference's runs, once per mode (chunked fused runs are held to
    the single fused run by the reference's own tests)."""
    pts, msk = _out_and_back()
    cfg = _slam_cfg()
    return pts, msk, {mode: JaxSlam3D(cfg).run(pts, msk, mode=mode)
                      for mode in ("fused", "streaming")}


@pytest.mark.parametrize("mode,chunk", [("fused", 0), ("streaming", 0),
                                        ("fused", 6)])
def test_slam3d_matches_reference(reference, mode, chunk):
    pts, msk, ref = reference
    ref_poses, ref_rep = ref[mode]
    slam = Slam3D(_slam_cfg(), device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        poses, rep = slam.run(pts, msk, mode=mode, chunk_frames=chunk)
    assert ref_rep.n_loop_closures >= 1  # the log closes in the reference
    # the program's spans: verification's batches, and the pose graph once
    # a run that keeps closures
    spans = collections.Counter(
        e.name() for e in prof.profiler.kineto_results.events()
        if e.name().startswith("icp_slam."))
    assert spans["icp_slam.backend.graph"] == 1 and slam.closures_kept
    assert spans["icp_slam.verify.batch"] >= 1
    for f in ("n_frames", "n_keyframes", "n_loop_candidates",
              "n_loop_closures", "n_loops_rejected", "n_suspect_closures"):
        assert getattr(rep, f) == getattr(ref_rep, f), f
    assert [(c["i"], c["j"], c["n_inliers"], c["suspect"])
            for c in rep.closure_table] == [
        (c["i"], c["j"], c["n_inliers"], c["suspect"])
        for c in ref_rep.closure_table]
    np.testing.assert_allclose(rep.chi2, ref_rep.chi2, rtol=1e-3, atol=1e-9)
    assert poses.shape == ref_poses.shape and np.isfinite(poses).all()
    gap = np.linalg.norm(poses[:, :3, 3] - ref_poses[:, :3, 3], axis=1)
    assert gap.max() <= POSE_GAPS[0], gap
    assert _rot_gap(poses, ref_poses).max() <= POSE_GAPS[1]
    assert len(slam.kf_poses_out) == rep.n_keyframes
    if chunk:
        assert [c[1] for c in slam.chunk_stats] == [6, 6, 2]
    assert slam.backend_s > 0.0 and slam.detector.verify_iters > 0


@pytest.fixture(scope="module")
def dense_and_schur():
    """The out-and-back log's fused run with the dense pose graph and with
    dist.mesh_shape=(2,) in a world of one rank (one Schur block)."""
    pts, msk = _out_and_back()
    runs = []
    for shape in ((1,), (2,)):
        cfg = dataclasses.replace(_slam_cfg(),
                                  dist=DistConfig(mesh_shape=shape))
        slam = Slam3D(cfg, device="cpu")
        runs.append((slam, *slam.run(pts, msk)))
    return runs


@pytest.mark.parametrize("kw", [{"checkpoint_path": "ck.npz"},
                                {"checkpoint_every": 3}, {"resume": True}])
def test_slam3d_unported_options_raise(kw, tmp_path, dense_and_schur):
    """Every option is ported now. The checkpoint options
    (tests/test_torch_checkpoint.py), alone, without a record to write or
    read, change nothing. dist.mesh_shape=(2,), once refused, takes the
    Schur branch over min(2, world size) = 1 block here: the same keyframes
    and kept closures as the dense solve, poses and chi2 within the
    reference's own Schur-vs-dense bound (rtol 1e-7 / atol 1e-8, chi2 rtol
    1e-6, tests/test_schur.py:49-54)."""
    pts, msk = _out_and_back()
    kw = {k: str(tmp_path / v) if k == "checkpoint_path" else v
          for k, v in kw.items()}
    poses, rep = Slam3D(_slam_cfg(), device="cpu").run(pts[:3], msk[:3],
                                                        **kw)
    plain, _ = Slam3D(_slam_cfg(), device="cpu").run(pts[:3], msk[:3])
    np.testing.assert_array_equal(poses, plain)
    assert rep.n_frames == 3 and not os.listdir(tmp_path)
    (dense, d_poses, d_rep), (schur, s_poses, s_rep) = dense_and_schur
    assert d_rep.n_loop_closures >= 1 and len(dense.closures_kept) >= 1
    assert schur.kf_frames == dense.kf_frames
    assert [(c.i, c.j) for c in schur.closures_kept] == \
        [(c.i, c.j) for c in dense.closures_kept]
    np.testing.assert_allclose(s_poses, d_poses, rtol=1e-7, atol=1e-8)
    np.testing.assert_allclose(s_rep.chi2, d_rep.chi2, rtol=1e-6)


def test_slice_at_rescore_matches_reference():
    """One scan-to-map steps run at nn_backend="pallas",
    nn_precision="rescore" on both sides: the reference's shortlist kernel
    in interpret mode, the port's K4 plain version."""
    pts, msk, gt = _log(n_frames=6)
    cfg = _s2m_cfg()
    cfg = dataclasses.replace(cfg, icp=dataclasses.replace(
        cfg.icp, nn_backend="pallas", nn_precision="rescore"))
    ji, ti = _run_both(cfg, pts, msk)
    _assert_slice_agrees(ji, ti, gt, RESCORE_GAPS)
    np.testing.assert_array_equal(ti["iters"], ji["iters"])
