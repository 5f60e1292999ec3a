"""Slam2D of the torch port against the reference's, on the reference's own
fixtures shortened (tests/test_slam2d_backend.py), the reference run as its
tests run it (CPU, nn_backend="xla").

- The out-and-back corridor (24 frames out, 23 back, 256 points a scan,
  4 yaw hypotheses): the same keyframes, candidates and accepted closures
  (each T_ij within 1e-3 m / 1e-3 rad), the same closures kept by the
  pose graph, poses within 2e-3 m (measured 8.1e-4 m: the scan-to-scan
  chain carries its NN decisions at near-ties, where the reference scores
  the factored float32 form and the port the difference form).

The z = 0 lift onto the scan-to-map pipeline is held in
test_torch_state2d.py.
"""

import numpy as np
import pytest
import torch

from tpu_icp_slam.config import (
    BackendConfig,
    ICPConfig,
    PipelineConfig,
    SlamConfig,
    to_json,
)
from tpu_icp_slam.datasets import synthetic
from tpu_icp_slam.slam.runner import pad_scans
from tpu_icp_slam.slam.slam2d import Slam2D as JaxSlam2D
from tpu_icp_slam_torch.config import from_json
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


def out_and_back(f_half=24):
    """test_slam2d_backend.py's route: down the corridor and back."""
    log = synthetic.lidar2d_log(n_frames=f_half, n_beams=360, seed=0,
                                noise=0.01)
    fwd = [synthetic.scan_to_points(log.ranges[i], log.angles, log.max_range)
           for i in range(f_half)]
    pts, msk = pad_scans(fwd + fwd[::-1][1:], 256)
    return pts, msk, log.max_range


def backend_cfg(enabled=True):
    return SlamConfig(
        icp=ICPConfig(method="point_to_point", max_iters=30,
                      max_corr_dist=1.0, nn_backend="xla"),
        pipeline=PipelineConfig(scan_capacity=256, keyframe_trans=1.0,
                                keyframe_rot=0.3),
        backend=BackendConfig(enabled=enabled, min_loop_separation=8,
                              candidate_topk=3, verify_max_rmse=0.25,
                              gating_radius=3.0, verify_max_dev=1.2,
                              descriptor_rings=12, descriptor_sectors=48,
                              verify_yaws=4),
    )


def _rot(T):
    return np.arctan2(T[..., 1, 0], T[..., 0, 0])


@pytest.fixture(scope="module")
def runs():
    pts, msk, rng = out_and_back()
    js = JaxSlam2D(backend_cfg(), sensor_max_range=rng)
    jp, jrep = js.run(pts, msk)
    ts = Slam2D(_port(backend_cfg()), sensor_max_range=rng, device="cpu")
    tp, trep = ts.run(pts, msk)
    return (js, jp, jrep), (ts, tp, trep), (pts, msk, rng)


def test_slam2d_matches_reference(runs):
    (js, jp, jrep), (ts, tp, trep), _ = runs
    assert tp.shape == jp.shape == (47, 3, 3)
    assert ts.kf_frames == js.kf_frames
    assert (trep.n_keyframes, trep.n_loop_candidates, trep.n_loop_closures) \
        == (jrep.n_keyframes, jrep.n_loop_candidates, jrep.n_loop_closures)
    assert trep.n_loop_closures >= 1
    want = {(lc.i, lc.j): lc for lc in js.closures}
    got = {(lc.i, lc.j): lc for lc in ts.closures}
    assert got.keys() == want.keys()
    for k, lc in got.items():
        assert lc.T_ij.shape == (3, 3)
        assert np.linalg.norm(lc.T_ij[:2, 2] - want[k].T_ij[:2, 2]) < 1e-3
        assert abs(_rot(lc.T_ij) - _rot(want[k].T_ij)) < 1e-3
    assert sorted((c.i, c.j) for c in ts.closures_kept) == sorted(
        (c.i, c.j) for c in js.closures_kept)
    assert trep.n_loops_rejected == jrep.n_loops_rejected
    assert len(trep.chi2) == len(jrep.chi2)
    np.testing.assert_allclose(tp[:, :2, 2], jp[:, :2, 2], atol=2e-3)
    np.testing.assert_allclose(_rot(tp), _rot(jp), atol=2e-3)
    assert ts.detector.verify_iters > 0
    assert ts.frontend_iters.shape == (46,)


def test_slam2d_closure_pulls_the_loop_back(runs):
    """test_slam2d_loop_closure_reduces_final_error on the port."""
    _, (ts, tp, trep), (pts, msk, rng) = runs
    assert trep.chi2[-1] < trep.chi2[0] * 1.1
    odo, _ = Slam2D(_port(backend_cfg(False)), sensor_max_range=rng,
                    device="cpu").run(pts, msk)
    # an exact revisit: the last frame's true pose is the first's
    assert np.linalg.norm(tp[-1, :2, 2]) <= np.linalg.norm(odo[-1, :2, 2]) \
        + 1e-6


def test_slam2d_streaming_equals_fused(runs):
    _, (ts, tp, trep), (pts, msk, rng) = runs
    sp, srep = Slam2D(_port(backend_cfg()), sensor_max_range=rng,
                      device="cpu").run(pts, msk, mode="streaming")
    np.testing.assert_array_equal(sp, tp)
    assert srep.n_loop_closures == trep.n_loop_closures
