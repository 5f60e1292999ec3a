"""The torch port's backend — point-to-point ICP, batched alignment, loop
closure and the pose graph — against the JAX reference on the same numpy
inputs (the reference as its own tests run it on the CPU: NN on "xla").

Tolerances, each with its reason:
- point-to-point solves: 1e-5 (float32 sums and 3×3 SVDs in another order);
- alignments: 1e-5 per transform entry, iterations and inliers equal (the
  port's CPU NN scores the exact difference form, the reference's "xla" NN
  the factored form: they agree away from near-ties);
- descriptors: equal (no point of these scans lies on a bin edge, where
  XLA's and torch's float32 rounding can fall either way); scores 1e-5;
- verified closures: the same (i, j), T_ij within 1e-3 m / 1e-3 rad;
- pose graph (float64 on both sides): 1e-9 on residuals, Jacobians and H,
  1e-7 on optimized poses (ten Gauss-Newton solves of a 72-unknown
  system).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_loop_closure import _loop_fixture
from test_pose_graph import _chain_with_loop, _drifty_chain
from tpu_icp_slam.backend import loop_closure as jlc
from tpu_icp_slam.backend import pose_graph as jpg
from tpu_icp_slam.config import BackendConfig, ICPConfig
from tpu_icp_slam.core import pointcloud as jpc
from tpu_icp_slam.core.pointcloud import voxel_downsample_np
from tpu_icp_slam.datasets import synthetic
from tpu_icp_slam.icp import loop as jloop
from tpu_icp_slam.icp import point_to_point as jp2p
from tpu_icp_slam_torch.backend import loop_closure as tlc
from tpu_icp_slam_torch.backend import pose_graph as tpg
from tpu_icp_slam_torch.core import pointcloud as tpc
from tpu_icp_slam_torch.icp import loop as tloop
from tpu_icp_slam_torch.icp import point_to_point as tp2p
from tpu_icp_slam_torch.interop import load_detector_store, pose_graph_from_numpy

# test_loop_closure.py's detector with 4 yaw hypotheses per candidate (the
# r5 lean basket): the CPU plain NN scores every pair in difference form,
# so the batch size sets this file's time
FIXTURE_CFG = BackendConfig(enabled=True, min_loop_separation=12,
                            candidate_topk=3, verify_max_rmse=0.6,
                            gating_radius=15.0, verify_yaws=4)
LEAN_CFG = dataclasses.replace(FIXTURE_CFG, verify_max_dev=5.0,
                               verify_stride=2)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs test files in parallel worker processes: torch's own
    thread pool in each would oversubscribe the cores (this file took ~8x
    its serial time under six workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _rot_gap(Ta, Tb):
    M = np.asarray(Ta)[..., :3, :3].swapaxes(-1, -2) @ np.asarray(Tb)[..., :3, :3]
    A = M - np.swapaxes(M, -1, -2)
    sin = np.linalg.norm(np.stack([A[..., 2, 1], A[..., 0, 2], A[..., 1, 0]],
                                  -1), axis=-1) / 2.0
    return np.arctan2(sin, (np.trace(M, axis1=-2, axis2=-1) - 1.0) / 2.0)


# ---- point-to-point ----------------------------------------------------


def _pairs(seed, reflect=False):
    rng = np.random.default_rng(seed)
    src = rng.uniform(-10, 10, (3, 200, 3)).astype(np.float32)
    T = synthetic.rigid_transform(3, rng, 0.5, 2.0)
    dst = (src @ T[:3, :3].T + T[:3, 3]).astype(np.float32)
    if reflect:  # a mirror image: the SVD alone would return a reflection
        dst[..., 2] *= -1.0
    dst += rng.normal(size=dst.shape).astype(np.float32) * 0.01
    w = rng.uniform(0, 1, (3, 200)).astype(np.float32)
    w[:, 150:] = 0.0
    return src, dst, w


@pytest.mark.parametrize("reflect", [False, True])
def test_umeyama_matches_reference(reflect):
    src, dst, w = _pairs(1, reflect)
    a = np.asarray(jp2p.umeyama_masked(*map(jnp.asarray, (src, dst, w))))
    b = tp2p.umeyama_masked(_t(src), _t(dst), _t(w)).numpy()
    np.testing.assert_allclose(b, a, atol=1e-5)
    np.testing.assert_allclose(np.linalg.det(b[:, :3, :3]), 1.0, atol=1e-5)
    mj = jp2p.moments(*map(jnp.asarray, (src, dst, w)))
    mt = tp2p.moments(_t(src), _t(dst), _t(w))
    for x, y in zip(mt, mj):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=1e-5,
                                   atol=1e-3)
    a = np.asarray(jp2p.umeyama_from_moments(*mj))
    b = tp2p.umeyama_from_moments(*mt).numpy()
    np.testing.assert_allclose(b, a, atol=1e-4)


P2P = ICPConfig(max_iters=25, tol=1e-6, nn_backend="xla")


def test_point_to_point_align_matches_reference():
    s, d, T_gt = synthetic.two_scan_pair(n=512, seed=3, rot_scale=0.2,
                                         trans_scale=0.3)
    ra = jloop.align(jpc.make(s, 600), jpc.make(d, 640), cfg=P2P)
    rb = tloop.align(tpc.make(s, 600), tpc.make(d, 640), cfg=P2P)
    assert rb.iters == int(ra.iters) and int(rb.n_inliers) == int(
        ra.n_inliers)
    np.testing.assert_allclose(rb.T.numpy(), np.asarray(ra.T), atol=1e-5)
    assert np.linalg.norm(rb.T.numpy()[:3, 3] - T_gt[:3, 3]) < 2e-3


def _batch_problem():
    """One scan against two targets (the same scene moved two ways), three
    initial yaws each: elements converge after different counts."""
    rng = np.random.default_rng(2)
    scans, _ = synthetic.velodyne_log(n_frames=2, n_rings=8, n_azimuth=160)
    src = voxel_downsample_np(scans[0], 0.5)[:700].astype(np.float32)
    targets = []
    for k in range(2):
        T = synthetic.rigid_transform(3, rng, 0.1, 1.0)
        moved = src @ T[:3, :3].T + T[:3, 3] + rng.normal(
            size=src.shape) * 0.02  # sensor noise: a non-trivial rmse
        targets.append(np.asarray(jpc.make(moved.astype(np.float32),
                                           768).points))
    yaws = np.asarray([0.0, 0.2, -0.3, 0.1, 0.4, -0.1], np.float32)
    inits = np.tile(np.eye(4, dtype=np.float32), (6, 1, 1))
    inits[:, 0, 0] = inits[:, 1, 1] = np.cos(yaws)
    inits[:, 0, 1], inits[:, 1, 0] = -np.sin(yaws), np.sin(yaws)
    return jpc.make(src, 720), np.stack(targets), inits


@pytest.mark.parametrize("cfg", [
    dataclasses.replace(P2P, max_corr_dist=6.0, huber_delta=1.5, tol=1e-5,
                        min_inliers=30, max_iters=50),
    dataclasses.replace(P2P, max_corr_dist=3.0, tol=1e-5, max_iters=30,
                        step_scale=1.2, max_total_trans=1.5,
                        max_total_rot=0.5, tol_update=0.01)])
def test_align_batched_equals_unbatched_aligns(cfg):
    """Each element of align_batched is its own align: elements that stop
    early are frozen while the rest iterate (tolerance 1e-6: batched and
    unbatched float32 reductions may round differently)."""
    src, dst, inits = _batch_problem()
    s = tpc.PointCloud(points=_t(src.points), mask=_t(src.mask))
    dst_t = _t(dst)
    res = tloop.align_batched(s, dst_t, torch.ones(dst.shape[:2], dtype=bool),
                              _t(inits), cfg)
    iters = res.iters.numpy()
    assert res.T.shape == (6, 4, 4) and iters.dtype == np.int32
    for b in range(6):
        one = tloop.align(s, tpc.PointCloud(points=dst_t[b // 3],
                                            mask=torch.ones(768, dtype=bool)),
                          _t(inits[b]), cfg)
        assert iters[b] == one.iters
        assert int(res.n_inliers[b]) == int(one.n_inliers)
        assert bool(res.converged[b]) == bool(one.converged)
        np.testing.assert_allclose(res.T[b].numpy(), one.T.numpy(), atol=1e-6)
        np.testing.assert_allclose(float(res.rmse[b]), float(one.rmse),
                                   atol=1e-6)
    assert len(set(iters.tolist())) > 1, iters  # stopped at different counts


def test_align_batched_refuses_unported_methods():
    src, dst, inits = _batch_problem()
    s = tpc.PointCloud(points=_t(src.points), mask=_t(src.mask))
    with pytest.raises(NotImplementedError):
        tloop.align_batched(s, _t(dst), torch.ones(2, 768, dtype=bool),
                            _t(inits), ICPConfig(method="point_to_plane"))


# ---- loop closure ------------------------------------------------------


@pytest.fixture(scope="module")
def fixture():
    """tests/test_loop_closure.py's 24-frame loop log and reference detector,
    and a port detector holding the same keyframe store."""
    det, pts, msk, gt = _loop_fixture(FIXTURE_CFG)
    tdet = tlc.LoopDetector(FIXTURE_CFG)
    load_detector_store(tdet, det._descs, det._positions)
    return det, tdet, pts, msk, gt


def test_scan_context_and_scores_match_reference(fixture):
    det, _, pts, msk, _ = fixture
    descs = []
    for i in (0, 7, 23):
        a = np.asarray(jlc.scan_context(jnp.asarray(pts[i]),
                                        jnp.asarray(msk[i]), 20, 60))
        b = tlc.scan_context(_t(pts[i]), _t(msk[i]), 20, 60).numpy()
        np.testing.assert_array_equal(b, a)
        np.testing.assert_array_equal(b, det._descs[i])
        descs.append(a)
    q, D = descs[2], np.stack(descs)
    sj, shj = jlc.shift_match_scores(jnp.asarray(q), jnp.asarray(D))
    st, sht = tlc.shift_match_scores(_t(q), _t(D))
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=1e-5)
    np.testing.assert_array_equal(sht.numpy(), np.asarray(shj))
    mj = np.asarray(jlc.shift_score_matrix(jnp.asarray(q), jnp.asarray(D)))
    np.testing.assert_allclose(tlc.shift_score_matrix(_t(q), _t(D)).numpy(),
                               mj, atol=1e-5)
    # 2D scans: occupancy counts per bin. Every point counts here, so the
    # scan is turned off the synthetic azimuth grid first: on it, 16 points
    # per ring sit exactly on a 48-sector edge, where XLA's float32 rounding
    # (an FMA in r, its own scaling) and torch's can fall either way
    c, s_ = np.cos(0.1234), np.sin(0.1234)
    pts2 = (pts[3][:, :2] @ np.array([[c, -s_], [s_, c]]).T).astype(
        np.float32)
    a = np.asarray(jlc.scan_context(jnp.asarray(pts2), jnp.asarray(msk[3]),
                                    12, 48))
    b = tlc.scan_context(_t(pts2), _t(msk[3]), 12, 48).numpy()
    np.testing.assert_array_equal(b, a)


def test_candidates_match_reference(fixture):
    det, tdet, *_ = fixture
    for q in (5, 12, 20, 23):
        a = det.candidates(q)
        b = tdet.candidates(q)
        assert [(c.match_idx, c.yaw) for c in b] == [
            (c.match_idx, c.yaw) for c in a]
        np.testing.assert_allclose([c.score for c in b],
                                   [c.score for c in a], atol=1e-5)


def _assert_same_closures(ta, tb):
    assert [(lc.i, lc.j) for lc in tb] == [(lc.i, lc.j) for lc in ta]
    assert ta, "the reference accepted no closure"
    for a, b in zip(ta, tb):
        assert np.linalg.norm(b.T_ij[:3, 3] - a.T_ij[:3, 3]) < 1e-3
        assert _rot_gap(a.T_ij, b.T_ij) < 1e-3
        assert abs(b.rmse - a.rmse) < 1e-3


def test_verify_batch_matches_reference(fixture):
    det, tdet, pts, msk, gt = fixture
    q = len(pts) - 1
    cands = det.candidates(q)
    idx = [c.match_idx for c in cands]
    T_preds = np.stack([np.linalg.inv(gt[i]) @ gt[q] for i in idx])
    args = (pts[q], msk[q], pts[idx], msk[idx])
    a = det.verify_batch(cands, *args, T_preds=T_preds)
    b = tdet.verify_batch(tdet.candidates(q), *args, T_preds=T_preds)
    assert len(a) == len(b) == len(cands)
    assert [x is None for x in b] == [x is None for x in a]
    _assert_same_closures([x for x in a if x], [x for x in b if x])
    assert tdet.verify_iters > 0


def test_verify_keyframe_candidates_strided_lean_yaws_match_reference():
    det, pts, msk, gt = _loop_fixture(LEAN_CFG)
    tdet = tlc.LoopDetector(LEAN_CFG)
    load_detector_store(tdet, det._descs, det._positions)
    q = len(pts) - 1
    kf_frames = list(range(len(pts)))
    kf_poses = [gt[i] for i in kf_frames]
    args = (q, pts[q], msk[q], pts, msk, kf_frames, kf_poses, gt[q])
    na, la = det.verify_keyframe_candidates(*args)
    nb, lb = tdet.verify_keyframe_candidates(*args)
    assert nb == na > 0
    _assert_same_closures(la, lb)
    # the dedup gate drops every candidate of the closed region, as in
    # test_closure_dedup_skips_already_closed_region
    tdet.cfg = dataclasses.replace(LEAN_CFG, closure_dedup_kf=4)
    assert tdet.verify_keyframe_candidates(*args, lb) == (0, [])


def test_relocalize_matches_reference():
    scans, gt = synthetic.velodyne_log(n_frames=20, n_rings=12,
                                       n_azimuth=256, path_fraction=0.5)
    cfg = BackendConfig(verify_max_rmse=0.6, verify_max_dev=0.0,
                        verify_yaws=4)
    det, tdet = jlc.LoopDetector(cfg), tlc.LoopDetector(cfg)
    store, poses = [], []
    for i in range(0, 20, 2):
        p = np.asarray(jpc.make(voxel_downsample_np(scans[i], 0.5)[:1536],
                                1536).points)
        m = np.abs(p).max(1) < 1e5
        det.add_keyframe(p, m, position=gt[i][:3, 3])
        tdet.add_keyframe(p, m, position=gt[i][:3, 3])
        store.append((p, m))
        poses.append(gt[i])
    for d_ref, d_port in zip(det._descs, tdet._descs):
        np.testing.assert_array_equal(d_port, d_ref)
    qp = np.asarray(jpc.make(voxel_downsample_np(scans[7], 0.5)[:1536],
                             1536).points)
    qm = np.abs(qp).max(1) < 1e5
    a = det.relocalize(qp, qm, store, poses)
    b = tdet.relocalize(qp, qm, store, poses)
    assert a is not None and b is not None and b[1] == a[1]
    assert np.linalg.norm(b[0][:3, 3] - a[0][:3, 3]) < 1e-3
    assert np.linalg.norm(b[0][:3, 3] - gt[7][:3, 3]) < 1.0


def test_detector_store_doubles_like_reference():
    cfg = dataclasses.replace(FIXTURE_CFG, max_keyframes=2)
    tdet = tlc.LoopDetector(cfg)
    p = np.random.default_rng(0).uniform(-20, 20, (64, 3)).astype(np.float32)
    for k in range(70):
        tdet.add_keyframe(p, np.ones(64, bool), position=[k, 0.0])
    assert tdet._descs_dev.shape[0] == 128 and tdet._n_dev == 70
    np.testing.assert_array_equal(tdet._pos_dev[69].numpy(), [69, 0, 0])
    assert torch.isnan(tdet._pos_dev[70]).all()


# ---- pose graph --------------------------------------------------------


def _graphs(n=12, drift=0.03, **caps):
    init, gt, factors = _chain_with_loop(n=n, drift=drift)
    jg = jpg.from_arrays(init, factors, dtype=jnp.float64, **caps)
    tg = tpg.from_arrays(init, factors, dtype=torch.float64, **caps)
    return jg, tg, gt


def test_pose_graph_from_arrays_and_interop():
    jg, tg, _ = _graphs(max_keyframes=16, max_factors=20)
    for f in ("poses", "pose_mask", "fi", "fj", "T_meas", "weight"):
        np.testing.assert_array_equal(getattr(tg, f).numpy(),
                                      np.asarray(getattr(jg, f)), err_msg=f)
        np.testing.assert_array_equal(
            getattr(pose_graph_from_numpy(jg), f).numpy(),
            np.asarray(getattr(jg, f)), err_msg=f)
    assert tg.capacity == 16 and tg.factor_capacity == 20
    assert tg.poses.dtype == torch.float64
    ej, et = jpg.create(5, 7, jnp.float64), tpg.create(5, 7, torch.float64)
    for f in ("poses", "pose_mask", "fi", "fj", "T_meas", "weight"):
        np.testing.assert_array_equal(getattr(et, f).numpy(),
                                      np.asarray(getattr(ej, f)), err_msg=f)


def test_pose_graph_linearization_matches_reference():
    jg, tg, _ = _graphs(max_keyframes=14, max_factors=16)
    np.testing.assert_allclose(tpg.residuals(tg).numpy(),
                               np.asarray(jpg.residuals(jg)), atol=1e-9)
    lj = jpg.linearize(jg, huber_delta=0.05)
    lt = tpg.linearize(tg, huber_delta=0.05)
    for x, y in zip(lt, lj):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), atol=1e-9)
    Hj, gj = jpg.assemble(jg, *lj, damping=1e-6, anchor_weight=1e6)
    Ht, gt_ = tpg.assemble(tg, *lt, damping=1e-6, anchor_weight=1e6)
    np.testing.assert_allclose(Ht.numpy(), np.asarray(Hj), rtol=1e-12,
                               atol=1e-9)
    np.testing.assert_allclose(gt_.numpy(), np.asarray(gj), atol=1e-9)
    dj = np.asarray(jpg.solve_dense(Hj, gj))
    dt = tpg.solve_dense(Ht, gt_).numpy()
    np.testing.assert_allclose(dt, dj, atol=1e-9)
    np.testing.assert_allclose(tpg.apply_update(tg, _t(dj)).poses.numpy(),
                               np.asarray(jpg.apply_update(jg, dj).poses),
                               atol=1e-12)
    # a system that is not positive definite gives a zero step
    bad = tpg.solve_dense(-Ht, gt_)
    assert torch.equal(bad, torch.zeros_like(bad))


@pytest.mark.parametrize("caps", [{}, {"max_keyframes": 32,
                                       "max_factors": 64}])
def test_pose_graph_optimize_matches_reference(caps):
    jg, tg, gt = _graphs(**caps)
    oj, cj = jpg.optimize(jg, iters=10, damping=1e-9, huber_delta=1.0)
    ot, ct = tpg.optimize(tg, iters=10, damping=1e-9, huber_delta=1.0)
    np.testing.assert_allclose(ot.poses.numpy(), np.asarray(oj.poses),
                               atol=1e-7)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=1e-6,
                               atol=1e-12)
    assert float(ct[-1]) < 0.5 * float(ct[0])
    after = np.linalg.norm(ot.poses.numpy()[:12, :3, 3] - gt[:, :3, 3], axis=1)
    assert after[-1] < 0.2


def _closures(n=12, alias=5.0, seed=4):
    rng = np.random.default_rng(seed)
    poses_gt, odo, factors = _drifty_chain(rng, n)

    def rel(i, j):
        return np.linalg.inv(poses_gt[i]) @ poses_gt[j]

    closures = [(0, n - 1, rel(0, n - 1)), (1, n - 1, rel(1, n - 1)),
                (0, n - 2, rel(0, n - 2))]
    T_false = rel(1, n - 2).copy()
    T_false[:3, 3] += np.asarray([alias, 0.0, 0.0])
    closures.append((1, n - 2, T_false))
    return np.stack(odo), closures, factors


@pytest.mark.parametrize("alias", [5.0, 8.0])
def test_pcm_and_confidence_match_reference(alias):
    odo, closures, _ = _closures(alias=alias)
    np.testing.assert_allclose(
        tpg.closure_cycle_matrix(odo, closures),
        jpg.closure_cycle_matrix(odo, closures), atol=1e-9)
    keep_t = tpg.pairwise_consistent_closures(odo, closures, gamma=0.5)
    keep_j = jpg.pairwise_consistent_closures(odo, closures, gamma=0.5)
    np.testing.assert_array_equal(keep_t, keep_j)
    assert keep_t.tolist() == [True, True, True, False]
    st, su_t = tpg.closure_confidence(odo, closures, suspect_cycle=1.0)
    sj, su_j = jpg.closure_confidence(odo, closures, suspect_cycle=1.0)
    np.testing.assert_allclose(st, sj, atol=1e-9)
    np.testing.assert_array_equal(su_t, su_j)
    # singletons and the empty set
    assert np.isnan(tpg.closure_confidence(odo, closures[:1])[0][0])
    assert len(tpg.closure_confidence(odo, [])[0]) == 0
    # no mutual support: the closure closest to its odometry prediction
    far = [(0, 11, closures[0][2]), (1, 10, closures[3][2])]
    np.testing.assert_array_equal(
        tpg.pairwise_consistent_closures(odo, far, gamma=1e-6),
        jpg.pairwise_consistent_closures(odo, far, gamma=1e-6))


def test_reject_inconsistent_loops_matches_reference():
    rng = np.random.default_rng(4)
    n = 12
    poses_gt, odo, factors = _drifty_chain(rng, n)
    n_odo = len(factors)
    factors.append((0, n - 1, np.linalg.inv(poses_gt[0]) @ poses_gt[-1], 2.0))
    T_false = (np.linalg.inv(poses_gt[1]) @ poses_gt[-2]).copy()
    T_false[:3, 3] += np.asarray([20.0, 0.0, 0.0])
    factors.append((1, n - 2, T_false, 2.0))
    jg = jpg.from_arrays(np.stack(odo), factors, dtype=jnp.float64)
    tg = tpg.from_arrays(np.stack(odo), factors, dtype=torch.float64)
    loop_mask = np.zeros(len(factors), bool)
    loop_mask[n_odo:] = True
    kw = dict(reject_residual=0.75, iters=10, damping=1e-6, huber_delta=1.0)
    kj, nj = jpg.reject_inconsistent_loops(jg, loop_mask, **kw)
    kt, nt = tpg.reject_inconsistent_loops(tg, loop_mask, **kw)
    assert nt == nj >= 1
    np.testing.assert_array_equal(kt.numpy(), np.asarray(kj))
    assert kt[n_odo + 1] == 0
