"""The port's rigid fit (icp/point_to_point.py) and align_batched's trip
function (icp/loop.py) against the JAX reference on the same numpy inputs,
on the CPU.

`rigid_from_stats_ref`, the plain version that CPU tensors take, is held
to the reference's `rigid_from_stats` within 1e-5, the bound of
test_torch_backend.py::test_umeyama_matches_reference (float32 SVDs by two
LAPACK drivers). Each case is also held to a float64 numpy Umeyama of the
same float32 inputs: the rotation within 1e-6 (measured at most 4.2e-7
over the cases, 0 at cov = 0, where both give the identity) and the
translation within 5e-6 (measured at most 3.0e-6: |t| reaches ~20, where
a float32 ulp is 1.9e-6). Collinear inliers (rank <= D-2) have no unique
rotation: the plain version is held only to a finite proper one.

The trip function is what align_batched captures as a CUDA graph on the
card; here it runs eagerly, trip 0 apart and then the rest, on rows that
stop at different trips. Iterations, inliers and convergence equal the
reference's vmapped align; T and rmse are within 1e-5 of it, the bound of
test_torch_backend.py::test_point_to_point_align_matches_reference
(measured 1.4e-6 in 3D, 2.1e-6 in 2D: float32 SVDs and sums in another
order; test_align_batched_equals_unbatched_aligns's 1e-6 holds the port's
batched rows to its own unbatched aligns, which on these problems differ
by up to 1.3e-6 too). align_batched on CPU tensors drives the same trips
and gives the trip function's state bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_icp_slam.config import ICPConfig as JICPConfig
from tpu_icp_slam.core import pointcloud as jpc
from tpu_icp_slam.icp import loop as jloop
from tpu_icp_slam.icp import point_to_point as jp2p
from tpu_icp_slam_torch.config import ICPConfig
from tpu_icp_slam_torch.core import pointcloud as tpc
from tpu_icp_slam_torch.icp import loop as tloop
from tpu_icp_slam_torch.icp import point_to_point as tp2p


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the suite runs test files in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def _rotations(rng, shape, d):
    """Random proper rotations (*shape, d, d), float64."""
    q, r = np.linalg.qr(rng.normal(size=(*shape, d, d)))
    q = q * np.sign(np.diagonal(r, axis1=-2, axis2=-1))[..., None, :]
    q[..., :, 0] *= np.sign(np.linalg.det(q))[..., None]
    return q


# case -> (batch shape, singular values or a builder)
CASES = {
    "batch_1": ((1,), None),
    "batch_16": ((16,), None),
    "batch_4x8": ((4, 8), None),
    "reflecting": ((16,), "reflect"),
    "rank_d_minus_1": ((16,), "rank"),
    "near_equal": ((16,), (1.0, 1.0 + 1e-6, 1.0 - 1e-6)),
    "zero": ((16,), "zero"),
}


def _stats(case, d, seed=0):
    """(cov (*shape, d, d), mu_s, mu_d (*shape, d)) float32 for a case."""
    shape, kind = CASES[case]
    rng = np.random.default_rng(seed + 10 * d)
    R0 = _rotations(rng, shape, d)
    if kind is None:  # a weighted Umeyama's covariance of noisy pairs
        src = rng.uniform(-5, 5, (*shape, 40, d))
        dst = src @ np.swapaxes(R0, -1, -2) + rng.normal(size=src.shape) * 0.3
        xs = src - src.mean(-2, keepdims=True)
        xd = dst - dst.mean(-2, keepdims=True)
        cov = np.swapaxes(xd, -1, -2) @ xs / 40.0
    elif kind == "reflect":  # det(U Vᵀ) = -1: the correction flips a pair
        cov = R0 * np.asarray([3.0, 2.0, -1.0][3 - d:])[..., None, :]
    elif kind == "rank":  # D = 3: the z = 0 lift; D = 2: one direction
        if d == 3:
            cov = R0 * np.asarray([2.0, 1.0, 0.0])[..., None, :]
            cov[..., 2, :] = cov[..., :, 2] = 0.0
            cov[..., :2, :2] = _rotations(rng, shape, 2) * [2.0, 0.7]
        else:
            a, b = rng.normal(size=(2, *shape, 2))
            cov = a[..., :, None] * b[..., None, :]
    elif kind == "zero":
        cov = np.zeros((*shape, d, d))
    else:
        cov = R0 * np.asarray(kind[:d])[..., None, :]
    mu_s, mu_d = rng.normal(size=(2, *shape, d)) * 5.0
    return (cov.astype(np.float32), mu_s.astype(np.float32),
            mu_d.astype(np.float32))


def _umeyama64(cov, mu_s, mu_d):
    """Float64 numpy Umeyama of the same inputs, the reference's form."""
    cov, mu_s, mu_d = (np.asarray(a, np.float64) for a in (cov, mu_s, mu_d))
    d = cov.shape[-1]
    U, _, Vt = np.linalg.svd(cov)
    corr = np.ones(cov.shape[:-1])
    corr[..., -1] = np.sign(np.linalg.det(U @ Vt))
    R = (U * corr[..., None, :]) @ Vt
    T = np.zeros((*cov.shape[:-2], d + 1, d + 1))
    T[..., :d, :d] = R
    T[..., :d, d] = mu_d - np.einsum("...ij,...j->...i", R, mu_s)
    T[..., d, d] = 1.0
    return T


def _assert_proper(T, d):
    R = np.asarray(T, np.float64)[..., :d, :d]
    assert np.isfinite(R).all()
    np.testing.assert_allclose(np.linalg.det(R), 1.0, atol=1e-5)
    np.testing.assert_allclose(R @ np.swapaxes(R, -1, -2),
                               np.broadcast_to(np.eye(d), R.shape),
                               atol=1e-5)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("d", [2, 3])
def test_rigid_from_stats_ref_matches_reference(d, case):
    cov, mu_s, mu_d = _stats(case, d)
    want = np.asarray(jp2p.rigid_from_stats(*map(jnp.asarray,
                                                  (cov, mu_s, mu_d))))
    got = tp2p.rigid_from_stats_ref(_t(cov), _t(mu_s), _t(mu_d)).numpy()
    assert got.shape == (*CASES[case][0], d + 1, d + 1)
    np.testing.assert_allclose(got, want, atol=1e-5)
    _assert_proper(got, d)
    gap = np.abs(got - _umeyama64(cov, mu_s, mu_d))
    assert gap[..., :d, :d].max() <= 1e-6, gap[..., :d, :d].max()
    assert gap[..., :d, d].max() <= 5e-6, gap[..., :d, d].max()
    if case == "reflecting":  # the plain SVD alone would reflect
        U, _, Vt = np.linalg.svd(cov.astype(np.float64))
        assert (np.linalg.det(U @ Vt) < 0).all()
    if case == "zero":
        assert (got[..., :d, :d] == np.eye(d, dtype=np.float32)).all()


def test_rigid_from_stats_ref_collinear_is_a_rotation():
    """Rank <= D-2 at D = 3 (collinear inliers; at D = 2 only cov = 0,
    tested above): no unique rotation, so only a finite proper one is
    required."""
    rng = np.random.default_rng(5)
    a, b = rng.normal(size=(2, 16, 3))
    cov = (a[:, :, None] * b[:, None, :]).astype(np.float32)
    mu = rng.normal(size=(2, 16, 3)).astype(np.float32)
    T = tp2p.rigid_from_stats_ref(_t(cov), _t(mu[0]), _t(mu[1])).numpy()
    _assert_proper(T, 3)


def test_rigid_from_stats_takes_the_plain_version_on_the_cpu():
    cov, mu_s, mu_d = (_t(a) for a in _stats("batch_16", 3))
    before = tp2p.rigid_from_stats.launches
    got = tp2p.rigid_from_stats(cov, mu_s, mu_d)
    assert torch.equal(got, tp2p.rigid_from_stats_ref(cov, mu_s, mu_d))
    assert tp2p.rigid_from_stats.launches == before
    with pytest.raises(ValueError):  # neither all CPU nor all CUDA
        tp2p.rigid_from_stats(cov.to("meta"), mu_s.to("meta"),
                              mu_d.to("meta"))


def _trip_problem(d):
    """One source of 300 points in a box against two moved, noisy copies
    (a yaw, in 3D also a tilt), four initial yaws each (B = 8, G = 4): the
    rows converge after different counts."""
    rng = np.random.default_rng(20 + d)
    src = rng.uniform(-5, 5, (300, d))
    targets = []
    for _ in range(2):
        yaw, tilt = rng.uniform(-0.2, 0.2, 2)
        R = np.eye(d)
        R[:2, :2] = [[np.cos(yaw), -np.sin(yaw)], [np.sin(yaw), np.cos(yaw)]]
        if d == 3:
            R = R @ [[1, 0, 0], [0, np.cos(tilt), -np.sin(tilt)],
                     [0, np.sin(tilt), np.cos(tilt)]]
        moved = (src @ R.T + rng.uniform(-0.5, 0.5, d)
                 + rng.normal(size=src.shape) * 0.02)
        targets.append(np.asarray(jpc.make(moved.astype(np.float32),
                                           320).points))
    yaws = np.tile(np.asarray([0.0, 0.15, -0.25, 0.4]), 2)
    inits = np.tile(np.eye(d + 1, dtype=np.float32), (8, 1, 1))
    c, s = np.cos(yaws), np.sin(yaws)
    inits[:, 0, 0], inits[:, 0, 1], inits[:, 1, 0], inits[:, 1, 1] = \
        c, -s, s, c
    return jpc.make(src.astype(np.float32), 320), np.stack(targets), inits


TRIP_CFG = ICPConfig(method="point_to_point", max_iters=40, tol=1e-6,
                     nn_backend="xla", max_corr_dist=3.0, huber_delta=1.0,
                     min_inliers=20)


@pytest.mark.parametrize("d", [3, 2])
def test_batched_trip_matches_vmapped_reference(d):
    srcp, targets, inits = _trip_problem(d)
    group = inits.shape[0] // targets.shape[0]
    src = tpc.PointCloud(points=_t(srcp.points), mask=_t(srcp.mask))
    T0 = _t(inits)
    trip = tloop._batched_trip(tloop._batched_step(
        TRIP_CFG, src, _t(targets), torch.ones(targets.shape[:2], dtype=bool),
        T0, None))
    state = trip(tloop._init_state(T0), 0)  # trip 0: Anderson's first arm
    trips = 1
    while trips < TRIP_CFG.max_iters and not bool(state[3].all()):
        state = trip(state, 1)
        trips += 1
    T, rmse, n_inl, converged, _, _, iters = state

    jcfg = JICPConfig(**dataclasses.asdict(TRIP_CFG))
    mask = jnp.ones(targets.shape[1], bool)
    ref = jax.vmap(lambda t, p: jloop.align(
        srcp, jpc.PointCloud(points=p, mask=mask), t, cfg=jcfg))(
        jnp.asarray(inits), jnp.asarray(np.repeat(targets, group, 0)))
    np.testing.assert_array_equal(iters.numpy(), np.asarray(ref.iters))
    np.testing.assert_array_equal(n_inl.numpy(), np.asarray(ref.n_inliers))
    np.testing.assert_array_equal(converged.numpy(),
                                  np.asarray(ref.converged))
    np.testing.assert_allclose(T.numpy(), np.asarray(ref.T), atol=1e-5)
    np.testing.assert_allclose(rmse.numpy(), np.asarray(ref.rmse), atol=1e-5)
    assert trips == int(iters.max()) and len(set(iters.tolist())) > 1, iters
    res = tloop.align_batched(src, _t(targets),
                              torch.ones(targets.shape[:2], dtype=bool), T0,
                              TRIP_CFG)
    for got, want in zip((res.T, res.rmse, res.n_inliers, res.converged,
                          res.iters), (T, rmse, n_inl, converged, iters)):
        assert torch.equal(got, want)


def test_trip_graph_buffers_follow_each_call():
    """The graph runner's trip over its static buffers, run eagerly as the
    capture records it, equals the trip function on each call's own
    tensors bit for bit, call after call with other inputs: nothing the
    trip reads is a copy made when it was built."""
    runner = None
    for d in (3, 3, 2):
        srcp, targets, inits = _trip_problem(d)
        if d == 3 and runner is not None:
            inits = inits[::-1].copy()  # another call, other inputs
            targets = targets[::-1].copy()
        src = tpc.PointCloud(points=_t(srcp.points), mask=_t(srcp.mask))
        T0 = _t(inits)
        if runner is None or d == 2:
            runner = tloop._TripGraph(TRIP_CFG, 8, 4, 320, 320, d,
                                      torch.float32, torch.device("cpu"))
        trip = tloop._batched_trip(tloop._batched_step(
            TRIP_CFG, src, _t(targets),
            torch.ones(targets.shape[:2], dtype=bool), T0, None))
        want = trip(tloop._init_state(T0), 0)
        runner.start(src, _t(targets), T0, None)
        for _ in range(6):
            for a, b in zip(runner.state, want):
                assert torch.equal(a, b)
            want = trip(want, 1)
            runner.step()
