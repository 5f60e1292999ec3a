"""The port's copies of the reference's small public helpers, held to the
reference (inputs made from seeds with numpy): se3.identity/compose,
pointcloud.count/fill_invalid/valid_points_np/round_up, the adversarial 2D
scenes of tests/test_adversarial.py (synthetic.aliased_world_segments,
aliased_racetrack_segments, racetrack_waypoints, crossing_pedestrian) and
native.polar_to_cartesian bit for bit; se3.apply and pointcloud.transform,
the same expressions, within the rounding of their products (XLA's and
torch's small matrix products round differently: measured 1.8e-15 in
float64, 4.8e-7 m in float32 on points within 5 m)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_icp_slam import native as jnative
from tpu_icp_slam.core import pointcloud as jpc
from tpu_icp_slam.core import se3 as jse3
from tpu_icp_slam.datasets import synthetic as jsyn
from tpu_icp_slam_torch import native, synthetic
from tpu_icp_slam_torch.core import pointcloud as pc
from tpu_icp_slam_torch.core import se3


def _poses(rng, n):
    return np.stack([jsyn.rigid_transform(3, rng) for _ in range(n)])


@pytest.mark.parametrize("batch", [(), (3,), (2, 2)])
def test_se3_identity(batch):
    for jd, td in ((jnp.float32, torch.float32), (jnp.float64, torch.float64)):
        want = np.asarray(jse3.identity(jd, batch))
        got = se3.identity(td, batch, device="cpu").numpy()
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_se3_compose_and_apply():
    rng = np.random.default_rng(0)
    A, B = _poses(rng, 5), _poses(rng, 5)
    pts = rng.uniform(-5, 5, (5, 40, 3))
    np.testing.assert_array_equal(
        se3.compose(torch.as_tensor(A), torch.as_tensor(B)).numpy(),
        np.asarray(jse3.compose(jnp.asarray(A), jnp.asarray(B))))
    got = se3.apply(torch.as_tensor(A), torch.as_tensor(pts)).numpy()
    want = np.asarray(jse3.apply(jnp.asarray(A), jnp.asarray(pts)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-14)
    got1 = se3.apply(torch.as_tensor(A[0]), torch.as_tensor(pts[0])).numpy()
    np.testing.assert_allclose(got1, want[0], rtol=0, atol=1e-14)


def _clouds(rng, normals):
    pts = rng.uniform(-5, 5, (37, 3))
    nrm = rng.standard_normal((37, 3)) if normals else None
    return (pc.make(pts, 64, normals=nrm, device="cpu"),
            jpc.make(pts, 64, normals=nrm, dtype=jnp.float32))


@pytest.mark.parametrize("normals", [False, True])
def test_pointcloud_helpers(normals):
    rng = np.random.default_rng(1)
    t, j = _clouds(rng, normals)
    assert int(pc.count(t)) == int(jpc.count(j)) == 37
    # a cloud whose padded slots were overwritten: fill_invalid re-pins them
    t_bad = pc.PointCloud(points=t.points.clone().fill_(3.0), mask=t.mask,
                          normals=t.normals)
    j_bad = jpc.PointCloud(points=jnp.full((64, 3), 3.0, jnp.float32),
                           mask=j.mask, normals=j.normals)
    np.testing.assert_array_equal(pc.fill_invalid(t_bad).points.numpy(),
                                  np.asarray(jpc.fill_invalid(j_bad).points))
    T = jsyn.rigid_transform(3, rng).astype(np.float32)
    tt = pc.transform(torch.as_tensor(T), t)
    jt = jpc.transform(jnp.asarray(T), j)
    np.testing.assert_array_equal(tt.mask.numpy(), np.asarray(jt.mask))
    np.testing.assert_allclose(tt.points.numpy(), np.asarray(jt.points),
                               rtol=1e-6, atol=1e-6)
    assert np.all(tt.points.numpy()[37:] == pc.PAD_COORD)
    if normals:
        np.testing.assert_allclose(tt.normals.numpy(),
                                   np.asarray(jt.normals), atol=1e-6)
        assert np.all(tt.normals.numpy()[37:] == 0.0)
    else:
        assert tt.normals is None and jt.normals is None
    np.testing.assert_array_equal(pc.valid_points_np(t),
                                  jpc.valid_points_np(j))
    for n, m in ((0, 8), (1, 8), (8, 8), (9, 8), (1000, 128), (7, 1)):
        assert pc.round_up(n, m) == jpc.round_up(n, m)


@pytest.mark.parametrize("kw", [{}, {"n_bays": 3, "bay_len": 5.0,
                                     "corridor_half_w": 1.5}])
def test_aliased_world_segments(kw):
    np.testing.assert_array_equal(synthetic.aliased_world_segments(**kw),
                                  jsyn.aliased_world_segments(**kw))


@pytest.mark.parametrize("kw", [{}, {"n_bays": 4, "bay_len": 6.0}])
def test_aliased_racetrack_segments(kw):
    np.testing.assert_array_equal(synthetic.aliased_racetrack_segments(**kw),
                                  jsyn.aliased_racetrack_segments(**kw))


@pytest.mark.parametrize("laps", [1, 3])
def test_racetrack_waypoints(laps):
    np.testing.assert_array_equal(synthetic.racetrack_waypoints(laps),
                                  jsyn.racetrack_waypoints(laps))
    np.testing.assert_array_equal(
        synthetic.racetrack_waypoints(laps, half_len=7.5),
        jsyn.racetrack_waypoints(laps, half_len=7.5))


def test_crossing_pedestrian():
    fa = synthetic.crossing_pedestrian(20, y0=-2.0, size=0.5)
    fb = jsyn.crossing_pedestrian(20, y0=-2.0, size=0.5)
    for f in (0, 7, 19):
        np.testing.assert_array_equal(fa(f), fb(f))
    np.testing.assert_array_equal(synthetic.crossing_pedestrian(1)(0),
                                  jsyn.crossing_pedestrian(1)(0))


def test_polar_to_cartesian():
    rng = np.random.default_rng(2)
    ranges = rng.uniform(0.1, 12.0, 360)
    ranges[::7] = 12.0  # misses at max range are dropped
    angles = np.linspace(-np.pi, np.pi, 360, endpoint=False)
    got = native.polar_to_cartesian(ranges, angles, 12.0)
    want = jnative.polar_to_cartesian(ranges, angles, 12.0)
    assert got is not None and want is not None
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(
        got, synthetic.scan_to_points(ranges, angles, 12.0), rtol=0,
        atol=1e-12)
