"""Parity of the torch port's core (SE(3), padded clouds, host helpers) with
the JAX reference: the same float32 numpy inputs go to both packages."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_icp_slam.core import pointcloud as jpc
from tpu_icp_slam.core import se3 as jse3
from tpu_icp_slam.datasets import synthetic
from tpu_icp_slam.slam import runner as jrunner
from tpu_icp_slam_torch.core import pointcloud as tpc
from tpu_icp_slam_torch.core import se3 as tse3
from tpu_icp_slam_torch.slam import runner as trunner

ATOL = 1e-6  # float32 transcendental and rounding differences only


def _twists(kind: str, n: int = 64, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    rho = rng.uniform(-1, 1, (n, 3))  # metres: the scale of ICP updates
    axis = rng.standard_normal((n, 3))
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    angle = {
        "generic": rng.uniform(0.01, 3.0, n),
        "small": 10.0 ** rng.uniform(-9, -4.5, n),  # Taylor branches
        "zero": np.zeros(n),
        "near_pi": np.pi - 10.0 ** rng.uniform(-4, -2.5, n),
    }[kind]
    return np.concatenate([rho, axis * angle[:, None]], 1).astype(np.float32)


def _both(fn_name, x):
    a = np.asarray(getattr(jse3, fn_name)(jnp.asarray(x)))
    b = getattr(tse3, fn_name)(torch.from_numpy(np.array(x))).numpy()
    return a, b


@pytest.mark.parametrize("kind", ["generic", "small", "zero", "near_pi"])
def test_se3_exp_matches_reference(kind):
    a, b = _both("exp", _twists(kind))
    np.testing.assert_allclose(b, a, atol=ATOL)


@pytest.mark.parametrize("kind", ["generic", "small", "zero", "near_pi"])
def test_se3_log_matches_reference(kind):
    xi = _twists(kind, seed=1).astype(np.float64)
    T = np.asarray(jse3.exp(jnp.asarray(xi))).astype(np.float32)
    a, b = _both("log", T)
    np.testing.assert_allclose(b, a, atol=ATOL)


@pytest.mark.parametrize("fn", ["so3_exp", "so3_left_jacobian", "hat"])
def test_so3_helpers_match_reference(fn):
    phi = _twists("generic", seed=2)[:, 3:]
    a, b = _both(fn, phi)
    np.testing.assert_allclose(b, a, atol=ATOL)


def test_so3_log_vee_inverse_geodesic_match_reference():
    T = np.asarray(jse3.exp(jnp.asarray(_twists("generic", seed=3)))).astype(
        np.float32)
    a, b = _both("inverse", T)
    np.testing.assert_allclose(b, a, atol=ATOL)
    a, b = _both("so3_log", T[:, :3, :3])
    np.testing.assert_allclose(b, a, atol=ATOL)
    W = np.asarray(jse3.hat(jnp.asarray(T[:, :3, 3])))
    a, b = _both("vee", W)
    np.testing.assert_array_equal(b, a)
    Ra, Rb = T[:32, :3, :3], T[32:, :3, :3]
    ga = np.asarray(jse3.rotation_geodesic(jnp.asarray(Ra), jnp.asarray(Rb)))
    gb = tse3.rotation_geodesic(torch.as_tensor(Ra), torch.as_tensor(Rb))
    np.testing.assert_allclose(gb.numpy(), ga, atol=1e-5)


def test_se3_from_rt_broadcasts():
    R = torch.eye(3)
    t = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    T = tse3.from_rt(R, t)
    assert T.shape == (2, 4, 4)
    np.testing.assert_array_equal(T[:, :3, 3].numpy(), t.numpy())
    np.testing.assert_array_equal(T[:, 3].numpy(), [[0, 0, 0, 1]] * 2)


def test_pointcloud_make_matches_reference():
    rng = np.random.default_rng(4)
    pts = rng.uniform(-5, 5, (100, 3)).astype(np.float32)
    nrm = rng.standard_normal((100, 3)).astype(np.float32)
    for cap in (128, 64):
        a = jpc.make(pts, cap, normals=nrm)
        b = tpc.make(pts, cap, normals=nrm, device="cpu")
        np.testing.assert_array_equal(b.points.numpy(), np.asarray(a.points))
        np.testing.assert_array_equal(b.mask.numpy(), np.asarray(a.mask))
        np.testing.assert_array_equal(b.normals.numpy(), np.asarray(a.normals))
    assert tpc.PAD_COORD == jpc.PAD_COORD


def test_host_helpers_match_reference():
    scans, _ = synthetic.velodyne_log(n_frames=3, n_rings=8, n_azimuth=128)
    for s in scans:
        np.testing.assert_array_equal(tpc.voxel_downsample_np(s, 0.5),
                                      jpc.voxel_downsample_np(s, 0.5))
    for cap in (256, 2048):
        a = jrunner.pad_scans(scans, cap)
        b = trunner.pad_scans(scans, cap)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(y, x)


@pytest.mark.parametrize("fn", ["adjoint", "ad", "right_jacobian_inv"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_se3_backend_jacobians_match_reference(fn, dtype):
    """The pose graph's Jacobian pieces, in float32 and in the float64 the
    pose graph runs in (the reference's tests run with x64 on)."""
    xi = _twists("generic", seed=6).astype(dtype)
    x = np.asarray(jse3.exp(jnp.asarray(xi))) if fn == "adjoint" else xi
    a, b = _both(fn, x)
    assert b.dtype == a.dtype == dtype
    np.testing.assert_allclose(b, a, atol=ATOL if dtype == np.float32
                               else 1e-12)

