"""core/se2 of the torch port against the JAX reference: the cases of
tests/test_se2.py on the port, and each function on the same numpy inputs
in both packages (float64; agreement to 1e-12, the last bits of a cos/sin
or atan2 that the two libraries may round apart)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_icp_slam.core import se2 as jse2
from tpu_icp_slam_torch.core import se2


def _xi(seed, n=64, lo=-2.0, hi=2.0):
    return np.random.default_rng(seed).uniform(lo, hi, size=(n, 3))


def test_exp_log_roundtrip():
    xi = torch.from_numpy(_xi(0))
    np.testing.assert_allclose(se2.log(se2.exp(xi)).numpy(), xi.numpy(),
                               atol=1e-10)


def test_small_angle():
    xi = torch.tensor([[0.3, -0.2, 1e-9], [0.0, 0.0, 0.0]],
                      dtype=torch.float64)
    np.testing.assert_allclose(se2.log(se2.exp(xi)).numpy(), xi.numpy(),
                               atol=1e-12)


def test_compose_inverse():
    T = se2.exp(torch.from_numpy(_xi(1, 8)))
    eye = se2.compose(T, se2.inverse(T)).numpy()
    np.testing.assert_allclose(eye, np.broadcast_to(np.eye(3), (8, 3, 3)),
                               atol=1e-12)


def test_apply():
    T = se2.from_xytheta(1.0, 2.0, np.pi / 2)
    out = se2.apply(T, torch.tensor([[1.0, 0.0]])).numpy()
    np.testing.assert_allclose(out, [[1.0, 3.0]], atol=1e-6)


def test_to_se3_embedding():
    T2 = se2.exp(torch.from_numpy(_xi(2, 5, -1.0, 1.0)))
    T3 = se2.to_se3(T2).numpy()
    assert T3.shape == (5, 4, 4)
    np.testing.assert_allclose(T3[:, :2, :2], T2[:, :2, :2].numpy())
    np.testing.assert_allclose(T3[:, :2, 3], T2[:, :2, 2].numpy())
    np.testing.assert_allclose(T3[:, 2:, 2:],
                               np.broadcast_to(np.eye(2), (5, 2, 2)))


@pytest.mark.parametrize("fn", ["exp", "log", "inverse", "to_xytheta",
                                "to_se3", "apply", "identity"])
def test_matches_reference(fn):
    xi = _xi(3, 32)
    xi[:4, 2] = [0.0, 1e-7, -3e-6, np.pi - 1e-9]  # the small-angle branch
    T = np.asarray(jse2.exp(jnp.asarray(xi)))
    pts = np.random.default_rng(4).uniform(-5, 5, (32, 7, 2))
    if fn == "exp":
        a, b = np.asarray(jse2.exp(jnp.asarray(xi))), se2.exp(
            torch.from_numpy(xi))
    elif fn == "apply":
        a = np.asarray(jse2.apply(jnp.asarray(T), jnp.asarray(pts)))
        b = se2.apply(torch.from_numpy(T), torch.from_numpy(pts))
    elif fn == "identity":
        a = np.asarray(jse2.identity(jnp.float64, (2, 4)))
        b = se2.identity(torch.float64, (2, 4))
    else:
        a = np.asarray(getattr(jse2, fn)(jnp.asarray(T)))
        b = getattr(se2, fn)(torch.from_numpy(T))
    assert tuple(b.shape) == a.shape
    np.testing.assert_allclose(b.numpy(), a, atol=1e-12)


def test_from_xytheta_matches_reference_in_float32():
    a = np.asarray(jse2.from_xytheta(1.5, -2.0, 0.7))
    b = se2.from_xytheta(1.5, -2.0, 0.7)
    assert b.dtype == torch.float32
    np.testing.assert_allclose(b.numpy(), a, atol=1e-7)
