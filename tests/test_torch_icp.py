"""Parity of the torch port's point-to-plane ICP (normal equations, damped
solve, GN step, the iteration loop) with the JAX reference."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_icp_slam.config import ICPConfig
from tpu_icp_slam.core import pointcloud as jpc
from tpu_icp_slam.datasets import synthetic
from tpu_icp_slam.icp import loop as jloop
from tpu_icp_slam.icp import point_to_plane as jp2p
from tpu_icp_slam.mapping.normals import normals_knn as j_normals
from tpu_icp_slam_torch.core import pointcloud as tpc
from tpu_icp_slam_torch.icp import loop as tloop
from tpu_icp_slam_torch.icp import point_to_plane as tp2p


def _system(seed, m=500):
    rng = np.random.default_rng(seed)
    p = rng.uniform(-20, 20, (m, 3)).astype(np.float32)
    q = (p + 0.05 * rng.standard_normal((m, 3))).astype(np.float32)
    n = rng.standard_normal((m, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    w = rng.uniform(0, 1, m).astype(np.float32)
    return p, q, n, w


@pytest.mark.parametrize("case", ["plain", "prior", "clamped"])
def test_solve_increment_matches_reference(case):
    p, q, n, w = _system(seed=7)
    H, g = jp2p.build_normal_equations(*map(jnp.asarray, (p, q, n, w)))
    H, g = np.asarray(H), np.asarray(g)
    kw = dict(damping=1e-3)
    if case == "prior":
        kw.update(prior_w=np.full(6, 40.0, np.float32),
                  xi_prior=np.linspace(-0.1, 0.1, 6).astype(np.float32))
    if case == "clamped":
        kw.update(max_step_trans=1e-3, max_step_rot=1e-4)
    a = np.asarray(jp2p.solve_increment(
        jnp.asarray(H), jnp.asarray(g),
        **{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()}))
    b = tp2p.solve_increment(
        torch.from_numpy(H), torch.from_numpy(g),
        **{k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()}).numpy()
    np.testing.assert_allclose(b, a, atol=1e-5)
    assert np.abs(a).max() > 1e-5  # not trivially zero


@pytest.mark.parametrize("H", [np.zeros((6, 6), np.float32),
                               -np.eye(6, dtype=np.float32)])
def test_solve_increment_singular_gives_zero_update(H):
    g = np.ones(6, np.float32)
    a = np.asarray(jp2p.solve_increment(jnp.asarray(H), jnp.asarray(g), 0.0))
    b = tp2p.solve_increment(torch.from_numpy(H), torch.from_numpy(g), 0.0)
    np.testing.assert_array_equal(a, np.zeros(6))
    np.testing.assert_array_equal(b.numpy(), np.zeros(6))


@pytest.mark.parametrize("backend", ["auto", "xla"])
def test_gauss_newton_step_matches_reference(backend):
    p, q, n, w = _system(seed=8)
    a = np.asarray(jp2p.gauss_newton_step(
        *map(jnp.asarray, (p, q, n, w)), damping=1e-3, max_step_trans=1.0,
        max_step_rot=0.3, backend="xla"))
    b = tp2p.gauss_newton_step(
        *map(torch.from_numpy, (p, q, n, w)), damping=1e-3,
        max_step_trans=1.0, max_step_rot=0.3, backend=backend).numpy()
    np.testing.assert_allclose(b, a, atol=1e-5)


def _align_pair():
    src, dst, T_gt = synthetic.two_scan_pair(n=1024, seed=3, noise=0.002,
                                             rot_scale=0.1, trans_scale=0.3)
    src, dst = src.astype(np.float32), dst.astype(np.float32)
    nrm = np.asarray(j_normals(jnp.asarray(dst), jnp.ones(len(dst), bool),
                               k=8)).astype(np.float32)
    return src, dst, nrm, T_gt


_CFG = ICPConfig(method="point_to_plane", max_iters=30, tol=1e-7,
                 max_corr_dist=1.0, damping=1e-6, huber_delta=0.3,
                 nn_backend="xla", step_scale=1.2, tol_update=1e-4,
                 prior_trans_weight=1e-3, prior_rot_weight=1e-2,
                 max_total_trans=1.0, max_total_rot=0.5, min_inliers=20)


def test_align_matches_reference():
    src, dst, nrm, T_gt = _align_pair()
    ra = jloop.align(jpc.make(src, 1100), jpc.make(dst, 1200, normals=nrm),
                     cfg=_CFG)
    rb = tloop.align(tpc.make(src, 1100, device="cpu"),
                     tpc.make(dst, 1200, normals=nrm, device="cpu"),
                     cfg=dataclasses.replace(_CFG, nn_backend="auto"))
    assert rb.iters == int(ra.iters)
    assert bool(rb.converged) == bool(ra.converged)
    assert int(rb.n_inliers) == int(ra.n_inliers)
    np.testing.assert_allclose(rb.T.numpy(), np.asarray(ra.T), atol=1e-4)
    np.testing.assert_allclose(float(rb.rmse), float(ra.rmse), atol=1e-5)
    np.testing.assert_allclose(rb.T.numpy(), T_gt, atol=5e-3)


def test_align_max_iters_cap_matches_reference():
    src, dst, nrm, _ = _align_pair()
    cfg = dataclasses.replace(_CFG, max_iters=2, tol=0.0, tol_update=0.0)
    ra = jloop.align(jpc.make(src), jpc.make(dst, normals=nrm), cfg=cfg)
    rb = tloop.align(tpc.make(src, device="cpu"),
                     tpc.make(dst, normals=nrm, device="cpu"), cfg=cfg)
    assert rb.iters == int(ra.iters) == 2
    np.testing.assert_allclose(rb.T.numpy(), np.asarray(ra.T), atol=1e-5)


@pytest.mark.parametrize("override", [
    {"method": "projective"}, {"anderson": True}, {"unroll_iters": 4},
    {"degen_eps": 0.01}, {"nn_backend": "voxel"},
])
def test_unported_icp_options_raise(override):
    """No ICP option is refused any more: the projective method (in align,
    the reference's point-to-point Umeyama branch), anderson, unroll_iters,
    degen_eps and the voxel backend run, and match the reference's align
    under the same config: equal iterations and inliers, T within 1e-4."""
    src, dst, nrm, _ = _align_pair()
    cfg = dataclasses.replace(_CFG, **override)
    ra = jloop.align(jpc.make(src, 1100), jpc.make(dst, 1200, normals=nrm),
                     cfg=cfg)
    rb = tloop.align(tpc.make(src, 1100, device="cpu"),
                     tpc.make(dst, 1200, normals=nrm, device="cpu"), cfg=cfg)
    assert int(rb.iters) == int(ra.iters)
    assert int(rb.n_inliers) == int(ra.n_inliers)
    np.testing.assert_allclose(rb.T.numpy(), np.asarray(ra.T), atol=1e-4)
