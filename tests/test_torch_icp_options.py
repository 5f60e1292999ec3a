"""The ICP options of the torch port against the JAX reference on the same
numpy inputs (the reference on the CPU, NN on "xla"): SE(2) `align` and
`align_batched`, and the cases of tests/test_icp.py:175-280 (anderson,
unroll_iters, degen_eps) in 3D and, for anderson and unroll, in 2D.

Tolerances: equal iterations and inliers; T within 1e-4 (measured up to
4.6e-5 in 2D, 1e-6 in 3D). Point-to-point on samples of walls is weakly
curved along the walls, so float32-level differences (the reference's
factored NN score, sums in another order) move the converged 2D
translation by 1e-5.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_icp_slam.config import ICPConfig as JICPConfig
from tpu_icp_slam.core import pointcloud as jpc
from tpu_icp_slam.datasets import synthetic as jsyn
from tpu_icp_slam.icp import loop as jloop
from tpu_icp_slam.icp.point_to_plane import solve_increment as j_solve
from tpu_icp_slam_torch.config import ICPConfig
from tpu_icp_slam_torch.core import pointcloud as tpc
from tpu_icp_slam_torch.icp import loop as tloop
from tpu_icp_slam_torch.icp.point_to_plane import solve_increment


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread a worker: the suite runs files in parallel."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


# ---- SE(2) ICP ---------------------------------------------------------------

P2P = ICPConfig(method="point_to_point", max_iters=30, tol=1e-6,
                nn_backend="xla", max_corr_dist=1.0, step_scale=1.2,
                tol_update=1e-4, huber_delta=0.3, min_inliers=20)


def _jcfg(cfg):
    return JICPConfig(**dataclasses.asdict(cfg))


def _pair2d(seed=3, n=600):
    src, dst, T_gt = jsyn.two_scan_pair(n=n, seed=seed, dim=2,
                                        rot_scale=0.1, trans_scale=0.3)
    return src.astype(np.float32), dst.astype(np.float32), T_gt


def _align_both(cfg, src, dst, nrm=None, init=None):
    ra = jloop.align(jpc.make(src, 640), jpc.make(dst, 700, normals=nrm),
                     None if init is None else jnp.asarray(init),
                     cfg=_jcfg(cfg))
    rb = tloop.align(tpc.make(src, 640, device="cpu"),
                     tpc.make(dst, 700, normals=nrm, device="cpu"),
                     None if init is None else _t(init), cfg=cfg)
    return ra, rb


@pytest.mark.parametrize("variant", ["plain", "trust_region", "anderson",
                                     "unroll", "point_to_plane"])
def test_se2_align_matches_reference(variant):
    src, dst, T_gt = _pair2d()
    cfg, nrm = P2P, None
    if variant == "trust_region":
        cfg = dataclasses.replace(cfg, max_total_trans=0.2,
                                  max_total_rot=0.05)
    elif variant == "anderson":
        cfg = dataclasses.replace(cfg, anderson=True, step_scale=1.0)
    elif variant == "unroll":
        cfg = dataclasses.replace(cfg, unroll_iters=30)
    elif variant == "point_to_plane":
        # normals of the L-shaped room from the local segment direction
        cfg = dataclasses.replace(cfg, method="point_to_plane", damping=1e-6,
                                  prior_trans_weight=1e-3,
                                  prior_rot_weight=1e-2)
        tang = np.gradient(dst, axis=0)
        nrm = np.stack([-tang[:, 1], tang[:, 0]], 1)
        nrm = (nrm / np.linalg.norm(nrm, axis=1, keepdims=True)).astype(
            np.float32)
    ra, rb = _align_both(cfg, src, dst, nrm)
    assert rb.T.shape == (3, 3)
    assert int(rb.iters) == int(ra.iters)
    assert int(rb.n_inliers) == int(ra.n_inliers)
    assert bool(rb.converged) == bool(ra.converged)
    np.testing.assert_allclose(rb.T.numpy(), np.asarray(ra.T), atol=1e-4)
    # the pair is noise-free: at convergence the rmse is float32 rounding
    # of ~10 m coordinates (~2e-4 m), and its last digits differ
    np.testing.assert_allclose(float(rb.rmse), float(ra.rmse), atol=1e-4)
    if variant in ("plain", "anderson", "unroll"):
        np.testing.assert_allclose(rb.T.numpy(), T_gt, atol=5e-3)


def test_se2_align_batched_matches_reference():
    """align_batched on 2-D clouds (Slam2D's verification form) against the
    reference's align of each (target, initial yaw) pair."""
    src, dst, _ = _pair2d(seed=5)
    rng = np.random.default_rng(5)
    dst2 = np.stack([dst, (dst @ np.array([[0.0, -1.0], [1.0, 0.0]]).T
                           + rng.normal(size=dst.shape) * 0.01)]
                    ).astype(np.float32)
    targets = np.stack([np.asarray(jpc.make(d, 700).points) for d in dst2])
    yaws = np.asarray([0.0, 0.3, np.pi / 2, 1.4], np.float32)
    c, s = np.cos(yaws), np.sin(yaws)
    inits = np.zeros((4, 3, 3), np.float32)
    inits[:, 0, 0], inits[:, 0, 1], inits[:, 1, 0], inits[:, 1, 1] = c, -s, s, c
    inits[:, 2, 2] = 1.0
    cfg = dataclasses.replace(P2P, max_corr_dist=3.0, huber_delta=1.0)
    srcp = jpc.make(src, 640)
    res = tloop.align_batched(
        tpc.PointCloud(points=_t(srcp.points), mask=_t(srcp.mask)),
        _t(targets), torch.ones(2, 700, dtype=torch.bool), _t(inits), cfg)
    assert res.T.shape == (4, 3, 3)
    for b in range(4):
        ra = jloop.align(srcp, jpc.PointCloud(
            points=jnp.asarray(targets[b // 2]),
            mask=jnp.ones(700, bool)), jnp.asarray(inits[b]), cfg=_jcfg(cfg))
        assert int(res.iters[b]) == int(ra.iters)
        assert int(res.n_inliers[b]) == int(ra.n_inliers)
        np.testing.assert_allclose(res.T[b].numpy(), np.asarray(ra.T),
                                   atol=1e-4)


# ---- tests/test_icp.py:175-280 ---------------------------------------------


@pytest.mark.parametrize("dim", [3, 2])
def test_anderson_acceleration_matches_reference(dim):
    """test_align_anderson_acceleration: AA(1) converges to the plain
    transform, in no more than two iterations beyond plain ICP, and to the
    reference's result."""
    # with 5 mm of noise: on the noise-free pair the rmse sits at float32
    # rounding, where the tol test decides by the last bits
    src, dst, T_gt = jsyn.two_scan_pair(n=1000, seed=11, rot_scale=0.15,
                                        trans_scale=0.3, dim=dim, noise=0.005)
    plain = ICPConfig(max_iters=50, nn_backend="xla")
    aa = dataclasses.replace(plain, anderson=True)
    outs = {}
    for name, cfg in (("plain", plain), ("aa", aa)):
        ra = jloop.align(jpc.make(src, 1024), jpc.make(dst, 1024),
                         cfg=_jcfg(cfg))
        rb = tloop.align(tpc.make(src, 1024, device="cpu"),
                         tpc.make(dst, 1024, device="cpu"), cfg=cfg)
        assert int(rb.iters) == int(ra.iters), name
        np.testing.assert_allclose(rb.T.numpy(), np.asarray(ra.T), atol=1e-4)
        outs[name] = rb
    assert float(np.abs(outs["aa"].T.numpy() - T_gt).max()) < 2e-3
    assert int(outs["aa"].iters) <= int(outs["plain"].iters) + 2


@pytest.mark.parametrize("dim", [3, 2])
def test_unrolled_matches_while_loop(dim):
    """test_unrolled_matches_while_loop: the fixed-trip frozen form equals
    the host loop, and the reference's unrolled form; its iters is a
    tensor (no host read inside the trip)."""
    s, d, _ = jsyn.two_scan_pair(n=256, seed=7, rot_scale=0.15,
                                 trans_scale=0.2, dim=dim)
    base = ICPConfig(max_iters=25, tol=1e-6, nn_backend="xla")
    unr = dataclasses.replace(base, unroll_iters=25)
    a = [tpc.make(s, 256, device="cpu"), tpc.make(d, 256, device="cpu")]
    res_w = tloop.align(*a, cfg=base)
    res_u = tloop.align(*a, cfg=unr)
    ref_u = jloop.align(jpc.make(s, 256), jpc.make(d, 256), cfg=_jcfg(unr))
    assert torch.is_tensor(res_u.iters)
    np.testing.assert_allclose(res_u.T.numpy(), res_w.T.numpy(), rtol=1e-6,
                               atol=1e-7)
    assert int(res_u.iters) == int(res_w.iters) == int(ref_u.iters)
    assert bool(res_u.converged) == bool(res_w.converged)
    np.testing.assert_allclose(res_u.T.numpy(), np.asarray(ref_u.T),
                               atol=1e-4)


@pytest.mark.parametrize("dim", [3, 2])
def test_unrolled_honors_max_iters(dim):
    s, d, _ = jsyn.two_scan_pair(n=256, seed=8, rot_scale=0.15,
                                 trans_scale=0.2, dim=dim)
    base = ICPConfig(max_iters=5, tol=0.0, nn_backend="xla")  # never converges
    a = [tpc.make(s, 256, device="cpu"), tpc.make(d, 256, device="cpu")]
    res_w = tloop.align(*a, cfg=base)
    res_u = tloop.align(*a, cfg=dataclasses.replace(base, unroll_iters=10))
    ref = jloop.align(jpc.make(s, 256), jpc.make(d, 256), cfg=_jcfg(
        dataclasses.replace(base, unroll_iters=10)))
    assert int(res_u.iters) == int(res_w.iters) == int(ref.iters) == 5
    np.testing.assert_allclose(res_u.T.numpy(), res_w.T.numpy(), rtol=1e-6,
                               atol=1e-7)


def test_degen_remapping_zeroes_unobserved_direction():
    """test_degen_remapping_zeroes_unobserved_direction, and the remapped
    solve against the reference's on the same float32 system."""
    diag = np.array([1e-6, 50.0, 40.0, 900.0, 800.0, 700.0], np.float64)
    rng = np.random.default_rng(3)
    Q, _ = np.linalg.qr(rng.standard_normal((6, 6)))
    H = (Q * diag) @ Q.T
    xi_true = np.array([0.0, 0.2, -0.1, 0.01, -0.02, 0.03])
    g = -(H @ xi_true)
    H32, g32 = H.astype(np.float32), g.astype(np.float32)
    xi = solve_increment(_t(H32), _t(g32), damping=1e-6,
                         degen_eps=1e-3).numpy().astype(np.float64)
    null_dir = Q[:, 0]
    assert abs(xi @ null_dir) < 1e-4, xi @ null_dir
    proj = np.eye(6) - np.outer(null_dir, null_dir)
    np.testing.assert_allclose(proj @ xi, proj @ xi_true, atol=5e-3)
    ref = np.asarray(j_solve(jnp.asarray(H32), jnp.asarray(g32),
                             damping=1e-6, degen_eps=1e-3))
    np.testing.assert_allclose(xi, ref, atol=1e-5)
    xi0 = solve_increment(_t(H32), _t(g32), damping=1e-6).numpy()
    assert np.isfinite(xi0).all()
    # with the prior and the clamps, as the loop calls it
    kw = dict(damping=1e-3, degen_eps=0.02, max_step_trans=0.1,
              max_step_rot=0.01)
    pw = np.full(6, 5.0, np.float32)
    xp = np.linspace(-0.05, 0.05, 6).astype(np.float32)
    a = solve_increment(_t(H32), _t(g32), prior_w=_t(pw), xi_prior=_t(xp),
                        **kw).numpy()
    b = np.asarray(j_solve(jnp.asarray(H32), jnp.asarray(g32),
                           prior_w=jnp.asarray(pw),
                           xi_prior=jnp.asarray(xp), **kw))
    np.testing.assert_allclose(a, b, atol=1e-6)
