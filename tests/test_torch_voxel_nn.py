"""kernels/voxel_nn.py of the torch port (`icp.nn_backend="voxel"`) against
the reference's hash grid on the same numpy inputs: the cases of
tests/test_voxel_nn.py on the port, the grid's table equal to the
reference's entry for entry, and queries equal (indices; d2 within 1e-6
relative, float32 sums of three squares in another order). A batched
align on the voxel backend equals the unbatched one within 1e-5 (batched
and unbatched float32 reductions round apart).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_icp_slam.config import ICPConfig as JICPConfig
from tpu_icp_slam.core import pointcloud as jpc
from tpu_icp_slam.datasets import synthetic
from tpu_icp_slam.icp import loop as jloop
from tpu_icp_slam.kernels import voxel_nn as jvnn
from tpu_icp_slam_torch.config import ICPConfig
from tpu_icp_slam_torch.core import pointcloud as tpc
from tpu_icp_slam_torch.icp import loop as tloop
from tpu_icp_slam_torch.kernels import nn_cuda, voxel_nn


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread a worker: the suite runs files in parallel."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def _agree(idx_v, d2_v, idx_b, d2_b):
    return (idx_v == idx_b) | np.isclose(d2_v, d2_b, rtol=1e-5, atol=1e-7)


def test_voxel_nn_matches_bruteforce_within_gate():
    rng = np.random.default_rng(0)
    dst = synthetic.surface_cloud(3000, rng)
    src = (dst[rng.integers(0, 3000, 1000)]
           + 0.2 * rng.standard_normal((1000, 3))).astype(np.float32)
    cl = tpc.make(dst, capacity=3072, device="cpu")
    grid = voxel_nn.build(cl.points, cl.mask, voxel=1.0, bucket=64)
    idx_v, d2_v = voxel_nn.query(grid, _t(src), voxel=1.0)
    idx_b, d2_b = nn_cuda.nn_bruteforce_ref(_t(src), cl.points)
    in_gate = d2_b.numpy() <= 1.0
    assert in_gate.mean() > 0.95
    agree = _agree(idx_v.numpy(), d2_v.numpy(), idx_b.numpy(), d2_b.numpy())
    assert agree[in_gate].mean() > 0.995, agree[in_gate].mean()


def test_voxel_nn_no_candidates_is_inf():
    cl = tpc.make(np.zeros((4, 3), np.float32), capacity=8, device="cpu")
    grid = voxel_nn.build(cl.points, cl.mask, voxel=0.5, table_size=256,
                          bucket=4)
    idx, d2 = voxel_nn.query(grid, torch.tensor([[100.0, 100.0, 100.0]]),
                             voxel=0.5)
    assert torch.isinf(d2[0]) and int(idx[0]) == 0


@pytest.mark.parametrize("dim", [3, 2])
def test_voxel_grid_and_queries_equal_reference(dim):
    """Table entry for entry (the same hash, stable sort and bucket
    positions), then the same candidates and picks."""
    rng = np.random.default_rng(5)
    dst = rng.uniform(-8, 8, (800, dim)).astype(np.float32)
    src = (dst[rng.integers(0, 800, 300)]
           + 0.1 * rng.standard_normal((300, dim))).astype(np.float32)
    src[:5] -= 40.0  # far off: only hash-aliased buckets, if any
    jcl = jpc.make(dst, capacity=1024, dtype=jnp.float32)
    tcl = tpc.make(dst, capacity=1024, device="cpu")
    jg = jvnn.build(jcl.points, jcl.mask, voxel=0.8, table_size=4096,
                    bucket=8)
    tg = voxel_nn.build(tcl.points, tcl.mask, voxel=0.8, table_size=4096,
                        bucket=8)
    np.testing.assert_array_equal(tg.table.numpy(), np.asarray(jg.table))
    ji, jd = jvnn.query(jg, jnp.asarray(src), voxel=0.8)
    ti, td = voxel_nn.query(tg, _t(src), voxel=0.8)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-6,
                               atol=1e-6)


def test_voxel_nn_2d():
    rng = np.random.default_rng(5)
    dst = rng.uniform(-8, 8, (800, 2))
    src = (dst[rng.integers(0, 800, 300)]
           + 0.1 * rng.standard_normal((300, 2))).astype(np.float32)
    cl = tpc.make(dst, capacity=1024, device="cpu")
    grid = voxel_nn.build(cl.points, cl.mask, voxel=0.8, bucket=32)
    idx_v, d2_v = voxel_nn.query(grid, _t(src), voxel=0.8)
    idx_b, d2_b = nn_cuda.nn_bruteforce_ref(_t(src), cl.points)
    in_gate = d2_b.numpy() <= 0.64
    agree = _agree(idx_v.numpy(), d2_v.numpy(), idx_b.numpy(), d2_b.numpy())
    assert agree[in_gate].mean() > 0.99


def test_voxel_backend_in_icp():
    """test_voxel_backend_in_icp on the port, and its transform against the
    reference's (within 1e-5), in align and align_batched."""
    src, dst, T_gt = synthetic.two_scan_pair(n=1500, seed=3, rot_scale=0.05,
                                             trans_scale=0.2)
    cfg = ICPConfig(method="point_to_point", max_iters=40, max_corr_dist=1.5,
                    nn_backend="voxel", voxel_table_size=4096,
                    voxel_bucket=32)
    cs = tpc.make(src, capacity=1536, device="cpu")
    cd = tpc.make(dst, capacity=1536, device="cpu")
    res = tloop.align(cs, cd, cfg=cfg)
    assert np.abs(res.T.numpy() - T_gt).max() < 5e-3
    ref = jloop.align(jpc.make(src, 1536), jpc.make(dst, 1536),
                      cfg=JICPConfig(**dataclasses.asdict(cfg)))
    assert int(res.iters) == int(ref.iters)
    np.testing.assert_allclose(res.T.numpy(), np.asarray(ref.T), atol=1e-5)
    batched = tloop.align_batched(cs, cd.points[None], cd.mask[None],
                                  torch.eye(4).repeat(2, 1, 1), cfg)
    for b in range(2):
        assert int(batched.iters[b]) == int(res.iters)
        np.testing.assert_allclose(batched.T[b].numpy(), res.T.numpy(),
                                   atol=1e-5)
