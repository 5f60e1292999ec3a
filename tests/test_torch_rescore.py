"""K4 (the rescore shortlist nearest neighbour) of the torch port, its
dispatch, and the ICP loop's tile pass-through, against the JAX reference.

On the CPU `nn_rescore` runs its plain version, held against
nn_bruteforce_pallas(precision="rescore") in interpret mode (as
tests/test_nn_pallas.py runs it) on the same float32 inputs. The CUDA kernel
is held against the plain version in test_torch_cuda.py.

Tolerances. Indices must be equal: both sides pick each slot's candidate by
the first minimum of the same packed bf16 score and the winner by the first
minimum over slots of the exact float32 d², so they differ only where two
packed scores of one slot sit within the reference's score error (none on
these cases). d² agrees to 1e-6 relative: both are float32 difference-form
sums of three squares, which may be added in another order (observed
<= 1.8e-7).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_icp_slam.config import ICPConfig
from tpu_icp_slam.core import pointcloud as jpc
from tpu_icp_slam.datasets import synthetic
from tpu_icp_slam.icp import loop as jloop
from tpu_icp_slam.kernels.nn_pallas import nn_bruteforce_pallas
from tpu_icp_slam_torch.core import pointcloud as tpc
from tpu_icp_slam_torch.icp import loop as tloop
from tpu_icp_slam_torch.kernels import nn as dispatch
from tpu_icp_slam_torch.kernels import nn_rescore as k4
from tpu_icp_slam_torch.kernels.nn_cuda import nn_bruteforce_ref

D2_RTOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs test files in parallel worker processes: torch's own
    thread pool in each would oversubscribe the cores (this file took ~8x
    its serial time under six workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reference(src, dst, **tiles):
    idx, d2 = nn_bruteforce_pallas(jnp.asarray(src), jnp.asarray(dst),
                                   interpret=True, precision="rescore",
                                   **tiles)
    return np.asarray(idx), np.asarray(d2)


def _port(src, dst, tile_n=0):
    idx, d2 = k4.nn_rescore(torch.from_numpy(src), torch.from_numpy(dst),
                            tile_n=tile_n)
    assert idx.dtype == torch.int32 and d2.dtype == torch.float32
    return idx.numpy(), d2.numpy()


def _assert_same(port, ref):
    np.testing.assert_array_equal(port[0], ref[0])
    np.testing.assert_allclose(port[1], ref[1], rtol=D2_RTOL, atol=0.0)


def _uniform(m, n, seed, scale=10.0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-scale, scale, (m, 3)).astype(np.float32),
            rng.uniform(-scale, scale, (n, 3)).astype(np.float32))


@pytest.mark.parametrize("m,n,tile_m,tile_n", [
    (256, 256, 128, 128),   # exact tiles, 2 slots
    (300, 1500, 128, 256),  # ragged both axes, 6 slots
    (64, 96, 128, 128),     # a single slot covering everything
])
def test_rescore_plain_matches_pallas_oracle_shapes(m, n, tile_m, tile_n):
    """test_pallas_rescore_matches_oracle's shapes and data."""
    src, dst = _uniform(m, n, seed=10 * m + n)
    _assert_same(_port(src, dst, tile_n),
                 _reference(src, dst, tile_m=tile_m, tile_n=tile_n))


@pytest.mark.parametrize("tile_n", [0, 256, 384, 4096])
def test_rescore_plain_matches_pallas_tile_n(tile_n):
    """tile_n auto (8 slots of 384), smaller, equal, and larger than the
    auto-shrunk size (the shrink applies to a given tile_n too)."""
    src, dst = _uniform(500, 3000, seed=77)
    tn, s = k4.slots(3000, tile_n)
    assert (tn, s) == {0: (384, 8), 256: (256, 12), 384: (384, 8),
                       4096: (384, 8)}[tile_n]
    _assert_same(_port(src, dst, tile_n), _reference(src, dst, tile_n=tile_n))


def test_rescore_plain_resolves_near_ties_like_pallas():
    """test_pallas_rescore_resolves_near_ties_in_f32's case: true nearest at
    0.3 m, a rival 1 mm further at the adjacent index, on a 500 m offset."""
    rng = np.random.default_rng(7)
    offset = np.asarray([500.0, -300.0, 40.0], np.float32)
    m = 64
    src = (rng.uniform(-30, 30, (m, 3)) + offset).astype(np.float32)
    dirs = rng.normal(size=(m, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    dirs2 = rng.normal(size=(m, 3)).astype(np.float32)
    dirs2 /= np.linalg.norm(dirs2, axis=1, keepdims=True)
    pairs = np.stack([src + 0.3 * dirs, src + (0.3 + 1e-3) * dirs2],
                     axis=1).reshape(-1, 3)
    clutter = (rng.uniform(-30, 30, (512, 3)) + offset).astype(np.float32)
    dst = np.concatenate([pairs, clutter]).astype(np.float32)
    port = _port(src, dst, tile_n=256)
    _assert_same(port, _reference(src, dst, tile_m=128, tile_n=256))
    D = ((src[:, None].astype(np.float64) - dst[None].astype(np.float64))
         ** 2).sum(-1)
    np.testing.assert_array_equal(port[0], D.argmin(1))


def test_rescore_plain_sentinel_rows_like_pallas():
    """Padded targets (the 1e6 sentinel) never win for a real source row."""
    rng = np.random.default_rng(11)
    real = rng.uniform(-5, 5, (100, 3)).astype(np.float32)
    padded = np.asarray(jpc.make(real, capacity=250).points)  # 150 sentinels
    src = rng.uniform(-5, 5, (64, 3)).astype(np.float32)
    port = _port(src, padded)
    _assert_same(port, _reference(src, padded))
    assert np.all(port[0] < 100)


def test_rescore_padded_sources_like_pallas():
    """Padded SOURCE rows against a target with no sentinel rows land on the
    wrapper's own padding (index >= N, here N = 250, TN = 128), as the
    reference's do; the ICP loop's gather clamps that index as JAX's
    does."""
    rng = np.random.default_rng(12)
    dst = rng.uniform(-5, 5, (250, 3)).astype(np.float32)
    src = np.asarray(jpc.make(rng.uniform(-5, 5, (64, 3)).astype(np.float32),
                              capacity=80).points)  # 16 padded sources
    port = _port(src, dst)
    _assert_same(port, _reference(src, dst))
    assert k4.slots(250) == (128, 2)
    assert np.all(port[0][:64] < 250) and np.all(port[0][64:] >= 250)
    nrm = np.zeros_like(dst)
    nrm[:, 2] = 1.0
    cfg = ICPConfig(method="point_to_plane", nn_backend="pallas",
                    nn_precision="rescore", max_corr_dist=1.0)
    q, _, gate, _ = tloop._nn_correspondence(
        cfg, tpc.make(dst, normals=nrm))(torch.from_numpy(src))
    jq, _, jgate, _ = jloop._nn_correspondence(
        cfg, jpc.make(dst, normals=nrm))(jnp.asarray(src))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(gate.numpy(), np.asarray(jgate))


def _slot_order_tie(n=1024):
    """Every source's nearest target appears twice, at indices 3 and 8
    (slots 3 and 0 of 8): the exact search takes 3, the shortlist the lower
    SLOT, so 8."""
    rng = np.random.default_rng(5)
    dst = rng.uniform(-20, 20, (n, 3)).astype(np.float32)
    dst[8] = dst[3] = [0.5, 0.25, -0.125]
    src = (dst[3] + rng.uniform(-0.01, 0.01, (40, 3))).astype(np.float32)
    return src, dst


def test_rescore_exact_tie_goes_to_the_lowest_slot():
    src, dst = _slot_order_tie()
    assert k4.slots(len(dst)) == (128, 8)
    ref = _reference(src, dst)
    assert np.all(ref[0] == 8)
    _assert_same(_port(src, dst), ref)
    exact, _ = nn_bruteforce_ref(torch.from_numpy(src), torch.from_numpy(dst))
    assert np.all(exact.numpy() == 3)


def test_nearest_neighbor_pallas_rescore_on_cpu_runs_k4():
    """The dispatch runs K4's plain version for pallas + rescore on CPU
    tensors, tile_n included (it used to return the exact search)."""
    src, dst = _slot_order_tie()
    s, d = torch.from_numpy(src), torch.from_numpy(dst)
    for tile_n, want in ((0, 8), (64, 3)):  # 8 slots, then 16
        idx, d2 = dispatch.nearest_neighbor(s, d, backend="pallas",
                                            tile_m=64, tile_n=tile_n,
                                            precision="rescore")
        assert torch.all(idx == want), (tile_n, idx[:4])
        ref = _reference(src, dst, tile_n=tile_n)
        _assert_same((idx.numpy(), d2.numpy()), ref)
    # the exact search on "xla" and "auto" (CPU), as the reference's
    for backend in ("xla", "auto"):
        idx, _ = dispatch.nearest_neighbor(s, d, backend=backend,
                                           precision="rescore")
        assert torch.all(idx == 3)


def test_icp_loop_passes_nn_tiles_through():
    """icp.nn_tile_n reaches K4: it fixes the slots, so the correspondence
    the loop gathers (the reference's loop.py passes both tiles)."""
    src, dst = _slot_order_tie()
    nrm = np.zeros_like(dst)
    nrm[:, 2] = 1.0
    cfg = ICPConfig(method="point_to_plane", nn_backend="pallas",
                    nn_precision="rescore", max_corr_dist=1.0)
    for tile_n, want in ((0, 8), (64, 3)):
        c = dataclasses.replace(cfg, nn_tile_m=64, nn_tile_n=tile_n)
        corr = tloop._nn_correspondence(c, tpc.make(dst, normals=nrm))
        q, n, gate, d2 = corr(torch.from_numpy(src))
        np.testing.assert_array_equal(q.numpy(), dst[np.full(len(src), want)])
        jcorr = jloop._nn_correspondence(c, jpc.make(dst, normals=nrm))
        jq, _, jgate, jd2 = jcorr(jnp.asarray(src))
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(gate.numpy(), np.asarray(jgate))


def test_rescore_icp_recovers_transform_like_reference():
    """test_pallas_rescore_icp_recovers_transform's case, point-to-point at
    rescore on both sides: the same transform to 1e-5 and the same
    iterations (only float32 summation order differs)."""
    s, d, T_gt = synthetic.two_scan_pair(n=512, seed=5, rot_scale=0.2,
                                         trans_scale=0.3)
    cfg = ICPConfig(max_iters=25, tol=1e-6, nn_backend="pallas",
                    nn_precision="rescore")
    ra = jloop.align(jpc.make(s, 512), jpc.make(d, 512), cfg=cfg)
    rb = tloop.align(tpc.make(s, 512), tpc.make(d, 512), cfg=cfg)
    assert rb.iters == int(ra.iters)
    np.testing.assert_allclose(rb.T.numpy(), np.asarray(ra.T), atol=1e-5)
    err = np.linalg.norm(rb.T.numpy()[:3, 3] - T_gt[:3, 3])
    assert err < 2e-3, err
