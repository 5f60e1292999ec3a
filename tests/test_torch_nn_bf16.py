"""K3 (bf16 packed nearest neighbour) of the torch port, and the repaired
`nearest_neighbor` dispatch, against the JAX reference.

On the CPU `nn_bf16` runs its plain version, held against
nn_bruteforce_pallas(precision="bf16") in interpret mode (as
tests/test_nn_pallas.py runs it) on the same float32 inputs. The CUDA
kernel itself is held against the plain version in test_torch_cuda.py.

Tolerances. The port scores the packed bf16 operands with exact products
summed in float32, so its score is within γ = 13·2⁻²⁴ times Σ|a_k·b_k| of
the exact (float64) packed score: derived, and observed at <= 1.9·2⁻²⁴.
The reference's interpret-mode scores are looser: up to 2.1e-6·Σ|a_k·b_k|
from the exact packed score on these cases, so it is held to 10x that,
REF_REL. Indices must agree wherever the best two exact packed scores are
further apart than both errors together. The parent tree's exact search
fails the port's own bound on a third of the rows of the 500 m case.
"""

import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_icp_slam.core import pointcloud as jpc
from tpu_icp_slam.kernels.nn_pallas import nn_bruteforce_pallas
from tpu_icp_slam_torch.kernels import nn as dispatch
from tpu_icp_slam_torch.kernels import nn_bf16 as k3
from tpu_icp_slam_torch.kernels.nn_cuda import nn_bruteforce_ref
from tpu_icp_slam_torch.kernels.nn_rescore import nn_rescore_ref

GAMMA = 13 * 2.0 ** -24  # float32 sum of 13 exact products
REF_REL = 2e-5  # 10x the reference's observed score error, relative


def _clouds(m, n, seed, scale=10.0, offset=0.0):
    rng = np.random.default_rng(seed)
    src = (rng.uniform(-scale, scale, (m, 3)) + offset).astype(np.float32)
    dst = (rng.uniform(-scale, scale, (n, 3)) + offset).astype(np.float32)
    return src, dst


def _reference(src, dst, **tiles):
    idx, d2 = nn_bruteforce_pallas(jnp.asarray(src), jnp.asarray(dst),
                                   interpret=True, precision="bf16", **tiles)
    return np.asarray(idx), np.asarray(d2)


def _packed(src, dst):
    """Exact (float64) packed scores of the port's operands, and each row's
    float32 summation bound for a given pick."""
    s, d = k3.recentre(torch.from_numpy(src), torch.from_numpy(dst))
    A = k3.pack_source(s).double().numpy()
    B = k3.pack_target(d).double().numpy()
    return A, B, A @ B.T


def _check_against_reference(src, dst, idx, d2, ref_idx, ref_d2):
    A, B, E = _packed(src, dst)
    rows = np.arange(len(src))
    own = GAMMA * np.abs(A * B[idx]).sum(-1)
    ref = REF_REL * np.abs(A * B[ref_idx]).sum(-1)
    # the port returns the packed minimum, to float32 summation
    assert np.all(np.abs(d2 - E[rows, idx]) <= own), \
        np.max(np.abs(d2 - E[rows, idx]) / own)
    part = np.partition(E, 1, axis=1)
    assert np.all(E[rows, idx] - part[:, 0] <= 2 * own)
    # and agrees with the reference within both errors
    assert np.all(np.abs(d2 - ref_d2) <= own + ref), \
        np.max(np.abs(d2 - ref_d2) / (own + ref))
    clear = (part[:, 1] - part[:, 0]) > 2 * (own + ref)
    assert clear.mean() > 0.5  # the comparison is not vacuous
    np.testing.assert_array_equal(idx[clear], ref_idx[clear])


@pytest.mark.parametrize("m,n,scale", [(256, 256, 10.0), (300, 500, 10.0),
                                       (64, 1000, 30.0), (1024, 96, 30.0)])
def test_nn_bf16_plain_matches_pallas(m, n, scale):
    src, dst = _clouds(m, n, seed=m + n, scale=scale)
    ri, rd = _reference(src, dst, tile_m=128, tile_n=256)
    idx, d2 = k3.nn_bf16(torch.from_numpy(src), torch.from_numpy(dst))
    assert idx.dtype == torch.int32 and d2.dtype == torch.float32
    _check_against_reference(src, dst, idx.numpy(), d2.numpy(), ri, rd)


def test_nn_bf16_picked_excess_within_lo_lo_bound():
    """The pick is the exact nearest up to the packed score's own error:
    the true d² of the pick exceeds the true minimum by at most twice the
    row's largest |packed score - d²| (the dropped lo·lo terms and the
    split residuals), plus float32 summation."""
    src, dst = _clouds(700, 900, seed=5, scale=30.0)
    idx, _ = k3.nn_bf16(torch.from_numpy(src), torch.from_numpy(dst))
    idx = idx.numpy()
    A, B, E = _packed(src, dst)
    D = ((src[:, None].astype(np.float64) - dst[None].astype(np.float64))
         ** 2).sum(-1)
    score_err = np.abs(E - D).max(1)
    excess = D[np.arange(len(src)), idx] - D.min(1)
    bound = 2 * score_err + 2 * GAMMA * np.abs(A * B[idx]).sum(-1)
    assert np.all(excess <= bound), np.max(excess - bound)
    assert score_err.max() < 0.1  # lo·lo scale at a 60 m extent, m²


def test_nearest_neighbor_pallas_bf16_on_cpu_runs_k3():
    """nearest_neighbor(backend="pallas", precision="bf16") on CPU tensors
    is K3's plain version, not the exact search: it matches the reference's
    bf16 kernel in interpret mode on the 500 m world-offset case of
    test_pallas_bf16_recentered_selection_quality, and keeps its <= 5 cm
    selection excess."""
    src, dst = _clouds(800, 2000, seed=3, scale=30.0,
                       offset=np.asarray([500.0, -300.0, 40.0], np.float32))
    ri, rd = _reference(src, dst)
    idx, d2 = dispatch.nearest_neighbor(torch.from_numpy(src),
                                        torch.from_numpy(dst),
                                        backend="pallas", precision="bf16")
    idx, d2 = idx.numpy(), d2.numpy()
    _check_against_reference(src, dst, idx, d2, ri, rd)
    D = ((src[:, None].astype(np.float64) - dst[None].astype(np.float64))
         ** 2).sum(-1)
    excess = np.sqrt(D[np.arange(len(src)), idx]) - np.sqrt(D.min(1))
    assert float(excess.max()) < 0.05


def test_nn_bf16_sentinel_rows_never_win():
    rng = np.random.default_rng(1)
    real = rng.uniform(-5, 5, (100, 3)).astype(np.float32)
    padded = np.array(jpc.make(real, capacity=256).points)
    src = rng.uniform(-5, 5, (64, 3)).astype(np.float32)
    idx, d2 = k3.nn_bf16(torch.from_numpy(src), torch.from_numpy(padded))
    assert np.all(idx.numpy() < 100)
    assert np.all(np.isfinite(d2.numpy())) and np.all(d2.numpy() >= 0)
    ri, _ = _reference(src, padded)
    assert np.all(ri < 100)


def test_nn_dispatch_precisions_on_cpu(caplog, monkeypatch):
    src, dst = (torch.from_numpy(a) for a in _clouds(200, 300, seed=9))
    exact = nn_bruteforce_ref(src, dst)
    packed = k3.nn_bf16_ref(src, dst)
    monkeypatch.setattr(dispatch, "_warned_precision_ignored", False)
    with caplog.at_level(logging.WARNING, logger=dispatch.__name__):
        for backend in ("auto", "xla"):  # auto on CPU resolves to xla
            got = dispatch.nearest_neighbor(src, dst, backend=backend,
                                            precision="bf16")
            assert torch.equal(got[0], exact[0])
            assert torch.equal(got[1], exact[1])
    assert len([r for r in caplog.records
                if "precision setting is ignored" in r.getMessage()]) == 1
    got = dispatch.nearest_neighbor(src, dst, backend="pallas",
                                    precision="bf16")
    assert torch.equal(got[0], packed[0]) and torch.equal(got[1], packed[1])
    # rescore runs K4's plain version (the reference's interpret-mode
    # shortlist), not the exact search; on these clouds both pick the same
    # points, and K4's d² is the exact difference form too
    rescore = nn_rescore_ref(src, dst)
    got = dispatch.nearest_neighbor(src, dst, backend="pallas",
                                    precision="rescore")
    assert torch.equal(got[0], rescore[0]) and torch.equal(got[1], rescore[1])
    assert torch.equal(got[0], exact[0])
    with pytest.raises(ValueError):
        dispatch.nearest_neighbor(src, dst, precision="fp8")
