"""Kernels K1 (NN) and K2 (GN accumulation) of the torch port.

On the CPU the wrappers run their plain torch versions; those are held
against the JAX reference's Pallas kernels (interpret mode, as the
reference's own tests run them) and XLA fallbacks on the same float32
inputs. The CUDA kernels themselves are tested in test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_icp_slam.core import pointcloud as jpc
from tpu_icp_slam.icp.point_to_plane import build_normal_equations
from tpu_icp_slam.kernels.gn_pallas import gn_accum_pallas
from tpu_icp_slam.kernels.nn_pallas import nn_bruteforce_pallas
from tpu_icp_slam.kernels.nn_xla import nn_bruteforce_xla
from tpu_icp_slam_torch.kernels import _build, gn_cuda, nn_cuda
from tpu_icp_slam_torch.kernels.nn import nearest_neighbor

NEAR_TIE = 1e-3  # m²: below this the reference's factored f32 score may
# rank the two best targets either way


def _clouds(m, n, seed, scale=10.0):
    rng = np.random.default_rng(seed)
    src = rng.uniform(-scale, scale, (m, 3)).astype(np.float32)
    dst = rng.uniform(-scale, scale, (n, 3)).astype(np.float32)
    return src, dst


def _check_nn(src, dst, idx, d2, ref_idx, ref_d2):
    """idx equal away from near-ties, d2 within 1e-3 m², picks never worse
    than the exact best by more than the tie band."""
    D = ((src[:, None, :].astype(np.float64) - dst[None].astype(np.float64))
         ** 2).sum(-1)
    part = np.partition(D, 1, axis=1)
    clear = (part[:, 1] - part[:, 0]) > NEAR_TIE
    assert clear.mean() > 0.5  # the comparison is not vacuous
    np.testing.assert_array_equal(idx[clear], ref_idx[clear])
    np.testing.assert_allclose(d2, ref_d2, atol=1e-3)
    picked = D[np.arange(len(src)), idx]
    assert np.all(picked - part[:, 0] <= NEAR_TIE)


@pytest.mark.parametrize("m,n", [(256, 256), (300, 500), (64, 1000),
                                 (1024, 96)])
def test_nn_plain_matches_pallas_highest(m, n):
    src, dst = _clouds(m, n, seed=m + n)
    ri, rd = nn_bruteforce_pallas(jnp.asarray(src), jnp.asarray(dst),
                                  tile_m=128, tile_n=256, interpret=True,
                                  precision="highest")
    idx, d2 = nn_cuda.nn_bruteforce(torch.from_numpy(src),
                                    torch.from_numpy(dst))
    assert idx.dtype == torch.int32 and d2.dtype == torch.float32
    _check_nn(src, dst, idx.numpy(), d2.numpy(), np.asarray(ri),
              np.asarray(rd))


@pytest.mark.parametrize("chunk", [2048, 100])
def test_nn_plain_matches_xla(chunk):
    src, dst = _clouds(700, 900, seed=5, scale=30.0)
    ri, rd = nn_bruteforce_xla(jnp.asarray(src), jnp.asarray(dst))
    idx, d2 = nn_cuda.nn_bruteforce_ref(torch.from_numpy(src),
                                        torch.from_numpy(dst), chunk=chunk)
    _check_nn(src, dst, idx.numpy(), d2.numpy(), np.asarray(ri),
              np.asarray(rd))


def test_nn_sentinel_padding_never_wins():
    rng = np.random.default_rng(1)
    real = rng.uniform(-5, 5, (100, 3)).astype(np.float32)
    padded = np.array(jpc.make(real, capacity=256).points)
    src = rng.uniform(-5, 5, (64, 3)).astype(np.float32)
    idx, d2 = nn_cuda.nn_bruteforce(torch.from_numpy(src),
                                    torch.from_numpy(padded))
    assert np.all(idx.numpy() < 100)
    assert np.all(np.isfinite(d2.numpy()))


def test_nn_ties_go_to_lowest_index():
    dst = np.zeros((10, 3), np.float32)
    dst[:, 0] = [3, 1, 2, 1, 5, 1, 7, 8, 9, 1]  # x = 1 at indices 1, 3, 5, 9
    idx, _ = nn_cuda.nn_bruteforce(torch.zeros(4, 3), torch.from_numpy(dst))
    np.testing.assert_array_equal(idx.numpy(), [1, 1, 1, 1])


def test_nn_dispatch_backends_on_cpu():
    src, dst = (torch.from_numpy(a) for a in _clouds(200, 300, seed=9))
    want = nn_cuda.nn_bruteforce_ref(src, dst)
    for backend in ("auto", "pallas", "xla"):
        got = nearest_neighbor(src, dst, backend=backend)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    # the voxel hash grid is built per align (icp/loop.py), not dispatched
    # here: the reference's nearest_neighbor refuses it the same way
    with pytest.raises(ValueError):
        nearest_neighbor(src, dst, backend="voxel")
    with pytest.raises(ValueError):
        nearest_neighbor(src, dst, backend="nope")


def _gn_case(m, seed, with_padding=True):
    rng = np.random.default_rng(seed)
    p = rng.uniform(-20, 20, (m, 3)).astype(np.float32)
    q = (p + 0.1 * rng.standard_normal((m, 3))).astype(np.float32)
    n = rng.standard_normal((m, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    w = rng.uniform(0, 1, m).astype(np.float32)
    if with_padding:
        w[m // 2:] = 0.0  # padded/gated rows must not contribute
    return p, q, n, w


@pytest.mark.parametrize("m", [128, 1000, 4096])
def test_gn_plain_matches_pallas(m):
    p, q, n, w = _gn_case(m, seed=m)
    H_ref, g_ref = gn_accum_pallas(*map(jnp.asarray, (p, q, n, w)),
                                   interpret=True)
    H, g = gn_cuda.gn_accum(*map(torch.from_numpy, (p, q, n, w)))
    assert H.shape == (6, 6) and g.shape == (6,)
    np.testing.assert_allclose(H.numpy(), np.asarray(H_ref), rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_allclose(g.numpy(), np.asarray(g_ref), rtol=1e-5,
                               atol=1e-4)


def test_gn_plain_matches_xla_normal_equations():
    p, q, n, w = _gn_case(2000, seed=3, with_padding=False)
    H_ref, g_ref = build_normal_equations(*map(jnp.asarray, (p, q, n, w)))
    H, g = gn_cuda.gn_accum_ref(*map(torch.from_numpy, (p, q, n, w)))
    np.testing.assert_allclose(H.numpy(), np.asarray(H_ref), rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_allclose(g.numpy(), np.asarray(g_ref), rtol=1e-5,
                               atol=1e-4)


def test_cpu_tensors_take_the_plain_versions():
    before = (nn_cuda.nn_bruteforce.launches, gn_cuda.gn_accum.launches)
    src, dst = (torch.from_numpy(a) for a in _clouds(50, 60, seed=2))
    nn_cuda.nn_bruteforce(src, dst)
    gn_cuda.gn_accum(src, src, src, torch.ones(50))
    assert (nn_cuda.nn_bruteforce.launches,
            gn_cuda.gn_accum.launches) == before


def test_build_is_keyed_by_sources_and_needs_nvcc(tmp_path, monkeypatch):
    path = _build.library_path()
    assert path.name == "libkernels.so"
    assert path.parent.parent.name == "tpu_icp_slam_torch"
    assert path.parents[2].name == "build"
    assert {s.name for s in _build.sources()} == {
        "nn_bruteforce.cu", "gn_accum.cu", "nn_bf16.cu", "icp_fused.cu",
        "coop_probe.cu", "nn_shortlist.cu", "rigid_fit.cu", "gn_step.cu",
        "projective.cu", "knn_normals.cu", "local_select.cu", "p2p_step.cu"}
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "k.cu").write_text("// a\n")
    (src / "shared.cuh").write_text("// a\n")
    monkeypatch.setattr(_build, "_CSRC", src)
    a = _build.library_path()
    (src / "k.cu").write_text("// b\n")
    b = _build.library_path()
    assert b != a
    # a shared header is not compiled on its own, but keys the library
    assert [s.name for s in _build.sources()] == ["k.cu"]
    (src / "shared.cuh").write_text("// b\n")
    assert _build.library_path() != b
    monkeypatch.setattr(_build, "_BUILD_ROOT", tmp_path / "build")
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(_build.os.path, "isfile",
                        lambda p: p.startswith(str(tmp_path)))
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build()


@pytest.mark.parametrize("sms,resident", [(132, 5), (132, 4), (114, 5),
                                          (8, 2)])
def test_k1_split_choice_covers_the_targets(sms, resident):
    """K1's target splits: a multiple of 4 targets each, none empty, at
    least three blocks per SM where the shape allows, and at the main-path
    shape on an H100 (132 SMs, 5 resident blocks) a whole number of blocks
    per SM."""
    for m, n, batch in [(1, 1, 1), (1, 300, 1), (16384, 16384, 1),
                        (16384, 16384, 16), (4097, 77, 1), (300, 5000, 1),
                        (1500, 701, 16), (16384, 40000, 1), (2, 5, 3)]:
        s = nn_cuda.n_split(m, n, batch, sms, resident)
        length = -(-(-(-n // s)) // 4) * 4
        assert s >= 1 and (s - 1) * length < n <= s * length, (m, n, s)
        items = -(-m // 1024) * batch * s
        if n >= 3 * sms * 256:
            assert items >= 3 * sms, (m, n, batch, s)
    assert nn_cuda.n_split(16384, 16384, 1, 132, 5) == 33  # 528 blocks
    assert nn_cuda.n_split(16384, 16384, 16, 132, 5) == 2  # 512 blocks
