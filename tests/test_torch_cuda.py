"""The CUDA kernels of the torch port against their plain versions, on the card.

Every test here is marked `cuda` and skips without a CUDA device. The file
imports no jax, so it also runs where JAX is not installed:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import dataclasses
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from tpu_icp_slam_torch import ICPConfig, MappingConfig, PipelineConfig
from tpu_icp_slam_torch import SlamConfig
from tpu_icp_slam_torch.kernels import (
    coop_probe,
    gn_cuda,
    icp_fused,
    nn_bf16,
    nn_cuda,
    nn_rescore,
    packed_mma,
)
from tpu_icp_slam_torch.kernels.nn import nearest_neighbor

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernel vs plain version on the card)")
    return torch.device("cuda")


def _clouds(m, n, seed, scale):
    rng = np.random.default_rng(seed)
    src = rng.uniform(-scale, scale, (m, 3)).astype(np.float32)
    dst = rng.uniform(-scale, scale, (n, 3)).astype(np.float32)
    return src, dst


def _gn_case(m, seed):
    rng = np.random.default_rng(seed)
    p = rng.uniform(-20, 20, (m, 3)).astype(np.float32)
    q = (p + 0.1 * rng.standard_normal((m, 3))).astype(np.float32)
    n = rng.standard_normal((m, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    w = rng.uniform(0, 1, m).astype(np.float32)
    w[m // 2:] = 0.0
    return p, q, n, w


@pytest.mark.parametrize("m,n", [(16384, 16384), (300, 5000), (4097, 77),
                                 (1, 1)])
def test_nn_kernel_matches_plain(cuda_device, m, n):
    """Index agreement >= 99.9% (the two differ only by FMA rounding on
    near-ties), d2 to f32 rounding, sentinel rows never picked."""
    src, dst = _clouds(m, n, seed=m, scale=40.0)
    n_pad = n // 8
    if n_pad:
        dst[-n_pad:] = 1.0e6
    s, d = (torch.from_numpy(a).to(cuda_device) for a in (src, dst))
    idx, d2 = nn_cuda.nn_bruteforce(s, d)
    ridx, rd2 = nn_cuda.nn_bruteforce_ref(s, d)
    assert idx.dtype == torch.int32 and idx.shape == (m,)
    assert float((idx == ridx).float().mean()) >= 0.999
    torch.testing.assert_close(d2, rd2, rtol=1e-6, atol=1e-5)
    assert int(idx.max()) < n - n_pad


def test_nn_kernel_ties_go_to_lowest_index(cuda_device):
    dst = torch.zeros(5000, 3, device=cuda_device)
    dst[:, 0] = 5.0
    dst[[17, 1200, 2500, 4999], 0] = 1.0  # equidistant winners in 3 splits
    idx, d2 = nn_cuda.nn_bruteforce(torch.zeros(64, 3, device=cuda_device),
                                    dst)
    assert torch.all(idx == 17) and torch.all(d2 == 1.0)


def test_gn_kernel_matches_plain_and_is_reproducible(cuda_device):
    p, q, n, w = (torch.from_numpy(a).to(cuda_device)
                  for a in _gn_case(16384, seed=11))
    H, g = gn_cuda.gn_accum(p, q, n, w)
    H_ref, g_ref = gn_cuda.gn_accum_ref(p, q, n, w)
    # rtol 1e-4 per entry plus 1e-4 of the largest entry: the summation
    # order differs from the plain matmul, and off-diagonal sums cancel
    torch.testing.assert_close(H, H_ref, rtol=1e-4,
                               atol=1e-4 * float(H_ref.abs().max()))
    torch.testing.assert_close(g, g_ref, rtol=1e-4,
                               atol=1e-4 * float(g_ref.abs().max()))
    assert torch.equal(H, H.T)
    H2, g2 = gn_cuda.gn_accum(p, q, n, w)
    assert torch.equal(H, H2) and torch.equal(g, g2)


def _k1_edges(m, n, device):
    """(split length, target tile, min-only run) of K1's grid at (m, n)."""
    from tpu_icp_slam_torch.kernels import _build

    index = torch.cuda.current_device()
    s = nn_cuda.n_split(m, n, 1, _build.sm_count(index),
                        nn_cuda.blocks_per_sm(index))
    return -(-(-(-n // s)) // 4) * 4, 256, 16


@pytest.mark.parametrize("m,n", [(1, 1), (1, 300), (1025, 255), (3000, 257),
                                 (2049, 1000), (130, 4099), (16385, 77),
                                 (7, 16387)])
def test_nn_kernel_ragged_shapes(cuda_device, m, n):
    """M and N off every multiple of the block's rows (1,024), the tile
    (256) and the run (16), N below one tile, M = 1: the plain version's
    picks (but for FMA-rounding near-ties) and distances."""
    src, dst = _clouds(m, n, seed=m + n, scale=30.0)
    s, d = (torch.from_numpy(a).to(cuda_device) for a in (src, dst))
    idx, d2 = nn_cuda.nn_bruteforce(s, d)
    ridx, rd2 = nn_cuda.nn_bruteforce_ref(s, d)
    assert idx.shape == (m,) and d2.shape == (m,)
    assert int(idx.min()) >= 0 and int(idx.max()) < n
    assert float((idx == ridx).float().mean()) >= (0.99 if m < 1000 else
                                                   0.999)
    torch.testing.assert_close(d2, rd2, rtol=1e-6, atol=1e-5)
    # the distance returned is the picked target's own
    picked = ((s.double() - d.double()[idx.long()]) ** 2).sum(-1)
    torch.testing.assert_close(d2.double(), picked, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("where", ["run", "tile", "split", "far"])
def test_nn_kernel_duplicate_targets_lowest_index_wins(cuda_device, where):
    """An exact duplicate planted on both sides of a run edge, a tile edge,
    a split edge, or far apart: every source takes the lower index."""
    m, n = 16384, 40000
    split, tile, run = _k1_edges(m, n, cuda_device)
    assert split > tile + run  # every edge lies inside the target axis
    a, b = {"run": (split + tile + run - 1, split + tile + run),
            "tile": (split + tile - 1, split + tile),
            "split": (split - 1, split),
            "far": (5, n - 3)}[where]
    rng = np.random.default_rng(7)
    dst = rng.uniform(20, 60, (n, 3)).astype(np.float32)
    dst[a] = dst[b] = [0.5, -0.25, 0.125]
    src = (dst[a] + rng.uniform(-0.3, 0.3, (m, 3))).astype(np.float32)
    idx, d2 = nn_cuda.nn_bruteforce(torch.from_numpy(src).to(cuda_device),
                                    torch.from_numpy(dst).to(cuda_device))
    assert torch.all(idx == a), (where, a, b, torch.unique(idx))


def test_nn_kernel_sentinel_rows_never_win(cuda_device):
    """Sentinel (1e6) targets at the start of every split and tile, and in
    a block at the end, never win for a real source point; a source at the
    sentinel itself finds one at distance 0."""
    m, n = 16384, 20000
    split, tile, _ = _k1_edges(m, n, cuda_device)
    assert split > tile
    src, dst = _clouds(m, n, seed=9, scale=40.0)
    pad = np.zeros(n, bool)
    for start in range(0, n, split):
        for t in range(start, min(n, start + split), tile):
            pad[t:t + 8] = True
    pad[-700:] = True
    dst[pad] = 1.0e6
    src[-5:] = 1.0e6
    idx, d2 = nn_cuda.nn_bruteforce(torch.from_numpy(src).to(cuda_device),
                                    torch.from_numpy(dst).to(cuda_device))
    idx = idx.cpu().numpy()
    assert not pad[idx[:-5]].any()
    assert pad[idx[-5:]].all() and torch.all(d2[-5:] == 0)


def test_batched_nn_kernel_ragged(cuda_device):
    """The batched form at B = 16, G = 8 on ragged shapes: each element is
    its own unbatched call bit for bit."""
    rng = np.random.default_rng(4)
    src = rng.uniform(-40, 40, (16, 1500, 3)).astype(np.float32)
    dst = rng.uniform(-40, 40, (2, 701, 3)).astype(np.float32)
    s, d = (torch.from_numpy(a).to(cuda_device) for a in (src, dst))
    idx, d2 = nn_cuda.nn_bruteforce(s, d)
    for b in (0, 7, 8, 15):
        one = nn_cuda.nn_bruteforce(s[b].contiguous(), d[b // 8].contiguous())
        assert torch.equal(one[0], idx[b]) and torch.equal(one[1], d2[b])


@pytest.mark.parametrize("m", [0, 1, 255, 16385])
def test_gn_kernel_edge_sizes(cuda_device, m):
    """M = 0 gives zeros; otherwise the plain version's H and g (rtol 1e-4
    plus 1e-4 of the largest entry: another summation order), symmetric,
    bit-reproducible across calls."""
    p, q, n, w = (torch.from_numpy(a).to(cuda_device)
                  for a in _gn_case(max(m, 1), seed=m))
    if m == 1:
        w[:] = 0.75
    p, q, n, w = p[:m], q[:m], n[:m], w[:m]
    H, g = gn_cuda.gn_accum(p, q, n, w)
    H_ref, g_ref = gn_cuda.gn_accum_ref(p, q, n, w)
    if m == 0:
        assert torch.equal(H, torch.zeros_like(H))
        assert torch.equal(g, torch.zeros_like(g))
    else:
        torch.testing.assert_close(H, H_ref, rtol=1e-4,
                                   atol=1e-4 * float(H_ref.abs().max()))
        torch.testing.assert_close(g, g_ref, rtol=1e-4,
                                   atol=1e-4 * float(g_ref.abs().max()))
    assert torch.equal(H, H.T)
    for _ in range(3):
        H2, g2 = gn_cuda.gn_accum(p, q, n, w)
        assert torch.equal(H, H2) and torch.equal(g, g2)


def test_gn_kernel_all_weights_zero(cuda_device):
    p, q, n, w = (torch.from_numpy(a).to(cuda_device)
                  for a in _gn_case(5000, seed=2))
    H, g = gn_cuda.gn_accum(p, q, n, torch.zeros_like(w))
    assert torch.equal(H, torch.zeros_like(H))
    assert torch.equal(g, torch.zeros_like(g))


def test_gn_kernel_is_one_launch(cuda_device):
    """One call is one kernel on the card (the profiler's count) and one on
    the wrapper's counter."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    p, q, n, w = (torch.from_numpy(a).to(cuda_device)
                  for a in _gn_case(16384, seed=3))
    gn_cuda.gn_accum(p, q, n, w)
    torch.cuda.synchronize()
    before = gn_cuda.gn_accum.launches
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        gn_cuda.gn_accum(p, q, n, w)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    assert gn_cuda.gn_accum.launches == before + 1
    assert len(kernels) == 1 and "gn_accum" in kernels[0].name, [
        e.name for e in kernels]


def test_wrappers_count_launches(cuda_device):
    a = torch.rand(100, 3, device=cuda_device)
    before = (nn_cuda.nn_bruteforce.launches, gn_cuda.gn_accum.launches)
    nn_cuda.nn_bruteforce(a, a)
    gn_cuda.gn_accum(a, a, a, torch.ones(100, device=cuda_device))
    nn_cuda.nn_bruteforce_ref(a, a)
    assert (nn_cuda.nn_bruteforce.launches, gn_cuda.gn_accum.launches) == (
        before[0] + 1, before[1] + 1)


def test_wrappers_raise_instead_of_falling_back(cuda_device):
    a = torch.zeros(8, 3, device=cuda_device)
    with pytest.raises(ValueError):
        nn_cuda.nn_bruteforce(a.double(), a)
    with pytest.raises(ValueError):
        nn_cuda.nn_bruteforce(a, a.cpu())
    with pytest.raises(ValueError):
        nn_cuda.nn_bruteforce(a[:, :2].contiguous(), a)
    with pytest.raises(ValueError):
        gn_cuda.gn_accum(a, a, a, torch.ones(7, device=cuda_device))
    with pytest.raises(ValueError):
        gn_cuda.gn_accum(a, a.t().contiguous().t(), a,
                         torch.ones(8, device=cuda_device))
    with pytest.raises(ValueError):
        nn_bf16.nn_bf16(a, a.cpu())
    with pytest.raises(ValueError):
        nn_bf16.nn_bf16(a.t().contiguous().t(), a)
    # batched K4: one unbatched launch a row, as the reference's vmap
    before = nn_rescore.nn_rescore.launches
    idx, d2 = nearest_neighbor(a[None], a[None], backend="pallas",
                               precision="rescore")
    one = nn_rescore.nn_rescore(a, a)
    assert torch.equal(idx[0], one[0]) and torch.equal(d2[0], one[1])
    assert nn_rescore.nn_rescore.launches == before + 2
    with pytest.raises(ValueError):
        nn_rescore.nn_rescore(a, a.cpu())
    with pytest.raises(ValueError):
        nn_rescore.nn_rescore(a.double(), a)
    with pytest.raises(ValueError):
        nn_rescore.nn_rescore(a.t().contiguous().t(), a)
    ones = torch.ones(8, dtype=torch.bool, device=cuda_device)
    with pytest.raises(ValueError):
        icp_fused.icp_fused(a, ones, a.cpu(), a, ones)
    with pytest.raises(ValueError):
        icp_fused.icp_fused(a, ones.cpu(), a, a, ones)
    with pytest.raises(ValueError):
        icp_fused.icp_fused(a, ones, a, a.t().contiguous().t(), ones)


def _k3_contract(s, d, idx, d2, e_min=None):
    """K3's picks against its plain version's under the tensor-core
    contract: each pick the plain one or a near-tie of it (>= 99.9% equal
    on these uniform clouds where there are 1,000 rows or more), the
    float64 argmin of the packed score picked at least as often as the
    plain version picks it, each score within TAU·Σ|a b| of the exact
    packed score, d2 = max(e_min, 0) bit for bit."""
    ridx, rd2 = nn_bf16.nn_bf16_ref(s, d)
    a_aug, b_aug = _packed(s, d)
    assert idx.dtype == torch.int32 and idx.shape == (s.shape[0],)
    assert d2.dtype == torch.float32 and d2.shape == (s.shape[0],)
    assert int(idx.min()) >= 0 and int(idx.max()) < d.shape[0]
    assert bool(packed_mma.near_ties(a_aug, b_aug, idx, ridx).all())
    best = packed_mma.exact_argmin(a_aug, b_aug)
    assert int((idx == best).sum()) >= int((ridx == best).sum()) \
        - max(1, s.shape[0] // 1000)
    if s.shape[0] >= 1000:
        assert float((idx == ridx).float().mean()) >= 0.999
    if e_min is not None:
        exact, mag = packed_mma.exact_scores(a_aug, b_aug, idx)
        assert float(torch.max(torch.abs(e_min.double() - exact) / mag)) \
            <= packed_mma.TAU
        assert torch.equal(_bits(d2), _bits(torch.clamp(e_min, min=0.0)))
    return ridx, rd2


@pytest.mark.parametrize("m,n", [(16384, 16384), (300, 5000), (1, 1)])
def test_nn_bf16_kernel_matches_plain(cuda_device, m, n):
    """K3 on the tensor cores against its plain version: picks equal but
    for near-ties, scores within TAU of the exact packed score, d2 the
    clamped minimum, sentinel rows never picked; the call that keeps its
    operands is the main path's call."""
    src, dst = _clouds(m, n, seed=m, scale=40.0)
    n_pad = n // 8
    if n_pad:
        dst[-n_pad:] = 1.0e6
    s, d = (torch.from_numpy(a).to(cuda_device) for a in (src, dst))
    idx, d2 = nn_bf16.nn_bf16(s, d)
    det = nn_bf16.nn_bf16_detail(s, d)
    assert torch.equal(det["idx"], idx) and torch.equal(det["d2"], d2)
    _k3_contract(s, d, idx, d2, det["e_min"])
    assert int(idx.max()) < n - n_pad


@pytest.mark.parametrize("m,n,offset", [(16384, 16384, 0.0), (300, 5000, 0.0),
                                        (1, 1, 0.0), (4097, 3001, 500.0),
                                        (17, 15, -300.0)])
def test_nn_bf16_device_packing_is_the_plain_packing(cuda_device, m, n,
                                                     offset):
    """K3's recentring and packing on the device give the plain packing's
    bits: the centre and both packed operands (a 500 m offset and sentinel
    rows included)."""
    src, dst = _clouds(m, n, seed=m + n + 1, scale=40.0)
    src += np.float32(offset)
    dst += np.float32(offset)
    if n > 8:
        dst[-(n // 8):] = 1.0e6
    s, d = (torch.from_numpy(a).to(cuda_device) for a in (src, dst))
    det = nn_bf16.nn_bf16_detail(s, d)
    a_aug, b_aug = _packed(s, d)
    valid = torch.all(torch.abs(d) < nn_bf16.VALID_ABS, dim=1, keepdim=True)
    centre = nn_bf16.valid_centre(d, valid)
    assert torch.equal(_bits(det["centre"]), _bits(centre))
    assert det["a_aug"].shape == a_aug.shape
    assert det["b_aug"].shape == b_aug.shape
    assert torch.equal(_bits(det["a_aug"]), _bits(a_aug))
    assert torch.equal(_bits(det["b_aug"]), _bits(b_aug))


@pytest.mark.parametrize("m,n", [(1, 300), (1025, 255), (3000, 257),
                                 (130, 4099), (16385, 77), (7, 16387),
                                 (1, 16384), (16384, 1)])
def test_nn_bf16_kernel_ragged_shapes(cuda_device, m, n):
    """K3 with n off every multiple of 16 and of the 256-target tile, n
    below one split, m = 1 and m off the 128-row source tile: the
    tensor-core contract holds."""
    src, dst = _clouds(m, n, seed=m + 2 * n, scale=30.0)
    s, d = (torch.from_numpy(a).to(cuda_device) for a in (src, dst))
    det = nn_bf16.nn_bf16_detail(s, d)
    _k3_contract(s, d, det["idx"], det["d2"], det["e_min"])


def _open_trace_window():
    """A sleep kernel first in a profiler window: the tracer can miss the
    first kernels of a window (seen on an H100), and then misses this one."""
    torch.cuda._sleep(1_000_000)


def _own_kernels(prof, in_order=False):
    """The names of the port's kernels (anonymous-namespace CUDA C++) that
    the profiler saw run, in order of their start on the card if
    in_order."""
    from torch.autograd import DeviceType

    events = [e for e in prof.events()
              if e.device_type == DeviceType.CUDA
              and e.name.startswith("(anonymous namespace)::")]
    if in_order:
        events.sort(key=lambda e: e.time_range.start)
    return [e.name for e in events]


def _k3_split(m, n):
    from tpu_icp_slam_torch.kernels import _build

    index = torch.cuda.current_device()
    return nn_bf16.splits(m, n, _build.sm_count(index),
                          nn_bf16.blocks_per_sm(index))


@pytest.mark.parametrize("where", ["fragment", "tile", "split", "far"])
def test_nn_bf16_kernel_duplicate_targets_lowest_index_wins(cuda_device,
                                                            where):
    """An exact duplicate planted on both sides of an mma fragment edge
    (8 targets), a staged tile edge (256), a split edge, or far apart:
    every source takes the lower index."""
    m, n = 2048, 40000
    k, length = _k3_split(m, n)
    assert k >= 2 and length > 256 + 8  # every edge lies inside a split
    a, b = {"fragment": (length + 7, length + 8),
            "tile": (length + 255, length + 256),
            "split": (length - 1, length),
            "far": (5, n - 3)}[where]
    rng = np.random.default_rng(8)
    dst = rng.uniform(20, 60, (n, 3)).astype(np.float32)
    dst[a] = dst[b] = [0.5, -0.25, 0.125]
    src = (dst[a] + rng.uniform(-0.3, 0.3, (m, 3))).astype(np.float32)
    idx, _ = nn_bf16.nn_bf16(torch.from_numpy(src).to(cuda_device),
                             torch.from_numpy(dst).to(cuda_device))
    assert torch.all(idx == a), (where, a, b, torch.unique(idx))


def test_nn_bf16_kernel_sentinel_rows_never_win(cuda_device):
    """Sentinel (1e6) targets at the start of every split and staged tile,
    and in a block at the end, never win for a real source point; a source
    at the sentinel itself picks one."""
    m, n = 16384, 20000
    k, length = _k3_split(m, n)
    src, dst = _clouds(m, n, seed=10, scale=40.0)
    pad = np.zeros(n, bool)
    for start in range(0, n, length):
        for t in range(start, min(n, start + length), 256):
            pad[t:t + 8] = True
    pad[-700:] = True
    dst[pad] = 1.0e6
    src[-5:] = 1.0e6
    idx, d2 = nn_bf16.nn_bf16(torch.from_numpy(src).to(cuda_device),
                              torch.from_numpy(dst).to(cuda_device))
    idx = idx.cpu().numpy()
    assert not pad[idx[:-5]].any()
    assert pad[idx[-5:]].all() and torch.all(torch.isfinite(d2))


def test_nn_bf16_is_one_wrapper_launch_of_four_kernels(cuda_device):
    """One call adds one to K3's counter, and puts the four kernels of the
    design on the card (centre, pack, scan, fold) and nothing else; its
    plain version counts nothing."""
    from torch.profiler import ProfilerActivity, profile

    s, d = (torch.from_numpy(a).to(cuda_device)
            for a in _clouds(4096, 5000, seed=12, scale=30.0))
    nn_bf16.nn_bf16(s, d)
    torch.cuda.synchronize()
    before = nn_bf16.nn_bf16.launches
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _open_trace_window()
        nn_bf16.nn_bf16(s, d)
        torch.cuda.synchronize()
    nn_bf16.nn_bf16_ref(s, d)
    assert nn_bf16.nn_bf16.launches == before + 1
    kernels = _own_kernels(prof)
    assert len(kernels) == 4, kernels
    for want in ("nn_centre_kernel", "nn_pack_kernel", "packed_scan_kernel",
                 "nn_fold_kernel"):
        assert sum(want in k for k in kernels) == 1, (want, kernels)


@pytest.mark.parametrize("m,n", [(16384, 16384), (300, 5000), (1000, 100)])
def test_nn_rescore_kernel_matches_plain(cuda_device, m, n):
    """K4 against its plain version: the same packed operands and the same
    float32 rescore, so indices agree but for packed-score near-ties inside
    one slot (>= 99.9%) and the picked d² is equal wherever they do;
    (1000, 100) is a single slot (S = 1), sentinel rows never picked."""
    src, dst = _clouds(m, n, seed=m + 1, scale=40.0)
    n_pad = n // 8
    dst[-n_pad:] = 1.0e6
    s, d = (torch.from_numpy(a).to(cuda_device) for a in (src, dst))
    idx, d2 = nn_rescore.nn_rescore(s, d)
    ridx, rd2 = nn_rescore.nn_rescore_ref(s, d)
    assert idx.dtype == torch.int32 and idx.shape == (m,)
    same = idx == ridx
    assert float(same.float().mean()) >= 0.999
    assert torch.equal(d2[same], rd2[same])
    assert int(idx.max()) < n - n_pad
    if (m, n) == (1000, 100):
        assert nn_rescore.slots(n)[1] == 1


def test_nn_rescore_kernel_ties_go_to_the_lowest_slot(cuda_device):
    """An exact duplicate at indices 3 and 8 (slots 3 and 0 of 8): the
    kernel takes the lower slot, 8, as the reference does."""
    rng = np.random.default_rng(5)
    dst = rng.uniform(-20, 20, (1024, 3)).astype(np.float32)
    dst[8] = dst[3] = [0.5, 0.25, -0.125]
    src = (dst[3] + rng.uniform(-0.01, 0.01, (40, 3))).astype(np.float32)
    idx, _ = nn_rescore.nn_rescore(torch.from_numpy(src).to(cuda_device),
                                   torch.from_numpy(dst).to(cuda_device))
    assert torch.all(idx == 8)


def test_batched_nn_kernel_matches_plain(cuda_device):
    """K1's batched form: B = 16 sources over 2 targets (G = 8) against the
    plain version element by element; B = 1 is the unbatched call bit for
    bit."""
    rng = np.random.default_rng(3)
    src = rng.uniform(-40, 40, (16, 4096, 3)).astype(np.float32)
    dst = rng.uniform(-40, 40, (2, 5000, 3)).astype(np.float32)
    dst[:, -100:] = 1.0e6
    s, d = (torch.from_numpy(a).to(cuda_device) for a in (src, dst))
    idx, d2 = nn_cuda.nn_bruteforce(s, d)
    ridx, rd2 = nn_cuda.nn_bruteforce_ref(s, d)
    assert idx.shape == (16, 4096) and idx.dtype == torch.int32
    assert float((idx == ridx).float().mean()) >= 0.999
    torch.testing.assert_close(d2, rd2, rtol=1e-6, atol=1e-5)
    for b in (0, 9):  # each element is its own unbatched search
        one = nn_cuda.nn_bruteforce(s[b].contiguous(), d[b // 8].contiguous())
        assert torch.equal(one[0], idx[b]) and torch.equal(one[1], d2[b])
    one = nn_cuda.nn_bruteforce(s[:1], d[:1])
    ref = nn_cuda.nn_bruteforce(s[0].contiguous(), d[0].contiguous())
    assert torch.equal(one[0][0], ref[0]) and torch.equal(one[1][0], ref[1])


def test_batched_wrappers_raise_and_count(cuda_device):
    a = torch.zeros(4, 8, 3, device=cuda_device)
    with pytest.raises(ValueError):  # 4 sources over 3 targets
        nn_cuda.nn_bruteforce(a, a[:3])
    with pytest.raises(ValueError):
        nn_cuda.nn_bruteforce(a, a[:2].cpu())
    with pytest.raises(ValueError):
        nn_cuda.nn_bruteforce(a.transpose(0, 1), a[:1])
    # batched K3: one unbatched launch a row against target b // G, each
    # equal to its own call
    rng = torch.Generator(device="cpu").manual_seed(0)
    s = torch.rand(4, 64, 3, generator=rng).to(cuda_device)
    t = torch.rand(2, 80, 3, generator=rng).to(cuda_device)
    n0 = nn_bf16.nn_bf16.launches
    idx, d2 = nearest_neighbor(s, t, backend="pallas", precision="bf16")
    assert nn_bf16.nn_bf16.launches == n0 + 4
    for b in range(4):
        one = nn_bf16.nn_bf16(s[b], t[b // 2])
        assert torch.equal(idx[b], one[0]) and torch.equal(d2[b], one[1])
    before = (nn_cuda.nn_bruteforce.launches,
              nn_cuda.nn_bruteforce.batched_launches,
              nn_rescore.nn_rescore.launches)
    nn_cuda.nn_bruteforce(a, a[:2])
    nn_cuda.nn_bruteforce(a[0], a[0])
    nn_rescore.nn_rescore(a[0], a[0])
    nn_rescore.nn_rescore_ref(a[0], a[0])
    nn_cuda.nn_bruteforce_ref(a, a[:2])
    assert (nn_cuda.nn_bruteforce.launches,
            nn_cuda.nn_bruteforce.batched_launches,
            nn_rescore.nn_rescore.launches) == (
        before[0] + 2, before[1] + 1, before[2] + 1)


def test_slam3d_on_cuda_matches_cpu(cuda_device):
    """Full SLAM at nn_precision="rescore" on the card (K4 and K2 in the
    front end, batched K1 in verification) against the port on the CPU
    (their plain versions): the same keyframes and closures, poses within
    3 cm; one K4 launch per front-end ICP iteration, one K1 launch per
    batched verification iteration. K4 and its plain version add the 13
    packed products in different orders (a float32 ulp of the packed score
    is ~6e-5 m² at these extents), so near-tied points of one slot can swap;
    each swap moves a 768-point scan's pose by a few mm, and the map carries
    it on (observed 9.7e-3 m on an H100)."""
    from tpu_icp_slam_torch import BackendConfig, synthetic
    from tpu_icp_slam_torch.core.pointcloud import voxel_downsample_np
    from tpu_icp_slam_torch.slam.runner import pad_scans
    from tpu_icp_slam_torch.slam.slam3d import Slam3D

    cfg = SlamConfig(
        icp=ICPConfig(method="point_to_plane", max_iters=15,
                      max_corr_dist=1.5, damping=1e-3, max_step_trans=1.0,
                      max_step_rot=0.3, min_inliers=50, huber_delta=0.3,
                      nn_precision="rescore"),
        mapping=MappingConfig(map_capacity=8192, local_model_size=2048,
                              map_voxel=0.3),
        pipeline=PipelineConfig(mode="scan_to_map", scan_capacity=768,
                                keyframe_trans=1.6, keyframe_rot=0.2),
        backend=BackendConfig(enabled=True, min_loop_separation=2,
                              candidate_topk=1, verify_yaws=4,
                              verify_max_rmse=0.6, gating_radius=10.0),
    )
    scans, _ = synthetic.velodyne_log(n_frames=8, n_rings=10, n_azimuth=192,
                                      path_fraction=0.1)
    scans = [voxel_downsample_np(s, 0.5) for s in scans]
    pts, msk = pad_scans(scans + scans[::-1][1:], 768)
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        slam = Slam3D(cfg, device=dev)
        k0 = (nn_rescore.nn_rescore.launches, nn_cuda.nn_bruteforce.launches)
        poses, rep = slam.run(pts, msk, mode="fused")
        out[dev.type] = (poses, rep, slam, (
            nn_rescore.nn_rescore.launches - k0[0],
            nn_cuda.nn_bruteforce.launches - k0[1]))
    (gp, g_rep, gslam, gl), (cp, crep, _, cl) = out["cuda"], out["cpu"]
    assert crep.n_loop_closures >= 1
    assert (g_rep.n_keyframes, g_rep.n_loop_closures) == (
        crep.n_keyframes, crep.n_loop_closures)
    np.testing.assert_allclose(gp[:, :3, 3], cp[:, :3, 3], atol=3e-2)
    assert gl == (int(gslam.frontend_iters.sum()),
                  gslam.detector.verify_iters) and cl == (0, 0)


def _align_problem(device, seed=0, m=4096, n=6144):
    """Two walls and a floor (tests/test_icp_fused.py's _problem, larger),
    the scan a noisy subset moved by a known transform."""
    rng = np.random.default_rng(seed)
    k = n // 3
    dst = np.concatenate([
        np.c_[rng.uniform(-8, 8, k), rng.uniform(-8, 8, k), np.zeros(k)],
        np.c_[np.full(k, 8.0), rng.uniform(-8, 8, k), rng.uniform(0, 4, k)],
        np.c_[rng.uniform(-8, 8, n - 2 * k), np.full(n - 2 * k, -8.0),
              rng.uniform(0, 4, n - 2 * k)]]).astype(np.float32)
    nrm = np.zeros_like(dst)
    nrm[:k, 2] = 1.0
    nrm[k:2 * k, 0] = -1.0
    nrm[2 * k:, 1] = 1.0
    ang = 0.05
    R = np.array([[np.cos(ang), -np.sin(ang), 0], [np.sin(ang), np.cos(ang), 0],
                  [0, 0, 1]], np.float32)
    t = np.array([0.3, -0.2, 0.1], np.float32)
    src = (dst[rng.permutation(n)[:m]] - t) @ R  # = R^T (x - t)
    src += rng.normal(size=src.shape).astype(np.float32) * 0.005
    smask = np.ones(m, bool)
    smask[-m // 8:] = False
    dst[-32:] = 1.0e6  # padded model rows
    dmask = np.ones(n, bool)
    dmask[-32:] = False
    args = tuple(torch.from_numpy(a).to(device)
                 for a in (src, smask, dst, nrm, dmask))
    kw = dict(max_iters=18, tol=1e-5, tol_update=0.01, max_corr_dist=1.0,
              huber_delta=0.3, damping=1e-3, step_scale=1.4,
              max_step_trans=1.0, max_step_rot=0.3, min_inliers=100,
              prior_trans_weight=0.004, prior_rot_weight=0.04,
              max_total_trans=1.5, max_total_rot=0.5)
    return args, kw


@pytest.mark.parametrize("precision", ["highest", "bf16"])
def test_icp_fused_kernel_matches_plain(cuda_device, precision):
    """K5 against its plain version on the card: the same pose up to float32
    summation order (5e-4 m / rad), one launch per align, bit-reproducible
    across launches."""
    args, kw = _align_problem(cuda_device)
    r_gate = torch.tensor(30.0, device=cuda_device)
    before = icp_fused.icp_fused.launches
    T, rmse, it, inl, conv = icp_fused.icp_fused(
        *args, r_gate=r_gate, precision=precision, **kw)
    T2, rmse2, *_ = icp_fused.icp_fused(*args, r_gate=r_gate,
                                        precision=precision, **kw)
    assert icp_fused.icp_fused.launches == before + 2
    Tr, rmse_r, it_r, inl_r, conv_r = icp_fused.icp_fused_ref(
        *args, r_gate=r_gate, precision=precision, **kw)
    assert torch.equal(T, T2) and torch.equal(rmse, rmse2)
    assert it.dtype == torch.int32 and conv.dtype == torch.bool
    assert float(torch.max(torch.abs(T - Tr))) < 5e-4
    assert abs(float(rmse) - float(rmse_r)) < 1e-4
    assert abs(int(inl) - int(inl_r)) <= 0.01 * int(inl_r)
    assert abs(int(it) - int(it_r)) <= 1


def test_capability_probe(cuda_device):
    got = coop_probe.capability_probe(cuda_device)
    assert got["blocks"]["highest"] >= 1 and got["blocks"]["bf16"] >= 1


def test_fused_pipeline_on_cuda_matches_cpu(cuda_device):
    """loop_backend="fused" on the card (K5) against the port on the CPU
    (its plain version): one K5 launch per frame and no K1, K2 or K3."""
    from tpu_icp_slam_torch import synthetic
    from tpu_icp_slam_torch.core.pointcloud import voxel_downsample_np
    from tpu_icp_slam_torch.slam.runner import pad_scans
    from tpu_icp_slam_torch.slam.scan_to_map import ScanToMapPipeline

    cfg = SlamConfig(
        icp=ICPConfig(method="point_to_plane", max_iters=15,
                      max_corr_dist=1.5, damping=1e-3, max_step_trans=1.0,
                      max_step_rot=0.3, min_inliers=50, huber_delta=0.3,
                      loop_backend="fused"),
        mapping=MappingConfig(map_capacity=32768, local_model_size=4096,
                              map_voxel=0.3),
        pipeline=PipelineConfig(mode="scan_to_map", scan_capacity=2048,
                                keyframe_trans=2.0, keyframe_rot=0.2),
    )
    scans, _ = synthetic.velodyne_log(n_frames=8, n_rings=16, n_azimuth=320,
                                      path_fraction=0.1)
    pts, msk = pad_scans([voxel_downsample_np(s, 0.4) for s in scans], 2048)
    out = {}
    kernels = (nn_cuda.nn_bruteforce, gn_cuda.gn_accum, nn_bf16.nn_bf16,
               icp_fused.icp_fused)
    for dev in (cuda_device, torch.device("cpu")):
        pipe = ScanToMapPipeline(cfg, device=dev)
        k0 = [k.launches for k in kernels]
        _, infos = pipe.run_fused(pipe.init_state(pts[0], msk[0]), pts[1:],
                                  msk[1:])
        out[dev.type] = ({k: v.cpu().numpy() for k, v in infos.items()},
                         [k.launches - b for k, b in zip(kernels, k0)])
    (gpu, gpu_launches), (cpu, cpu_launches) = out["cuda"], out["cpu"]
    assert gpu_launches == [0, 0, 0, len(pts) - 1]
    assert cpu_launches == [0, 0, 0, 0]
    assert gpu["iters"].dtype.kind == "i"
    np.testing.assert_allclose(gpu["pose"], cpu["pose"], atol=5e-3)
    for k in ("is_keyframe", "map_inserted"):
        np.testing.assert_array_equal(gpu[k], cpu[k])


def test_pipeline_on_cuda_matches_cpu(cuda_device):
    """The scan-to-map slice on the card (kernels K1/K2) against the same
    port on the CPU (their plain versions); K1 and K2 run once per ICP
    iteration."""
    from tpu_icp_slam_torch import synthetic
    from tpu_icp_slam_torch.core.pointcloud import voxel_downsample_np
    from tpu_icp_slam_torch.slam.runner import pad_scans
    from tpu_icp_slam_torch.slam.scan_to_map import ScanToMapPipeline

    cfg = SlamConfig(
        icp=ICPConfig(method="point_to_plane", max_iters=15,
                      max_corr_dist=1.5, damping=1e-3, max_step_trans=1.0,
                      max_step_rot=0.3, min_inliers=50, huber_delta=0.3),
        mapping=MappingConfig(map_capacity=32768, local_model_size=4096,
                              map_voxel=0.3),
        pipeline=PipelineConfig(mode="scan_to_map", scan_capacity=2048,
                                keyframe_trans=2.0, keyframe_rot=0.2),
    )
    scans, _ = synthetic.velodyne_log(n_frames=8, n_rings=16, n_azimuth=320,
                                      path_fraction=0.1)
    pts, msk = pad_scans([voxel_downsample_np(s, 0.4) for s in scans], 2048)
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        pipe = ScanToMapPipeline(cfg, device=dev)
        k0 = (nn_cuda.nn_bruteforce.launches, gn_cuda.gn_accum.launches)
        _, infos = pipe.run_fused(pipe.init_state(pts[0], msk[0]), pts[1:],
                                  msk[1:])
        launches = (nn_cuda.nn_bruteforce.launches - k0[0],
                    gn_cuda.gn_accum.launches - k0[1])
        out[dev.type] = ({k: v.cpu().numpy() for k, v in infos.items()},
                         launches)
    (gpu, gpu_launches), (cpu, cpu_launches) = out["cuda"], out["cpu"]
    n_iters = int(gpu["iters"].sum())
    assert gpu_launches == (n_iters, n_iters) and cpu_launches == (0, 0)
    np.testing.assert_allclose(gpu["pose"], cpu["pose"], atol=5e-3)
    for k in ("is_keyframe", "map_inserted"):
        np.testing.assert_array_equal(gpu[k], cpu[k])
    cfg_xla = dataclasses.replace(
        cfg, icp=dataclasses.replace(cfg.icp, nn_backend="xla",
                                     gn_backend="xla"))
    k0 = (nn_cuda.nn_bruteforce.launches, gn_cuda.gn_accum.launches)
    pipe = ScanToMapPipeline(cfg_xla, device=cuda_device)
    pipe.run_fused(pipe.init_state(pts[0], msk[0]), pts[1:3], msk[1:3])
    assert (nn_cuda.nn_bruteforce.launches, gn_cuda.gn_accum.launches) == k0


def _chip_smoke():
    """chip_smoke.py (the repository root's), for K5_BOUNDS and its checks."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_for_cuda", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _bits(t):
    return t.contiguous().view({2: torch.int16, 4: torch.int32}[
        t.element_size()])


def _fma_emulated_nn(src, dst, chunk=1024):
    """K1's score chain in plain torch: dx·dx rounded to float32, then
    fma(dy, dy, .) and fma(dz, dz, .), each exact in float64 (a float32
    square is exact there) and rounded once to float32; the first minimum."""
    idx_out, d2_out = [], []
    for a in torch.split(src, chunk):
        dx = a[:, None, 0] - dst[None, :, 0]
        dy = a[:, None, 1] - dst[None, :, 1]
        dz = a[:, None, 2] - dst[None, :, 2]
        d = dx * dx
        d = (dy.double() * dy.double() + d.double()).float()
        d = (dz.double() * dz.double() + d.double()).float()
        d2, idx = torch.min(d, dim=1)
        idx_out.append(idx.to(torch.int32))
        d2_out.append(d2)
    return torch.cat(idx_out), torch.cat(d2_out)


@pytest.mark.parametrize("m,n", [(1, 1), (1025, 255), (130, 4099),
                                 (4097, 16387)])
def test_nn_kernel_is_its_score_chain_bit_for_bit(cuda_device, m, n):
    """K1, its loop now in csrc/nn_exact.cuh (shared with K5 at
    "highest"), against a plain emulation of its own score chain: indices
    and d2 equal bit for bit on ragged shapes, sentinel rows included."""
    src, dst = _clouds(m, n, seed=3 * m + n, scale=40.0)
    if n > 9:
        dst[-(n // 9):] = 1.0e6
    s, d = (torch.from_numpy(a).to(cuda_device) for a in (src, dst))
    idx, d2 = nn_cuda.nn_bruteforce(s, d)
    ridx, rd2 = _fma_emulated_nn(s, d)
    assert torch.equal(idx, ridx)
    assert torch.equal(_bits(d2), _bits(rd2))


def _packed(s, d):
    sc, dc = nn_bf16.recentre(s, d)
    return nn_bf16.pack_source(sc), nn_bf16.pack_target(dc)


@pytest.mark.parametrize("m,n", [(1, 1), (15, 17), (17, 15), (1, 16385),
                                 (16385, 1), (16385, 16385)])
def test_packed_mma_scorer_ragged_shapes(cuda_device, m, n):
    """The tensor-core scorer over a whole target at ragged M and N: every
    score within TAU·Σ|a b| of the exact packed score, every pick the plain
    argmin's or a near-tie of it, and an exact duplicate target planted
    across a fragment edge (7, 8) and across a tile edge (255, 256) goes to
    the lower index."""
    src, dst = _clouds(m, n, seed=7 * m + n, scale=30.0)
    planted = [(a, b) for a, b in ((7, 8), (255, 256)) if b < n]
    for k, (a, b) in enumerate(planted):
        dst[a] = dst[b] = [0.5 + 10.0 * k, -0.25, 0.125]
        if k < m:
            src[k] = dst[a] + np.float32([1e-3, 0.0, 0.0])
    s, d = (torch.from_numpy(x).to(cuda_device) for x in (src, dst))
    a_aug, b_aug = _packed(s, d)
    before = packed_mma.packed_mma_argmin.launches
    idx, e = packed_mma.packed_mma_argmin(a_aug, b_aug)
    assert packed_mma.packed_mma_argmin.launches == before + 1
    ridx, _ = nn_bf16.packed_argmin_ref(a_aug, b_aug)
    assert idx.shape == (m,) and idx.dtype == torch.int32
    assert int(idx.min()) >= 0 and int(idx.max()) < n
    exact, mag = packed_mma.exact_scores(a_aug, b_aug, idx)
    assert float(torch.max(torch.abs(e.double() - exact) / mag)) \
        <= packed_mma.TAU
    assert bool(packed_mma.near_ties(a_aug, b_aug, idx, ridx).all())
    for k, (a, _) in enumerate(planted[:m]):
        assert int(idx[k]) == a, (k, a, int(idx[k]))


def test_packed_mma_scorer_is_k3_scan_and_fold(cuda_device):
    """packed_mma_argmin runs K3's scan over its target splits and K3's
    fold, two kernels, and returns K3's raw minimum: the same picks as a K3
    call on the clouds it packed, e_min bit-equal to that call's.

    The profiler can miss the first kernels of a traced window (one run on
    an H100 saw 5 of 6, the sleep kernel that opens the window
    notwithstanding), so the kernels are counted by name over 8
    back-to-back calls after the first call's fold: each of the two at
    least 3 times and both equally often, and no other kernel of the
    port's."""
    from torch.profiler import ProfilerActivity, profile

    s, d = (torch.from_numpy(a).to(cuda_device)
            for a in _clouds(3000, 7000, seed=13, scale=30.0))
    a_aug, b_aug = _packed(s, d)
    packed_mma.packed_mma_argmin(a_aug, b_aug)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _open_trace_window()
        for _ in range(8):
            idx, e = packed_mma.packed_mma_argmin(a_aug, b_aug)
        torch.cuda.synchronize()
    kernels = _own_kernels(prof, in_order=True)
    first_fold = next(i for i, k in enumerate(kernels)
                      if "nn_fold_kernel" in k)
    kernels = kernels[first_fold + 1:]
    counts = {want: sum(want in k for k in kernels)
              for want in ("packed_scan_kernel", "nn_fold_kernel")}
    assert sum(counts.values()) == len(kernels), kernels
    assert min(counts.values()) >= 3, counts
    assert counts["packed_scan_kernel"] == counts["nn_fold_kernel"], counts
    det = nn_bf16.nn_bf16_detail(s, d)
    assert torch.equal(idx, det["idx"])
    assert torch.equal(_bits(e), _bits(det["e_min"]))


def test_packed_mma_scorer_raises_on_bad_operands(cuda_device):
    a = torch.zeros(8, 16, dtype=torch.bfloat16, device=cuda_device)
    with pytest.raises(ValueError):
        packed_mma.packed_mma_argmin(a.float(), a)
    with pytest.raises(ValueError):
        packed_mma.packed_mma_argmin(a[:, :15].contiguous(), a)
    with pytest.raises(ValueError):
        packed_mma.packed_mma_argmin(a, a.cpu())
    with pytest.raises(ValueError):
        packed_mma.packed_mma_argmin(a[:0], a)


def test_nn_rescore_kernel_slots_ties_and_sentinels(cuda_device):
    """K4 at N = 3,000 (not a multiple of TN) with tile_n = 256 (S = 12):
    an exact duplicate at indices 5 (slot 5) and 14 (slot 2) goes to the
    lower SLOT, 14; sentinel rows never win a real source; the candidates
    are the plain version's or near-ties of them, the picks equal on >= 99%
    of the rows and d2 equal where they are."""
    rng = np.random.default_rng(21)
    dst = rng.uniform(-20, 20, (3000, 3)).astype(np.float32)
    dst[-300:] = 1.0e6
    dst[5] = dst[14] = [0.5, 0.25, -0.125]
    src = rng.uniform(-20, 20, (2000, 3)).astype(np.float32)
    src[:40] = dst[5] + rng.uniform(-0.01, 0.01, (40, 3)).astype(np.float32)
    s, d = (torch.from_numpy(a).to(cuda_device) for a in (src, dst))
    assert nn_rescore.slots(3000, 256) == (256, 12)
    idx, d2 = nn_rescore.nn_rescore(s, d, tile_n=256)
    det = nn_rescore.nn_rescore_detail(s, d, tile_n=256)
    plain = nn_rescore.shortlist_ref(s, d, tile_n=256)
    ridx, rd2 = nn_rescore.nn_rescore_ref(s, d, tile_n=256)
    assert torch.equal(det["idx"], idx) and torch.equal(det["d2"], d2)
    assert torch.all(idx[:40] == 14)
    assert int(idx.max()) < 2700
    assert bool(packed_mma.near_ties(det["a_aug"], det["b_aug"], det["cand"],
                                     plain["cand"]).all())
    same = idx == ridx
    assert float(same.float().mean()) >= 0.99
    assert torch.equal(d2[same], rd2[same])
    exact, mag = packed_mma.exact_scores(det["a_aug"], det["b_aug"],
                                         det["cand"])
    assert float(torch.max(torch.abs(det["cand_score"].double() - exact)
                           / mag)) <= packed_mma.TAU


@pytest.mark.parametrize("m,n,tile_n,offset", [(300, 5000, 0, 0.0),
                                               (1, 1, 0, 0.0),
                                               (4097, 3000, 256, 500.0)])
def test_nn_rescore_device_packing_is_the_plain_packing(cuda_device, m, n,
                                                        tile_n, offset):
    """K4's recentring and packing on the device (two launches) give the
    plain packing's bits: recentred source, padded target, both packed rows
    (a 500 m offset and sentinel rows included)."""
    src, dst = _clouds(m, n, seed=m + n, scale=40.0)
    src += np.float32(offset)
    dst += np.float32(offset)
    if n > 8:
        dst[-(n // 8):] = 1.0e6
    s, d = (torch.from_numpy(a).to(cuda_device) for a in (src, dst))
    dev = nn_rescore.nn_rescore_detail(s, d, tile_n)
    plain = nn_rescore.shortlist_ref(s, d, tile_n)
    for k in ("sc", "dp", "a_aug", "b_aug"):
        assert dev[k].shape == plain[k].shape, k
        assert torch.equal(_bits(dev[k]), _bits(plain[k])), k


@pytest.mark.parametrize("precision", ["highest", "bf16"])
def test_icp_fused_kernel_ragged_held_to_bounds(cuda_device, precision):
    """K5 at M = 4,000 (not a multiple of its 64-row tile) and N = 6,000
    (ragged to both precisions' model tiles): bit-reproducible across two
    launches, and held to chip_smoke.K5_BOUNDS against its plain version,
    iterations, inliers and convergence equal."""
    smoke = _chip_smoke()
    args, kw = _align_problem(cuda_device, seed=2, m=4000, n=6000)
    r_gate = torch.tensor(30.0, device=cuda_device)
    out = icp_fused.icp_fused(*args, r_gate=r_gate, precision=precision, **kw)
    again = icp_fused.icp_fused(*args, r_gate=r_gate, precision=precision,
                                **kw)
    ref = icp_fused.icp_fused_ref(*args, r_gate=r_gate, precision=precision,
                                  **kw)
    assert all(torch.equal(x, y) for x, y in zip(out, again))
    assert smoke._k5_mismatches(out, ref, precision) == []


def _small_scan_to_map(cuda_device):
    """A short scan-to-map log and chip_smoke's small point-to-plane
    configuration (phase 5's), the pipeline on the card."""
    from tpu_icp_slam_torch import synthetic
    from tpu_icp_slam_torch.core.pointcloud import voxel_downsample_np
    from tpu_icp_slam_torch.slam.runner import pad_scans
    from tpu_icp_slam_torch.slam.scan_to_map import ScanToMapPipeline

    cfg = SlamConfig(
        icp=ICPConfig(method="point_to_plane", max_iters=15,
                      max_corr_dist=1.5, damping=1e-3, max_step_trans=1.0,
                      max_step_rot=0.3, min_inliers=50, huber_delta=0.3),
        mapping=MappingConfig(map_capacity=32768, local_model_size=4096,
                              map_voxel=0.3),
        pipeline=PipelineConfig(mode="scan_to_map", scan_capacity=2048,
                                keyframe_trans=2.0, keyframe_rot=0.2),
    )
    scans, gt = synthetic.velodyne_log(n_frames=6, n_rings=16, n_azimuth=320,
                                       path_fraction=0.08)
    pts, msk = pad_scans([voxel_downsample_np(s, 0.4) for s in scans], 2048)
    return ScanToMapPipeline(cfg, device=cuda_device), pts, msk, gt


def test_checkpoint_on_the_card_resumes_bit_equal(cuda_device, tmp_path):
    """A MapOdomState on the card saved, loaded back onto the card, and
    stepped once: the same leaves and the same step as the live state's,
    bit for bit."""
    from tpu_icp_slam_torch.slam import checkpoint

    pipe, pts, msk, _ = _small_scan_to_map(cuda_device)
    st = pipe.init_state(pts[0], msk[0])
    hist = [np.eye(4)]
    for f in range(1, 4):
        st, info = pipe.step(st, pts[f], msk[f])
        hist.append(info["pose"].cpu().numpy())
    path = str(tmp_path / "ck.npz")
    checkpoint.save_checkpoint(path, st, 4, hist, cfg=pipe.cfg)
    st2, nxt, hist2 = checkpoint.load_checkpoint(path, pipe.cfg,
                                                 device=cuda_device)
    assert nxt == 4 and len(hist2) == 4
    assert st2.pose.device.type == "cuda"
    for a, b in zip(checkpoint._flatten(st2), checkpoint._flatten(st)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    _, live = pipe.step(st, pts[4], msk[4])
    _, loaded = pipe.step(st2, pts[4], msk[4])
    for k in live:
        assert torch.equal(torch.as_tensor(live[k]),
                           torch.as_tensor(loaded[k])), k


def test_cli_align_on_the_card(cuda_device, capsys):
    """`cli align --n 4096` with the default device: the transform
    recovered to 1e-3 through K1, one launch per ICP iteration of each of
    its two solves."""
    from tpu_icp_slam_torch import cli

    nn_cuda.nn_bruteforce.launches = 0
    rc = cli.main(["align", "--n", "4096"])
    rep = json.loads(capsys.readouterr().out)
    assert rc == 0 and rep["recovered_under_1e-3"], rep
    assert nn_cuda.nn_bruteforce.launches == 2 * rep["iters"] > 0


def test_localize_in_map_on_the_card_matches_cpu(cuda_device, tmp_path):
    """One saved map localized on the card and on the CPU: the same matched
    keyframe, positions within 1e-3 m (the kernels' picks differ from the
    plain version's only at near-ties; float32 ICP in another summation
    order), verification on batched K1."""
    from tpu_icp_slam_torch import BackendConfig, synthetic
    from tpu_icp_slam_torch.backend.loop_closure import LoopDetector
    from tpu_icp_slam_torch.core.pointcloud import voxel_downsample_np
    from tpu_icp_slam_torch.slam import map_io
    from tpu_icp_slam_torch.slam.runner import pad_scans

    scans, gt = synthetic.velodyne_log(n_frames=16, n_rings=12,
                                       n_azimuth=256, path_fraction=0.4)
    pts, msk = pad_scans([voxel_downsample_np(s, 0.5) for s in scans], 1536)
    cfg = BackendConfig(verify_max_rmse=0.6, verify_max_dev=0.0)
    det = LoopDetector(cfg, device="cpu")
    kf = list(range(0, 16, 2))
    for f in kf:
        det.add_keyframe(pts[f], msk[f], position=gt[f][:3, 3])
    path = str(tmp_path / "map.npz")
    map_io.save_map(path, [(pts[f], msk[f]) for f in kf], gt[kf],
                    detector=det)
    nn_cuda.nn_bruteforce.batched_launches = 0
    card = map_io.localize_in_map(
        map_io.load_map(path, cfg, device=cuda_device), pts[5], msk[5])
    assert nn_cuda.nn_bruteforce.batched_launches > 0
    cpu = map_io.localize_in_map(map_io.load_map(path, cfg, device="cpu"),
                                 pts[5], msk[5])
    assert card is not None and cpu is not None
    assert card[1] == cpu[1]
    assert np.linalg.norm(card[0][:3, 3] - cpu[0][:3, 3]) < 1e-3
    assert np.linalg.norm(card[0][:3, 3] - gt[5][:3, 3]) < 1.0


# ---- config 2: K1 on 2-D points and the 2D pipelines ----------------------


def _clouds2(m, n, seed, scale):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-scale, scale, (m, 2)).astype(np.float32),
            rng.uniform(-scale, scale, (n, 2)).astype(np.float32))


@pytest.mark.parametrize("m,n", [(1, 1), (1025, 255), (130, 4099),
                                 (4096, 4096), (16384, 16384)])
def test_nn_kernel_2d_is_the_plain_version_bit_for_bit(cuda_device, m, n):
    """K1 at D = 2 scores dx*dx + dy*dy with the plain version's rounding:
    idx and d2 equal to the plain version's bit for bit on ragged shapes,
    sentinel rows included and never picked by a real point."""
    src, dst = _clouds2(m, n, seed=5 * m + n, scale=12.0)
    n_pad = n // 9
    if n_pad:
        dst[-n_pad:] = 1.0e6
    s, d = (torch.from_numpy(a).to(cuda_device) for a in (src, dst))
    before = nn_cuda.nn_bruteforce.launches
    idx, d2 = nn_cuda.nn_bruteforce(s, d)
    assert nn_cuda.nn_bruteforce.launches == before + 1
    ridx, rd2 = nn_cuda.nn_bruteforce_ref(s, d)
    assert idx.shape == (m,) and idx.dtype == torch.int32
    assert torch.equal(idx, ridx)
    assert torch.equal(_bits(d2), _bits(rd2))
    assert int(idx.max()) < n - n_pad or n_pad == 0


def test_nn_kernel_2d_ties_go_to_lowest_index(cuda_device):
    dst = torch.zeros(5000, 2, device=cuda_device)
    dst[:, 0] = 5.0
    dst[[17, 1200, 2500, 4999], 0] = 1.0  # equidistant winners in 3 splits
    idx, d2 = nn_cuda.nn_bruteforce(torch.zeros(64, 2, device=cuda_device),
                                    dst)
    assert torch.all(idx == 17) and torch.all(d2 == 1.0)


def test_batched_nn_kernel_2d_is_the_plain_version_bit_for_bit(cuda_device):
    """Batched K1 at D = 2, loop verification's shape (B = 32 = 4
    candidates x 8 yaws, G = 8, M = N = 512): bit-equal to the plain
    version, and B = 1 to the unbatched call."""
    rng = np.random.default_rng(9)
    src = rng.uniform(-12, 12, (32, 512, 2)).astype(np.float32)
    dst = rng.uniform(-12, 12, (4, 512, 2)).astype(np.float32)
    dst[:, -40:] = 1.0e6
    s, d = (torch.from_numpy(a).to(cuda_device) for a in (src, dst))
    before = nn_cuda.nn_bruteforce.batched_launches
    idx, d2 = nn_cuda.nn_bruteforce(s, d)
    assert nn_cuda.nn_bruteforce.batched_launches == before + 1
    ridx, rd2 = nn_cuda.nn_bruteforce_ref(s, d)
    assert idx.shape == (32, 512)
    assert torch.equal(idx, ridx) and torch.equal(_bits(d2), _bits(rd2))
    one = nn_cuda.nn_bruteforce(s[:1], d[:1])
    ref = nn_cuda.nn_bruteforce(s[0].contiguous(), d[0].contiguous())
    assert torch.equal(one[0][0], ref[0]) and torch.equal(one[1][0], ref[1])
    with pytest.raises(ValueError):  # 2-D sources over 3-D targets
        nn_cuda.nn_bruteforce(s, torch.zeros(4, 512, 3, device=cuda_device))


def _sim2d_cfg():
    from tpu_icp_slam_torch.config import override

    return override(SlamConfig(), {
        "icp.max_corr_dist": 0.5, "icp.max_iters": 30,
        "pipeline.scan_capacity": 512, "mapping.grid_size": 256,
        "mapping.grid_resolution": 0.1, "mapping.ray_samples": 64})


def test_odometry_2d_on_cuda_matches_cpu(cuda_device):
    """2D scan-to-scan odometry (SE(2) ICP on K1 at D = 2, the occupancy
    grid) on the card and on the CPU: the same iterations, poses within
    5e-5 (K1 is bit-equal; the SVDs and sums round apart: measured 1.55e-5
    on an H100), grids equal within 1e-4 but for a few cells on a face (at
    most 0.05%), one K1 launch per ICP iteration."""
    from tpu_icp_slam_torch.slam import runner
    from tpu_icp_slam_torch.slam.pipeline import OdometryPipeline

    pts, msk = runner.pad_scans(runner.load_dataset("sim2d", 12).scans, 512)
    out = {}
    for dev in (cuda_device, "cpu"):
        pipe = OdometryPipeline(_sim2d_cfg(), dim=2, device=dev)
        nn_cuda.nn_bruteforce.launches = 0
        st, infos = pipe.run_fused(pipe.init_state(pts[0], msk[0]), pts[1:],
                                   msk[1:])
        out[str(dev)] = (st, {k: v.cpu() for k, v in infos.items()},
                         nn_cuda.nn_bruteforce.launches)
    (gs, gi, launches), (cs, ci, _) = out["cuda"], out["cpu"]
    assert launches == int(gi["iters"].sum()) > 0
    assert torch.equal(gi["iters"], ci["iters"])
    torch.testing.assert_close(gi["pose"], ci["pose"], rtol=0, atol=5e-5)
    diff = (gs.grid.logodds.cpu() - cs.grid.logodds).abs()
    assert float((diff > 1e-4).float().mean()) <= 5e-4


def test_occupancy_update_on_cuda_matches_cpu(cuda_device):
    """The grid's scatter-adds run in the atomics' order on the card:
    log-odds within 1e-5 of the CPU's."""
    from tpu_icp_slam_torch import synthetic
    from tpu_icp_slam_torch.mapping import occupancy2d

    log = synthetic.lidar2d_log(n_frames=3, n_beams=360, seed=2)
    pts = torch.as_tensor(synthetic.scan_to_points(
        log.ranges[1], log.angles, log.max_range), dtype=torch.float32)
    mask = torch.ones(len(pts), dtype=torch.bool)
    pose = torch.as_tensor(log.gt_poses[1], dtype=torch.float32)
    grids = {}
    for dev in (cuda_device, "cpu"):
        g = occupancy2d.create(512, 0.05, device=dev)
        for _ in range(3):
            g = occupancy2d.update(g, pose.to(dev), pts.to(dev),
                                   mask.to(dev))
        grids[str(dev)] = g.logodds.cpu()
    torch.testing.assert_close(grids["cuda"], grids["cpu"], rtol=0,
                               atol=1e-5)
    assert (grids["cuda"] > 0).sum() > 100


@pytest.mark.parametrize("dim", [2, 3])
def test_voxel_nn_on_cuda_matches_cpu(cuda_device, dim):
    from tpu_icp_slam_torch.core import pointcloud as tpc
    from tpu_icp_slam_torch.kernels import voxel_nn

    rng = np.random.default_rng(5)
    dst = rng.uniform(-8, 8, (3000, dim)).astype(np.float32)
    src = (dst[rng.integers(0, 3000, 1000)]
           + 0.1 * rng.standard_normal((1000, dim))).astype(np.float32)
    out = {}
    for dev in (cuda_device, "cpu"):
        cl = tpc.make(dst, capacity=3072, device=dev)
        g = voxel_nn.build(cl.points, cl.mask, voxel=0.8, table_size=4096,
                           bucket=16)
        idx, d2 = voxel_nn.query(g, torch.from_numpy(src).to(dev), voxel=0.8)
        out[str(dev)] = (g.table.cpu(), idx.cpu(), d2.cpu())
    assert torch.equal(out["cuda"][0], out["cpu"][0])
    assert torch.equal(out["cuda"][1], out["cpu"][1])
    torch.testing.assert_close(out["cuda"][2], out["cpu"][2], rtol=1e-6,
                               atol=1e-6)


def test_unrolled_icp_on_cuda_reads_nothing_back(cuda_device):
    """icp.unroll_iters: the fixed-trip loop (point-to-plane: K1, K2 and a
    Cholesky solve; torch's SVD, which point-to-point solves with,
    synchronizes by itself) makes no synchronizing call inside the trip,
    returns iters on the card, and equals the host loop."""
    import warnings

    from tpu_icp_slam_torch import synthetic
    from tpu_icp_slam_torch.core import pointcloud as tpc
    from tpu_icp_slam_torch.icp import loop
    from tpu_icp_slam_torch.mapping.normals import normals_knn

    s, d, _ = synthetic.two_scan_pair(n=2048, seed=7, rot_scale=0.05,
                                      trans_scale=0.2)
    dp = torch.as_tensor(d, dtype=torch.float32, device=cuda_device)
    nrm = normals_knn(dp, torch.ones(len(d), dtype=torch.bool,
                                     device=cuda_device), k=8)
    a = (tpc.make(s, device=cuda_device),
         tpc.make(d, normals=nrm, device=cuda_device))
    base = ICPConfig(method="point_to_plane", max_iters=25, tol=1e-6,
                     max_corr_dist=1.0, damping=1e-6)
    res_w = loop.align(*a, cfg=base)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            res_u = loop.align(*a, cfg=dataclasses.replace(base,
                                                           unroll_iters=25))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert not [w for w in caught if "synchroniz" in str(w.message)]
    assert res_u.iters.device.type == "cuda"
    assert int(res_u.iters) == res_w.iters
    torch.testing.assert_close(res_u.T, res_w.T, rtol=0, atol=1e-6)


def test_slam2d_on_cuda_matches_cpu(cuda_device):
    """Slam2D on the out-and-back corridor (16 frames out, 15 back, 256
    points): the same keyframes and accepted closures on the card as on the
    CPU, poses within 1e-3 m; verification on batched K1 at D = 2."""
    from tpu_icp_slam_torch import BackendConfig, synthetic
    from tpu_icp_slam_torch.slam.runner import pad_scans
    from tpu_icp_slam_torch.slam.slam2d import Slam2D

    log = synthetic.lidar2d_log(n_frames=16, n_beams=360, seed=0, noise=0.01)
    fwd = [synthetic.scan_to_points(log.ranges[i], log.angles, log.max_range)
           for i in range(16)]
    pts, msk = pad_scans(fwd + fwd[::-1][1:], 256)
    cfg = SlamConfig(
        icp=ICPConfig(method="point_to_point", max_iters=30,
                      max_corr_dist=1.0),
        pipeline=PipelineConfig(scan_capacity=256, keyframe_trans=1.0,
                                keyframe_rot=0.3),
        backend=BackendConfig(enabled=True, min_loop_separation=8,
                              candidate_topk=3, verify_max_rmse=0.25,
                              gating_radius=3.0, verify_max_dev=1.2,
                              descriptor_rings=12, descriptor_sectors=48))
    out = {}
    for dev in (cuda_device, "cpu"):
        slam = Slam2D(cfg, sensor_max_range=log.max_range, device=dev)
        nn_cuda.nn_bruteforce.batched_launches = 0
        poses, rep = slam.run(pts, msk)
        out[str(dev)] = (slam, poses, rep,
                         nn_cuda.nn_bruteforce.batched_launches)
    (g, gp, grep, batched), (c, cp, crep, _) = out["cuda"], out["cpu"]
    assert g.kf_frames == c.kf_frames
    assert sorted((lc.i, lc.j) for lc in g.closures) == sorted(
        (lc.i, lc.j) for lc in c.closures)
    assert grep.n_loop_closures >= 1
    assert batched == g.detector.verify_iters > 0
    np.testing.assert_allclose(gp[:, :2, 2], cp[:, :2, 2], atol=1e-3)


# ---- config 3 (RGB-D) and the mapping options --------------------------------


def _rgbd_maps(device, size=(640, 480), frames=(0, 1), n_frames=30):
    """Vertex, normal and validity maps of frames of the synthetic depth
    log, computed on the CPU and copied to `device` (the same inputs on
    both devices), and its intrinsics."""
    from tpu_icp_slam_torch import synthetic
    from tpu_icp_slam_torch.icp import projective
    from tpu_icp_slam_torch.mapping.normals import normals_from_depth

    depths, _, ki = synthetic.rgbd_log(
        n_frames=n_frames, K=synthetic.Intrinsics.tum_default(*size))
    K = projective.CameraIntrinsics(ki.fx, ki.fy, ki.cx, ki.cy, ki.width,
                                    ki.height)
    out = []
    for f in frames:
        v, ok = projective.backproject_depth(
            torch.as_tensor(depths[f], dtype=torch.float32), K)
        n, nok = normals_from_depth(v, ok)
        out.append(tuple(t.to(device) for t in (v, n, ok & nok)))
    return K, out, depths


def test_gn_kernel_at_the_rgbd_grid(cuda_device):
    """K2 at M = 307,200 (640x480, frame 1 looked up in frame 0's maps):
    each entry of H and g within 1e-5 of the sum of its terms' absolute
    values of the plain version (two float32 sums of the same terms in
    different orders); bit-reproducible."""
    from tpu_icp_slam_torch.icp import projective

    K, ((v0, n0, ok0), (v1, _, ok1)), _ = _rgbd_maps(cuda_device)
    mask = ok1.reshape(-1)
    p = torch.where(mask[:, None], v1.reshape(-1, 3),
                    torch.full_like(v1.reshape(-1, 3), 1.0e6))
    q, n, gate, _ = projective.projective_correspondence(
        K, v0, n0, ok0, max_corr_dist=0.3)(p)
    w = gate * mask.float()
    assert p.shape == (307200, 3) and q.is_contiguous() and n.is_contiguous()
    H, g = gn_cuda.gn_accum(p, q, n, w)
    H_ref, g_ref = gn_cuda.gn_accum_ref(p, q, n, w)
    p64, q64, n64, w64 = (t.double() for t in (p, q, n, w))
    J = torch.cat([n64, torch.linalg.cross(p64, n64, dim=-1)], dim=-1)
    r = torch.sum(n64 * (p64 - q64), dim=-1)
    aJw = (J * w64[:, None]).abs()
    assert torch.all((H - H_ref).abs().double() <= 1e-5 * (J.abs().T @ aJw))
    assert torch.all((g - g_ref).abs().double() <= 1e-5 * (aJw.T @ r.abs()))
    H2, g2 = gn_cuda.gn_accum(p, q, n, w)
    assert torch.equal(H, H2) and torch.equal(g, g2)


def test_projective_correspondence_on_cuda_matches_cpu(cuda_device):
    """The lookup of a moved full-width frame on the card and the CPU from
    the same maps: q, n and the gate equal, d2 within 1e-6 relative (its
    3-term sum may round differently), except at pixel-boundary points (u
    or v within 1e-4 of k + 0.5), at most 1e-4 of the rows."""
    from tpu_icp_slam_torch import synthetic
    from tpu_icp_slam_torch.icp import projective

    K, ((v0, n0, ok0), (v1, _, ok1)), _ = _rgbd_maps("cpu")
    T = synthetic.rigid_transform(3, np.random.default_rng(4),
                                  rot_scale=0.02, trans_scale=0.03)
    pts = (v1.reshape(-1, 3).double() @ torch.as_tensor(T[:3, :3]).T
           + torch.as_tensor(T[:3, 3])).float()
    pts[~ok1.reshape(-1)] = 1.0e6
    got = {}
    for dev in ("cpu", cuda_device):
        corr = projective.projective_correspondence(
            K, v0.to(dev), n0.to(dev), ok0.to(dev), max_corr_dist=0.3)
        got[str(dev)] = [t.cpu() for t in corr(pts.to(dev))]
    (q, n, gate, d2), (qc, nc, gc, d2c) = got["cpu"], got["cuda"]
    p64 = pts.double()
    u = p64[:, 0] / p64[:, 2] * K.fx + K.cx
    v = p64[:, 1] / p64[:, 2] * K.fy + K.cy
    edge = (((u - u.floor() - 0.5).abs() < 1e-4)
            | ((v - v.floor() - 0.5).abs() < 1e-4))
    same = (q == qc).all(1) & (n == nc).all(1) & (gate == gc)
    assert int((~same & ~edge).sum()) == 0
    assert int((~same).sum()) <= 1e-4 * len(pts)
    torch.testing.assert_close(d2c[same], d2[same], rtol=1e-6, atol=0)
    assert gate.sum() > 0.3 * len(pts)


@pytest.mark.parametrize("size,stride", [((160, 120), 1), ((640, 480), 1),
                                         ((640, 480), 2)])
def test_rgbd_odometry_on_cuda_matches_cpu(cuda_device, size, stride):
    """One RGBDOdometry frame (init, then frame 1) with configs/rgbd.json on
    the card and the CPU: poses within 1e-5, the same iterations, one K2
    launch per iteration on the card."""
    from tpu_icp_slam_torch import from_json
    from tpu_icp_slam_torch.slam.rgbd import RGBDOdometry

    root = Path(__file__).resolve().parents[1]
    cfg = from_json((root / "configs" / "rgbd.json").read_text())
    cfg = dataclasses.replace(cfg, pipeline=dataclasses.replace(
        cfg.pipeline, rgbd_src_stride=stride))
    K, _, depths = _rgbd_maps("cpu", size=size, frames=())
    out = {}
    for dev in ("cpu", cuda_device):
        odo = RGBDOdometry(cfg, K, device=dev)
        gn_cuda.gn_accum.launches = 0
        _, info = odo.step(odo.init_state(depths[0]), depths[1])
        out[str(dev)] = (info["pose"].cpu(), int(info["iters"]),
                         gn_cuda.gn_accum.launches)
    (pc, ic, _), (pg, ig, launches) = out["cpu"], out["cuda"]
    assert ig == ic == launches > 0
    torch.testing.assert_close(pg, pc, rtol=0, atol=1e-5)


def test_insert_hash_on_cuda_matches_cpu(cuda_device):
    """insert_hash on the card equals the CPU entry for entry: without
    eviction into a filling map, and with spatial eviction."""
    from tpu_icp_slam_torch.mapping import voxel_map

    rng = np.random.default_rng(9)
    for center in (False, True):
        maps = {d: voxel_map.create(4096, device=d)
                for d in ("cpu", str(cuda_device))}
        for _ in range(3):
            pts = rng.uniform(-30, 30, (3000, 3)).astype(np.float32)
            msk = rng.uniform(size=3000) > 0.1
            pts[~msk] = 1.0e6
            nrm = rng.standard_normal((3000, 3)).astype(np.float32)
            c = rng.uniform(-5, 5, 3).astype(np.float32)
            for d in maps:
                maps[d] = voxel_map.insert_hash(
                    maps[d], *(torch.as_tensor(a, device=d)
                               for a in (pts, msk, nrm)), voxel=0.5,
                    center=torch.as_tensor(c, device=d) if center else None)
            for f in ("points", "normals", "mask"):
                assert torch.equal(getattr(maps["cpu"], f),
                                   getattr(maps[str(cuda_device)], f).cpu()), f
        assert int(voxel_map.count(maps["cpu"])) == 4096


# ---- config 5: the distributed layer on the card ----------------------------


def _plane_cases(b=2, m=2048, seed=5):
    """B point-to-plane problems (float32, normals of a plane-rich cloud)
    for the sharded align, with the ICP config the card runs them at."""
    from tpu_icp_slam_torch import synthetic
    from tpu_icp_slam_torch.mapping.normals import normals_knn

    rng = np.random.default_rng(seed)
    src_b, dst_b, nrm_b = [], [], []
    for _ in range(b):
        src = synthetic.surface_cloud(m, rng).astype(np.float32)
        T = synthetic.rigid_transform(3, rng, rot_scale=0.05,
                                      trans_scale=0.1)
        dst = (src @ T[:3, :3].T + T[:3, 3]).astype(np.float32)
        d = torch.as_tensor(dst)
        nrm_b.append(normals_knn(d, torch.ones(m, dtype=torch.bool),
                                 k=12).numpy())
        src_b.append(src)
        dst_b.append(dst)
    cfg = ICPConfig(method="point_to_plane", max_iters=10, damping=1e-6)
    return cfg, (np.stack(src_b), np.ones((b, m), bool), np.stack(dst_b),
                 np.stack(nrm_b))


def _cpu_align(cfg, arrays):
    from tpu_icp_slam_torch.dist import ShardedAligner, make_mesh

    res = ShardedAligner(make_mesh(1, device="cpu"), cfg)(*arrays)
    return res.T.numpy(), res.iters.numpy()


@pytest.mark.parametrize("world,shape,backend", [
    (1, (1, 1), "nccl"),  # one rank, the collectives through NCCL
    (2, (1, 2), "gloo"),  # two ranks sharing the card: gloo, sp = 2
])
def test_sharded_align_on_card_matches_cpu(cuda_device, tmp_path, world,
                                           shape, backend):
    """The sharded align on the card (K1 batched, K2 once a row) against
    the port on the CPU (the plain versions), rtol 1e-4 / atol 1e-5."""
    import _torch_dist_workers as workers
    from tpu_icp_slam_torch.dist.spawn import spawn

    cfg, arrays = _plane_cases()
    out = spawn(workers.align_cases, world, [(cfg, *arrays)], shape, "cuda",
                init_file=str(tmp_path / "store"), backend=backend,
                timeout_s=300)
    T_cpu, it_cpu = _cpu_align(cfg, arrays)
    for rank_out in out:
        np.testing.assert_allclose(rank_out[0]["T"], T_cpu, rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_array_equal(rank_out[0]["iters"], it_cpu)


def test_multi_sequence_on_card_bit_equal(cuda_device):
    """One rank, no world: the runner's sequences equal their own run_fused
    on the card bit for bit."""
    from tpu_icp_slam_torch.dist import make_mesh, make_multi_sequence_runner

    pipe, log, log_msk, _ = _small_scan_to_map(cuda_device)
    pts = np.stack([log, log[::-1].copy()])  # out, and the way back
    msk = np.stack([log_msk, log_msk[::-1].copy()])
    run = make_multi_sequence_runner(make_mesh(1, axes=("dp",)), pipe.cfg)
    got = run(pts, msk).cpu().numpy()
    for s in range(2):
        _, infos = pipe.run_fused(pipe.init_state(pts[s, 0], msk[s, 0]),
                                  pts[s, 1:], msk[s, 1:])
        np.testing.assert_array_equal(got[s, 1:], infos["pose"].cpu().numpy())
        np.testing.assert_array_equal(got[s, 0], np.eye(4))


def test_schur_float64_on_card(cuda_device):
    """optimize_distributed in float64 on the card (one block, no world)
    against the dense solve on the card and the Schur solve on the CPU."""
    from tpu_icp_slam_torch import synthetic
    from tpu_icp_slam_torch.backend import pose_graph as pg
    from tpu_icp_slam_torch.backend import schur
    from tpu_icp_slam_torch.dist import make_mesh

    rng = np.random.default_rng(0)
    chain, factors = [np.eye(4)], []
    for i in range(1, 24):
        rel = synthetic.rigid_transform(3, rng, rot_scale=0.1,
                                        trans_scale=1.0)
        chain.append(chain[-1] @ rel)
        factors.append((i - 1, i, rel, 1.0))
    factors.append((0, 23, synthetic.rigid_transform(3, rng) @ chain[-1],
                    2.0))
    def graph(dev):
        return pg.from_arrays(np.stack(chain), factors, dtype=torch.float64,
                              device=dev)

    def solve(dev):
        return schur.optimize_distributed(
            graph(dev), make_mesh(1, axes=("graph",), device=dev), iters=4)

    got = solve(cuda_device)
    assert got[0].poses.device.type == cuda_device.type
    for ref in (pg.optimize(graph(cuda_device), iters=4), solve("cpu")):
        np.testing.assert_allclose(got[0].poses.cpu().numpy(),
                                   ref[0].poses.cpu().numpy(), rtol=1e-7,
                                   atol=1e-8)
        np.testing.assert_allclose(got[1].cpu().numpy(),
                                   ref[1].cpu().numpy(), rtol=1e-6)


def test_cli_bench_on_card(cuda_device, capsys):
    from tpu_icp_slam_torch import cli

    assert cli.main(["bench", "--config-id", "1", "--json"]) == 0
    rep = json.loads(capsys.readouterr().out)
    assert rep["platform"] == "cuda" and rep["devices"] == 1
    assert rep["device_name"] == torch.cuda.get_device_name(0)
    assert rep["value"] > 0 and rep["impl"] == "torch"
