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
    gn_step,
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
    # batched K4 at B = 1: one call of the batched form, row 0 equal to the
    # unbatched call
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
    # batched K3: one call of the batched form for the whole batch, row b
    # against target b // G equal to its own call
    rng = torch.Generator(device="cpu").manual_seed(0)
    s = torch.rand(4, 64, 3, generator=rng).to(cuda_device)
    t = torch.rand(2, 80, 3, generator=rng).to(cuda_device)
    n0 = (nn_bf16.nn_bf16.launches, nn_bf16.nn_bf16.batched_launches)
    idx, d2 = nearest_neighbor(s, t, backend="pallas", precision="bf16")
    assert (nn_bf16.nn_bf16.launches,
            nn_bf16.nn_bf16.batched_launches) == (n0[0] + 1, n0[1] + 1)
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
    """The scan-to-map slice on the card (kernels K1/K2S) against the same
    port on the CPU (their plain versions); K1 and K2S run once per ICP
    iteration, K2 never (K2S sums H and g itself); gn_backend "xla" runs
    neither K2 nor K2S."""
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
        k0 = (nn_cuda.nn_bruteforce.launches, gn_step.gn_step.launches,
              gn_cuda.gn_accum.launches)
        _, infos = pipe.run_fused(pipe.init_state(pts[0], msk[0]), pts[1:],
                                  msk[1:])
        launches = (nn_cuda.nn_bruteforce.launches - k0[0],
                    gn_step.gn_step.launches - k0[1],
                    gn_cuda.gn_accum.launches - k0[2])
        out[dev.type] = ({k: v.cpu().numpy() for k, v in infos.items()},
                         launches)
    (gpu, gpu_launches), (cpu, cpu_launches) = out["cuda"], out["cpu"]
    n_iters = int(gpu["iters"].sum())
    assert gpu_launches == (n_iters, n_iters, 0)
    assert cpu_launches == (0, 0, 0)
    np.testing.assert_allclose(gpu["pose"], cpu["pose"], atol=5e-3)
    for k in ("is_keyframe", "map_inserted"):
        np.testing.assert_array_equal(gpu[k], cpu[k])
    cfg_xla = dataclasses.replace(
        cfg, icp=dataclasses.replace(cfg.icp, nn_backend="xla",
                                     gn_backend="xla"))
    k0 = (nn_cuda.nn_bruteforce.launches, gn_cuda.gn_accum.launches,
          gn_step.gn_step.launches)
    pipe = ScanToMapPipeline(cfg_xla, device=cuda_device)
    pipe.run_fused(pipe.init_state(pts[0], msk[0]), pts[1:3], msk[1:3])
    assert (nn_cuda.nn_bruteforce.launches, gn_cuda.gn_accum.launches,
            gn_step.gn_step.launches) == k0


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



# ---- the batched 3-D scan (factored filter, certified selection) ----------

PLANTED = ("dup_run_edge", "dup_tile_edge", "dup_split_edge", "equidistant",
           "one_ulp", "shift_plus_500", "shift_minus_500", "sentinels",
           "far_rows", "dup_overflow")
PLANTED_SPLITS = 2  # the plain version's splits of the target axis


def _k1_score_np(a, b):
    """K1's chain on float32 numpy points (rows of a against rows of b):
    _fma_emulated_nn's, element by element."""
    d = a - b
    s = (d[..., 0] * d[..., 0]).astype(np.float32)
    s = (d[..., 1].astype(np.float64) ** 2 + s).astype(np.float32)
    return (d[..., 2].astype(np.float64) ** 2 + s).astype(np.float32)


def planted_nn_case(name, m=700, n=3000):
    """A planted near-tie case of the batched 3-D search: src (4, m, 3) and
    dst (2, n, 3) float32 (G = 2), sources drawn around the targets, then:
    duplicate targets on either side of a run (32), tile (256) or split
    edge of the plain version's PLANTED_SPLITS splits, each the nearest
    point of 200 sources; two targets at exactly the same score from a
    source ("equidistant"); two targets one ulp apart in K1's score
    ("one_ulp"); clouds 500 m off the origin, where the filter's bound is
    wide ("shift_*"); sentinel (1e6) targets at run, tile and split starts
    and at the end, and sentinel sources (the last rows, and one more:
    they share the last row's pick); far sources unlike the last row, so
    that their block scores every pair in the difference form
    ("far_rows"); one target sixteen times over in
    the first eight runs (of any split the card's grid cuts), so that a row
    keeps more runs than its slots hold ("dup_overflow")."""
    from tpu_icp_slam_torch.kernels.nn_cuda import split_length

    rng = np.random.default_rng(PLANTED.index(name) + 11)
    half = 3.0 if name.startswith("shift") else 30.0
    dst = rng.uniform(-half, half, (2, n, 3)).astype(np.float32)
    pick = rng.integers(0, n, (4, m))
    src = (dst[np.arange(4)[:, None] // 2, pick]
           + rng.normal(0, 0.3, (4, m, 3))).astype(np.float32)
    length = split_length(n, PLANTED_SPLITS)
    if name.startswith("dup_") and name != "dup_overflow":
        lo = {"dup_run_edge": length + 3 * 32 - 1,
              "dup_tile_edge": length + 255,
              "dup_split_edge": length - 1}[name]
        for t in range(2):
            p = rng.uniform(-20, 20, 3).astype(np.float32)
            dst[t, lo] = dst[t, lo + 1] = p
            src[2 * t:2 * t + 2, :200] = p + rng.uniform(-0.3, 0.3,
                                                        (2, 200, 3))
    elif name == "dup_overflow":
        spots = 3 + 16 * np.arange(16)  # two in each of the first 8 runs
        for t in range(2):
            dst[t, spots] = dst[t, spots[0]]
            src[2 * t:2 * t + 2, :200] = dst[t, spots[0]] + rng.uniform(
                -0.3, 0.3, (2, 200, 3))
    elif name == "equidistant":
        for t in range(2):
            spots = rng.permutation(n)[:200].reshape(100, 2)
            for i, j in enumerate(spots):
                a = np.round(rng.uniform(-25, 25, 3) * 64) / 64
                v = np.round(rng.uniform(-0.1, 0.1, 3) * 64) / 64
                src[2 * t:2 * t + 2, i] = a
                dst[t, j[0]], dst[t, j[1]] = a + v, a - v
    elif name == "one_ulp":
        for t in range(2):
            spots = np.sort(rng.permutation(n)[:200].reshape(100, 2), axis=1)
            for i, j in enumerate(spots):
                a = rng.uniform(-25, 25, 3).astype(np.float32)
                v = rng.uniform(-0.05, 0.05, 3)
                b1 = (a + v).astype(np.float32)
                want = np.nextafter(_k1_score_np(a, b1), np.float32(np.inf))
                # the same offset turned every way: one lands an ulp above
                u = rng.normal(size=(4000, 3))
                u *= np.linalg.norm(v) / np.linalg.norm(u, axis=1)[:, None]
                cands = (a + u).astype(np.float32)
                hit = np.nonzero(_k1_score_np(a, cands) == want)[0]
                if not len(hit):
                    continue
                b2 = cands[hit[0]]
                src[2 * t:2 * t + 2, i] = a
                # the later index holds the lower score half of the time
                dst[t, j[0]], dst[t, j[1]] = (b1, b2) if i % 2 else (b2, b1)
    elif name.startswith("shift"):
        off = np.float32(500.0 if name == "shift_plus_500" else -500.0)
        src += off
        dst += off
    elif name == "sentinels":
        for start in (0, length):
            for edge in (0, 32, 256):
                dst[:, start + edge:start + edge + 8] = 1.0e6
        dst[:, -300:] = 1.0e6
        src[:, -90:] = 1.0e6
        src[:, 5] = 1.0e6
    elif name == "far_rows":
        src[:, 5] = [2.0e5, 1.0e5, -3.0e5]
        src[:, 9] = [-1.0e6, 0.5, 2.0]
    return src.astype(np.float32), dst.astype(np.float32)


@pytest.mark.parametrize("name", PLANTED)
def test_factored_scan_bit_for_bit_on_planted_ties(cuda_device, name):
    """The batched 3-D scan against the difference form's scan (today's
    batched K1, `difference_scan`) on every planted case: idx and d2 bit
    for bit, and both against K1's score chain."""
    src, dst = (torch.from_numpy(a).to(cuda_device)
                for a in planted_nn_case(name))
    nn_cuda.reset_scan_counts()
    idx, d2 = nn_cuda.nn_bruteforce(src, dst)
    ref = nn_cuda.difference_scan(src, dst)
    assert torch.equal(idx, ref[0]), int((idx != ref[0]).sum())
    assert torch.equal(_bits(d2), _bits(ref[1]))
    counts = nn_cuda.scan_counts()
    assert counts["rows"] == 4 * src.shape[1] * _splits_of(src, dst)
    if name == "dup_overflow":
        assert counts["fallback_rows"] > 0  # the whole-split rescans ran
    if name == "far_rows":  # one block, in the difference form
        assert counts["fallback_rows"] == counts["rows"]
        assert counts["shared_rows"] == 0
    if name == "sentinels":  # the 91 sentinel rows share the last pick
        assert counts["shared_rows"] == 91 * counts["rows"] // src.shape[1]
    for b in range(4):
        e_idx, e_d2 = _fma_emulated_nn(src[b], dst[b // 2])
        assert torch.equal(idx[b], e_idx) and torch.equal(_bits(d2[b]),
                                                          _bits(e_d2))


def _splits_of(src, dst):
    from tpu_icp_slam_torch.kernels import _build

    index = src.device.index
    return nn_cuda.n_split(src.shape[1], dst.shape[1], src.shape[0],
                           _build.sm_count(index),
                           nn_cuda.blocks_per_sm(index, 3, True))


@pytest.mark.parametrize("m,n", [(1, 1), (1, 300), (1025, 255), (3000, 257),
                                 (2049, 1000), (130, 4099), (16385, 77),
                                 (7, 16387)])
def test_factored_scan_ragged_bit_for_bit(cuda_device, m, n):
    """Ragged M and N (off the block's 1,024 rows, the 256-target tile and
    the 32-target run; one target; one row), B = 4, G = 2, sentinel
    targets at the end: the difference form's scan bit for bit."""
    rng = np.random.default_rng(m * 7 + n)
    src = torch.from_numpy(rng.uniform(-40, 40, (4, m, 3)).astype(
        np.float32)).to(cuda_device)
    dst = torch.from_numpy(rng.uniform(-40, 40, (2, n, 3)).astype(
        np.float32)).to(cuda_device)
    if n > 9:
        dst[:, -(n // 9):] = 1.0e6
    idx, d2 = nn_cuda.nn_bruteforce(src, dst)
    ref = nn_cuda.difference_scan(src, dst)
    assert torch.equal(idx, ref[0]) and torch.equal(_bits(d2), _bits(ref[1]))



@pytest.mark.parametrize("case", ["nan_row", "huge_row", "inf_target",
                                  "nan_target"])
def test_factored_scan_out_of_range_inputs(cuda_device, case):
    """A NaN or 1e30 source row, or an inf or NaN target (a norm beyond the
    bound's range), sends its block or split to the difference form: bit
    for bit the difference form's scan, NaN scores never a minimum."""
    rng = np.random.default_rng(17)
    src = torch.from_numpy(rng.uniform(-40, 40, (4, 3000, 3)).astype(
        np.float32)).to(cuda_device)
    dst = torch.from_numpy(rng.uniform(-40, 40, (2, 5000, 3)).astype(
        np.float32)).to(cuda_device)
    if case == "nan_row":
        src[1, 77, 0] = float("nan")
    elif case == "huge_row":
        src[2, 1500] = torch.tensor([1e30, -1e30, 0.0])
    elif case == "inf_target":
        dst[0, 4321, 2] = float("inf")
    else:
        dst[1, 10, 1] = float("nan")
    idx, d2 = nn_cuda.nn_bruteforce(src, dst)
    ref = nn_cuda.difference_scan(src, dst)
    assert torch.equal(idx, ref[0]) and torch.equal(_bits(d2), _bits(ref[1]))


def _generator_scans():
    from tpu_icp_slam_torch import synthetic
    from tpu_icp_slam_torch.core.pointcloud import voxel_downsample_np
    from tpu_icp_slam_torch.slam.runner import pad_scans

    scans, _ = synthetic.velodyne_log(n_frames=12, n_rings=48,
                                      n_azimuth=1024, path_fraction=0.1,
                                      seed=5)
    return pad_scans([voxel_downsample_np(s, 0.15) for s in scans], 16384)


def test_factored_scan_verification_shape_bit_for_bit(cuda_device):
    """B = 16, G = 8 at 16,384² on generator scans (a query under eight
    yaws against two keyframes, padded rows and targets as they come), and
    again with the query's last 2,000 rows padded: bit for bit the
    difference form's scan, and most rows rescan one run."""
    pts, _ = _generator_scans()
    yaws = np.linspace(-np.pi, np.pi, 8, endpoint=False)
    c, s = np.cos(yaws), np.sin(yaws)
    rot = np.zeros((8, 3, 3), np.float32)
    rot[:, 0, 0], rot[:, 0, 1], rot[:, 1, 0], rot[:, 1, 1] = c, -s, s, c
    rot[:, 2, 2] = 1.0
    q = np.einsum("yij,mj->ymi", rot, pts[-1]).astype(np.float32)
    src = torch.from_numpy(np.concatenate([q, q])).to(cuda_device)
    dst = torch.from_numpy(np.stack([pts[0], pts[4]])).to(cuda_device)
    for padded in (False, True):
        if padded:
            src[:, -2000:] = 1.0e6
        nn_cuda.reset_scan_counts()
        idx, d2 = nn_cuda.nn_bruteforce(src, dst)
        ref = nn_cuda.difference_scan(src, dst)
        assert torch.equal(idx, ref[0]), (padded,
                                          int((idx != ref[0]).sum()))
        assert torch.equal(_bits(d2), _bits(ref[1]))
        counts = nn_cuda.scan_counts()
        filtered = (counts["rows"] - counts["fallback_rows"]
                    - counts["shared_rows"])
        assert counts["runs_rescanned"] <= 1.1 * filtered, counts
        if padded:
            assert counts["shared_rows"] > 0, counts


def test_align_batched_same_with_either_scan(cuda_device, monkeypatch):
    """align_batched (the graphed trip, verification's coarse ICP) gives
    T, rmse, iters and n_inliers bit for bit whether its batched NN is the
    factored scan or the difference form's."""
    from tpu_icp_slam_torch.core.pointcloud import PointCloud
    from tpu_icp_slam_torch.icp import loop
    from tpu_icp_slam_torch.kernels import nn as nn_dispatch

    pts, msk = _generator_scans()
    cfg = ICPConfig(method="point_to_point", max_iters=12,
                    max_corr_dist=2.0, nn_precision="highest")
    yaws = torch.tensor(np.linspace(-0.4, 0.4, 8), dtype=torch.float32)
    T0 = torch.eye(4).repeat(16, 1, 1)
    T0[:, 0, 0], T0[:, 0, 1] = torch.cos(yaws.repeat(2)), -torch.sin(
        yaws.repeat(2))
    T0[:, 1, 0], T0[:, 1, 1] = torch.sin(yaws.repeat(2)), torch.cos(
        yaws.repeat(2))
    src = PointCloud(points=torch.from_numpy(pts[6]).to(cuda_device),
                     mask=torch.from_numpy(msk[6]).to(cuda_device))
    dst = torch.from_numpy(np.stack([pts[2], pts[9]])).to(cuda_device)
    dmask = torch.from_numpy(np.stack([msk[2], msk[9]])).to(cuda_device)
    runs = []
    for scan in (None, nn_cuda.difference_scan):
        loop._graphs.clear()
        if scan is not None:
            monkeypatch.setattr(nn_dispatch, "nn_bruteforce", scan)
        res = loop.align_batched(src, dst, dmask, T0.to(cuda_device), cfg)
        runs.append([t.clone() for t in (res.T, res.rmse, res.iters,
                                         res.n_inliers)])
    loop._graphs.clear()
    for new, old in zip(*runs):
        assert torch.equal(new, old)


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
    the card and the CPU: poses within 1e-5, the same iterations, one K2S
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
        gn_step.gn_step.launches = 0
        _, info = odo.step(odo.init_state(depths[0]), depths[1])
        out[str(dev)] = (info["pose"].cpu(), int(info["iters"]),
                         gn_step.gn_step.launches)
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
    """The sharded align on the card (batched K1 and K2) against the port
    on the CPU (the plain versions), rtol 1e-4 / atol 1e-5."""
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


# ---- batched K2, K3 and K4 (the sharded align's local rows) -----------------


def _batched_nn_case(b, groups, cuda_device, m=3000, n=2500, seed=0):
    """src (b, m, 3) over b / groups targets (n, 3) on the card; the last
    target all at the 1e6 sentinel (no valid row), the first partly
    padded."""
    rng = np.random.default_rng(seed + b)
    src = rng.uniform(-30, 30, (b, m, 3)).astype(np.float32)
    dst = rng.uniform(-30, 30, (b // groups, n, 3)).astype(np.float32)
    dst[0, -n // 8:] = 1.0e6
    if b // groups > 1:
        dst[-1] = 1.0e6
    return (torch.from_numpy(src).to(cuda_device),
            torch.from_numpy(dst).to(cuda_device))


BATCHES = [(1, 1), (3, 1), (4, 2)]  # (B, G)


@pytest.mark.parametrize("b,groups", BATCHES)
def test_batched_gn_kernel_rows_bit_equal_per_row_calls(cuda_device, b,
                                                        groups):
    """Batched K2: one launch, each row bit for bit the unbatched call on
    it (its own ticket and partial slab; the tickets left at 0 for the
    next call), and within the plain version's bound."""
    del groups
    rows = [_gn_case(16385, seed=10 * b + i) for i in range(b)]
    p, q, n, w = (torch.from_numpy(np.stack(x)).to(cuda_device)
                  for x in zip(*rows))
    before = (gn_cuda.gn_accum.launches, gn_cuda.gn_accum.batched_launches)
    H, g = gn_cuda.gn_accum(p, q, n, w)
    assert (gn_cuda.gn_accum.launches, gn_cuda.gn_accum.batched_launches) \
        == (before[0] + 1, before[1] + 1)
    assert H.shape == (b, 6, 6) and g.shape == (b, 6)
    for _ in range(2):  # again, after the tickets went round
        H2, g2 = gn_cuda.gn_accum(p, q, n, w)
        assert torch.equal(_bits(H2), _bits(H))
        assert torch.equal(_bits(g2), _bits(g))
    H_ref, g_ref = gn_cuda.gn_accum_ref(p, q, n, w)
    for i in range(b):
        H1, g1 = gn_cuda.gn_accum(p[i], q[i], n[i], w[i])
        assert torch.equal(_bits(H[i]), _bits(H1)), i
        assert torch.equal(_bits(g[i]), _bits(g1)), i
        torch.testing.assert_close(H[i], H_ref[i], rtol=1e-4,
                                   atol=1e-4 * float(H_ref[i].abs().max()))
        torch.testing.assert_close(g[i], g_ref[i], rtol=1e-4,
                                   atol=1e-4 * float(g_ref[i].abs().max()))


def _launches_per_call(fn, calls=3):
    """(kernel launches one call of fn makes, the names of the kernels the
    tracer saw on the card) over `calls` traced calls. The launches are
    the host's runtime launch calls, which the tracer records every time;
    on the card it can miss kernels of a window."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    launches = sum(a.count for a in prof.key_averages()
                   if a.key.startswith(("cudaLaunch", "cuLaunch")))
    names = {e.name for e in prof.events()
             if e.device_type == DeviceType.CUDA}
    return launches / calls, names


@pytest.mark.parametrize("b,groups", BATCHES)
def test_batched_nn_bf16_rows_bit_equal_per_row_calls(cuda_device, b,
                                                      groups):
    """Batched K3: each row's idx and d2 bit for bit the unbatched call on
    (src[b], dst[b // G]); the device packing bit-equal to the batched plain
    packing (each target's own centre, 0 for the all-sentinel one); the
    picks under the tensor-core contract."""
    s, d = _batched_nn_case(b, groups, cuda_device)
    idx, d2 = nn_bf16.nn_bf16(s, d)
    det = nn_bf16.nn_bf16_detail(s, d)
    assert idx.shape == d2.shape == (b, s.shape[1])
    assert torch.equal(det["idx"], idx) and torch.equal(_bits(det["d2"]),
                                                        _bits(d2))
    sc, dc = nn_bf16.recentre(s, d)
    assert torch.equal(_bits(det["a_aug"]), _bits(nn_bf16.pack_source(sc)))
    assert torch.equal(_bits(det["b_aug"]), _bits(nn_bf16.pack_target(dc)))
    for i in range(b):
        one_i, one_d = nn_bf16.nn_bf16(s[i].contiguous(),
                                       d[i // groups].contiguous())
        assert torch.equal(idx[i], one_i), i
        assert torch.equal(_bits(d2[i]), _bits(one_d)), i
        if i // groups < d.shape[0] - 1 or d.shape[0] == 1:
            _k3_contract(s[i], d[i // groups], idx[i], d2[i],
                         det["e_min"][i])


@pytest.mark.parametrize("b,groups", BATCHES)
def test_batched_nn_rescore_rows_bit_equal_per_row_calls(cuda_device, b,
                                                         groups):
    """Batched K4: each row's idx and d2 bit for bit the unbatched call;
    the device packing (recentred points, padded target, packed rows) and
    the plain candidates as the batched plain version's but for near-ties;
    the picks' d2 equal to the plain version's where the picks agree."""
    s, d = _batched_nn_case(b, groups, cuda_device, seed=5)
    idx, d2 = nn_rescore.nn_rescore(s, d)
    det = nn_rescore.nn_rescore_detail(s, d)
    plain = nn_rescore.shortlist_ref(s, d)
    for k in ("sc", "dp", "a_aug", "b_aug"):
        assert torch.equal(_bits(det[k]), _bits(plain[k])), k
    assert det["cand"].shape == plain["cand"].shape
    ridx, rd2 = nn_rescore.nn_rescore_ref(s, d)
    for i in range(b):
        one_i, one_d = nn_rescore.nn_rescore(s[i].contiguous(),
                                             d[i // groups].contiguous())
        assert torch.equal(idx[i], one_i), i
        assert torch.equal(_bits(d2[i]), _bits(one_d)), i
        assert bool(packed_mma.near_ties(
            det["a_aug"][i], det["b_aug"][i // groups], det["cand"][i],
            plain["cand"][i]).all()), i
        same = idx[i] == ridx[i]
        assert float(same.float().mean()) >= 0.999
        assert torch.equal(d2[i][same], rd2[i][same])


@pytest.mark.parametrize("kernel", ["gn_accum", "nn_bf16", "nn_rescore"])
def test_batched_kernels_launch_count_independent_of_batch(cuda_device,
                                                           kernel):
    """One call makes the same launches at B = 1, 3 and 4, and the card
    runs only the kernels of the design: one K2 launch; K3's centre, pack,
    scan and fold; K4's centre, pack, scan and rescore."""
    seen = {}
    for b, groups in BATCHES:
        if kernel == "gn_accum":
            rows = [_gn_case(4096, seed=i) for i in range(b)]
            args = [torch.from_numpy(np.stack(x)).to(cuda_device)
                    for x in zip(*rows)]
            fn = gn_cuda.gn_accum
        else:
            args = _batched_nn_case(b, groups, cuda_device, m=1000, n=900)
            fn = getattr({"nn_bf16": nn_bf16, "nn_rescore": nn_rescore}[
                kernel], kernel)
        seen[b] = _launches_per_call(lambda: fn(*args))
    want = {"gn_accum": ["gn_accum_kernel"],
            "nn_bf16": ["nn_centre_kernel", "nn_fold_kernel",
                        "nn_pack_kernel", "packed_scan_kernel"],
            "nn_rescore": ["nn_centre_kernel", "nn_pack_kernel",
                           "nn_rescore_kernel", "packed_scan_kernel"]}[kernel]
    for b, (launches, names) in seen.items():
        assert launches == len(want), (b, launches, names)
        assert all(any(w in n for w in want) for n in names), (b, names)


@pytest.mark.parametrize("precision", ["bf16", "rescore"])
def test_sharded_align_batched_nn_on_card_matches_cpu(cuda_device,
                                                      precision):
    """The sharded align without a world at "bf16" and "rescore" on the
    card: K3/K4 and K2 once a trip each in their batched forms, against the
    port on the CPU, rtol 1e-4 / atol 1e-5. The tensor cores' picks are the
    plain version's but for near-ties, so a row may meet the rmse tolerance
    one iteration apart (seen at "bf16" on an H100: 5 against 6)."""
    from tpu_icp_slam_torch.dist import ShardedAligner, make_mesh

    cfg, arrays = _plane_cases(b=3)
    cfg = dataclasses.replace(cfg, nn_precision=precision,
                              nn_backend="pallas")
    counter = {"bf16": nn_bf16.nn_bf16,
               "rescore": nn_rescore.nn_rescore}[precision]
    aligner = ShardedAligner(make_mesh(1, device=cuda_device), cfg)
    before = (counter.launches, counter.batched_launches,
              gn_cuda.gn_accum.launches, gn_cuda.gn_accum.batched_launches)
    res = aligner(*arrays)
    trips = int(res.iters.max())
    assert (counter.launches, counter.batched_launches,
            gn_cuda.gn_accum.launches,
            gn_cuda.gn_accum.batched_launches) == tuple(
        x + trips for x in before)
    T_cpu, it_cpu = _cpu_align(cfg, arrays)
    np.testing.assert_allclose(res.T.cpu().numpy(), T_cpu, rtol=1e-4,
                               atol=1e-5)
    assert np.abs(res.iters.cpu().numpy() - it_cpu).max() <= 1, it_cpu


# ---- RF and the graphed verification trip ----------------------------------


def _rigid_cases(d, rng):
    """name -> (cov (16, d, d), mu_s, mu_d (16, d)) float32, and whether
    Umeyama's rotation is unique there: well-conditioned, reflecting
    (det(U Vᵀ) = -1), rank D-1 (at D = 3 the z = 0 lift), near-equal
    singular values, cov = 0, collinear (D = 3, rank 1) and non-finite."""
    q, r = np.linalg.qr(rng.normal(size=(16, d, d)))
    R0 = q * np.sign(np.diagonal(r, axis1=-2, axis2=-1))[:, None, :]
    R0[:, :, 0] *= np.sign(np.linalg.det(R0))[:, None]
    a, b = rng.normal(size=(2, 16, d))
    rank = a[:, :, None] * b[:, None, :]
    if d == 3:
        rank = np.zeros((16, 3, 3))
        rank[:, :2, :2] = rng.normal(size=(16, 2, 2))
    cases = {
        "random": (rng.normal(size=(16, d, d)), True),
        "reflecting": (R0 * np.asarray([3.0, 2.0, -1.0][3 - d:]), True),
        "rank_d_minus_1": (rank, True),
        "near_equal": (R0 * np.asarray([1.0, 1 + 1e-6, 1 - 1e-6][:d]), True),
        "zero": (np.zeros((16, d, d)), True),
    }
    if d == 3:
        cases["collinear"] = (a[:, :, None] * b[:, None, :], False)
    bad = rng.normal(size=(16, d, d))
    bad[3, 0, 0], bad[7, 1, 0] = np.nan, np.inf
    cases["non_finite"] = (bad, False)
    mu = rng.normal(size=(2, 16, d)) * 5.0
    return {k: ((c.astype(np.float32), mu[0].astype(np.float32),
                 mu[1].astype(np.float32)), unique)
            for k, (c, unique) in cases.items()}


def _umeyama64(cov, mu_s, mu_d):
    d = cov.shape[-1]
    U, _, Vt = np.linalg.svd(cov.astype(np.float64))
    corr = np.ones(cov.shape[:-1])
    corr[..., -1] = np.sign(np.linalg.det(U @ Vt))
    R = (U * corr[..., None, :]) @ Vt
    return R, mu_d - np.einsum("...ij,...j->...i", R, mu_s.astype(np.float64))


@pytest.mark.parametrize("d", [2, 3])
def test_rigid_fit_kernel_matches_plain_and_float64(cuda_device, d):
    """RF against a float64 numpy Umeyama and its plain version (torch's
    float32 SVD form on the card): where the rotation is unique, R and t
    within 1e-5 of float64 (|t| ~ 20: float32 rounds t to ~2e-6), and within
    1e-5 of the plain version beyond the plain version's own gap to float64
    (up to ~5e-5 on ill-conditioned random cases on an H100); at rank D-1
    the rotation within 1e-5 of the plain version's; a proper rotation on
    every finite case; cov = 0 gives the identity exactly; a non-finite
    element gives a non-finite T. One launch a call, batched over (16,)
    and (4, 4)."""
    from tpu_icp_slam_torch.icp import point_to_point as p2p

    for name, ((cov, mu_s, mu_d), unique) in _rigid_cases(
            d, np.random.default_rng(d)).items():
        args = [torch.from_numpy(a).to(cuda_device) for a in (cov, mu_s, mu_d)]
        before = p2p.rigid_from_stats.launches
        T = p2p.rigid_from_stats(*args)
        assert p2p.rigid_from_stats.launches == before + 1
        flat = p2p.rigid_from_stats(args[0].view(4, 4, d, d),
                                    args[1].view(4, 4, d),
                                    args[2].view(4, 4, d))
        torch.testing.assert_close(flat.view(16, d + 1, d + 1), T, rtol=0,
                                   atol=0, equal_nan=True)
        T = T.cpu().numpy().astype(np.float64)
        finite = np.isfinite(cov).all((1, 2))
        assert not np.isfinite(T[~finite]).all((1, 2)).any(), name
        T, cov, mu_s, mu_d = T[finite], cov[finite], mu_s[finite], \
            mu_d[finite]
        R = T[:, :d, :d]
        np.testing.assert_allclose(np.linalg.det(R), 1.0, atol=1e-5)
        np.testing.assert_allclose(R @ R.transpose(0, 2, 1),
                                   np.broadcast_to(np.eye(d), R.shape),
                                   atol=1e-5)
        assert (T[:, d, :d] == 0).all() and (T[:, d, d] == 1).all()
        if not unique:
            continue
        R64, t64 = _umeyama64(cov, mu_s, mu_d)
        np.testing.assert_allclose(R, R64, atol=1e-5, err_msg=name)
        np.testing.assert_allclose(T[:, :d, d], t64, atol=1e-5, err_msg=name)
        plain = p2p.rigid_from_stats_ref(*(torch.from_numpy(a).to(
            cuda_device) for a in (cov, mu_s, mu_d))).cpu().numpy()
        own = max(np.abs(plain[:, :d, :d] - R64).max(),
                  np.abs(plain[:, :d, d] - t64).max())
        assert np.abs(T[:, :d] - plain[:, :d]).max() <= 1e-5 + own, name
        if name == "rank_d_minus_1":
            np.testing.assert_allclose(R, plain[:, :d, :d], atol=1e-5)
        if name == "zero":
            assert (R == np.eye(d)).all()


def test_umeyama_masked_on_cuda_makes_no_sync(cuda_device):
    from tpu_icp_slam_torch.icp.point_to_point import umeyama_masked

    rng = np.random.default_rng(3)
    src = torch.tensor(rng.uniform(-5, 5, (16, 2048, 3)), dtype=torch.float32,
                       device=cuda_device)
    dst = src + 0.1
    w = torch.rand(16, 2048, device=cuda_device)
    umeyama_masked(src, dst, w)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        T = umeyama_masked(src, dst, w)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.testing.assert_close(T[:, :3, 3], torch.full_like(T[:, :3, 3], 0.1),
                               rtol=0, atol=1e-5)


def _verify_problem(device, d, batch, groups, m):
    """Verification's batch: one source of m points against `groups`
    moved, noisy copies, batch // groups initial yaws each."""
    from tpu_icp_slam_torch.core import pointcloud as tpc

    rng = np.random.default_rng(batch + d)
    src = rng.uniform(-20, 20, (m, d)).astype(np.float32)
    targets = []
    for g in range(groups):
        yaw = rng.uniform(-0.3, 0.3)
        R = np.eye(d)
        R[:2, :2] = [[np.cos(yaw), -np.sin(yaw)], [np.sin(yaw), np.cos(yaw)]]
        moved = src @ R.T + rng.uniform(-1, 1, d) + rng.normal(
            size=src.shape) * 0.05
        targets.append(moved[: m - 37 * g])  # padded rows differ a target
    dst = torch.full((groups, m, d), 1.0e6, device=device)
    for g, t in enumerate(targets):
        dst[g, : len(t)] = torch.from_numpy(t.astype(np.float32))
    yaws = np.linspace(-np.pi, np.pi, batch // groups, endpoint=False)
    yaws = np.tile(yaws * 0.1, groups)
    inits = np.tile(np.eye(d + 1, dtype=np.float32), (batch, 1, 1))
    inits[:, 0, 0] = inits[:, 1, 1] = np.cos(yaws)
    inits[:, 0, 1], inits[:, 1, 0] = -np.sin(yaws), np.sin(yaws)
    return (tpc.make(src, device=device), dst,
            torch.ones(dst.shape[:2], dtype=torch.bool, device=device),
            torch.from_numpy(inits).to(device))


VERIFY_CFG = ICPConfig(method="point_to_point", max_iters=50,
                       max_corr_dist=6.0, huber_delta=1.5,
                       max_step_trans=3.0, max_step_rot=0.5, min_inliers=30,
                       tol=1e-5)


@pytest.mark.parametrize("d,batch,groups,m", [(3, 16, 2, 4096),
                                             (2, 32, 4, 512)])
def test_graphed_align_batched_equals_eager_trips(cuda_device, d, batch,
                                                  groups, m):
    """The verification trip as a CUDA graph: every trip's carried state
    bit-equal to the trip function driven eagerly on the card (batched K1
    folds in index order, K2P's sums in a fixed order: deterministic);
    align_batched's result that state; one host sync a trip once its
    graph exists (the condition read; none after a trip that reaches
    max_iters); K1's batched and K2P's launches one a trip, replays
    included, and no RF launch; each replay one span graph.verify_trip."""
    import warnings

    from torch.profiler import ProfilerActivity, profile

    from tpu_icp_slam_torch.icp import loop
    from tpu_icp_slam_torch.icp import point_to_point as p2p
    from tpu_icp_slam_torch.kernels import p2p_step

    src, dst, msk, inits = _verify_problem(cuda_device, d, batch, groups, m)
    trip = loop._batched_trip(loop._batched_step(VERIFY_CFG, src, dst, msk,
                                                 inits, None))
    eager = trip(loop._init_state(inits), 0)
    graph = loop._TripGraph(VERIFY_CFG, batch, batch // groups, m, m, d,
                            torch.float32, inits.device)
    graph.start(src, dst, inits, None)
    trips = 1
    while True:
        for a, b in zip(graph.state, eager):
            assert torch.equal(a, b), trips
        if trips >= VERIFY_CFG.max_iters or bool(eager[3].all()):
            break
        eager = trip(eager, 1)
        graph.step()
        trips += 1
    assert graph.graph is not None and trips > 2, trips
    assert trips == int(eager[6].max())

    k1 = nn_cuda.nn_bruteforce
    loop.align_batched(src, dst, msk, inits, VERIFY_CFG)  # makes its graph
    k2p = p2p_step.p2p_step
    before = (k1.batched_launches, k2p.launches,
              p2p.rigid_from_stats.launches)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            res = loop.align_batched(src, dst, msk, inits, VERIFY_CFG)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    syncs = sum("synchroniz" in str(w.message) for w in caught)
    # the condition is read before every trip after the first and once
    # more to stop, unless max_iters stopped the loop
    assert syncs == trips - (trips == VERIFY_CFG.max_iters), (syncs, trips)
    assert (k1.batched_launches - before[0], k2p.launches - before[1],
            p2p.rigid_from_stats.launches - before[2]) == (trips, trips, 0)
    for got, want in zip((res.T, res.rmse, res.n_inliers, res.converged,
                          res.iters), (eager[0], eager[1], eager[2],
                                       eager[3], eager[6])):
        assert torch.equal(got, want)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        loop.align_batched(src, dst, msk, inits, VERIFY_CFG)
    replays = [e for e in prof.profiler.kineto_results.events()
               if e.name() == "icp_slam.graph.verify_trip"]
    assert len(replays) == trips - 1


def _frame_graph_case(cuda_device, **icp):
    """A short log and chip_smoke's slice configuration cut to 2,048-point
    scans, a 32,768-point map and a 4,096-point local model, on the card."""
    from tpu_icp_slam_torch import synthetic
    from tpu_icp_slam_torch.core.pointcloud import voxel_downsample_np
    from tpu_icp_slam_torch.slam.runner import pad_scans

    cfg = SlamConfig(
        icp=ICPConfig(**{
            "method": "point_to_plane", "max_iters": 18,
            "max_corr_dist": 1.0, "damping": 1e-3, "max_step_trans": 1.0,
            "max_step_rot": 0.3, "min_inliers": 100, "huber_delta": 0.3,
            "tol": 1e-5, "step_scale": 1.4, "tol_update": 0.01,
            "prior_trans_weight": 0.004, "prior_rot_weight": 0.04,
            "max_total_trans": 1.5, "max_total_rot": 0.5, **icp}),
        mapping=MappingConfig(map_capacity=32768, local_model_size=4096,
                              map_voxel=0.2),
        pipeline=PipelineConfig(mode="scan_to_map", scan_capacity=2048,
                                keyframe_trans=2.5, keyframe_rot=0.3,
                                normal_ref_stride=4))
    scans, _ = synthetic.velodyne_log(n_frames=9, n_rings=16, n_azimuth=320,
                                      path_fraction=0.14)
    pts, msk = pad_scans([voxel_downsample_np(s, 0.3) for s in scans], 2048)
    return (cfg, torch.as_tensor(pts, device=cuda_device),
            torch.as_tensor(msk, device=cuda_device))


def _eager_step_frames(cfg, state, pts, msk):
    from tpu_icp_slam_torch.slam import scan_to_map as s2m

    infos = []
    for f in range(len(pts)):
        state, info = s2m._step(state, pts[f], msk[f], cfg=cfg)
        infos.append({k: torch.as_tensor(v).cpu() for k, v in info.items()})
    return state, {k: torch.stack([i[k] for i in infos]) for k in infos[0]}


def _assert_frames_bit_equal(got, want):
    for k, w in want.items():
        g = got[k].cpu()
        assert torch.equal(g.to(torch.int64) if k == "iters" else g,
                           w.to(torch.int64) if k == "iters"
                           else w.to(g.dtype)), k
        if g.dtype == torch.float32:
            assert torch.equal(_bits(g), _bits(w)), k


def _sync_count(fn):
    import warnings

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    # the mode's own "prototype feature" warning, once a process, is no sync
    return sum("called a synchronizing CUDA operation" in str(w.message)
               for w in caught), out


@pytest.mark.parametrize("backend,precision", [
    ("steps", "highest"), ("fused", "highest"), ("fused", "bf16"),
    ("steps", "bf16"), ("steps", "rescore")])
def test_frame_graphs_equal_eager_step_on_card(cuda_device, backend,
                                               precision):
    """ScanToMapPipeline.run_fused on the card replays the frame graphs:
    every info and the final state bit-equal to the eager _step loop (the
    same kernels in the same order), two runs from one state equal, the
    kernels' launches equal with the replays counted, and the host syncs
    the ICP trips' condition reads plus one insert read a frame ("steps"),
    or that one read ("fused")."""
    from tpu_icp_slam_torch.slam import scan_to_map as s2m

    cfg, pts, msk = _frame_graph_case(cuda_device, loop_backend=backend,
                                      nn_precision=precision)
    pipe = s2m.ScanToMapPipeline(cfg, device=cuda_device)
    state0 = pipe.init_state(pts[0], msk[0])
    kernels = (nn_cuda.nn_bruteforce, gn_cuda.gn_accum, nn_bf16.nn_bf16,
               nn_rescore.nn_rescore, icp_fused.icp_fused, gn_step.gn_step)
    k0 = [k.launches for k in kernels]
    st_e, inf_e = _eager_step_frames(cfg, state0, pts[1:], msk[1:])
    eager_launches = [k.launches - b for k, b in zip(kernels, k0)]
    for call in range(2):  # call 0 captures, call 1 replays
        k0 = [k.launches for k in kernels]
        st, infos = pipe.run_fused(state0, pts[1:], msk[1:])
        assert [k.launches - b for k, b in zip(kernels, k0)] \
            == eager_launches, call
        _assert_frames_bit_equal(infos, inf_e)
        for f in dataclasses.fields(st):
            a, b = getattr(st, f.name), getattr(st_e, f.name)
            if f.name == "vmap":
                for x in ("points", "normals", "mask"):
                    assert torch.equal(getattr(a, x), getattr(b, x)), x
            else:
                assert torch.equal(a, b), f.name
    assert int(inf_e["map_inserted"].sum()) >= 1
    syncs, _ = _sync_count(lambda: pipe.run_fused(state0, pts[1:], msk[1:]))
    iters = inf_e["iters"].numpy()
    reads = 0 if backend == "fused" else int(
        (iters - (iters >= cfg.icp.max_iters)).sum())
    assert syncs == reads + len(iters), (syncs, reads, len(iters))


def test_frame_graphs_survive_k2_scratch_growth(cuda_device):
    """K2's scratch is never freed: a graph captured over K2's unbatched
    call (and a frame graph, over K2S, whose scratch is its own) keeps
    working after a batched call outgrows the scratch and the freed sizes
    are allocated and scribbled over."""
    from tpu_icp_slam_torch.kernels import graphs
    from tpu_icp_slam_torch.slam import scan_to_map as s2m

    cfg, pts, msk = _frame_graph_case(cuda_device, max_iters=17)
    p, q, n, w = (torch.as_tensor(x, device=cuda_device)
                  for x in _gn_case(4096, seed=3))
    H_want, g_want = (t.clone() for t in gn_cuda.gn_accum(p, q, n, w))
    out = []
    k2 = graphs.Graphed(lambda: out.append(gn_cuda.gn_accum(p, q, n, w)),
                        cuda_device, "k2")
    k2()  # runs and captures K2 over the scratch as it is
    pipe = s2m.ScanToMapPipeline(cfg, device=cuda_device)
    state0 = pipe.init_state(pts[0], msk[0])
    _, want = pipe.run_fused(state0, pts[1:], msk[1:])  # captures K2S
    # shapes only: a reference to the old buffers would keep them alive
    shapes = [(t.shape, t.dtype) for t in gn_cuda._device_scratch(p.device)]
    batch = shapes[1][0][0] + 1
    gn_cuda.gn_accum(*(x.expand(batch, *x.shape).contiguous()
                       for x in (p, q, n, w)))
    assert gn_cuda._device_scratch(p.device)[1].shape[0] == batch
    junk = [torch.full(shape, 7, dtype=dtype, device=cuda_device)
            for shape, dtype in shapes for _ in range(4)]
    _, got = pipe.run_fused(state0, pts[1:], msk[1:])  # replays
    k2()  # replays K2 into the captured outputs
    _, eager = _eager_step_frames(cfg, state0, pts[1:], msk[1:])
    del junk
    _assert_frames_bit_equal(got, eager)
    _assert_frames_bit_equal(want, eager)
    H, g = out[0]
    assert torch.equal(H, H_want) and torch.equal(g, g_want)


def _odom_graph_case(kind, device):
    """(pipeline, seed state, logs on the card, eager step, its keywords,
    max_iters) of the frame-to-frame odometries: configs/rgbd.json on 12
    frames of the 160x120 depth log, or 2D scan-to-scan with its grid on
    12 frames of sim2d."""
    from tpu_icp_slam_torch import from_json
    from tpu_icp_slam_torch.slam import pipeline, rgbd, runner

    if kind == "rgbd":
        root = Path(__file__).resolve().parents[1]
        cfg = from_json((root / "configs" / "rgbd.json").read_text())
        K, _, depths = _rgbd_maps("cpu", size=(160, 120), frames=(),
                                  n_frames=12)
        pipe = rgbd.RGBDOdometry(cfg, K, device=device)
        logs = (torch.as_tensor(depths, dtype=torch.float32, device=device),)
        return (pipe, pipe.init_state(logs[0][0]), logs, rgbd._step,
                {"cfg": cfg, "K": K}, cfg.icp.max_iters)
    cfg = _sim2d_cfg()
    pts, msk = runner.pad_scans(runner.load_dataset("sim2d", 12).scans, 512)
    pipe = pipeline.OdometryPipeline(cfg, dim=2, device=device)
    logs = tuple(torch.as_tensor(x, device=device) for x in (pts, msk))
    return (pipe, pipe.init_state(*(x[0] for x in logs)), logs,
            pipeline._step, {"cfg": cfg}, cfg.icp.max_iters)


def _odom_leaves(st):
    out = {}
    for f in dataclasses.fields(st):
        v = getattr(st, f.name)
        if dataclasses.is_dataclass(v):
            out.update({f"{f.name}.{k}": t for k, t in _odom_leaves(v).items()})
        elif v is not None:
            out[f.name] = v
    return out


@pytest.mark.parametrize("kind", ["rgbd", "scan-to-scan 2D"])
def test_odometry_graphs_equal_eager_step_on_card(cuda_device, kind):
    """RGBDOdometry.run_fused and OdometryPipeline.run_fused on the card
    replay their frame graphs: every info and every state field (the
    occupancy grid too) bit-equal to the eager _step loop, two runs from one
    state equal, the kernels' launches equal with the replays counted, and
    the host syncs the ICP's condition reads, one a trip. A loop of `step`
    (the same graphs, a frame a call) gives the same frames."""
    pipe, state0, logs, step, kw, max_iters = _odom_graph_case(kind,
                                                               cuda_device)
    kernels = (nn_cuda.nn_bruteforce, gn_cuda.gn_accum, gn_step.gn_step)
    k0 = [k.launches for k in kernels]
    st_e, infos = state0, []
    for inputs in zip(*(x[1:] for x in logs)):
        st_e, info = step(st_e, *inputs, **kw)
        infos.append({k: torch.as_tensor(v).cpu() for k, v in info.items()})
    inf_e = {k: torch.stack([i[k] for i in infos]) for k in infos[0]}
    eager_launches = [k.launches - b for k, b in zip(kernels, k0)]
    for call in range(2):  # call 0 captures, call 1 replays
        k0 = [k.launches for k in kernels]
        st, got = pipe.run_fused(state0, *(x[1:] for x in logs))
        assert [k.launches - b for k, b in zip(kernels, k0)] \
            == eager_launches, call
        _assert_frames_bit_equal(got, inf_e)
        a, b = _odom_leaves(st), _odom_leaves(st_e)
        assert a.keys() == b.keys()
        for name in b:
            assert torch.equal(a[name], b[name]), (call, name)
    syncs, _ = _sync_count(lambda: pipe.run_fused(state0,
                                                  *(x[1:] for x in logs)))
    iters = inf_e["iters"].numpy()
    assert syncs == int((iters - (iters >= max_iters)).sum()), syncs
    assert max(eager_launches) == int(iters.sum()) > 0
    st_s = state0
    for f, inputs in enumerate(zip(*(x[1:] for x in logs))):
        st_s, info = pipe.step(st_s, *inputs)
        for k in inf_e:
            assert torch.equal(torch.as_tensor(info[k]).cpu().to(
                inf_e[k].dtype), inf_e[k][f]), (f, k)
    a = _odom_leaves(st_s)
    for name, v in _odom_leaves(st_e).items():
        assert torch.equal(a[name], v), ("step", name)


# ---- K2S: the point-to-plane iteration after the correspondence -----------


def _k2s_problem(m, seed, device):
    """A fixed correspondence at M rows, the last eighth padded: targets on
    three planes, the source the targets under a small motion with noise;
    (cur source, mask as float, corr)."""
    rng = np.random.default_rng(seed)
    q = rng.uniform(-20.0, 20.0, (m, 3))
    n = np.zeros((m, 3))
    axis = np.arange(m) % 3
    q[np.arange(m), axis] = rng.choice([-15.0, 15.0], m)
    n[np.arange(m), axis] = 1.0
    c, s = np.cos(0.02), np.sin(0.02)
    R = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
    src = (q - [0.1, -0.05, 0.03]) @ R + 0.01 * rng.standard_normal((m, 3))
    pad = m // 8
    src[-pad:] = 1.0e6
    mask = np.ones(m, np.float32)
    mask[-pad:] = 0.0
    qt, nt, srct = (torch.as_tensor(a, dtype=torch.float32, device=device)
                    for a in (q, n, src))

    def corr(cur, max_d2=1.0):
        diff = cur - qt
        d2 = torch.sum(diff * diff, dim=-1)
        return qt, nt, (d2 <= max_d2).to(torch.float32), d2

    return srct, torch.as_tensor(mask, device=device), corr


def _k2s_option_sets():
    cs = _chip_smoke()
    root = Path(__file__).resolve().parents[1]
    from tpu_icp_slam_torch import from_json

    presets = {name: from_json((root / "configs" / f"{name}.json")
                               .read_text()).icp
               for name in ("rgbd", "kitti_full_res")}
    base = cs.slice_config().icp
    out = {"slice": (base, None), **{k: (v, None) for k, v in
                                     presets.items()}}
    for name, (icp, variant) in cs._k2s_options(base).items():
        if name != "preset":
            out[name] = (icp, variant)
    return cs, out


@pytest.mark.parametrize("m", [16384, 307200])
def test_gn_step_kernel_matches_plain(cuda_device, m):
    """K2S against its plain version (the torch step around K2) on the same
    inputs and state, trips 0 and 1, over the option sets: chip_smoke's
    slice, configs/rgbd.json, configs/kitti_full_res.json, Anderson, a
    min_inliers hold, a non-PD H (a zero step) and a converged state (left
    as it was): T within chip_smoke.K2S_T_TOL, rmse within K2S_RMSE_RTOL,
    n_inliers and iters equal, converged equal but within K2S_TOL_BAND of
    tol; bit-reproducible across two launches; H and g bit-equal to K2's
    on the same weights."""
    from tpu_icp_slam_torch.icp import loop

    cs, options = _k2s_option_sets()
    src, mask, corr = _k2s_problem(m, seed=m % 97, device=cuda_device)
    for name, (icp, variant) in options.items():
        for it in (0, 1):
            got, want, args, (H, g), again, _, prev = cs._k2s_trip(
                icp, src, mask, corr, it, variant)
            for a, b in zip(got, again):
                assert cs.bits_equal(a, b), (name, it)
            if variant == "frozen":
                for a, b in zip(got, want):
                    assert cs.bits_equal(a, b), (name, it)
                continue
            _, _, bad = cs._k2s_gaps(got, want)
            if bad == ["converged"]:
                assert min(abs(abs(prev - float(x[1])) - icp.tol)
                           for x in (got, want)) <= cs.K2S_TOL_BAND
            else:
                assert not bad, (name, it, bad)
            cur, q, n, gate, d2 = args
            w = loop.huber(icp, gate * mask, d2)
            H2, g2 = gn_cuda.gn_accum(cur, q, n, w)
            assert cs.bits_equal(H, H2) and cs.bits_equal(g, g2), (name, it)
            if variant == "non-PD":
                assert torch.equal(got[0], torch.eye(4, device=cuda_device))


def test_gn_step_kernel_in_the_loops(cuda_device):
    """The loops on the card run one K2S launch a trip and no K2:
    align_with_correspondence's eager host loop and its unrolled form (8
    trips, frozen after max_iters = 6) on a fixed correspondence, with the
    convergence tests off so that both devices run 6 iterations, equal the
    CPU's run of the same loop within chip_smoke.K2S_T_TOL a trip. A
    wrapper on CPU tensors launches nothing."""
    from tpu_icp_slam_torch.core.pointcloud import PointCloud
    from tpu_icp_slam_torch.icp import loop

    cs = _chip_smoke()
    icp = dataclasses.replace(cs.slice_config().icp, max_iters=6, tol=0.0,
                              tol_update=0.0)
    out = {}
    for dev in ("cpu", cuda_device):
        src, mask, corr = _k2s_problem(4096, seed=5, device=dev)
        cloud = PointCloud(points=src, mask=mask > 0)
        for unroll in (0, 8):
            cfg = dataclasses.replace(icp, unroll_iters=unroll)
            k0 = (gn_step.gn_step.launches, gn_cuda.gn_accum.launches)
            res = loop.align_with_correspondence(cloud, corr, None, cfg)
            k = (gn_step.gn_step.launches - k0[0],
                 gn_cuda.gn_accum.launches - k0[1])
            out[(str(dev), unroll)] = res, k
    for unroll in (0, 8):
        (rc, kc), (rg, kg) = out[("cpu", unroll)], out[("cuda", unroll)]
        iters = int(torch.as_tensor(rg.iters))
        assert iters == int(torch.as_tensor(rc.iters)) == icp.max_iters
        assert kc == (0, 0)
        assert kg == ((iters, 0) if unroll == 0 else (unroll, 0))
        assert float(torch.max(torch.abs(rg.T.cpu() - rc.T))) \
            <= cs.K2S_T_TOL * iters
        assert int(rg.n_inliers) == int(rc.n_inliers)


def test_occupancy_fold_on_card_bit_equal_to_one_spare_form(cuda_device):
    """occupancy2d.update on the card, a spare cell an off-grid entry,
    against its one-spare-cell form on the same scans (off-grid, masked and
    padded beams): the log-odds bit for bit."""
    import _occupancy_one_spare as fold_ref
    from tpu_icp_slam_torch.mapping import occupancy2d as occ

    new = old = occ.create(200, 0.1, device=cuda_device)
    for k in range(4):
        pose, pts, mask = (torch.as_tensor(a, device=cuda_device)
                           for a in fold_ref.fold_scans(k, capacity=4096))
        new = occ.update(new, pose, pts, mask)
        old = fold_ref.update_one_spare(old, pose, pts, mask)
        assert torch.equal(new.logodds.view(torch.int32),
                           old.logodds.view(torch.int32)), k
    assert (new.logodds > 0).any() and (new.logodds < 0).any()


@pytest.mark.parametrize("normal_gate", [False, True])
def test_projective_kernel_matches_plain(cuda_device, normal_gate):
    """PJ (the projective lookup's kernel) against its plain version, the
    torch lookup, on the card from the same maps: a moved 640x480 frame,
    with and without a normal gate: q and n bit-equal, d2 within 2 ulps,
    the gate equal but where d2 (or the normal's cosine) lies at the
    gate's edge; one launch a call, bit-reproducible."""
    from tpu_icp_slam_torch import synthetic
    from tpu_icp_slam_torch.icp import projective
    from tpu_icp_slam_torch.kernels import projective_cuda

    K, ((v0, n0, ok0), (v1, n1, ok1)), _ = _rgbd_maps(cuda_device)
    T = synthetic.rigid_transform(3, np.random.default_rng(4),
                                  rot_scale=0.02, trans_scale=0.03)
    Tt = torch.as_tensor(T, dtype=torch.float32, device=cuda_device)
    pts = (v1.reshape(-1, 3) @ Tt[:3, :3].T + Tt[:3, 3]).contiguous()
    pts[~ok1.reshape(-1)] = 1.0e6
    src_n = n1.reshape(-1, 3).contiguous() if normal_gate else None
    cos = 0.5 if normal_gate else -1.0
    corr = projective.projective_correspondence(
        K, v0, n0, ok0, max_corr_dist=0.3, normal_gate_cos=cos,
        src_normals=src_n)
    before = projective_cuda.projective_lookup.launches
    got = corr(pts)
    again = corr(pts)
    assert projective_cuda.projective_lookup.launches == before + 2
    fx, fy = (torch.full((), v, device=cuda_device) for v in (K.fx, K.fy))
    max_d2 = 0.3 * 0.3
    want = projective._lookup_ref(K, v0, n0, ok0, fx, fy, max_d2, cos, src_n,
                                  pts)
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    ulp = torch.abs(torch.nextafter(want[3], torch.full_like(
        want[3], float("inf"))) - want[3])
    assert bool(torch.all(torch.abs(got[3] - want[3]) <= 2 * ulp))
    edge = torch.abs(want[3] - max_d2) <= 2 * ulp
    if normal_gate:
        edge |= torch.abs(torch.sum(src_n * want[1], -1) - cos) <= 1e-6
    assert not bool(torch.any((got[2] != want[2]) & ~edge))
    assert float(want[2].sum()) > 0.3 * len(pts)
    with pytest.raises(ValueError):
        corr(pts.T.contiguous().T)  # not contiguous


def _scan16k():
    """Phase 4's frame 1: a 16,384-point synthetic Velodyne scan (voxel
    0.15 m, padded), on the card."""
    pts, msk, _ = _chip_smoke()._scans(2, 48, 1024, 2 / 110.0, 0.15, 16384)
    return (torch.as_tensor(pts[1], device="cuda"),
            torch.as_tensor(msk[1], device="cuda"))


@pytest.mark.parametrize("stride", [4, 1])
def test_knn_normals_kernel_matches_plain(cuda_device, stride):
    """KN at the presets' shapes (16,384 x 4,096 and 16,384 x 16,384)
    against the plain k-NN and fit: chip_smoke.py's phase 24 check (picks
    equal on every row whose scores are clear by KN_TAU_REL and on at least
    KN_ROWS_EQUAL of the rows, normals within KN_DOT_TOL on the well-posed
    rows, zero off the mask, bit-reproducible); one launch a call."""
    from tpu_icp_slam_torch.kernels import knn_cuda
    from tpu_icp_slam_torch.mapping import normals

    p, m = _scan16k()
    cs = _chip_smoke()
    same, _, worst, _ = cs._kn_check(p, m, 8, stride)
    assert same >= cs.KN_ROWS_EQUAL and worst >= 1 - cs.KN_DOT_TOL
    before = knn_cuda.knn_normals.launches
    got = normals.normals_knn(p, m, k=8, ref_stride=stride)
    assert knn_cuda.knn_normals.launches == before + 1
    assert torch.equal(got, knn_cuda.knn_normals(p, m, 8, stride)[0])


@pytest.mark.parametrize("k", [5, 8, 16, 20])
@pytest.mark.parametrize("stride", [1, 2, 3])
def test_knn_normals_kernel_ties_go_to_the_lower_index(cuda_device, k,
                                                        stride):
    """On 700 integer lattice points (exact scores, many ties) KN's picks
    are the plain version's (the reference's rule) bit for bit, for list
    sizes 8, 16 and 32 in use and target ranges cut anywhere."""
    from tpu_icp_slam_torch.kernels import knn_cuda
    from tpu_icp_slam_torch.kernels.nn_plain import knn_bruteforce

    rng = np.random.default_rng(k + 10 * stride)
    q = torch.as_tensor(rng.integers(-3, 4, (700, 3)).astype(np.float32),
                        device=cuda_device)
    on = torch.ones(700, dtype=torch.bool, device=cuda_device)
    nrm, idx = knn_cuda.knn_normals(q, on, k, stride)
    want, _ = knn_bruteforce(q, q[::stride].contiguous(), k)
    assert torch.equal(idx, want)
    unit = torch.linalg.vector_norm(nrm, dim=-1)
    assert float(torch.abs(unit - 1).max()) < 1e-5


def _select_case(case, device):
    """(map, centre, size, radius) of a local_select case at C = 131,072
    (the presets' map) unless the case says otherwise."""
    from tpu_icp_slam_torch.mapping import voxel_map

    rng = np.random.default_rng(7)
    c, size = 131072, 16384
    if case.startswith("lattice"):
        vm = _chip_smoke()._lattice_map(c, 100_000, 3)
        centre = torch.tensor([2.0, -1.0, 3.0], device=device)
        return vm, centre, size, 6.5 if case == "lattice-radius" else 0.0
    n_on = {"random": 90_000, "random-radius": 90_000, "fewer": 10_000,
            "exactly": size, "all": 5000}[case]
    if case == "all":
        c = size = 5000
    pts = rng.uniform(-60, 60, (c, 3)).astype(np.float32)
    msk = np.zeros(c, bool)
    msk[rng.permutation(c)[:n_on]] = True
    pts[~msk] = 1e6
    nrm = rng.standard_normal((c, 3)).astype(np.float32)
    vm = voxel_map.VoxelMap(points=torch.as_tensor(pts, device=device),
                            normals=torch.as_tensor(nrm, device=device),
                            mask=torch.as_tensor(msk, device=device))
    centre = torch.tensor([3.5, -7.25, 0.5], device=device)
    return vm, centre, size, 25.0 if case == "random-radius" else 0.0


@pytest.mark.parametrize("case", ["random", "random-radius", "lattice",
                                  "lattice-radius", "fewer", "exactly",
                                  "all"])
def test_local_select_kernel_bit_equal_to_plain(cuda_device, case):
    """EX against extract_local_ref: pts, nrm, msk and r_cover bit-equal
    at the presets' C = 131,072 -> 16,384 (a full map with and without a
    radius, a lattice map with exact d² ties, fewer points than size,
    exactly size) and at size = C; one launch a call, repeatable."""
    from tpu_icp_slam_torch.kernels import select_cuda
    from tpu_icp_slam_torch.mapping import voxel_map

    vm, centre, size, radius = _select_case(case, cuda_device)
    before = select_cuda.local_select.launches
    got = voxel_map.extract_local(vm, centre, size, radius=radius)
    again = voxel_map.extract_local(vm, centre, size, radius=radius)
    assert select_cuda.local_select.launches == before + 2
    want = voxel_map.extract_local_ref(vm, centre, size, radius)
    for a, b, c in zip(got, again, want):
        assert _chip_smoke().bits_equal(a, b) and \
            _chip_smoke().bits_equal(a, c)


def test_map_kernels_on_the_main_path(cuda_device):
    """On CUDA the frame's map stages run KN and EX inside the pre and
    insert graphs: EX once a frame, KN at the seed frame and at each map
    insert; the poses are those of the eager _step on the card."""
    from tpu_icp_slam_torch.kernels import knn_cuda, select_cuda
    from tpu_icp_slam_torch.slam import frame_graphs
    from tpu_icp_slam_torch.slam.scan_to_map import ScanToMapPipeline, _step

    cs = _chip_smoke()
    cfg = cs.slice_config()
    pts, msk, _ = cs._scans(8, 48, 1024, 8 / 110.0, 0.15, 16384)
    pipe = ScanToMapPipeline(cfg, device="cuda")
    before = (knn_cuda.knn_normals.launches,
              select_cuda.local_select.launches)
    state0 = pipe.init_state(pts[0], msk[0])
    _, infos = pipe.run_fused(state0, pts[1:], msk[1:])
    inserts = int(infos["map_inserted"].sum())
    assert (knn_cuda.knn_normals.launches - before[0],
            select_cuda.local_select.launches - before[1]) == (
        1 + inserts, len(pts) - 1)
    _, eager = frame_graphs.run_eager(
        _step, state0, zip(*pipe._as_tensors(pts[1:], msk[1:])), cfg=cfg)
    assert torch.equal(infos["pose"], eager["pose"])


def test_map_kernel_wrappers_raise_instead_of_falling_back(cuda_device):
    from tpu_icp_slam_torch.kernels import knn_cuda, select_cuda

    p = torch.randn(500, 3, device=cuda_device)
    on = torch.ones(500, dtype=torch.bool, device=cuda_device)
    with pytest.raises(ValueError):
        knn_cuda.knn_normals(p, on, 33)  # past the 32-slot list
    with pytest.raises(ValueError):
        knn_cuda.knn_normals(p, on.cpu(), 8)
    with pytest.raises(ValueError):
        knn_cuda.knn_normals(p.cpu(), on.cpu(), 8)  # CPU: the plain version
    with pytest.raises(ValueError):
        select_cuda.local_select(p, p, on, p[0], 501)  # size > C
    with pytest.raises(ValueError):
        select_cuda.local_select(p.T.contiguous().T, p, on, p[0], 100)


# ---- K2P: the point-to-point iteration after the correspondence ----------


def _k2p_problem(d, m, batch, device):
    """A point-to-point trip's inputs on the card: a room (walls, in 3D a
    floor) of m points, the last eighth padding, and the source the room
    under a small motion with noise, one copy an element of a batch of
    `batch` (None: unbatched) at yaws apart; (mask as float, inputs(state)
    -> (cur, q, gate, d2), T0, corr for align_with_correspondence)."""
    from tpu_icp_slam_torch.icp import loop

    rng = np.random.default_rng(60 + d)
    axis = rng.integers(0, d, m)
    q = rng.uniform(-10.0, 10.0, (m, d))
    q[np.arange(m), axis] = rng.choice([-10.0, 10.0], m)
    c, s = np.cos(0.03), np.sin(0.03)
    R = np.eye(d)
    R[:2, :2] = [[c, -s], [s, c]]
    src = (q - [0.2, -0.1, 0.05][:d]) @ R + 0.01 * rng.standard_normal((m, d))
    src[-m // 8:] = 1.0e6
    mask_f = torch.ones(m, device=device)
    mask_f[-m // 8:] = 0.0
    src_t = torch.as_tensor(src, dtype=torch.float32, device=device)
    q_t = torch.as_tensor(q, dtype=torch.float32, device=device)
    lead = () if batch is None else (batch,)
    T0 = torch.eye(d + 1, device=device).expand(*lead, -1, -1).contiguous()
    if batch is not None:
        yaw = torch.linspace(-0.05, 0.05, batch, device=device)
        T0[:, 0, 0] = T0[:, 1, 1] = torch.cos(yaw)
        T0[:, 0, 1], T0[:, 1, 0] = -torch.sin(yaw), torch.sin(yaw)

    def corr(cur):
        qq = q_t.expand_as(cur).contiguous()
        diff = cur - qq
        d2 = torch.sum(diff * diff, dim=-1)
        return qq, None, (d2 <= 1.0).float(), d2

    def inputs(state):
        cur = loop._moved(src_t, state[0])
        qq, _, gate, d2 = corr(cur)
        return cur, qq, gate, d2

    return mask_f, inputs, T0, (src_t, corr)


@pytest.mark.parametrize("d,m,batch", [(2, 4096, None), (3, 16384, None),
                                       (3, 16384, 16), (2, 4096, 8)])
def test_p2p_step_kernel_matches_plain(cuda_device, d, m, batch):
    """K2P against its plain version (loop.trip_ref on the card) from the
    same state and inputs, trips 0 and 1, over chip_smoke's option sets
    (the verification's coarse settings; Anderson, a trust region, both, a
    min_inliers hold and a frozen state): T within chip_smoke.K2P_T_TOL,
    rmse within K2P_RMSE_TOL, inliers and iterations equal, converged
    equal but at tol's edge; frozen elements bit-unchanged;
    bit-reproducible across two launches."""
    cs = _chip_smoke()
    mask_f, inputs, T0, _ = _k2p_problem(d, m, batch, cuda_device)
    for name, (icp, variant) in cs._k2p_options(VERIFY_CFG).items():
        for it in (0, 1):
            got, want, again, _, prev = cs._k2p_trip(icp, mask_f, inputs,
                                                     T0, it, variant)
            for a, b in zip(got, again):
                assert cs.bits_equal(a, b), (name, it)
            if variant == "frozen":
                for a, b in zip(got, want):
                    assert cs.bits_equal(a, b), (name, it)
                continue
            T_gap, rmse_gap, bad = cs._k2p_gaps(icp, got, want, prev)
            assert not bad, (name, it, bad, T_gap, rmse_gap)


def test_p2p_step_in_the_loops(cuda_device, monkeypatch):
    """The loops on the card run one K2P call a trip and never the torch
    Umeyama body (loop.umeyama_masked raises if called) or RF:
    align_with_correspondence's eager loop and its unrolled form, and
    align_batched, each against the CPU's run of the same loop (the plain
    version): iterations, inliers and convergence equal, T within
    K2P_T_TOL a trip (align_batched: on its converged elements)."""
    from tpu_icp_slam_torch.core.pointcloud import PointCloud
    from tpu_icp_slam_torch.icp import loop
    from tpu_icp_slam_torch.icp import point_to_point as p2p
    from tpu_icp_slam_torch.kernels import p2p_step

    cs = _chip_smoke()
    icp = dataclasses.replace(VERIFY_CFG, max_iters=6, tol=0.0)
    out = {}
    for dev in ("cpu", cuda_device):
        if str(dev) != "cpu":
            def refuse(*a, **k):
                raise AssertionError("umeyama_masked ran on the card")

            monkeypatch.setattr(loop, "umeyama_masked", refuse)
        mask_f, _, _, (src, corr) = _k2p_problem(3, 4096, None, dev)
        cloud = PointCloud(points=src, mask=mask_f > 0)

        for unroll in (0, 8):
            cfg = dataclasses.replace(icp, unroll_iters=unroll)
            k0 = (p2p_step.p2p_step.launches, p2p.rigid_from_stats.launches)
            res = loop.align_with_correspondence(cloud, corr, None, cfg)
            out[(str(dev), unroll)] = res, (
                p2p_step.p2p_step.launches - k0[0],
                p2p.rigid_from_stats.launches - k0[1])
        src_b, dst_b, msk_b, inits = _verify_problem(dev, 3, 16, 2, 4096)
        k0 = p2p_step.p2p_step.launches
        res = loop.align_batched(src_b, dst_b, msk_b, inits, VERIFY_CFG)
        out[(str(dev), "batched")] = res, p2p_step.p2p_step.launches - k0
    for unroll in (0, 8):
        (rc, kc), (rg, kg) = out[("cpu", unroll)], out[("cuda", unroll)]
        iters = int(torch.as_tensor(rg.iters))
        assert iters == int(torch.as_tensor(rc.iters)) == icp.max_iters
        assert kc == (0, 0)
        assert kg == ((iters, 0) if unroll == 0 else (unroll, 0))
        assert float(torch.max(torch.abs(rg.T.cpu() - rc.T))) \
            <= cs.K2P_T_TOL * iters
        assert int(rg.n_inliers) == int(rc.n_inliers)
    (rc, kc), (rg, kg) = out[("cpu", "batched")], out[("cuda", "batched")]
    assert kc == 0 and kg == int(rg.iters.max()) > 1
    assert torch.equal(rg.iters.cpu(), rc.iters)
    assert torch.equal(rg.n_inliers.cpu(), rc.n_inliers)
    assert torch.equal(rg.converged.cpu(), rc.converged)
    # an element that runs to max_iters without converging walks along a
    # flat direction, where the two devices' sums part (7.6e-3 after 50
    # trips on an H100); the converged ones are held
    conv = rc.converged
    gap = torch.abs(rg.T.cpu() - rc.T)[conv]
    assert bool(conv.any()) and float(gap.max()) \
        <= cs.K2P_T_TOL * int(rg.iters.max())


def test_p2p_step_refusals(cuda_device):
    """K2P takes float32 on one CUDA device and the point-to-point step
    only: anything else raises, never falls back."""
    from tpu_icp_slam_torch.icp import loop
    from tpu_icp_slam_torch.kernels import p2p_step

    mask_f, inputs, T0, _ = _k2p_problem(3, 1024, None, cuda_device)
    state = tuple(t.clone() for t in loop._init_state(T0))
    cur, q, gate, d2 = inputs(state)
    with pytest.raises(ValueError, match="point-to-point"):
        p2p_step.p2p_step(dataclasses.replace(VERIFY_CFG,
                                              method="point_to_plane"),
                          mask_f, cur, q, gate, d2, state, 0, T0, None)
    with pytest.raises(ValueError, match="float32"):
        p2p_step.p2p_step(VERIFY_CFG, mask_f, cur.double(), q, gate, d2,
                          state, 0, T0, None)
    with pytest.raises(ValueError, match="gate"):
        p2p_step.p2p_step(VERIFY_CFG, mask_f, cur, q, gate[:-1], d2, state,
                          0, T0, None)
    trust = dataclasses.replace(VERIFY_CFG, max_total_trans=1.0)
    with pytest.raises(ValueError, match="T0_inv"):
        p2p_step.p2p_step(trust, mask_f, cur, q, gate, d2, state, 0, T0,
                          None)
