"""The packed bf16 score's rules of the torch port on the CPU: the plain
packing's |x|² order, the near-tie rule that holds the tensor-core scorer
(kernels/packed_mma.py) to the plain version, the float64 argmin, K4's
plain shortlist and rescore, the layouts of K3's and K4's device scratch,
and K3's target-split rule.

The tensor-core kernels themselves run only on the card
(tests/test_torch_cuda.py, chip_smoke.py phases 7 and 11). Here the rule is
checked on crafted rows, and against a search that differs from the plain
one only in the order of its float32 sum, the situation the tensor cores
create.
"""

import numpy as np
import pytest
import torch

from tpu_icp_slam_torch.kernels import _build, nn_bf16, nn_rescore, packed_mma


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs test files in parallel worker processes: one torch
    thread each keeps them from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _clouds(m, n, seed, scale=20.0):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.uniform(-scale, scale, (m, 3))
                             .astype(np.float32)),
            torch.from_numpy(rng.uniform(-scale, scale, (n, 3))
                             .astype(np.float32)))


def test_plain_packing_sums_the_squares_in_the_stated_order():
    """|x|² lanes are the bf16 split of (x·x + y·y) + z·z in float32, each
    product and sum rounded on its own: the order the device packing
    writes out."""
    src, dst = _clouds(500, 700, seed=1, scale=300.0)
    a, b = nn_bf16.pack_source(src), nn_bf16.pack_target(dst)
    for x, sq_lanes in ((src.numpy(), a[:, 9:11]), (dst.numpy(), b[:, 11:13])):
        sq = (x[:, 0] * x[:, 0] + x[:, 1] * x[:, 1]) + x[:, 2] * x[:, 2]
        assert sq.dtype == np.float32
        hi, lo = nn_bf16._split(torch.from_numpy(sq)[:, None])
        assert torch.equal(sq_lanes[:, :1].view(torch.int16),
                           hi.view(torch.int16))
        assert torch.equal(sq_lanes[:, 1:].view(torch.int16),
                           lo.view(torch.int16))


def _rows(lanes):
    return torch.tensor(lanes, dtype=torch.float32).to(torch.bfloat16)


@pytest.mark.parametrize("case,expect", [("duplicate", True),
                                         ("inside", True),
                                         ("outside", False)])
def test_near_tie_rule_on_crafted_rows(case, expect):
    """Two picks of one source row: an exact duplicate target is a near-tie;
    a gap of half the rule's 2·TAU·Σ|a b| is one, a gap of twice it is not;
    the same pick is always accepted."""
    a = _rows([[1.0] * 13 + [0.0] * 3])
    base = [1.0] * 13 + [0.0] * 3
    base[5] = 0.0
    mag = 12.0  # Σ|a b| of the base row
    gap = {"duplicate": 0.0, "inside": 0.5, "outside": 2.0}[case] \
        * 2 * packed_mma.TAU * mag
    other = list(base)
    other[5] = float(torch.tensor(gap).to(torch.bfloat16))
    b = _rows([base, other])
    e, m = packed_mma.exact_scores(a, b, torch.tensor([1]))
    assert float(e) - 12.0 == pytest.approx(other[5], abs=0.0)
    got = packed_mma.near_ties(a, b, torch.tensor([1]), torch.tensor([0]))
    assert bool(got[0]) is expect, (case, other[5], float(m))
    assert bool(packed_mma.near_ties(a, b, torch.tensor([1]),
                                     torch.tensor([1]))[0])


def _lane_reversed_argmin(a_aug, b_aug, chunk=512):
    """The first minimum of the packed score summed in float32 from lane 15
    down to lane 0: the same exact products as packed_argmin_ref, another
    order."""
    a, b = a_aug.float(), b_aug.float()
    out = []
    for rows in torch.split(a, chunk):
        e = torch.zeros((rows.shape[0], b.shape[0]))
        for k in range(15, -1, -1):
            e = e + rows[:, k:k + 1] * b[None, :, k]
        out.append(torch.min(e, dim=1)[1].to(torch.int32))
    return torch.cat(out)


def test_reordered_lane_sum_changes_only_near_ties():
    """On a 2,048 x 2,048 problem (8 slots of 256), K4's plain candidates
    against candidates from a lane-reversed float32 sum of the same packed
    products: every candidate that differs is a near-tie by the rule."""
    src, dst = _clouds(2048, 2048, seed=3, scale=40.0)
    sl = nn_rescore.shortlist_ref(src, dst)
    s = nn_rescore.slots(2048)[1]
    assert s == 8
    reordered = torch.stack([
        _lane_reversed_argmin(sl["a_aug"], sl["b_aug"][j::s]) * s + j
        for j in range(s)])
    near = packed_mma.near_ties(sl["a_aug"], sl["b_aug"], reordered,
                                sl["cand"])
    assert bool(near.all())
    assert float((reordered == sl["cand"]).float().mean()) >= 0.999


def test_near_tie_rule_rejects_a_wrong_candidate():
    """The rule is not vacuous: the second-best target of a slot is no
    near-tie of the best on almost every row."""
    src, dst = _clouds(512, 1024, seed=4)
    sl = nn_rescore.shortlist_ref(src, dst)
    a, b = sl["a_aug"].float(), sl["b_aug"][0::8].float()
    second = torch.topk(a @ b.T, 2, dim=1, largest=False)[1][:, 1] * 8
    near = packed_mma.near_ties(sl["a_aug"], sl["b_aug"],
                                second.to(torch.int32), sl["cand"][0])
    assert float(near.float().mean()) < 0.01


def test_shortlist_candidates_rescore_to_the_plain_result():
    """nn_rescore_ref is the rescore of shortlist_ref's candidates: each
    candidate lies in its own slot and is that slot's packed minimum (up to
    a near-tie), and an independent numpy rescore of them in slot order
    gives the same (idx, d2) bit for bit."""
    src, dst = _clouds(700, 3000, seed=5)
    dst[-200:] = 1.0e6
    sl = nn_rescore.shortlist_ref(src, dst, tile_n=256)
    tn, s = nn_rescore.slots(3000, 256)
    assert sl["cand"].shape == (s, 700) and s == 12
    cand = sl["cand"].numpy()
    assert np.all(cand % s == np.arange(s)[:, None])
    e = sl["a_aug"].double() @ sl["b_aug"].double().T  # (M, Np)
    for j in range(s):
        best = e[:, j::s].argmin(dim=1) * s + j
        assert bool(packed_mma.near_ties(sl["a_aug"], sl["b_aug"],
                                         sl["cand"][j], best).all())
    sc, dp = sl["sc"].numpy(), sl["dp"].numpy()
    diff = sc[None] - dp[cand]
    d2 = (diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1]) \
        + diff[..., 2] * diff[..., 2]
    slot = d2.argmin(axis=0)
    idx, got_d2 = nn_rescore.nn_rescore_ref(src, dst, tile_n=256)
    np.testing.assert_array_equal(idx.numpy(), cand[slot, np.arange(700)])
    np.testing.assert_array_equal(got_d2.numpy(), d2[slot, np.arange(700)])
    assert np.all(idx.numpy() < 3000 - 200)


def test_device_scratch_layout():
    """K4's one scratch buffer: every array 256-byte aligned, none
    overlapping, each view of its stated dtype and shape."""
    m, np_, s = 300, 1536, 6
    ws, layout = nn_rescore._workspace(m, np_, s, torch.device("cpu"))
    views = _build.views(ws, layout)
    want = {"centre": (torch.float32, (3,)), "sc": (torch.float32, (m, 3)),
            "dp": (torch.float32, (np_, 3)),
            "a_aug": (torch.bfloat16, (m, 16)),
            "b_aug": (torch.bfloat16, (np_, 16)),
            "cand": (torch.int32, (s, m))}
    spans = []
    for name, (dtype, shape) in want.items():
        v = views[name]
        assert (v.dtype, tuple(v.shape)) == (dtype, shape), name
        start = v.data_ptr() - ws.data_ptr()
        assert start % 256 == 0, name
        spans.append((start, start + v.numel() * v.element_size()))
    spans.sort()
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
    assert spans[-1][1] <= ws.numel()


def test_packed_mma_argmin_on_cpu_is_the_plain_argmin():
    src, dst = _clouds(300, 900, seed=6)
    sc, dc = nn_bf16.recentre(src, dst)
    a, b = nn_bf16.pack_source(sc), nn_bf16.pack_target(dc)
    before = packed_mma.packed_mma_argmin.launches
    idx, e = packed_mma.packed_mma_argmin(a, b)
    ridx, re = nn_bf16.packed_argmin_ref(a, b)
    assert torch.equal(idx, ridx) and torch.equal(e, re)
    assert packed_mma.packed_mma_argmin.launches == before
    exact, mag = packed_mma.exact_scores(a, b, idx)
    # a float32 sum of 16 exact products: well inside TAU of the exact sum
    assert float(torch.max(torch.abs(e.double() - exact) / mag)) \
        <= packed_mma.TAU


def test_k3_scratch_layout():
    """K3's one scratch buffer: every array 256-byte aligned, none
    overlapping, each view of its stated dtype and shape; the partials are
    the ones packed_mma_argmin carves on their own."""
    m, n, k = 300, 5000, 20
    ws, layout = nn_bf16._workspace(m, n, k, torch.device("cpu"))
    views = _build.views(ws, layout)
    want = {"centre": (torch.float32, (3,)),
            "a_aug": (torch.bfloat16, (m, 16)),
            "b_aug": (torch.bfloat16, (n, 16)),
            "part_e": (torch.float32, (k, m)),
            "part_idx": (torch.int32, (k, m))}
    assert set(views) == set(want)
    spans = []
    for name, (dtype, shape) in want.items():
        v = views[name]
        assert (v.dtype, tuple(v.shape)) == (dtype, shape), name
        start = v.data_ptr() - ws.data_ptr()
        assert start % 256 == 0, name
        spans.append((start, start + v.numel() * v.element_size()))
    spans.sort()
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
    assert spans[-1][1] <= ws.numel()
    assert set(nn_bf16.PARTIALS) == {"part_e", "part_idx"}
    assert all(nn_bf16._SCRATCH[k] == v for k, v in nn_bf16.PARTIALS.items())


SHAPES = [(16384, 16384), (16385, 16385), (1, 1), (1, 16384), (16384, 1),
          (300, 5000), (4097, 3000), (16384, 77), (15, 17), (17, 15),
          (1, 16385), (16385, 1), (1000, 100000)]


@pytest.mark.parametrize("sms,per_sm", [(132, 8), (132, 6), (114, 8), (8, 2)])
def test_k3_split_rule_covers_the_target(sms, per_sm):
    """K3's target splits cover [0, n) in ascending contiguous ranges, each
    a multiple of 16 targets but the last, none empty, no more work items
    than the card holds at once unless one split per source tile already
    exceeds it, and never more than one split per staged tile of 256."""
    for m, n in SHAPES:
        k, length = nn_bf16.splits(m, n, sms, per_sm)
        ranges = [(s * length, min(n, (s + 1) * length)) for s in range(k)]
        assert length % 16 == 0 and k >= 1, (m, n)
        assert ranges[0][0] == 0 and ranges[-1][1] == n, (m, n)
        assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
        assert all(lo < hi for lo, hi in ranges), (m, n, k, length)
        assert k <= max(1, -(-n // 256)), (m, n, k)
        tiles = -(-m // 128)
        assert tiles * k <= max(tiles, sms * per_sm), (m, n, k)
        grid = min(tiles * k, sms * per_sm)
        assert 1 <= grid <= sms * per_sm


def test_k3_split_rule_fills_the_card_at_the_main_path_shape():
    """At 16,384 x 16,384 on an H100 (132 SMs, 8 scan blocks an SM) the
    items fill the card in one wave: 128 source tiles x 8 splits of 2,048 =
    1,024 items of 1,056 resident blocks; at m = 1 or n = 1 no split goes
    empty and no item is left idle for want of targets."""
    assert nn_bf16.splits(16384, 16384, 132, 8) == (8, 2048)
    k, length = nn_bf16.splits(16384, 16384, 132, 8)
    assert 0.95 <= 128 * k / (132 * 8) <= 1.0
    assert nn_bf16.splits(1, 16384, 132, 8) == (64, 256)
    assert nn_bf16.splits(16384, 1, 132, 8) == (1, 16)
    assert nn_bf16.splits(1, 1, 132, 8) == (1, 16)


def test_exact_argmin_is_the_float64_first_minimum():
    """exact_argmin is the first minimum of the float64 packed score (an
    exact duplicate target goes to the lower index), and the plain float32
    argmin is it or a near-tie of it."""
    src, dst = _clouds(700, 1500, seed=8, scale=30.0)
    dst[900] = dst[40]
    src[:5] = dst[40] + 1e-3
    sc, dc = nn_bf16.recentre(src, dst)
    a, b = nn_bf16.pack_source(sc), nn_bf16.pack_target(dc)
    best = packed_mma.exact_argmin(a, b, chunk=256)
    e = a.double().numpy() @ b.double().numpy().T
    np.testing.assert_array_equal(best.numpy(), e.argmin(axis=1))
    assert best.dtype == torch.int32 and torch.all(best[:5] == 40)
    ridx, _ = nn_bf16.packed_argmin_ref(a, b)
    assert bool(packed_mma.near_ties(a, b, ridx, best).all())
