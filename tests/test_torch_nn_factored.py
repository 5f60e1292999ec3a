"""The batched 3-D scan's selection in plain torch (kernels/nn_cuda.py::
nn_factored_ref: the factored filter, its float32 error bound, the rescan
of the runs it keeps, the whole-split rescan of a row that overflows its
slots) against K1's score chain (`_fma_emulated_nn`): idx and d2 bit for
bit on planted near-ties. The kernel itself is held to the difference
form's scan on the card (tests/test_torch_cuda.py)."""

import numpy as np
import pytest
import torch

from test_torch_cuda import PLANTED, PLANTED_SPLITS, _fma_emulated_nn
from test_torch_cuda import planted_nn_case
from tpu_icp_slam_torch.kernels import nn_cuda


def _bits(t):
    return t.view(torch.int32)


@pytest.mark.parametrize("name", PLANTED)
def test_factored_selection_is_k1_bit_for_bit(name):
    src, dst = (torch.from_numpy(a) for a in planted_nn_case(name))
    idx, d2, counts = nn_cuda.nn_factored_ref(src, dst, PLANTED_SPLITS)
    for b in range(src.shape[0]):
        e_idx, e_d2 = _fma_emulated_nn(src[b], dst[b // 2])
        assert torch.equal(idx[b], e_idx), (b, int((idx[b] != e_idx).sum()))
        assert torch.equal(_bits(d2[b]), _bits(e_d2))
    runs, rows, fallback, shared = counts
    assert rows == src.shape[0] * src.shape[1] * PLANTED_SPLITS
    if name == "dup_overflow":
        assert fallback > 0  # eight equal runs overflow the slots
    if name == "far_rows":  # one block, in the difference form
        assert fallback == rows and shared == 0
    if name == "sentinels":  # the sentinel rows share the last row's pick
        assert shared == 91 * 4 * PLANTED_SPLITS and fallback == 0
    if name in ("dup_run_edge", "equidistant", "one_ulp"):
        assert fallback == shared == 0 and runs >= rows  # the filter alone


def test_factored_selection_planted_cases_hold_their_ties():
    """The planted ties are there: equal scores at two indices, and one
    ulp between two targets of one source."""
    src, dst = planted_nn_case("equidistant")
    e = nn_cuda.k1_scores(torch.from_numpy(src[0, :100]),
                          torch.from_numpy(dst[0]))
    low = e.min(dim=1, keepdim=True).values
    assert int(((e == low).sum(dim=1) >= 2).sum()) >= 90
    src, dst = planted_nn_case("one_ulp")
    e = nn_cuda.k1_scores(torch.from_numpy(src[0, :100]),
                          torch.from_numpy(dst[0])).numpy()
    two = np.sort(e, axis=1)[:, :2]
    one_ulp = two[:, 1] == np.nextafter(two[:, 0], np.float32(np.inf))
    assert int(one_ulp.sum()) >= 50


def test_factored_selection_far_block_and_range():
    """Far rows that repeat the block's last row share its pick (they alone
    are shared rows); a block with another far row scores every pair in
    the difference form (all its rows are fallback rows); a target norm
    beyond the bound's range (or NaN) does the same; K1's picks each way."""
    rng = np.random.default_rng(3)
    dst = torch.from_numpy(rng.uniform(-30, 30, (500, 3)).astype(np.float32))
    src = torch.from_numpy(rng.uniform(-30, 30, (300, 3)).astype(np.float32))
    for far, kinds in (([7, 299], (0, 2)), ([7], (300, 0))):
        src[far] = 1.0e6
        idx, d2, (_, rows, *rest) = nn_cuda.nn_factored_ref(src, dst)
        assert rows == 300 and tuple(rest) == kinds
        e_idx, e_d2 = _fma_emulated_nn(src, dst)
        assert torch.equal(idx, e_idx) and torch.equal(_bits(d2),
                                                       _bits(e_d2))
        src[far] = 0.0
    dst[11] = torch.tensor([1e30, 0.0, 0.0])
    dst[12, 1] = float("nan")
    idx, d2, (_, rows, fallback, shared) = nn_cuda.nn_factored_ref(src, dst)
    assert fallback == rows and shared == 0
    # K1 takes no NaN score as a minimum (fminf)
    e = nn_cuda.k1_scores(src, dst)
    e_d2, e_idx = torch.min(torch.where(torch.isnan(e), torch.inf, e), dim=1)
    assert torch.equal(idx, e_idx.to(torch.int32))
    assert torch.equal(_bits(d2), _bits(e_d2))
