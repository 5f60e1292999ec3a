"""The tensor-core form of the packed bf16 score (csrc/packed_mma.cuh) and
the rules that hold it.

An mma.sync scores a packed source row against a packed target row as the
sum of 16 exact bf16 products in its own float32 order and rounding, so its
score e is not bit-equal to a float32 sum in lane order. It is held to the
float64 sum E of the same products: |e - E| <= TAU · Σ_k |a_k b_k|. Two
searches that differ only in such rounding pick the same target except on
near-ties, where the two picks' E differ by at most 2·TAU · Σ|a b|
(`near_ties`). On dense lidar scans such near-ties are common, and the
plain version's float32 sum is the coarser of the two: `exact_argmin`, the
float64 pick, tells which search found the packed minimum.

`packed_mma_argmin(a_aug, b_aug)` runs K3's scan and fold on given packed
operands: the scorer over the whole target, cut into `nn_bf16.splits`
contiguous ranges that fill the card and folded in index order, returning
the raw minimum. CUDA tensors launch it, CPU tensors take
nn_bf16.packed_argmin_ref. It serves tests and chip_smoke.py's phase 11; the
main path reaches the scorer through K3, K4 and K5.
"""

from __future__ import annotations

import torch

from tpu_icp_slam_torch.kernels import _build
from tpu_icp_slam_torch.kernels import nn_bf16
from tpu_icp_slam_torch.kernels.nn_bf16 import LANES, packed_argmin_ref

# Largest |e - E| / Σ|a b| accepted from the tensor cores: 2⁻¹⁹, about the
# reference's own interpret-mode score error (2.1e-6, ROADMAP §3).
TAU = 2.0 ** -19


def exact_scores(a_aug: torch.Tensor, b_aug: torch.Tensor,
                 idx: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(E, Σ|a b|) in float64 of each source row a_aug[i] against the target
    row b_aug[idx[..., i]]; idx (..., M) indexes b_aug."""
    a = a_aug.double()
    prod = a * b_aug.double()[idx.long()]
    return prod.sum(-1), prod.abs().sum(-1)


def exact_argmin(a_aug: torch.Tensor, b_aug: torch.Tensor,
                 chunk: int = 1024) -> torch.Tensor:
    """(M,) int32: the first minimum of the float64 packed score E of every
    source row over the whole target, the pick that no float32 rounding
    moves."""
    b = b_aug.double()
    return torch.cat([torch.argmin(a @ b.T, dim=1).to(torch.int32)
                      for a in torch.split(a_aug.double(), chunk)])


def near_ties(a_aug: torch.Tensor, b_aug: torch.Tensor, got: torch.Tensor,
              want: torch.Tensor, tau: float = TAU) -> torch.Tensor:
    """Boolean (..., M): True where the pick `got` equals `want` or the two
    are a near-tie, |E(got) - E(want)| <= 2·tau·max(Σ|a b| of either)."""
    e_got, m_got = exact_scores(a_aug, b_aug, got)
    e_want, m_want = exact_scores(a_aug, b_aug, want)
    gap = torch.abs(e_got - e_want)
    return (got == want) | (gap <= 2.0 * tau * torch.maximum(m_got, m_want))


def packed_mma_argmin(a_aug: torch.Tensor, b_aug: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """(M, 16), (N, 16) bf16 -> (idx (M,) int32, e_min (M,) f32): the first
    minimum of the packed score of every source row. CPU tensors take the
    plain version."""
    if a_aug.device.type == "cpu" and b_aug.device.type == "cpu":
        return packed_argmin_ref(a_aug, b_aug)
    for name, t in (("a_aug", a_aug), ("b_aug", b_aug)):
        if (t.device.type != "cuda" or t.dtype != torch.bfloat16
                or t.dim() != 2 or t.shape[1] != LANES
                or not t.is_contiguous() or t.shape[0] == 0):
            raise ValueError(f"packed_mma_argmin: {name} must be a non-empty "
                             f"contiguous (·, {LANES}) bf16 CUDA tensor, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")
    if a_aug.device != b_aug.device:
        raise ValueError("packed_mma_argmin: inputs on different devices")
    m, n = a_aug.shape[0], b_aug.shape[0]
    index = a_aug.device.index
    k, length = nn_bf16.splits(m, n, _build.sm_count(index),
                               nn_bf16.blocks_per_sm(index))
    ws, layout = _build.workspace(nn_bf16.PARTIALS, {"m": m, "k": k},
                                  a_aug.device)
    ptr = _build.pointers(ws, layout)
    idx = torch.empty(m, dtype=torch.int32, device=a_aug.device)
    e_min = torch.empty(m, dtype=torch.float32, device=a_aug.device)
    err = _build.load().packed_mma_argmin(
        a_aug.data_ptr(), b_aug.data_ptr(), m, n, k, length,
        nn_bf16.scan_grid(m, k, index), ptr["part_e"], ptr["part_idx"],
        e_min.data_ptr(), idx.data_ptr(),
        torch.cuda.current_stream(a_aug.device).cuda_stream)
    _build.check(err, "packed_mma_argmin")
    packed_mma_argmin.launches += 1
    return idx, e_min


packed_mma_argmin.launches = 0
