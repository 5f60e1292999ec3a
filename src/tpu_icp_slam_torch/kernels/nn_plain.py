"""k nearest neighbours in torch ops (counterpart of kernels/nn_xla.py).

Used by normal estimation. The reference runs this as XLA ops, not as a
Pallas kernel, so the port keeps it in torch: a chunked factored distance
matrix ‖a‖² + ‖b‖² − 2a·bᵀ (a full-float32 matmul; TF32 is off package-wide)
and an exact `torch.topk`.
"""

from __future__ import annotations

import torch


def knn_bruteforce(src: torch.Tensor, dst: torch.Tensor, k: int,
                   chunk: int = 1024) -> tuple[torch.Tensor, torch.Tensor]:
    """k nearest dst indices per src point: (M, k) int32 idx, (M, k) d².

    The reference's `approx=True, oversample=o` path selects the exact top-k
    among k·o approximate candidates, and its approximate stage is exact off
    the TPU, so exact top-k is the same function as the CPU reference's.
    """
    dst_sq = torch.sum(dst * dst, dim=-1)
    idx_out, d2_out = [], []
    for a in torch.split(src, chunk):
        a_sq = torch.sum(a * a, dim=-1)
        d = a_sq[:, None] + dst_sq[None, :] - 2.0 * (a @ dst.T)
        neg_d, idx = torch.topk(-d, k, dim=1)
        idx_out.append(idx.to(torch.int32))
        d2_out.append(torch.clamp(-neg_d, min=0.0))
    return torch.cat(idx_out), torch.cat(d2_out)
