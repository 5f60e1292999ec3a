"""k nearest neighbours in torch ops (counterpart of kernels/nn_xla.py).

The plain version of KN's selection (kernels/knn_cuda.py), used by normal
estimation on the CPU. The reference runs this as XLA ops, not as a
Pallas kernel. Each (chunk, N) tile scores the reference's factored
distance d = (‖a‖² + ‖b‖²) − 2·a·b: the norms as (x·x + y·y) + z·z, one
rounding a step, and a·b as a float32 matrix product (TF32 is off
package-wide). On the CPU that product is the chain fma(az, bz, fma(ay,
by, ax·bx)), bit for bit what the reference's XLA dot computes there and
what KN computes; cuBLAS on the card may sum it otherwise, within the
factored score's float32 error. Each row is then ordered by (d, index),
the rule of the reference's `lax.top_k` on the CPU (ties to the lower
index). `torch.topk` leaves the order of equal values open, so the k
picked are sorted by (d, index), and a row whose k-th and (k+1)-th values
tie is picked again over all its columns by (d, index).
"""

from __future__ import annotations

import torch


def sq_norm(p: torch.Tensor) -> torch.Tensor:
    """(n, 3) -> (n,): (x·x + y·y) + z·z, one rounding a step (what
    torch.sum(p * p, -1) gives)."""
    return p[:, 0] * p[:, 0] + p[:, 1] * p[:, 1] + p[:, 2] * p[:, 2]


def factored_d2(a: torch.Tensor, b: torch.Tensor, a_sq: torch.Tensor,
                b_sq: torch.Tensor) -> torch.Tensor:
    """(m, 3), (n, 3) and their squared norms -> (m, n) float32
    (‖a‖² + ‖b‖²) − 2·(a bᵀ)."""
    g = a @ b.T
    g *= 2.0
    return torch.sub(a_sq[:, None] + b_sq[None, :], g, out=g)


def order_keys(d: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """float32 d and its int64 column indices (same shape) -> int64 keys
    whose ascending order is (d, column): d's bit pattern made monotone
    (-0.0 before +0.0, as the reference's top_k has it) above the
    column."""
    bits = d.view(torch.int32)
    bits = bits ^ ((bits >> 31) & 0x7FFFFFFF)
    return (bits.to(torch.int64) << 32) | cols


def _by_d_then_index(d: torch.Tensor, vals: torch.Tensor, idx: torch.Tensor,
                     k: int) -> torch.Tensor:
    """The k first columns of each row of d by (d, index), from topk's
    k + 1 (or k, if d has k columns) smallest values and their columns."""
    tie = (vals[:, k - 1] == vals[:, k] if vals.shape[1] > k
           else torch.zeros_like(vals[:, 0], dtype=torch.bool))
    key = torch.sort(order_keys(vals[:, :k], idx[:, :k]), dim=1).values
    idx = key & 0xFFFFFFFF
    rows = torch.nonzero(tie)[:, 0]
    if rows.numel():
        sub = d[rows]
        cols = torch.arange(d.shape[1], device=d.device).expand_as(sub)
        idx[rows] = torch.topk(order_keys(sub, cols), k, dim=1,
                               largest=False).values & 0xFFFFFFFF
    return idx


def knn_bruteforce(src: torch.Tensor, dst: torch.Tensor, k: int,
                   chunk: int = 1024) -> tuple[torch.Tensor, torch.Tensor]:
    """k nearest dst indices per src point: (M, k) int32 idx, (M, k) d²
    (clamped at 0), each row ascending by (d², index).

    The reference's `approx=True, oversample=o` path selects the exact top-k
    among k·o approximate candidates, and its approximate stage is exact off
    the TPU, so exact top-k is the same function as the CPU reference's.
    """
    dst_sq = sq_norm(dst)
    idx_out, d2_out = [], []
    for a in torch.split(src, chunk):
        d = factored_d2(a, dst, sq_norm(a), dst_sq)
        vals, idx = torch.topk(d, min(k + 1, d.shape[1]), dim=1,
                               largest=False)
        idx = _by_d_then_index(d, vals, idx, k)
        idx_out.append(idx.to(torch.int32))
        d2_out.append(torch.clamp(torch.gather(d, 1, idx), min=0.0))
    return torch.cat(idx_out), torch.cat(d2_out)
