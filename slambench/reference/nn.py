"""Nearest neighbours and matrix products for the plain reference.

Every matrix product of the reference goes through `Arith.mm`, so that
the whole reference can be computed in one stated precision: "float32"
(TF32 off: the precision the configurations state) or "tf32" (both
operands rounded to TF32's 10-bit mantissa before a float32-accumulated
product, as the tensor cores do with TF32 on): the control that has to
come out as not correct.

Distances are scored by one product of augmented rows, [x, y, z, 1, |x|²]
against [-2x', -2y', -2z', |x'|², 1]. The front end's NN and the normals'
k-NN take a shortlist of the smallest factored scores and pick among it by
the difference-form distance, ties to the lower index, so they are exact
in float32 but for shortlists the factored form's error pushes the true
neighbour out of. Verification's batched NN takes the factored argmin,
as the JAX reference's NN does.
"""

from __future__ import annotations

import contextlib

import torch

SHORTLIST = 8  # factored candidates rescored in difference form


def _to_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (10 mantissa bits, to nearest, ties away)."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


class Arith:
    """The reference's matrix products in one precision."""

    def __init__(self, precision: str = "float32"):
        if precision not in ("float32", "tf32"):
            raise ValueError(f"unknown precision {precision}")
        self.precision = precision

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.precision == "tf32" and a.dtype == torch.float32:
            return _to_tf32(a) @ _to_tf32(b)
        return a @ b

    @contextlib.contextmanager
    def scope(self):
        """TF32 off in cuBLAS for the reference's products (the tf32
        precision rounds its operands itself)."""
        saved = (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            yield self
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = saved


def _aug_src(a: torch.Tensor) -> torch.Tensor:
    one = torch.ones_like(a[..., :1])
    return torch.cat([a, one, torch.sum(a * a, dim=-1, keepdim=True)], -1)


def _aug_dst(b: torch.Tensor) -> torch.Tensor:
    one = torch.ones_like(b[..., :1])
    return torch.cat([-2.0 * b, torch.sum(b * b, dim=-1, keepdim=True), one],
                     -1)


def _rescore(a: torch.Tensor, b: torch.Tensor, cand: torch.Tensor, k: int):
    """The k candidates of each row nearest by difference-form d², ties to
    the lower index: (idx (m, k) int64, d2 (m, k))."""
    diff = a[:, None, :] - b[cand]
    d2 = torch.sum(diff * diff, dim=-1)
    # order by (d2, index): sort by index first, then a stable sort by d2
    by_idx, perm = torch.sort(cand, dim=1)
    d2 = torch.gather(d2, 1, perm)
    d2s, order = torch.sort(d2, dim=1, stable=True)
    return torch.gather(by_idx, 1, order)[:, :k], d2s[:, :k]


def knn(ar: Arith, src: torch.Tensor, dst: torch.Tensor, k: int,
        chunk: int = 2048):
    """The k nearest dst rows of each src row: (idx (M, k), d2 (M, k))."""
    bt = _aug_dst(dst).T.contiguous()
    short = min(max(SHORTLIST, k + 4), dst.shape[0])
    out_i, out_d = [], []
    for a in torch.split(src, chunk):
        score = ar.mm(_aug_src(a), bt)
        cand = torch.topk(score, short, dim=1, largest=False).indices
        i, d = _rescore(a, dst, cand, k)
        out_i.append(i)
        out_d.append(d)
    return torch.cat(out_i), torch.cat(out_d)


def nearest(ar: Arith, src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """The nearest dst row of each src row (M,) int64."""
    return knn(ar, src, dst, 1)[0][:, 0]


def nearest_batched(ar: Arith, src: torch.Tensor, dst: torch.Tensor,
                    chunk: int = 4) -> torch.Tensor:
    """src (B, M, 3) against dst (B, N, 3): the factored-score argmin of each
    row (B, M) int64."""
    bt = _aug_dst(dst).transpose(1, 2).contiguous()
    a_aug = _aug_src(src)
    out = []
    for b0 in range(0, src.shape[0], chunk):
        score = ar.mm(a_aug[b0:b0 + chunk], bt[b0:b0 + chunk])
        out.append(torch.argmin(score, dim=2))
    return torch.cat(out)
