"""Distributed ICP: batch over "dp", source points sharded over "sp" (port
of tpu_icp_slam/dist/sharded_icp.py).

The SLAM analogue of sharding a big matmul: the M×N distance matrix of the
NN search tiles over ranks along the source axis. Each "sp" rank searches
its slice of source points against the full target, computes *local* solve
statistics — raw Umeyama moments (point-to-point) or the 6×6 normal
equations H, g (point-to-plane) — and one all-reduce over "sp" sums them
together with the gate statistics, packed into one tensor; every rank then
solves the same small system, so the transform stays replicated without a
broadcast. One collective pattern an iteration, as in the reference.

The reference vmaps a `lax.while_loop` over the local batch rows; here the
rows step together in one host loop (one host read an iteration: "any row
still running"), and a stopped row is frozen with `torch.where`. Every rank
of an "sp" group tests the same reduced numbers, so the group stops
together; a rank whose shard is all padding still takes part in every
collective. An iteration runs each kernel once for all the local rows, as
the reference's vmap makes one pallas_call of each: the NN in its batched
form (K1 at "highest", K3 at "bf16", K4 at "rescore"), then batched K2 for
the normal equations, then one batched 6×6 solve and one batched exp.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from tpu_icp_slam_torch.config import ICPConfig
from tpu_icp_slam_torch.core import se2, se3
from tpu_icp_slam_torch.dist.mesh import Mesh, all_gather, all_reduce
from tpu_icp_slam_torch.icp.loop import ICPResult
from tpu_icp_slam_torch.icp.point_to_plane import (
    build_normal_equations,
    solve_increment,
)
from tpu_icp_slam_torch.icp.point_to_point import moments, umeyama_from_moments
from tpu_icp_slam_torch.kernels.gn_cuda import gn_accum
from tpu_icp_slam_torch.kernels.nn import nearest_neighbor


def _gn_kernel(cfg: ICPConfig, pts: torch.Tensor) -> bool:
    """The reference's rule (sharded_icp.py:71-82): K2 when gn_backend
    resolves to the kernel ("auto" on the card) for 3-D float32 rows."""
    backend = cfg.gn_backend
    if backend == "auto":
        backend = "pallas" if pts.device.type == "cuda" else "xla"
    return (backend == "pallas" and pts.shape[-1] == 3
            and pts.dtype == torch.float32)


def _align_shard(
    src_pts: torch.Tensor,  # (Bl, Ms, D) local source shards
    src_msk: torch.Tensor,  # (Bl, Ms)
    dst_pts: torch.Tensor,  # (Bl, N, D) full targets
    dst_nrm: torch.Tensor,  # (Bl, N, D) target normals (zeros if unused)
    T0: torch.Tensor,  # (Bl, D+1, D+1)
    *,
    cfg: ICPConfig,
    reduce: Callable[[torch.Tensor], torch.Tensor],
) -> ICPResult:
    """The per-shard ICP loop over the local rows; `reduce` sums a (Bl, k)
    tensor over the "sp" ranks (one collective an iteration)."""
    bl, _, d = src_pts.shape
    dtype, dev = src_pts.dtype, src_pts.device
    lie = se3 if d == 3 else se2
    k = 6 if d == 3 else 3
    max_d2 = cfg.max_corr_dist * cfg.max_corr_dist
    mskf = src_msk.to(dtype)
    huber = cfg.huber_delta
    min_inl = max(cfg.min_inliers, d + 1)
    eye = torch.eye(d + 1, dtype=dtype, device=dev)
    last = dst_pts.shape[1] - 1
    kernel = cfg.method == "point_to_plane" and _gn_kernel(cfg, src_pts)

    def body(T):
        cur = src_pts @ T[:, :d, :d].transpose(-1, -2) + T[:, None, :d, d]
        idx, _ = nearest_neighbor(cur, dst_pts, backend=cfg.nn_backend,
                                  chunk=cfg.nn_chunk,
                                  precision=cfg.nn_precision)
        # rescore may pick a padded target row >= N: clamp, as the
        # reference's gather does
        idx = torch.clamp(idx.long(), max=last)[..., None].expand(-1, -1, d)
        q = torch.gather(dst_pts, 1, idx)
        diff = cur - q
        d2 = torch.sum(diff * diff, dim=-1)
        w = (d2 <= max_d2).to(dtype) * mskf
        if huber > 0.0:
            dist = torch.sqrt(torch.clamp(d2, min=1e-20))
            w = w * torch.clamp(huber / dist, max=1.0)
        stats = torch.stack([torch.sum(w, -1), torch.sum(w * d2, -1),
                             torch.sum(w > 0, -1).to(dtype)], -1)
        if cfg.method == "point_to_plane":
            n = torch.gather(dst_nrm, 1, idx)
            H, g = (gn_accum if kernel else build_normal_equations)(
                cur, q, n, w)
            tot = reduce(torch.cat([H.reshape(bl, k * k), g, stats], -1))
            dT = lie.exp(solve_increment(
                tot[:, :k * k].reshape(bl, k, k), tot[:, k * k:k * k + k],
                cfg.damping, cfg.max_step_trans, cfg.max_step_rot))
        else:
            wsum, s_src, s_dst, s_ds = moments(cur, q, w)
            tot = reduce(torch.cat([wsum[:, None], s_src, s_dst,
                                    s_ds.reshape(bl, d * d), stats], -1))
            dT = umeyama_from_moments(
                tot[:, 0], tot[:, 1:1 + d], tot[:, 1 + d:1 + 2 * d],
                tot[:, 1 + 2 * d:1 + 2 * d + d * d].reshape(bl, d, d))
        st = tot[:, -3:]
        dT = torch.where((st[:, 2] >= min_inl)[:, None, None], dT, eye)
        rmse = torch.sqrt(st[:, 1] / torch.clamp(st[:, 0], min=1e-12))
        return dT @ T, rmse, st[:, 2].to(torch.int32)

    T = T0.to(dtype)
    prev = torch.full((bl,), float("inf"), dtype=dtype, device=dev)
    iters = torch.zeros(bl, dtype=torch.int32, device=dev)
    n_inl = torch.zeros(bl, dtype=torch.int32, device=dev)
    converged = torch.zeros(bl, dtype=torch.bool, device=dev)
    while True:
        # the while_loop's cond, per row; the host reads "any row running"
        active = (iters < cfg.max_iters) & ~converged
        if not bool(active.any()):
            break
        T_new, rmse, n_new = body(T)
        conv_new = torch.abs(prev - rmse) < cfg.tol
        T = torch.where(active[:, None, None], T_new, T)
        prev = torch.where(active, rmse, prev)
        n_inl = torch.where(active, n_new, n_inl)
        converged = torch.where(active, conv_new, converged)
        iters = iters + active.to(torch.int32)
    return ICPResult(T=T, rmse=prev, iters=iters, n_inliers=n_inl,
                     converged=converged)


def make_sharded_align(mesh: Mesh, cfg: ICPConfig, batch_axis: str = "dp",
                       point_axis: str = "sp"):
    """A batched, point-sharded ICP align over `mesh`.

    Returns fn(src_pts (B, M, D), src_msk (B, M), dst_pts (B, N, D),
    dst_nrm (B, N, D), T0 (B, D+1, D+1)) -> ICPResult with leading (B,) on
    every rank. Every rank passes the whole batch and computes its block:
    B must divide by mesh[batch_axis] and M by mesh[point_axis]. The
    results are all-gathered over batch_axis (one collective)."""
    n_dp, n_sp = mesh.shape[batch_axis], mesh.shape[point_axis]
    i_dp, i_sp = mesh.index(batch_axis), mesh.index(point_axis)

    def reduce(x):
        return all_reduce(x, mesh, point_axis)

    def fn(src_pts, src_msk, dst_pts, dst_nrm, T0) -> ICPResult:
        b, m, d = src_pts.shape
        if b % n_dp or m % n_sp:
            raise ValueError(f"batch {b} must divide by {batch_axis}={n_dp} "
                             f"and points {m} by {point_axis}={n_sp}")
        rb, rm = b // n_dp, m // n_sp
        rows = slice(i_dp * rb, (i_dp + 1) * rb)
        cols = slice(i_sp * rm, (i_sp + 1) * rm)
        res = _align_shard(
            src_pts[rows, cols].contiguous(), src_msk[rows, cols],
            dst_pts[rows].contiguous(), dst_nrm[rows].contiguous(),
            T0[rows], cfg=cfg, reduce=reduce)
        # one gather of the packed result (float64 holds the integers
        # exactly)
        packed = torch.cat([
            res.T.reshape(rb, -1).double(), res.rmse[:, None].double(),
            res.iters[:, None].double(), res.n_inliers[:, None].double(),
            res.converged[:, None].double()], -1)
        full = all_gather(packed, mesh, batch_axis)
        e = (d + 1) * (d + 1)
        dtype = src_pts.dtype
        return ICPResult(
            T=full[:, :e].reshape(b, d + 1, d + 1).to(dtype),
            rmse=full[:, e].to(dtype), iters=full[:, e + 1].to(torch.int32),
            n_inliers=full[:, e + 2].to(torch.int32),
            converged=full[:, e + 3] > 0)

    return fn


@dataclasses.dataclass(frozen=True)
class ShardedAligner:
    """The sharded align over mesh ("dp", "sp"), on the mesh's device."""

    mesh: Mesh
    cfg: ICPConfig

    def __post_init__(self):
        object.__setattr__(self, "_fn", make_sharded_align(self.mesh,
                                                           self.cfg))

    def __call__(self, src_pts, src_msk, dst_pts, dst_nrm=None,
                 T0=None) -> ICPResult:
        dev = self.mesh.device

        def dev_t(x, dtype=None):
            return torch.as_tensor(np.asarray(x) if not isinstance(
                x, torch.Tensor) else x, dtype=dtype, device=dev)

        src_pts = dev_t(src_pts)
        dtype = src_pts.dtype
        src_msk = dev_t(src_msk, torch.bool)
        dst_pts = dev_t(dst_pts, dtype)
        b, _, d = src_pts.shape
        dst_nrm = (torch.zeros_like(dst_pts) if dst_nrm is None
                   else dev_t(dst_nrm, dtype))
        T0 = (torch.eye(d + 1, dtype=dtype, device=dev).expand(
            b, d + 1, d + 1) if T0 is None else dev_t(T0, dtype))
        # pad the batch to a multiple of the dp axis with copies of the last
        # row (the reference's mode="edge"): they converge alongside
        dp = self.mesh.shape["dp"]
        bp = -(-b // dp) * dp
        if bp != b:
            def tile(x):
                return torch.cat([x, x[-1:].expand(bp - b, *x.shape[1:])])

            src_pts, src_msk, dst_pts, dst_nrm, T0 = map(
                tile, (src_pts, src_msk, dst_pts, dst_nrm, T0))
        res = self._fn(src_pts, src_msk, dst_pts, dst_nrm, T0)
        if bp != b:
            res = ICPResult(*(getattr(res, f.name)[:b]
                              for f in dataclasses.fields(res)))
        return res
