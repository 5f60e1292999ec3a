"""The ICP iteration loop (port of tpu_icp_slam/icp/loop.py).

The reference runs the iteration as one `lax.while_loop` on the device.
Here it is a Python loop whose condition is read back once per iteration
(one host sync per ICP iteration); the condition is evaluated before the
body exactly as in the reference, so `iters` matches it.

`align_batched` is the reference's `vmap` of `align` over many initial
poses and targets (loop-closure verification): one loop over the batch,
every element stepping until all have stopped, each stopped element frozen,
so that each element's result is its own `align`'s.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from tpu_icp_slam.config import ICPConfig
from tpu_icp_slam_torch.core import se3
from tpu_icp_slam_torch.core.pointcloud import PointCloud
from tpu_icp_slam_torch.icp.point_to_plane import gauss_newton_step
from tpu_icp_slam_torch.icp.point_to_point import umeyama_masked
from tpu_icp_slam_torch.kernels.nn import nearest_neighbor


@dataclasses.dataclass(frozen=True)
class ICPResult:
    T: torch.Tensor  # (..., 4, 4) transform: dst_frame <- src_frame
    rmse: torch.Tensor  # inlier RMS correspondence distance at convergence
    iters: int | torch.Tensor  # iterations executed (a tensor from K5 and
    # from align_batched, one per element)
    n_inliers: torch.Tensor  # gated correspondences in the final iteration
    converged: torch.Tensor  # bool: tol reached before max_iters


def _check_supported(cfg: ICPConfig, dim: int = 3) -> None:
    if cfg.method not in ("point_to_plane", "point_to_point"):
        raise NotImplementedError(
            f"icp.method={cfg.method!r}: only point_to_plane and "
            "point_to_point are ported")
    if dim != 3:
        raise NotImplementedError("SE(2) alignment (2D clouds) is not "
                                  "ported yet")
    if cfg.anderson:
        raise NotImplementedError("icp.anderson is not ported yet")
    if cfg.unroll_iters > 0:
        raise NotImplementedError("icp.unroll_iters > 0 is not ported yet")
    if cfg.degen_eps > 0.0:
        raise NotImplementedError("icp.degen_eps > 0 is not ported yet")


def _gate(cfg: ICPConfig, cur_pts: torch.Tensor, d2: torch.Tensor
          ) -> torch.Tensor:
    """The correspondence distance gate as 0/1 weights."""
    if cfg.corr_range_rate > 0.0:
        rng = torch.sqrt(torch.sum(cur_pts * cur_pts, dim=-1))
        gate_p = cfg.max_corr_dist + cfg.corr_range_rate * rng
        return (d2 <= gate_p * gate_p).to(cur_pts.dtype)
    max_d2 = cfg.max_corr_dist * cfg.max_corr_dist
    return (d2 <= max_d2).to(cur_pts.dtype)


def _nn_correspondence(cfg: ICPConfig, dst: PointCloud):
    """Returns corr(points) -> (q, n, gate, d2): NN into dst + distance gate."""
    if cfg.nn_backend == "voxel":
        raise NotImplementedError("nn_backend='voxel' is not ported yet")
    last = dst.capacity - 1

    def corr(cur_pts: torch.Tensor):
        idx, _ = nearest_neighbor(cur_pts, dst.points, backend=cfg.nn_backend,
                                  chunk=cfg.nn_chunk, tile_m=cfg.nn_tile_m,
                                  tile_n=cfg.nn_tile_n,
                                  precision=cfg.nn_precision)
        # rescore may hand a padded source row a padded target row >= N;
        # the reference's gather clamps such an index, and so does this
        idx = torch.clamp(idx.long(), max=last)
        q = dst.points[idx]
        n = dst.normals[idx] if dst.normals is not None else None
        # difference-form distances for the gates and the rmse, as in the
        # reference (its NN returns the cancellation-prone factored form)
        diff = cur_pts - q
        d2 = torch.sum(diff * diff, dim=-1)
        return q, n, _gate(cfg, cur_pts, d2), d2

    return corr


def _huber(cfg: ICPConfig, w: torch.Tensor, d2: torch.Tensor) -> torch.Tensor:
    if cfg.huber_delta > 0.0:
        dist = torch.sqrt(torch.clamp(d2, min=1e-20))
        w = w * torch.clamp(cfg.huber_delta / dist, max=1.0)
    return w


def _project_total(cfg: ICPConfig, T_new: torch.Tensor, T0: torch.Tensor,
                   T0_inv: torch.Tensor) -> torch.Tensor:
    """Trust region: project the total correction log(T_new T0⁻¹) back onto
    the ball around T0 (batched over leading dims)."""
    xi_tot = se3.log(T_new @ T0_inv)
    s = torch.ones(xi_tot.shape[:-1], dtype=T_new.dtype, device=T_new.device)
    if cfg.max_total_trans > 0.0:
        tn = torch.linalg.vector_norm(xi_tot[..., :3], dim=-1)
        s = torch.minimum(s, cfg.max_total_trans / torch.clamp(tn, min=1e-12))
    if cfg.max_total_rot > 0.0:
        rn = torch.linalg.vector_norm(xi_tot[..., 3:], dim=-1)
        s = torch.minimum(s, cfg.max_total_rot / torch.clamp(rn, min=1e-12))
    return torch.where(s[..., None, None] < 1.0,
                       se3.exp(s[..., None] * xi_tot) @ T0, T_new)


def _step_converged(cfg: ICPConfig, prev_rmse, rmse, dT, eye3):
    converged = torch.abs(prev_rmse - rmse) < cfg.tol
    if cfg.tol_update > 0.0:
        step_mag = torch.linalg.vector_norm(dT[..., :3, 3], dim=-1) + \
            torch.linalg.matrix_norm(dT[..., :3, :3] - eye3)
        converged = converged | (step_mag < cfg.tol_update)
    return converged


def align(src: PointCloud, dst: PointCloud,
          init_T: Optional[torch.Tensor] = None,
          cfg: ICPConfig = ICPConfig()) -> ICPResult:
    """Align src onto dst: returns T such that T @ src ≈ dst."""
    return align_with_correspondence(src, _nn_correspondence(cfg, dst),
                                     init_T, cfg)


def align_with_correspondence(src: PointCloud, corr_fn: Callable,
                              init_T: Optional[torch.Tensor],
                              cfg: ICPConfig) -> ICPResult:
    """ICP with a pluggable correspondence function.

    corr_fn(cur_pts (M, 3)) -> (q (M, 3), n (M, 3) or None, gate (M,),
    d2 (M,)). loop_backend is not read here: like the reference's generic
    align_with_correspondence, this always runs the per-iteration steps path.
    """
    _check_supported(cfg, src.dim)
    dev, dtype = src.points.device, src.points.dtype
    eye4 = torch.eye(4, dtype=dtype, device=dev)
    T0 = eye4 if init_T is None else init_T.to(dtype)
    src_mask_f = src.mask.to(dtype)
    trust_region = cfg.max_total_trans > 0.0 or cfg.max_total_rot > 0.0
    use_prior = cfg.method == "point_to_plane" and (
        cfg.prior_trans_weight > 0.0 or cfg.prior_rot_weight > 0.0)
    T0_inv = (torch.linalg.inv_ex(T0)[0]
              if (use_prior or trust_region) else None)
    # filled on the device: a tensor from a host list would sync the stream
    prior_scale = torch.full((6,), cfg.prior_trans_weight, dtype=dtype,
                             device=dev)
    prior_scale[3:] = cfg.prior_rot_weight
    min_inl = max(cfg.min_inliers, 4)

    T = T0
    prev_rmse = torch.full((), float("inf"), dtype=dtype, device=dev)
    n_inl = torch.zeros((), dtype=torch.int32, device=dev)
    converged = torch.zeros((), dtype=torch.bool, device=dev)
    it = 0
    # cond before body, as lax.while_loop: `converged` is read on the host
    while it < cfg.max_iters and not (it > 0 and bool(converged)):
        cur = src.points @ T[:3, :3].T + T[:3, 3]
        q, n, gate, d2 = corr_fn(cur)
        w = _huber(cfg, gate * src_mask_f, d2)
        n_inl = torch.sum(w > 0, dtype=torch.int32)
        if cfg.method == "point_to_plane":
            if n is None:
                raise ValueError("point_to_plane requires target normals")
            prior_w = xi_prior = None
            if use_prior:
                # motion prior anchored at T0, λ relative to the frame's own
                # point evidence (see the reference's loop.py)
                prior_w = torch.clamp(torch.sum(w), min=1e-6) * prior_scale
                xi_prior = se3.log(T @ T0_inv)
            dT = gauss_newton_step(
                cur, q, n, w, damping=cfg.damping,
                max_step_trans=cfg.max_step_trans,
                max_step_rot=cfg.max_step_rot, backend=cfg.gn_backend,
                prior_w=prior_w, xi_prior=xi_prior)
        else:
            dT = umeyama_masked(cur, q, w)
        if cfg.step_scale != 1.0:
            dT = se3.exp(cfg.step_scale * se3.log(dT))
        # too few inliers: hold the pose (the motion-model init survives)
        dT = torch.where(n_inl >= min_inl, dT, eye4)
        T_new = dT @ T
        if trust_region:
            T_new = _project_total(cfg, T_new, T0, T0_inv)
        wsum = torch.clamp(torch.sum(w), min=1e-12)
        rmse = torch.sqrt(torch.sum(w * d2) / wsum)
        converged = _step_converged(cfg, prev_rmse, rmse, dT, eye4[:3, :3])
        T, prev_rmse = T_new, rmse
        it += 1
    return ICPResult(T=T, rmse=prev_rmse, iters=it, n_inliers=n_inl,
                     converged=converged)


def align_batched(src: PointCloud, dst_points: torch.Tensor,
                  dst_mask: torch.Tensor, init_T: torch.Tensor,
                  cfg: ICPConfig) -> ICPResult:
    """Point-to-point ICP of one source against many (target, initial pose)
    pairs: dst_points (B/G, N, 3), dst_mask (B/G, N), init_T (B, 4, 4);
    element b aligns src onto target b // G from init_T[b].

    The reference's vmap over `align` (backend/loop_closure.py::
    _batched_verify): all elements step until every one has stopped
    (converged or max_iters), and a stopped element is frozen with
    `torch.where`, so each element's result equals its own unbatched
    `align`. The NN runs once per iteration for the whole batch (K1's
    batched form on CUDA); "any still running" is read back once per
    iteration. Returns an ICPResult with a leading (B,) on every field; the
    loop ran max(iters) batched iterations.
    """
    _check_supported(cfg, src.dim)
    if cfg.method != "point_to_point":
        raise NotImplementedError(
            "align_batched runs point_to_point (loop-closure verification)")
    if cfg.nn_backend == "voxel":
        raise NotImplementedError("nn_backend='voxel' is not ported yet")
    del dst_mask  # padded targets carry the sentinel, as in align
    dev, dtype = src.points.device, src.points.dtype
    batch, n = init_T.shape[0], dst_points.shape[1]
    group = batch // dst_points.shape[0]
    eye4 = torch.eye(4, dtype=dtype, device=dev)
    T0 = init_T.to(dtype)
    trust_region = cfg.max_total_trans > 0.0 or cfg.max_total_rot > 0.0
    T0_inv = torch.linalg.inv_ex(T0)[0] if trust_region else None
    src_mask_f = src.mask.to(dtype)
    min_inl = max(cfg.min_inliers, 4)
    flat_dst = dst_points.reshape(-1, 3)
    # row of element b's target in flat_dst, clamped like the reference's
    # gather (rescore's padded-target case; see _nn_correspondence)
    base = (torch.arange(batch, device=dev) // group * n)[:, None]

    T = T0
    prev_rmse = torch.full((batch,), float("inf"), dtype=dtype, device=dev)
    iters = torch.zeros(batch, dtype=torch.int32, device=dev)
    n_inl = torch.zeros(batch, dtype=torch.int32, device=dev)
    converged = torch.zeros(batch, dtype=torch.bool, device=dev)
    it = 0
    # elements that have not converged have run every iteration so far
    while it < cfg.max_iters and not (it > 0 and bool(converged.all())):
        cur = src.points @ T[:, :3, :3].transpose(-1, -2) + T[:, None, :3, 3]
        idx, _ = nearest_neighbor(
            cur, dst_points, backend=cfg.nn_backend, chunk=cfg.nn_chunk,
            tile_m=cfg.nn_tile_m, tile_n=cfg.nn_tile_n,
            precision=cfg.nn_precision)
        q = flat_dst[base + torch.clamp(idx.long(), max=n - 1)]
        diff = cur - q
        d2 = torch.sum(diff * diff, dim=-1)
        w = _huber(cfg, _gate(cfg, cur, d2) * src_mask_f, d2)
        inl = torch.sum(w > 0, dim=-1, dtype=torch.int32)
        dT = umeyama_masked(cur, q, w)
        if cfg.step_scale != 1.0:
            dT = se3.exp(cfg.step_scale * se3.log(dT))
        dT = torch.where((inl >= min_inl)[:, None, None], dT, eye4)
        T_new = dT @ T
        if trust_region:
            T_new = _project_total(cfg, T_new, T0, T0_inv)
        wsum = torch.clamp(torch.sum(w, dim=-1), min=1e-12)
        rmse = torch.sqrt(torch.sum(w * d2, dim=-1) / wsum)
        conv = _step_converged(cfg, prev_rmse, rmse, dT, eye4[:3, :3])
        run = ~converged  # frozen elements keep their state
        T = torch.where(run[:, None, None], T_new, T)
        prev_rmse = torch.where(run, rmse, prev_rmse)
        n_inl = torch.where(run, inl, n_inl)
        iters = iters + run.to(torch.int32)
        converged = torch.where(run, conv, converged)
        it += 1
    return ICPResult(T=T, rmse=prev_rmse, iters=iters, n_inliers=n_inl,
                     converged=converged)
