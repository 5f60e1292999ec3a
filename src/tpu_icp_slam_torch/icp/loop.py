"""The point-to-plane ICP iteration loop (port of tpu_icp_slam/icp/loop.py).

The reference runs the iteration as one `lax.while_loop` on the device.
Here it is a Python loop whose condition is read back once per iteration
(one host sync per ICP iteration); the condition is evaluated before the
body exactly as in the reference, so `iters` matches it.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from tpu_icp_slam.config import ICPConfig
from tpu_icp_slam_torch.core import se3
from tpu_icp_slam_torch.core.pointcloud import PointCloud
from tpu_icp_slam_torch.icp.point_to_plane import gauss_newton_step
from tpu_icp_slam_torch.kernels.nn import nearest_neighbor


@dataclasses.dataclass(frozen=True)
class ICPResult:
    T: torch.Tensor  # (4, 4) transform: dst_frame <- src_frame
    rmse: torch.Tensor  # inlier RMS correspondence distance at convergence
    iters: int | torch.Tensor  # iterations executed (a tensor from K5)
    n_inliers: torch.Tensor  # gated correspondences in the final iteration
    converged: torch.Tensor  # bool: tol reached before max_iters


def _check_supported(cfg: ICPConfig) -> None:
    if cfg.method != "point_to_plane":
        raise NotImplementedError(
            f"icp.method={cfg.method!r}: only point_to_plane is ported")
    if cfg.anderson:
        raise NotImplementedError("icp.anderson is not ported yet")
    if cfg.unroll_iters > 0:
        raise NotImplementedError("icp.unroll_iters > 0 is not ported yet")
    if cfg.degen_eps > 0.0:
        raise NotImplementedError("icp.degen_eps > 0 is not ported yet")


def _nn_correspondence(cfg: ICPConfig, dst: PointCloud):
    """Returns corr(points) -> (q, n, gate, d2): NN into dst + distance gate."""
    if cfg.nn_backend == "voxel":
        raise NotImplementedError("nn_backend='voxel' is not ported yet")
    max_d2 = cfg.max_corr_dist * cfg.max_corr_dist

    def corr(cur_pts: torch.Tensor):
        idx, _ = nearest_neighbor(cur_pts, dst.points, backend=cfg.nn_backend,
                                  chunk=cfg.nn_chunk,
                                  precision=cfg.nn_precision)
        idx = idx.long()
        q = dst.points[idx]
        n = dst.normals[idx] if dst.normals is not None else None
        # difference-form distances for the gates and the rmse, as in the
        # reference (its NN returns the cancellation-prone factored form)
        diff = cur_pts - q
        d2 = torch.sum(diff * diff, dim=-1)
        if cfg.corr_range_rate > 0.0:
            rng = torch.sqrt(torch.sum(cur_pts * cur_pts, dim=-1))
            gate_p = cfg.max_corr_dist + cfg.corr_range_rate * rng
            gate = (d2 <= gate_p * gate_p).to(cur_pts.dtype)
        else:
            gate = (d2 <= max_d2).to(cur_pts.dtype)
        return q, n, gate, d2

    return corr


def align(src: PointCloud, dst: PointCloud,
          init_T: Optional[torch.Tensor] = None,
          cfg: ICPConfig = ICPConfig()) -> ICPResult:
    """Align src onto dst: returns T such that T @ src ≈ dst."""
    return align_with_correspondence(src, _nn_correspondence(cfg, dst),
                                     init_T, cfg)


def align_with_correspondence(src: PointCloud, corr_fn: Callable,
                              init_T: Optional[torch.Tensor],
                              cfg: ICPConfig) -> ICPResult:
    """Point-to-plane ICP with a pluggable correspondence function.

    corr_fn(cur_pts (M, 3)) -> (q (M, 3), n (M, 3), gate (M,), d2 (M,)).
    loop_backend is not read here: like the reference's generic
    align_with_correspondence, this always runs the per-iteration steps path.
    """
    _check_supported(cfg)
    dev, dtype = src.points.device, src.points.dtype
    eye4 = torch.eye(4, dtype=dtype, device=dev)
    T0 = eye4 if init_T is None else init_T.to(dtype)
    src_mask_f = src.mask.to(dtype)
    trust_region = cfg.max_total_trans > 0.0 or cfg.max_total_rot > 0.0
    use_prior = cfg.prior_trans_weight > 0.0 or cfg.prior_rot_weight > 0.0
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
        w = gate * src_mask_f
        if cfg.huber_delta > 0.0:
            dist = torch.sqrt(torch.clamp(d2, min=1e-20))
            w = w * torch.clamp(cfg.huber_delta / dist, max=1.0)
        n_inl = torch.sum(w > 0, dtype=torch.int32)
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
            max_step_trans=cfg.max_step_trans, max_step_rot=cfg.max_step_rot,
            backend=cfg.gn_backend, prior_w=prior_w, xi_prior=xi_prior)
        if cfg.step_scale != 1.0:
            dT = se3.exp(cfg.step_scale * se3.log(dT))
        # too few inliers: hold the pose (the motion-model init survives)
        dT = torch.where(n_inl >= min_inl, dT, eye4)
        T_new = dT @ T
        if trust_region:
            # project the total correction back onto the ball around T0
            xi_tot = se3.log(T_new @ T0_inv)
            s = torch.ones((), dtype=dtype, device=dev)
            if cfg.max_total_trans > 0.0:
                tn = torch.linalg.vector_norm(xi_tot[:3])
                s = torch.minimum(
                    s, cfg.max_total_trans / torch.clamp(tn, min=1e-12))
            if cfg.max_total_rot > 0.0:
                rn = torch.linalg.vector_norm(xi_tot[3:])
                s = torch.minimum(
                    s, cfg.max_total_rot / torch.clamp(rn, min=1e-12))
            T_new = torch.where(s < 1.0, se3.exp(s * xi_tot) @ T0, T_new)
        wsum = torch.clamp(torch.sum(w), min=1e-12)
        rmse = torch.sqrt(torch.sum(w * d2) / wsum)
        converged = torch.abs(prev_rmse - rmse) < cfg.tol
        if cfg.tol_update > 0.0:
            step_mag = torch.linalg.vector_norm(dT[:3, 3]) + \
                torch.linalg.matrix_norm(dT[:3, :3] - eye4[:3, :3])
            converged = converged | (step_mag < cfg.tol_update)
        T, prev_rmse = T_new, rmse
        it += 1
    return ICPResult(T=T, rmse=prev_rmse, iters=it, n_inliers=n_inl,
                     converged=converged)
