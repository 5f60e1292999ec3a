"""The ICP iteration loop (port of tpu_icp_slam/icp/loop.py), for 3D (SE(3))
and 2D (SE(2)) clouds.

The reference runs the iteration as one `lax.while_loop` on the device.
Here it is a Python loop whose condition is read back once per iteration
(one host sync per ICP iteration); the condition is evaluated before the
body exactly as in the reference, so `iters` matches it. With
`icp.unroll_iters > 0` it is the reference's unrolled form instead: a fixed
trip count with no host read inside it, every carried field frozen by
`torch.where` once `converged` or `it >= max_iters` holds, so `iters` is a
tensor (the form a CUDA graph could capture).

`align_batched` is the reference's `vmap` of `align` over many initial
poses and targets (loop-closure verification): one loop over the batch,
every element stepping until all have stopped, each stopped element frozen,
so that each element's result is its own `align`'s. Both drivers share one
body; `icp.anderson` (AA(1) on twists) runs in either.
"""

from __future__ import annotations

import dataclasses
import functools
import logging
from typing import Callable, Optional

import torch

from tpu_icp_slam_torch.config import ICPConfig
from tpu_icp_slam_torch.core import se2, se3
from tpu_icp_slam_torch.core.pointcloud import PointCloud
from tpu_icp_slam_torch.icp.point_to_plane import gauss_newton_step
from tpu_icp_slam_torch.icp.point_to_point import umeyama_masked
from tpu_icp_slam_torch.kernels import voxel_nn
from tpu_icp_slam_torch.kernels.nn import nearest_neighbor


@dataclasses.dataclass(frozen=True)
class ICPResult:
    T: torch.Tensor  # (..., D+1, D+1) transform: dst_frame <- src_frame
    rmse: torch.Tensor  # inlier RMS correspondence distance at convergence
    iters: int | torch.Tensor  # iterations executed (a tensor from K5, from
    # the unrolled loop and from align_batched, one per element)
    n_inliers: torch.Tensor  # gated correspondences in the final iteration
    converged: torch.Tensor  # bool: tol reached before max_iters


def _lie(d: int):
    """The group module of d-dimensional rigid motions."""
    if d not in (2, 3):
        raise ValueError(f"unsupported point dimension {d}")
    return se3 if d == 3 else se2


@functools.cache
def _warn_fused_ignored() -> None:
    """Once a process, as the reference warns: the generic loop below
    runs the per-iteration steps path whatever icp.loop_backend says."""
    logging.getLogger(__name__).warning(
        "icp.loop_backend='fused' is only honored by the scan-to-map "
        "pipeline (3D point_to_plane); this align() call runs the "
        "per-iteration steps path.")


def _gate(cfg: ICPConfig, cur_pts: torch.Tensor, d2: torch.Tensor
          ) -> torch.Tensor:
    """The correspondence distance gate as 0/1 weights."""
    if cfg.corr_range_rate > 0.0:
        rng = torch.sqrt(torch.sum(cur_pts * cur_pts, dim=-1))
        gate_p = cfg.max_corr_dist + cfg.corr_range_rate * rng
        return (d2 <= gate_p * gate_p).to(cur_pts.dtype)
    max_d2 = cfg.max_corr_dist * cfg.max_corr_dist
    return (d2 <= max_d2).to(cur_pts.dtype)


def _voxel_grid(cfg: ICPConfig, points: torch.Tensor, mask: torch.Tensor):
    """The hash grid of nn_backend="voxel" over one target: its voxel is the
    correspondence gate, so the search is exact inside the gate. Built once
    per align (the target is fixed across iterations)."""
    if cfg.max_corr_dist >= 1e6:
        raise ValueError("nn_backend='voxel' needs a finite max_corr_dist")
    return voxel_nn.build(points, mask, voxel=cfg.max_corr_dist,
                          table_size=cfg.voxel_table_size,
                          bucket=cfg.voxel_bucket)


def _nn_correspondence(cfg: ICPConfig, dst: PointCloud):
    """Returns corr(points) -> (q, n, gate, d2): NN into dst + distance gate."""
    grid = (_voxel_grid(cfg, dst.points, dst.mask)
            if cfg.nn_backend == "voxel" else None)
    last = dst.capacity - 1

    def corr(cur_pts: torch.Tensor):
        if grid is not None:
            idx, _ = voxel_nn.query(grid, cur_pts, voxel=cfg.max_corr_dist)
        else:
            idx, _ = nearest_neighbor(
                cur_pts, dst.points, backend=cfg.nn_backend,
                chunk=cfg.nn_chunk, tile_m=cfg.nn_tile_m,
                tile_n=cfg.nn_tile_n, precision=cfg.nn_precision)
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
    d = T_new.shape[-1] - 1
    lie = _lie(d)
    xi_tot = lie.log(T_new @ T0_inv)
    s = torch.ones(xi_tot.shape[:-1], dtype=T_new.dtype, device=T_new.device)
    if cfg.max_total_trans > 0.0:
        tn = torch.linalg.vector_norm(xi_tot[..., :d], dim=-1)
        s = torch.minimum(s, cfg.max_total_trans / torch.clamp(tn, min=1e-12))
    if cfg.max_total_rot > 0.0:
        rn = torch.linalg.vector_norm(xi_tot[..., d:], dim=-1)
        s = torch.minimum(s, cfg.max_total_rot / torch.clamp(rn, min=1e-12))
    return torch.where(s[..., None, None] < 1.0,
                       lie.exp(s[..., None] * xi_tot) @ T0, T_new)


def _step_converged(cfg: ICPConfig, prev_rmse, rmse, dT, eye_d):
    d = dT.shape[-1] - 1
    converged = torch.abs(prev_rmse - rmse) < cfg.tol
    if cfg.tol_update > 0.0:
        step_mag = torch.linalg.vector_norm(dT[..., :d, d], dim=-1) + \
            torch.linalg.matrix_norm(dT[..., :d, :d] - eye_d)
        converged = converged | (step_mag < cfg.tol_update)
    return converged


def align(src: PointCloud, dst: PointCloud,
          init_T: Optional[torch.Tensor] = None,
          cfg: ICPConfig = ICPConfig()) -> ICPResult:
    """Align src onto dst: returns T such that T @ src ≈ dst."""
    return align_with_correspondence(src, _nn_correspondence(cfg, dst),
                                     init_T, cfg)


def _body(cfg: ICPConfig, src: PointCloud, corr_fn: Callable, T0, T0_inv,
          prior_scale):
    """One ICP iteration as a function of the carried state, batched over
    the leading dims of T: (T, prev_rmse, it, f_prev, g_prev) -> (T_new,
    rmse, n_inliers, converged, f, g). `it` (an int, or a tensor of the
    batch's shape) only arms Anderson's first-iteration safeguard."""
    d = src.dim
    lie = _lie(d)
    dev, dtype = src.points.device, src.points.dtype
    eye = torch.eye(d + 1, dtype=dtype, device=dev)
    src_mask_f = src.mask.to(dtype)
    min_inl = max(cfg.min_inliers, d + 1)

    def body(T, prev_rmse, it, f_prev, g_prev):
        cur = src.points @ T[..., :d, :d].transpose(-1, -2) \
            + T[..., None, :d, d]
        q, n, gate, d2 = corr_fn(cur)
        w = _huber(cfg, gate * src_mask_f, d2)
        n_inl = torch.sum(w > 0, dim=-1, dtype=torch.int32)
        if cfg.method == "point_to_plane":
            if n is None:
                raise ValueError("point_to_plane requires target normals")
            prior_w = xi_prior = None
            if prior_scale is not None:
                # motion prior anchored at T0, λ relative to the frame's own
                # point evidence (see the reference's loop.py)
                prior_w = torch.clamp(torch.sum(w), min=1e-6) * prior_scale
                xi_prior = lie.log(T @ T0_inv)
            dT = gauss_newton_step(
                cur, q, n, w, damping=cfg.damping,
                max_step_trans=cfg.max_step_trans,
                max_step_rot=cfg.max_step_rot, backend=cfg.gn_backend,
                degen_eps=cfg.degen_eps, prior_w=prior_w, xi_prior=xi_prior)
        else:
            dT = umeyama_masked(cur, q, w)
        if cfg.step_scale != 1.0:
            dT = lie.exp(cfg.step_scale * lie.log(dT))
        # too few inliers: hold the pose (the motion-model init survives)
        dT = torch.where((n_inl >= min_inl)[..., None, None], dT, eye)
        T_new = dT @ T
        if cfg.anderson:
            # AA(1) on the fixed-point map T -> dT T in twist coordinates:
            # x = log T, g = log(dT T), f = g - x, x+ = g - γ (g - g_prev)
            # with γ = fᵀ(f - f_prev) / |f - f_prev|² clipped to [-1, 1];
            # the plain step on the first iteration or when |f| grew
            x = lie.log(T)
            g = lie.log(T_new)
            f = g - x
            df = f - f_prev
            denom = torch.sum(df * df, dim=-1)
            gamma = torch.where(
                denom > 1e-20,
                torch.sum(f * df, dim=-1) / torch.clamp(denom, min=1e-20),
                torch.zeros_like(denom))
            gamma = torch.clamp(gamma, -1.0, 1.0)
            x_aa = g - gamma[..., None] * (g - g_prev)
            use_aa = (torch.linalg.vector_norm(f, dim=-1)
                      <= torch.linalg.vector_norm(f_prev, dim=-1)) & (it > 0)
            T_new = torch.where(use_aa[..., None, None], lie.exp(x_aa), T_new)
            f_prev, g_prev = f, g
        if cfg.max_total_trans > 0.0 or cfg.max_total_rot > 0.0:
            T_new = _project_total(cfg, T_new, T0, T0_inv)
        wsum = torch.clamp(torch.sum(w, dim=-1), min=1e-12)
        rmse = torch.sqrt(torch.sum(w * d2, dim=-1) / wsum)
        converged = _step_converged(cfg, prev_rmse, rmse, dT, eye[:d, :d])
        return T_new, rmse, n_inl, converged, f_prev, g_prev

    return body


def _drive(cfg: ICPConfig, body: Callable, T0: torch.Tensor,
           batched: bool) -> ICPResult:
    """Run `body` from T0 under the reference's stopping rule: the host
    loop (condition read back before each body) or, with unroll_iters > 0,
    the fixed-trip frozen form. A batched loop runs until every element has
    stopped and freezes each stopped element."""
    dev, dtype = T0.device, T0.dtype
    bs = T0.shape[:-2]
    k = 6 if T0.shape[-1] == 4 else 3
    T = T0
    prev_rmse = torch.full(bs, float("inf"), dtype=dtype, device=dev)
    n_inl = torch.zeros(bs, dtype=torch.int32, device=dev)
    converged = torch.zeros(bs, dtype=torch.bool, device=dev)
    # Anderson's memory: the 1e6 f_prev sentinel marks the first iteration
    f_prev = torch.full((*bs, k), 1e6, dtype=dtype, device=dev)
    g_prev = torch.zeros((*bs, k), dtype=dtype, device=dev)
    iters = torch.zeros(bs, dtype=torch.int32, device=dev)

    def freeze(stop, new):
        """new, but the carried state where `stop` holds."""
        old = (T, prev_rmse, n_inl, converged, f_prev, g_prev)
        out = []
        for n, o in zip(new, old):
            s = stop.reshape(stop.shape + (1,) * (o.dim() - stop.dim()))
            out.append(torch.where(s, o, n))
        return tuple(out)

    if cfg.unroll_iters > 0:
        for _ in range(cfg.unroll_iters):
            stop = converged | (iters >= cfg.max_iters)
            T, prev_rmse, n_inl, converged, f_prev, g_prev = freeze(
                stop, body(T, prev_rmse, iters, f_prev, g_prev))
            iters = iters + (~stop).to(torch.int32)
        return ICPResult(T=T, rmse=prev_rmse, iters=iters, n_inliers=n_inl,
                         converged=converged)
    it = 0
    # cond before body, as lax.while_loop: `converged` is read on the host
    # (a batch stops when every element has)
    while it < cfg.max_iters and not (
            it > 0 and bool(converged.all() if batched else converged)):
        new = body(T, prev_rmse, it, f_prev, g_prev)
        if batched:  # stopped elements keep their state
            stop = converged
            T, prev_rmse, n_inl, converged, f_prev, g_prev = freeze(stop, new)
            iters = iters + (~stop).to(torch.int32)
        else:
            T, prev_rmse, n_inl, converged, f_prev, g_prev = new
        it += 1
    return ICPResult(T=T, rmse=prev_rmse, iters=iters if batched else it,
                     n_inliers=n_inl, converged=converged)


def _anchor(cfg: ICPConfig, T0: torch.Tensor, prior: bool):
    """(T0⁻¹ or None, the prior's per-axis scale or None)."""
    d = T0.shape[-1] - 1
    trust_region = cfg.max_total_trans > 0.0 or cfg.max_total_rot > 0.0
    T0_inv = (torch.linalg.inv_ex(T0)[0] if (prior or trust_region)
              else None)
    prior_scale = None
    if prior:
        # filled on the device: a tensor from a host list would sync the
        # stream
        k = 6 if d == 3 else 3
        prior_scale = torch.full((k,), cfg.prior_trans_weight,
                                 dtype=T0.dtype, device=T0.device)
        prior_scale[d:] = cfg.prior_rot_weight
    return T0_inv, prior_scale


def align_with_correspondence(src: PointCloud, corr_fn: Callable,
                              init_T: Optional[torch.Tensor],
                              cfg: ICPConfig) -> ICPResult:
    """ICP with a pluggable correspondence function.

    corr_fn(cur_pts (M, D)) -> (q (M, D), n (M, D) or None, gate (M,),
    d2 (M,)): a nearest-neighbour search or the projective lookup of RGB-D
    odometry (icp/projective.py). icp.method "point_to_plane" takes the
    Gauss-Newton step; every other method, "projective" included, takes
    the point-to-point Umeyama step, as in the reference. Like the
    reference's, this always runs the per-iteration steps path, and warns
    once when loop_backend="fused" reaches it.
    """
    if cfg.loop_backend == "fused":
        _warn_fused_ignored()
    d = src.dim
    dtype = src.points.dtype
    T0 = (torch.eye(d + 1, dtype=dtype, device=src.points.device)
          if init_T is None else init_T.to(dtype))
    use_prior = cfg.method == "point_to_plane" and (
        cfg.prior_trans_weight > 0.0 or cfg.prior_rot_weight > 0.0)
    T0_inv, prior_scale = _anchor(cfg, T0, use_prior)
    body = _body(cfg, src, corr_fn, T0, T0_inv, prior_scale)
    return _drive(cfg, body, T0, batched=False)


def align_batched(src: PointCloud, dst_points: torch.Tensor,
                  dst_mask: torch.Tensor, init_T: torch.Tensor,
                  cfg: ICPConfig) -> ICPResult:
    """Point-to-point ICP of one source against many (target, initial pose)
    pairs: dst_points (B/G, N, D), dst_mask (B/G, N), init_T (B, D+1, D+1);
    element b aligns src onto target b // G from init_T[b].

    The reference's vmap over `align` (backend/loop_closure.py::
    _batched_verify): all elements step until every one has stopped
    (converged or max_iters), and a stopped element is frozen with
    `torch.where`, so each element's result equals its own unbatched
    `align`. The NN runs once per iteration for the whole batch (K1's
    batched form on CUDA, at D = 2 or 3); "any still running" is read back
    once per iteration. Returns an ICPResult with a leading (B,) on every
    field; the loop ran max(iters) batched iterations.
    """
    if cfg.method != "point_to_point":
        raise NotImplementedError(
            "align_batched runs point_to_point (loop-closure verification)")
    d = src.dim
    batch, n = init_T.shape[0], dst_points.shape[1]
    group = batch // dst_points.shape[0]
    T0 = init_T.to(src.points.dtype)
    T0_inv, _ = _anchor(cfg, T0, prior=False)
    flat_dst = dst_points.reshape(-1, d)
    # row of element b's target in flat_dst, clamped like the reference's
    # gather (rescore's padded-target case; see _nn_correspondence)
    rows = torch.arange(batch, device=dst_points.device)
    base = (rows // group * n)[:, None]
    grids = ([_voxel_grid(cfg, p, m) for p, m in zip(dst_points, dst_mask)]
             if cfg.nn_backend == "voxel" else None)

    def corr(cur: torch.Tensor):
        if grids is not None:
            idx = torch.stack([voxel_nn.query(grids[b // group], cur[b],
                                              voxel=cfg.max_corr_dist)[0]
                               for b in range(batch)])
        else:
            # padded targets carry the sentinel, as in align
            idx, _ = nearest_neighbor(
                cur, dst_points, backend=cfg.nn_backend, chunk=cfg.nn_chunk,
                tile_m=cfg.nn_tile_m, tile_n=cfg.nn_tile_n,
                precision=cfg.nn_precision)
        q = flat_dst[base + torch.clamp(idx.long(), max=n - 1)]
        diff = cur - q
        d2 = torch.sum(diff * diff, dim=-1)
        return q, None, _gate(cfg, cur, d2), d2

    body = _body(cfg, src, corr, T0, T0_inv, None)
    return _drive(cfg, body, T0, batched=True)
