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
so that each element's result is its own `align`'s. Its trip reads nothing
back; on CUDA every trip after the first is one replay of a CUDA graph
(`_TripGraph`, its replays the span graph.verify_trip, obs/profile.py),
and the condition read is the trip's one host sync.
`StaticAlign` gives the unbatched loop the same form over static buffers,
for the frame graphs (slam/scan_to_map.FrameGraphs, slam/rgbd.
RGBDFrameGraphs, slam/pipeline.OdomFrameGraphs). `icp.anderson` (AA(1)
on twists) runs in each loop.

Every loop runs one in-place step on the carried state (`_step`, and
`_batched_step` for align_batched): the correspondence, then the rest of
the reference's compiled iteration. Its plain version is `gn_step_ref`
(the step after the correspondence, in torch) with the loops' freeze,
`trip_ref`. On CUDA two kernels replace it: K2S (`kernels.gn_step`) for a
3D point-to-plane iteration through K2's route with degen_eps 0
(`gn_step.routes`), one launch; K2P (`kernels.p2p_step`) for every
point-to-point (Umeyama) iteration, unbatched or batched, 2D or 3D, two
launches. Every other configuration, and every one on the CPU, runs
`trip_ref`.
"""

from __future__ import annotations

import collections
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
from tpu_icp_slam_torch.kernels import graphs, p2p_step, voxel_nn
from tpu_icp_slam_torch.kernels.gn_step import gn_step, routes
from tpu_icp_slam_torch.kernels.nn import nearest_neighbor
from tpu_icp_slam_torch.obs.profile import span


@dataclasses.dataclass(frozen=True)
class ICPResult:
    T: torch.Tensor  # (..., D+1, D+1) transform: dst_frame <- src_frame
    rmse: torch.Tensor  # inlier RMS correspondence distance at convergence
    iters: int | torch.Tensor  # iterations executed (a tensor from K5, from
    # the unrolled loop and from align_batched, one per element)
    n_inliers: torch.Tensor  # gated correspondences in the final iteration
    converged: torch.Tensor  # bool: tol reached before max_iters


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


def _nn_correspondence(cfg: ICPConfig, dst: PointCloud,
                       grid: Optional[voxel_nn.VoxelHashGrid] = None):
    """Returns corr(points) -> (q, n, gate, d2): NN into dst + distance gate.
    nn_backend="voxel" queries `grid`, or a grid built here from dst."""
    if cfg.nn_backend == "voxel" and grid is None:
        grid = _voxel_grid(cfg, dst.points, dst.mask)
    elif cfg.nn_backend != "voxel":
        grid = None
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
        # (int32 indices gather as they are: no int64 copy)
        idx = torch.clamp(idx, max=last)
        q = torch.index_select(dst.points, 0, idx)
        # the normals only where the step reads them (point-to-plane)
        n = (torch.index_select(dst.normals, 0, idx)
             if dst.normals is not None and cfg.method == "point_to_plane"
             else None)
        # difference-form distances for the gates and the rmse, as in the
        # reference (its NN returns the cancellation-prone factored form)
        diff = cur_pts - q
        d2 = torch.sum(diff * diff, dim=-1)
        return q, n, _gate(cfg, cur_pts, d2), d2

    return corr


def align(src: PointCloud, dst: PointCloud,
          init_T: Optional[torch.Tensor] = None,
          cfg: ICPConfig = ICPConfig()) -> ICPResult:
    """Align src onto dst: returns T such that T @ src ≈ dst."""
    return align_with_correspondence(src, _nn_correspondence(cfg, dst),
                                     init_T, cfg)


def _moved(points: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """points (M, D) moved by T (..., D+1, D+1) -> (..., M, D)."""
    d = points.shape[-1]
    return points @ T[..., :d, :d].transpose(-1, -2) + T[..., None, :d, d]


def lie(d: int):
    """The group module of d-dimensional rigid motions."""
    if d not in (2, 3):
        raise ValueError(f"unsupported point dimension {d}")
    return se3 if d == 3 else se2


def huber(cfg: ICPConfig, w: torch.Tensor, d2: torch.Tensor) -> torch.Tensor:
    if cfg.huber_delta > 0.0:
        dist = torch.sqrt(torch.clamp(d2, min=1e-20))
        w = w * torch.clamp(cfg.huber_delta / dist, max=1.0)
    return w


def project_total(cfg: ICPConfig, T_new: torch.Tensor, T0: torch.Tensor,
                  T0_inv: torch.Tensor) -> torch.Tensor:
    """Trust region: project the total correction log(T_new T0⁻¹) back onto
    the ball around T0 (batched over leading dims)."""
    d = T_new.shape[-1] - 1
    group = lie(d)
    xi_tot = group.log(T_new @ T0_inv)
    s = torch.ones(xi_tot.shape[:-1], dtype=T_new.dtype, device=T_new.device)
    if cfg.max_total_trans > 0.0:
        tn = torch.linalg.vector_norm(xi_tot[..., :d], dim=-1)
        s = torch.minimum(s, cfg.max_total_trans / torch.clamp(tn, min=1e-12))
    if cfg.max_total_rot > 0.0:
        rn = torch.linalg.vector_norm(xi_tot[..., d:], dim=-1)
        s = torch.minimum(s, cfg.max_total_rot / torch.clamp(rn, min=1e-12))
    return torch.where(s[..., None, None] < 1.0,
                       group.exp(s[..., None] * xi_tot) @ T0, T_new)


def step_converged(cfg: ICPConfig, prev_rmse, rmse, dT, eye_d):
    d = dT.shape[-1] - 1
    converged = torch.abs(prev_rmse - rmse) < cfg.tol
    if cfg.tol_update > 0.0:
        step_mag = torch.linalg.vector_norm(dT[..., :d, d], dim=-1) + \
            torch.linalg.matrix_norm(dT[..., :d, :d] - eye_d)
        converged = converged | (step_mag < cfg.tol_update)
    return converged


def freeze(stop: torch.Tensor, new: tuple, old: tuple) -> tuple:
    """new, but old where `stop` holds (stop batched over the leading
    dims)."""
    out = []
    for n, o in zip(new, old):
        s = stop.reshape(stop.shape + (1,) * (o.dim() - stop.dim()))
        out.append(torch.where(s, o, n))
    return tuple(out)


def gn_step_ref(cfg: ICPConfig, src_mask_f: torch.Tensor, cur: torch.Tensor,
                q: torch.Tensor, n: Optional[torch.Tensor],
                gate: torch.Tensor, d2: torch.Tensor, T: torch.Tensor,
                prev_rmse, it, f_prev, g_prev, T0: torch.Tensor,
                T0_inv: Optional[torch.Tensor],
                prior_scale: Optional[torch.Tensor],
                eye: Optional[torch.Tensor] = None) -> tuple:
    """One ICP iteration after the correspondence, batched over the leading
    dims of T: (cur, q, n, gate, d2) from corr_fn at the source moved by T
    -> (T_new, rmse, n_inliers, converged, f, g). `it` (an int, or a tensor
    of the batch's shape) only arms Anderson's first-iteration safeguard.
    `eye`, the (D+1, D+1) identity, may be made once by a caller that
    steps many times (a captured trip then makes no fill for it)."""
    d = cur.shape[-1]
    group = lie(d)
    if eye is None:
        eye = torch.eye(d + 1, dtype=cur.dtype, device=cur.device)
    min_inl = max(cfg.min_inliers, d + 1)
    w = huber(cfg, gate * src_mask_f, d2)
    n_inl = torch.sum(w > 0, dim=-1, dtype=torch.int32)
    if cfg.method == "point_to_plane":
        if n is None:
            raise ValueError("point_to_plane requires target normals")
        prior_w = xi_prior = None
        if prior_scale is not None:
            # motion prior anchored at T0, λ relative to the frame's own
            # point evidence (see the reference's loop.py)
            prior_w = torch.clamp(torch.sum(w), min=1e-6) * prior_scale
            xi_prior = group.log(T @ T0_inv)
        dT = gauss_newton_step(
            cur, q, n, w, damping=cfg.damping,
            max_step_trans=cfg.max_step_trans,
            max_step_rot=cfg.max_step_rot, backend=cfg.gn_backend,
            degen_eps=cfg.degen_eps, prior_w=prior_w, xi_prior=xi_prior)
    else:
        dT = umeyama_masked(cur, q, w)
    if cfg.step_scale != 1.0:
        dT = group.exp(cfg.step_scale * group.log(dT))
    # too few inliers: hold the pose (the motion-model init survives)
    dT = torch.where((n_inl >= min_inl)[..., None, None], dT, eye)
    T_new = dT @ T
    if cfg.anderson:
        # AA(1) on the fixed-point map T -> dT T in twist coordinates:
        # x = log T, g = log(dT T), f = g - x, x+ = g - γ (g - g_prev)
        # with γ = fᵀ(f - f_prev) / |f - f_prev|² clipped to [-1, 1];
        # the plain step on the first iteration or when |f| grew
        x = group.log(T)
        g = group.log(T_new)
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
        T_new = torch.where(use_aa[..., None, None], group.exp(x_aa), T_new)
        f_prev, g_prev = f, g
    if cfg.max_total_trans > 0.0 or cfg.max_total_rot > 0.0:
        T_new = project_total(cfg, T_new, T0, T0_inv)
    wsum = torch.clamp(torch.sum(w, dim=-1), min=1e-12)
    rmse = torch.sqrt(torch.sum(w * d2, dim=-1) / wsum)
    converged = step_converged(cfg, prev_rmse, rmse, dT, eye[:d, :d])
    return T_new, rmse, n_inl, converged, f_prev, g_prev


def trip_ref(cfg: ICPConfig, src_mask_f: torch.Tensor, cur: torch.Tensor,
             q: torch.Tensor, n: Optional[torch.Tensor], gate: torch.Tensor,
             d2: torch.Tensor, state: tuple, it: Optional[int],
             T0: torch.Tensor, T0_inv: Optional[torch.Tensor],
             prior_scale: Optional[torch.Tensor],
             unrolled: bool = False,
             eye: Optional[torch.Tensor] = None) -> None:
    """The plain trip, on any device and for every configuration, batched
    over the leading dims of the state: `gn_step_ref` and the loops'
    freeze, written into `state` in place (the arguments are
    kernels.gn_step.gn_step's, and gn_step_ref's `eye`). It is the plain
    version of K2S and K2P, and the trip wherever neither applies."""
    T, prev_rmse, _, converged, f_prev, g_prev, iters = state
    new = gn_step_ref(cfg, src_mask_f, cur, q, n, gate, d2, T, prev_rmse,
                      iters if it is None else it, f_prev, g_prev, T0,
                      T0_inv, prior_scale, eye)
    stop = converged | (iters >= cfg.max_iters) if unrolled else converged
    for buf, v in zip(state, (*freeze(stop, new, state[:6]),
                              iters + (~stop).to(torch.int32))):
        buf.copy_(v)


def _body(cfg: ICPConfig, src: PointCloud, corr_fn: Callable, T0, T0_inv,
          prior_scale):
    """One ICP iteration as a function of the carried state, batched over
    the leading dims of T: (T, prev_rmse, it, f_prev, g_prev) -> (T_new,
    rmse, n_inliers, converged, f, g), the correspondence at the moved
    source and then `gn_step_ref`. `it` (an int, or a tensor of the batch's
    shape) only arms Anderson's first-iteration safeguard."""
    dtype = src.points.dtype
    src_mask_f = src.mask.to(dtype)
    eye = torch.eye(src.dim + 1, dtype=dtype, device=src.points.device)

    def body(T, prev_rmse, it, f_prev, g_prev):
        cur = _moved(src.points, T)
        q, n, gate, d2 = corr_fn(cur)
        return gn_step_ref(cfg, src_mask_f, cur, q, n, gate, d2, T,
                           prev_rmse, it, f_prev, g_prev, T0, T0_inv,
                           prior_scale, eye)

    return body


def _step(cfg: ICPConfig, src: PointCloud, corr_fn: Callable, T0, T0_inv,
          prior_scale) -> Callable:
    """The unbatched iteration in place: step(state, it, unrolled=False)
    runs one trip of _body on _init_state's tuple, frozen as _batched_trip
    freezes it (or, unrolled, as _drive's unrolled form does), and counts
    the iteration. Where K2S computes the iteration (`gn_step.routes`: 3D
    point-to-plane through K2's route, degen_eps 0) that is one launch
    after the correspondence on CUDA, and where K2P does
    (`p2p_step.routes`: point-to-point) two; everywhere else, and on the
    CPU, the plain `trip_ref`."""
    dtype = src.points.dtype
    src_mask_f = src.mask.to(dtype)
    k2s = routes(cfg, src.dim)
    k2p = p2p_step.routes(cfg, src.dim)
    eye = torch.eye(src.dim + 1, dtype=dtype, device=src.points.device)

    def step(state: tuple, it: Optional[int], unrolled: bool = False):
        cur = _moved(src.points, state[0])
        q, n, gate, d2 = corr_fn(cur)
        if k2p:
            p2p_step.p2p_step(cfg, src_mask_f, cur, q, gate, d2, state, it,
                              T0, T0_inv, unrolled=unrolled)
            return
        if not k2s:
            trip_ref(cfg, src_mask_f, cur, q, n, gate, d2, state, it, T0,
                     T0_inv, prior_scale, unrolled=unrolled, eye=eye)
            return
        if n is None:
            raise ValueError("point_to_plane requires target normals")
        gn_step(cfg, src_mask_f, cur, q, n, gate, d2, state, it, T0, T0_inv,
                prior_scale, unrolled=unrolled)

    return step


def _init_state(T0: torch.Tensor) -> tuple:
    """The carried state before the first iteration: (T, prev_rmse,
    n_inliers, converged, f_prev, g_prev, iters), batched over T0's leading
    dims; the 1e6 f_prev sentinel is Anderson's mark of the first
    iteration."""
    dev, dtype = T0.device, T0.dtype
    bs = T0.shape[:-2]
    k = 6 if T0.shape[-1] == 4 else 3
    return (T0, torch.full(bs, float("inf"), dtype=dtype, device=dev),
            torch.zeros(bs, dtype=torch.int32, device=dev),
            torch.zeros(bs, dtype=torch.bool, device=dev),
            torch.full((*bs, k), 1e6, dtype=dtype, device=dev),
            torch.zeros((*bs, k), dtype=dtype, device=dev),
            torch.zeros(bs, dtype=torch.int32, device=dev))


def _batched_trip(step: Callable) -> Callable:
    """One iteration of a batch as a function, trip(state, it) -> state
    over _init_state's tuple: `step` (_batched_step's) run in place on a
    copy. The elements that have converged keep their state, the others
    step and count the iteration. `it` only arms Anderson's
    first-iteration safeguard: 0 on the first trip, a positive int after.
    The trip reads nothing back to the host."""
    def trip(state: tuple, it: int) -> tuple:
        new = tuple(t.clone() for t in state)
        step(new, it)
        return new

    return trip


def _drive(cfg: ICPConfig, step: Callable, T0: torch.Tensor) -> ICPResult:
    """Run an unbatched `step` (_step's) in place from T0 under the
    reference's stopping rule: the host loop (condition read back before
    each step) or, with unroll_iters > 0, the fixed-trip frozen form."""
    state = tuple(t.clone() for t in _init_state(T0))
    T, prev_rmse, n_inl, converged, _, _, iters = state
    if cfg.unroll_iters > 0:
        for _ in range(cfg.unroll_iters):
            step(state, None, unrolled=True)
        return ICPResult(T=T, rmse=prev_rmse, iters=iters, n_inliers=n_inl,
                         converged=converged)
    it = 0
    # cond before body, as lax.while_loop: `converged` is read on the host
    while it < cfg.max_iters and not (it > 0 and bool(converged)):
        step(state, it)
        it += 1
    return ICPResult(T=T, rmse=prev_rmse, iters=it, n_inliers=n_inl,
                     converged=converged)


def _drive_batched(cfg: ICPConfig, step: Callable,
                   T0: torch.Tensor) -> ICPResult:
    """Run a batched in-place `step` (_batched_step's) from T0 under the
    reference's stopping rule, until every element has stopped, each
    stopped element frozen: the host loop or, with unroll_iters > 0, the
    fixed-trip frozen form."""
    state = tuple(t.clone() for t in _init_state(T0))
    if cfg.unroll_iters > 0:
        for _ in range(cfg.unroll_iters):
            step(state, None, unrolled=True)
    else:
        it = 0
        while it < cfg.max_iters and not (it > 0 and bool(state[3].all())):
            step(state, it)
            it += 1
    T, prev_rmse, n_inl, converged, _, _, iters = state
    return ICPResult(T=T, rmse=prev_rmse, iters=iters, n_inliers=n_inl,
                     converged=converged)


def _anchor(cfg: ICPConfig, T0: torch.Tensor, prior: bool):
    """(T0⁻¹ or None, the prior's per-axis scale or None)."""
    d = T0.shape[-1] - 1
    trust_region = cfg.max_total_trans > 0.0 or cfg.max_total_rot > 0.0
    T0_inv = (torch.linalg.inv_ex(T0)[0] if (prior or trust_region)
              else None)
    if T0_inv is not None and T0_inv.is_cuda:
        # K2S reads T0⁻¹ row-major; the solver returns it column-major
        T0_inv = T0_inv.contiguous()
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
    return _drive(cfg, _step(cfg, src, corr_fn, T0, T0_inv, prior_scale), T0)


def eager_loop(cfg: ICPConfig) -> bool:
    """The ICP configurations whose iteration reads the host, and so runs
    `align_with_correspondence`'s eager loop, never a captured trip:
    degen_eps > 0 (torch.linalg.eigh checks its result on the host; sync
    debug mode "error" stops at point_to_plane.py's eigh). Every other
    configuration, each preset's and nn_backend="voxel" included, has a
    trip that reads nothing back."""
    return cfg.degen_eps > 0.0


class StaticAlign:
    """align_with_correspondence as align_batched runs it, over static
    buffers: the source `src` (points, and its mask as float weights, which
    _step reads in place) and whatever `corr_fn` closes over are the
    caller's tensors; T0 (I until `set_T0` writes it), T0⁻¹ (where _anchor
    makes one: a prior or a trust region) and the prior's scale are
    buffers made here, and `state` is _init_state's tuple, carried in
    place. A caller's stage that starts from another pose writes it with
    `set_T0` before `first()`; the scan-to-map frame keeps T0 = I. `first()`
    resets the state and runs trip 0 (it = 0, Anderson's first-iteration
    arm); `later()` runs one trip with it > 0. Neither reads the host:
    they are what a CUDA graph captures. `go_on(trips)` is the reference's
    while_loop condition, read once a trip (the span read.trip), as
    align_batched reads it; a trip is the eager loop's `_step` in place,
    so the result equals the eager loop's bit for bit. `unroll_iters > 0`
    runs its fixed trips inside `first()`. A caller that runs the ICP
    otherwise (K5, or the eager loop for `eager_loop`'s configurations)
    passes corr_fn None and keeps its result in `state` through
    `set_result`."""

    def __init__(self, cfg: ICPConfig, src: PointCloud, corr_fn: Callable):
        self.cfg = cfg
        self.src = src
        self.corr_fn = corr_fn
        dev, dtype = src.points.device, src.points.dtype
        self.T0 = torch.eye(src.dim + 1, dtype=dtype, device=dev)
        use_prior = cfg.method == "point_to_plane" and (
            cfg.prior_trans_weight > 0.0 or cfg.prior_rot_weight > 0.0)
        self.T0_inv, self.prior_scale = _anchor(cfg, self.T0, use_prior)
        self.step = (_step(cfg, src, corr_fn, self.T0, self.T0_inv,
                           self.prior_scale) if corr_fn is not None else None)
        self.state = tuple(t.clone() for t in _init_state(self.T0))

    def set_T0(self, T0: torch.Tensor) -> None:
        """T0 into its buffer and, where there is one, T0⁻¹ into its own,
        as align_with_correspondence's _anchor computes it."""
        self.T0.copy_(T0)
        if self.T0_inv is not None:
            self.T0_inv.copy_(torch.linalg.inv_ex(self.T0)[0])

    def first(self) -> None:
        if self.cfg.unroll_iters > 0:
            self.set_result(_drive(self.cfg, self.step, self.T0))
            return
        for buf, v in zip(self.state, _init_state(self.T0)):
            buf.copy_(v)
        if self.cfg.max_iters >= 1:
            self.step(self.state, 0)

    def later(self) -> None:
        self.step(self.state, 1)

    def go_on(self, trips: int) -> bool:
        if trips >= self.cfg.max_iters:
            return False
        with span("read.trip"):
            return not bool(self.state[3])

    def set_result(self, res: ICPResult) -> None:
        """An ICPResult into the state's T, rmse, n_inliers, converged and
        iters."""
        T, rmse, n_inl, conv, _, _, iters = self.state
        for buf, v in ((T, res.T), (rmse, res.rmse), (n_inl, res.n_inliers),
                       (conv, res.converged), (iters, res.iters)):
            buf.copy_(v) if isinstance(v, torch.Tensor) else buf.fill_(v)

    def result(self) -> ICPResult:
        """The state as an ICPResult (views of the static buffers)."""
        T, rmse, n_inl, conv, _, _, iters = self.state
        return ICPResult(T=T, rmse=rmse, iters=iters, n_inliers=n_inl,
                         converged=conv)


def _batched_correspondence(cfg: ICPConfig, dst_points: torch.Tensor,
                            dst_mask: torch.Tensor, batch: int) -> Callable:
    """corr(cur (B, M, D)) -> (q (B, M, D), gate, d2 (B, M)): element b's
    NN into target b // G of dst_points (B/G, N, D), once a trip for the
    whole batch (K1's batched form on CUDA, at D = 2 or 3), and the
    distance gate."""
    d, n = dst_points.shape[2], dst_points.shape[1]
    group = batch // dst_points.shape[0]
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
        return q, _gate(cfg, cur, d2), d2

    return corr


def _batched_step(cfg: ICPConfig, src: PointCloud, dst_points: torch.Tensor,
                  dst_mask: torch.Tensor, T0: torch.Tensor,
                  T0_inv: Optional[torch.Tensor]) -> Callable:
    """align_batched's iteration in place over these tensors,
    step(state, it, unrolled=False) on _init_state's batched tuple: element
    b of T0 (B, D+1, D+1) aligns src onto target b // G of dst_points
    (B/G, N, D). The correspondence (`_batched_correspondence`), then the
    rest of the iteration in K2P's batched form (two launches on CUDA, its
    plain version `trip_ref` on the CPU)."""
    src_mask_f = src.mask.to(src.points.dtype)
    corr = _batched_correspondence(cfg, dst_points, dst_mask, T0.shape[0])

    def step(state: tuple, it: Optional[int], unrolled: bool = False):
        cur = _moved(src.points, state[0])
        q, gate, d2 = corr(cur)
        p2p_step.p2p_step(cfg, src_mask_f, cur, q, gate, d2, state, it, T0,
                          T0_inv, unrolled=unrolled)

    return step


class _TripGraph:
    """align_batched's trip on CUDA, captured once as a CUDA graph over
    static buffers: the source cloud, the targets, T0 and T0⁻¹ (read by the
    trust region) and the carried state. `start` copies a call's inputs in
    and runs trip 0 eagerly (it = 0, Anderson's first-iteration arm). Each
    `step` runs a trip with it > 0 through `graphs.Graphed`: the first
    runs it eagerly and captures it, every later one replays it."""

    def __init__(self, cfg, batch, group, m, n, d, dtype, device):
        def buf(*shape, dtype=dtype):
            return torch.zeros(shape, dtype=dtype, device=device)

        # the mask as float weights: _batched_step casts src.mask once,
        # when it is built, and a float mask is its own cast, so the trip
        # reads this buffer and not a copy of its first contents
        self.src = PointCloud(points=buf(m, d), mask=buf(m))
        self.dst = buf(batch // group, n, d)
        self.T0 = buf(batch, d + 1, d + 1)
        trust = cfg.max_total_trans > 0.0 or cfg.max_total_rot > 0.0
        self.T0_inv = buf(batch, d + 1, d + 1) if trust else None
        self.state = tuple(t.clone() for t in _init_state(self.T0))
        self._step = _batched_step(cfg, self.src, self.dst, None, self.T0,
                                   self.T0_inv)
        self._later = graphs.Graphed(lambda: self._step(self.state, 1),
                                     device, "verify_trip")

    @property
    def graph(self) -> Optional[torch.cuda.CUDAGraph]:
        return self._later.graph

    def start(self, src: PointCloud, dst_points: torch.Tensor,
              T0: torch.Tensor, T0_inv: Optional[torch.Tensor]) -> None:
        self.src.points.copy_(src.points)
        self.src.mask.copy_(src.mask)
        self.dst.copy_(dst_points)
        self.T0.copy_(T0)
        if self.T0_inv is not None:
            self.T0_inv.copy_(T0_inv)
        for s, v in zip(self.state, _init_state(self.T0)):
            s.copy_(v)
        self._step(self.state, 0)

    def step(self) -> None:
        self._later()


GRAPH_CACHE = 8  # trip graphs kept, least recently used dropped first
_graphs: collections.OrderedDict = collections.OrderedDict()


def _trip_graph(*key) -> _TripGraph:
    """The trip graph of key = (cfg, B, G, M, N, D, dtype, device), made
    on first use and kept in a bounded cache (verification's B is
    candidates x yaws and varies)."""
    return graphs.cached(_graphs, GRAPH_CACHE, key, _TripGraph)


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
    batched form on CUDA, at D = 2 or 3), and on CUDA the rest of the
    iteration (weights, means, the centred covariance, the rigid fit, the
    step, the freeze) is K2P's batched form, two launches, in place on the
    carried state; "any still running" is read back once per iteration, the
    reference's
    while_loop condition. On CUDA every trip after the first is one replay
    of a CUDA graph (`_TripGraph`), so that read is the trip's only host
    sync; nn_backend="voxel" (one hash-grid query per row) and
    unroll_iters > 0 keep the eager loop, as the CPU does. Returns an
    ICPResult with a leading (B,) on every field; the loop ran max(iters)
    batched iterations.
    """
    if cfg.method != "point_to_point":
        raise NotImplementedError(
            "align_batched runs point_to_point (loop-closure verification)")
    T0 = init_T.to(src.points.dtype)
    T0_inv, _ = _anchor(cfg, T0, prior=False)
    if (T0.device.type != "cuda" or cfg.nn_backend == "voxel"
            or cfg.unroll_iters > 0 or cfg.max_iters < 1):
        step = _batched_step(cfg, src, dst_points, dst_mask, T0, T0_inv)
        return _drive_batched(cfg, step, T0)
    batch, (targets, n, d) = T0.shape[0], dst_points.shape
    graph = _trip_graph(cfg, batch, batch // targets, src.capacity, n, d,
                        T0.dtype, T0.device)
    graph.start(src, dst_points, T0, T0_inv)
    it = 1
    while it < cfg.max_iters and not bool(graph.state[3].all()):
        graph.step()
        it += 1
    T, rmse, n_inl, converged, _, _, iters = (t.clone() for t in graph.state)
    return ICPResult(T=T, rmse=rmse, iters=iters, n_inliers=n_inl,
                     converged=converged)
