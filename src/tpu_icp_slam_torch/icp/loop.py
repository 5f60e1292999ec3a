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
(`_TripGraph`), and the condition read is the trip's one host sync.
`StaticAlign` gives the unbatched loop the same form over static buffers,
for the frame graphs (slam/scan_to_map.FrameGraphs, slam/rgbd.
RGBDFrameGraphs, slam/pipeline.OdomFrameGraphs). `icp.anderson` (AA(1)
on twists) runs in each loop. The point-to-point step's rigid fit is RF on
CUDA (no host read either).

The unbatched loops (the host loop, the unrolled form and StaticAlign's
trips) run one in-place step, `_step`, on the carried state. For the 3D
point-to-plane iteration (gn_backend "auto" or "pallas", degen_eps 0:
`kernels.gn_step.routes`) it is the reference's compiled step: after the
correspondence, one K2S launch on CUDA (`kernels.gn_step.gn_step`) does
the rest of the iteration and writes the state. Every other
configuration, and every one on the CPU, runs the plain version
(`gn_step.trip_ref`), which align_batched's body runs too.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import logging
from typing import Callable, Optional

import torch

from tpu_icp_slam_torch.config import ICPConfig
from tpu_icp_slam_torch.core.pointcloud import PointCloud
from tpu_icp_slam_torch.kernels import graphs, voxel_nn
from tpu_icp_slam_torch.kernels.gn_step import (
    freeze,
    gn_step,
    gn_step_ref,
    routes,
    trip_ref,
)
from tpu_icp_slam_torch.kernels.nn import nearest_neighbor


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
        idx = torch.clamp(idx.long(), max=last)
        q = dst.points[idx]
        n = dst.normals[idx] if dst.normals is not None else None
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
    after the correspondence on CUDA; everywhere else, and on the CPU, the
    plain `trip_ref`."""
    dtype = src.points.dtype
    src_mask_f = src.mask.to(dtype)
    k2s = routes(cfg, src.dim)
    eye = torch.eye(src.dim + 1, dtype=dtype, device=src.points.device)

    def step(state: tuple, it: Optional[int], unrolled: bool = False):
        cur = _moved(src.points, state[0])
        q, n, gate, d2 = corr_fn(cur)
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


def _batched_trip(body: Callable) -> Callable:
    """One iteration of a batch as trip(state, it) -> state over
    _init_state's tuple: the elements that have converged keep their state,
    the others step and count the iteration. `it` only arms Anderson's
    first-iteration safeguard: 0 on the first trip, a positive int after.
    The trip reads nothing back to the host: on CUDA it is what
    align_batched captures as a graph."""
    def trip(state: tuple, it: int) -> tuple:
        T, prev_rmse, _, converged, f_prev, g_prev, iters = state
        new = body(T, prev_rmse, it, f_prev, g_prev)
        return (*freeze(converged, new, state[:6]),
                iters + (~converged).to(torch.int32))

    return trip


def _run_trips(cfg: ICPConfig, trip: Callable, state: tuple) -> tuple:
    """trip from state under the reference's while_loop condition, read
    on the host before every trip after the first: go on while it <
    max_iters and some element has not converged."""
    it = 0
    while it < cfg.max_iters and not (it > 0 and bool(state[3].all())):
        state = trip(state, it)
        it += 1
    return state


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


def _drive_batched(cfg: ICPConfig, body: Callable,
                   T0: torch.Tensor) -> ICPResult:
    """Run a batched `body` from T0 under the reference's stopping rule,
    until every element has stopped, each stopped element frozen: the host
    loop or, with unroll_iters > 0, the fixed-trip frozen form."""
    state = _init_state(T0)
    if cfg.unroll_iters > 0:
        T, prev_rmse, n_inl, converged, f_prev, g_prev, iters = state
        for _ in range(cfg.unroll_iters):
            stop = converged | (iters >= cfg.max_iters)
            T, prev_rmse, n_inl, converged, f_prev, g_prev = freeze(
                stop, body(T, prev_rmse, iters, f_prev, g_prev),
                (T, prev_rmse, n_inl, converged, f_prev, g_prev))
            iters = iters + (~stop).to(torch.int32)
        return ICPResult(T=T, rmse=prev_rmse, iters=iters, n_inliers=n_inl,
                         converged=converged)
    T, prev_rmse, n_inl, converged, _, _, iters = _run_trips(
        cfg, _batched_trip(body), state)
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
    while_loop condition, read once a trip, as align_batched reads it; a
    trip is the eager loop's `_step` in place, so the result equals the
    eager loop's bit for bit. `unroll_iters > 0` runs its fixed trips
    inside `first()`. A caller that runs the ICP otherwise (K5,
    or the eager loop for `eager_loop`'s configurations) passes corr_fn
    None and keeps its result in `state` through `set_result`."""

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
        return trips < self.cfg.max_iters and not bool(self.state[3])

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


def _batched_body(cfg: ICPConfig, src: PointCloud, dst_points: torch.Tensor,
                  dst_mask: torch.Tensor, T0: torch.Tensor,
                  T0_inv: Optional[torch.Tensor]) -> Callable:
    """align_batched's body over these tensors: element b of T0 (B, D+1,
    D+1) aligns src onto target b // G of dst_points (B/G, N, D). The NN
    runs once a trip for the whole batch (K1's batched form on CUDA, at
    D = 2 or 3)."""
    d = src.dim
    batch, n = T0.shape[0], dst_points.shape[1]
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
        return q, None, _gate(cfg, cur, d2), d2

    return _body(cfg, src, corr, T0, T0_inv, None)


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

        # the mask as float weights: _body casts src.mask once, when it is
        # built, and a float mask is its own cast, so the trip reads this
        # buffer and not a copy of its first contents
        self.src = PointCloud(points=buf(m, d), mask=buf(m))
        self.dst = buf(batch // group, n, d)
        self.T0 = buf(batch, d + 1, d + 1)
        trust = cfg.max_total_trans > 0.0 or cfg.max_total_rot > 0.0
        self.T0_inv = buf(batch, d + 1, d + 1) if trust else None
        self.state = tuple(t.clone() for t in _init_state(self.T0))
        self.trip = _batched_trip(_batched_body(
            cfg, self.src, self.dst, None, self.T0, self.T0_inv))
        self._later = graphs.Graphed(
            lambda: self._commit(self.trip(self.state, 1)), device)

    @property
    def graph(self) -> Optional[torch.cuda.CUDAGraph]:
        return self._later.graph

    def _commit(self, new: tuple) -> None:
        for s, v in zip(self.state, new):
            s.copy_(v)

    def start(self, src: PointCloud, dst_points: torch.Tensor,
              T0: torch.Tensor, T0_inv: Optional[torch.Tensor]) -> None:
        self.src.points.copy_(src.points)
        self.src.mask.copy_(src.mask)
        self.dst.copy_(dst_points)
        self.T0.copy_(T0)
        if self.T0_inv is not None:
            self.T0_inv.copy_(T0_inv)
        self._commit(_init_state(self.T0))
        self._commit(self.trip(self.state, 0))

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
    batched form on CUDA, at D = 2 or 3) and the rigid fit is one RF launch;
    "any still running" is read back once per iteration, the reference's
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
        body = _batched_body(cfg, src, dst_points, dst_mask, T0, T0_inv)
        return _drive_batched(cfg, body, T0)
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
