"""K2S: one point-to-plane ICP iteration after the correspondence — the
CUDA launch.

`gn_step` launches csrc/gn_step.cu for a 3D point-to-plane iteration with
gn_backend "auto" or "pallas" (`routes`; the reference runs that step
through K2, gn_pallas.py): the whole step in one launch, with H and g
summed as K2 sums them, writing the carried state (loop._init_state's
seven fields) in place, frozen as loop's trips freeze it. Its plain
version is the loop's own step, `icp.loop.trip_ref` (the torch step
around K2, `icp.loop.gn_step_ref`, and the freeze): CPU tensors take it,
so a loop over `gn_step` is the eager loop bit for bit. On CUDA a build or
launch failure raises: nothing falls back to the plain version.

A launch's scratch (a (30,) partial a block and the ticket that elects
the block that sums them) is allocated per device and reused: calls on one
stream never overlap, and the port runs on one stream. A CUDA graph that
captured a launch keeps writing through its pointers, so it is never
freed. `hg` (42 floats a device) receives each launch's H and g, for tests.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from tpu_icp_slam_torch.config import ICPConfig
from tpu_icp_slam_torch.kernels import _build

_SUMS = 30  # K2's 27, Σw, Σw·d², the inlier count


def routes(cfg: ICPConfig, d: int) -> bool:
    """The iterations K2S computes on CUDA: 3D point-to-plane where the
    reference accumulates through K2 (gn_backend "auto" or "pallas"),
    without the eigen-remap of degen_eps > 0 (whose eigh reads the host;
    icp.loop.eager_loop)."""
    return (d == 3 and cfg.method == "point_to_plane"
            and cfg.gn_backend in ("auto", "pallas") and cfg.degen_eps <= 0.0)


class _Params(ctypes.Structure):
    """csrc/gn_step.cu's StepParams, field by field."""

    _fields_ = [(name, ctypes.c_int) for name in (
        "min_inliers", "max_iters", "it", "unrolled", "anderson",
        "has_prior", "trust")] + [(name, ctypes.c_float) for name in (
            "huber", "damping", "step_scale", "max_step_trans",
            "max_step_rot", "max_total_trans", "max_total_rot", "tol",
            "tol_update")]


class _State(ctypes.Structure):
    """csrc/gn_step.cu's StepState: the seven fields' device addresses."""

    _fields_ = [(name, ctypes.c_void_p) for name in (
        "T", "rmse", "n_inl", "conv", "f", "g", "iters")]


_STATE = ((torch.float32, (4, 4)), (torch.float32, ()), (torch.int32, ()),
          (torch.bool, ()), (torch.float32, (6,)), (torch.float32, (6,)),
          (torch.int32, ()))

_scratch: dict[torch.device, tuple] = {}


def _device_scratch(device: torch.device) -> tuple:
    """(partials (2 * SMs, 30) float32, ticket (1,) int32 at 0, hg (42,)
    float32) of a CUDA device, made on its first call and kept."""
    have = _scratch.get(device)
    if have is None:
        have = (torch.empty((2 * _build.sm_count(device.index), _SUMS),
                            dtype=torch.float32, device=device),
                torch.zeros(1, dtype=torch.int32, device=device),
                torch.zeros(42, dtype=torch.float32, device=device))
        _scratch[device] = have
    return have


def last_hg(device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """H (6, 6) and g (6,) of the last unfrozen launch on `device` (views
    of the device's buffer, which the next launch overwrites)."""
    hg = _device_scratch(torch.device(device))[2]
    return hg[:36].view(6, 6), hg[36:]


def gn_step(cfg: ICPConfig, src_mask_f: torch.Tensor, cur: torch.Tensor,
            q: torch.Tensor, n: torch.Tensor, gate: torch.Tensor,
            d2: torch.Tensor, state: tuple, it: Optional[int],
            T0: torch.Tensor, T0_inv: Optional[torch.Tensor],
            prior_scale: Optional[torch.Tensor],
            unrolled: bool = False) -> None:
    """One iteration of an unbatched 3D point-to-plane ICP, in place on
    `state` (loop._init_state's tuple): cur, q, n (M, 3) and gate, d2,
    src_mask_f (M,) float32 as corr_fn and _body give them; T0 (4, 4);
    T0_inv where there is a prior or a trust region; prior_scale (6,) with a
    prior. Frozen where the state has converged (or, unrolled, has reached
    max_iters); else the step's (T, rmse, n_inliers, converged, f, g) and
    iters + 1. `it` arms Anderson's first-iteration safeguard (it > 0);
    None (the unrolled loop) reads it from iters. CPU tensors take the
    plain version."""
    if all(t.device.type == "cpu" for t in (cur, q, n, gate, d2, state[0])):
        from tpu_icp_slam_torch.icp.loop import trip_ref

        trip_ref(cfg, src_mask_f, cur, q, n, gate, d2, state, it, T0, T0_inv,
                 prior_scale, unrolled)
        return
    if not routes(cfg, cur.shape[-1]):
        raise ValueError("gn_step: K2S computes 3D point_to_plane at "
                         "gn_backend 'auto'/'pallas' with degen_eps 0")
    _build.require_points("gn_step", (3,), cur=cur, q=q, n=n)
    m = cur.shape[0]
    if q.shape[0] != m or n.shape[0] != m:
        raise ValueError(f"gn_step: q {tuple(q.shape)} and n "
                         f"{tuple(n.shape)} must have cur's {m} rows")
    for name, t in (("gate", gate), ("d2", d2), ("src_mask_f", src_mask_f)):
        if (t.device != cur.device or t.dtype != torch.float32
                or tuple(t.shape) != (m,) or not t.is_contiguous()):
            raise ValueError(f"gn_step: {name} must be contiguous float32 "
                             f"({m},) on {cur.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    for i, (t, (dtype, shape)) in enumerate(zip(state, _STATE)):
        if (t.device != cur.device or t.dtype != dtype
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(f"gn_step: state field {i} must be contiguous "
                             f"{dtype} {shape} on {cur.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    trust = cfg.max_total_trans > 0.0 or cfg.max_total_rot > 0.0
    anchors = [("T0", T0, (4, 4), trust), ("T0_inv", T0_inv, (4, 4),
               trust or prior_scale is not None),
               ("prior_scale", prior_scale, (6,), prior_scale is not None)]
    for name, t, shape, needed in anchors:
        if needed and (t is None or t.device != cur.device
                       or t.dtype != torch.float32
                       or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(f"gn_step: {name} must be contiguous float32 "
                             f"{shape} on {cur.device}")
    params = _Params(
        min_inliers=max(cfg.min_inliers, 4), max_iters=cfg.max_iters,
        it=-1 if it is None else int(it), unrolled=int(unrolled),
        anderson=int(cfg.anderson), has_prior=int(prior_scale is not None),
        trust=int(trust), huber=cfg.huber_delta, damping=cfg.damping,
        step_scale=cfg.step_scale, max_step_trans=cfg.max_step_trans,
        max_step_rot=cfg.max_step_rot, max_total_trans=cfg.max_total_trans,
        max_total_rot=cfg.max_total_rot, tol=cfg.tol,
        tol_update=cfg.tol_update)
    st = _State(*(t.data_ptr() for t in state))
    partial, ticket, hg = _device_scratch(cur.device)
    n_blocks = max(1, min(-(-m // 256), partial.shape[0]))
    err = _build.load().gn_step_f32(
        cur.data_ptr(), q.data_ptr(), n.data_ptr(), gate.data_ptr(),
        d2.data_ptr(), src_mask_f.data_ptr(), m, ctypes.addressof(params),
        ctypes.addressof(st), T0.data_ptr(),
        T0_inv.data_ptr() if T0_inv is not None else None,
        prior_scale.data_ptr() if prior_scale is not None else None,
        n_blocks, partial.data_ptr(), ticket.data_ptr(), hg.data_ptr(),
        torch.cuda.current_stream(cur.device).cuda_stream)
    _build.check(err, "gn_step_f32")
    gn_step.launches += 1


gn_step.launches = 0  # every launch
