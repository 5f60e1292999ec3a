"""K2P: one point-to-point ICP iteration after the correspondence — the
CUDA launch.

`p2p_step` launches csrc/p2p_step.cu for an iteration of a Umeyama method
(every ICP method but point_to_plane; `routes`), in SE(2) or SE(3),
unbatched (the loops of `icp/loop.py`: 2D and 3D scan-to-scan, Slam2D's
z = 0 lift) or batched over a leading axis (align_batched, loop-closure
verification): the Huber weights, the inlier count, the weighted means and
the centred cross-covariance, RF's rigid fit, over-relaxation, the
min_inliers hold, AA(1), the trust region, the rmse and the convergence
test, writing the carried state (loop._init_state's seven fields) in
place, frozen as the loops freeze it. Two launches, no host read. Its
plain version is the loop's own step, `icp.loop.trip_ref` (the torch
step around `umeyama_masked` and RF, and the freeze): CPU tensors take it.
On CUDA a build or launch failure raises: nothing falls back to the plain
version.

A launch's scratch (a (9,) partial a block and a ticket an element, and an
element's stats row) is allocated per device and reused: calls on one
stream never overlap, and the port runs on one stream. A CUDA graph that
captured a launch keeps writing through its pointers, so a buffer outgrown
by a larger batch is kept, never freed.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from tpu_icp_slam_torch.config import ICPConfig
from tpu_icp_slam_torch.kernels import _build

_PARTIAL = 9  # the widest pass: D² centred sums (2D + 3 <= 9 in the first)
_STATS = 20  # csrc/p2p_step.cu's kStats

_scratch: dict[torch.device, tuple] = {}
_outgrown: list = []  # scratch a captured graph may still use: never freed


def routes(cfg: ICPConfig, d: int) -> bool:
    """The iterations K2P computes on CUDA: every method that takes the
    point-to-point Umeyama step (all but point_to_plane), at D = 2 or 3."""
    return cfg.method != "point_to_plane" and d in (2, 3)


class _Params(ctypes.Structure):
    """csrc/p2p_step.cu's P2PParams, field by field."""

    _fields_ = [(name, ctypes.c_int) for name in (
        "min_inliers", "max_iters", "it", "unrolled", "anderson",
        "trust")] + [(name, ctypes.c_float) for name in (
            "huber", "step_scale", "max_total_trans", "max_total_rot", "tol",
            "tol_update")]


class _State(ctypes.Structure):
    """csrc/p2p_step.cu's P2PState: the seven fields' device addresses."""

    _fields_ = [(name, ctypes.c_void_p) for name in (
        "T", "rmse", "n_inl", "conv", "f", "g", "iters")]


def _device_scratch(device: torch.device, batch: int, n_blocks: int
                    ) -> tuple:
    """(partial float32, ticket int32 at 0, stats float32) of a CUDA
    device for at least `batch` elements of `n_blocks` blocks, made on
    first use and remade larger when a call needs more."""
    have = _scratch.get(device)
    if (have is None or have[1].numel() < batch
            or have[0].numel() < batch * n_blocks * _PARTIAL):
        if have is not None:
            _outgrown.append(have)
        cap = max(batch, 64)
        blocks = max(n_blocks, 2 * _build.sm_count(device.index))
        have = (torch.empty(cap * blocks * _PARTIAL, dtype=torch.float32,
                            device=device),
                torch.zeros(cap, dtype=torch.int32, device=device),
                torch.zeros((cap, _STATS), dtype=torch.float32,
                            device=device))
        _scratch[device] = have
    return have


def _require(name: str, t: Optional[torch.Tensor], dtype: torch.dtype,
             shape: tuple, device: torch.device) -> None:
    if (t is None or t.device != device or t.dtype != dtype
            or tuple(t.shape) != shape or not t.is_contiguous()):
        got = (None if t is None
               else f"{t.dtype} {tuple(t.shape)} on {t.device}")
        raise ValueError(f"p2p_step: {name} must be contiguous {dtype} "
                         f"{shape} on {device}, got {got}")


def p2p_step(cfg: ICPConfig, src_mask_f: torch.Tensor, cur: torch.Tensor,
             q: torch.Tensor, gate: torch.Tensor, d2: torch.Tensor,
             state: tuple, it: Optional[int], T0: torch.Tensor,
             T0_inv: Optional[torch.Tensor], unrolled: bool = False) -> None:
    """One point-to-point ICP iteration in place on `state`
    (loop._init_state's tuple), unbatched or over a leading batch axis:
    cur, q ([B,] M, D) and gate, d2 ([B,] M) as the correspondence gives
    them, src_mask_f (M,) float32; T0 ([B,] D+1, D+1) and T0_inv where
    there is a trust region. Frozen where an element has converged (or,
    unrolled, has reached max_iters); else its step's (T, rmse, n_inliers,
    converged, f, g) and iters + 1. `it` arms Anderson's first-iteration
    safeguard (it > 0); None (the unrolled loops) reads it from iters. CPU
    tensors take the plain version, `icp.loop.trip_ref`."""
    if all(t.device.type == "cpu" for t in (cur, q, gate, d2, state[0])):
        from tpu_icp_slam_torch.icp.loop import trip_ref

        trip_ref(cfg, src_mask_f, cur, q, None, gate, d2, state, it, T0,
                 T0_inv, None, unrolled)
        return
    d = cur.shape[-1]
    if not routes(cfg, d):
        raise ValueError("p2p_step: K2P computes the point-to-point step "
                         "(any method but point_to_plane) at D = 2 or 3")
    lead = tuple(cur.shape[:-2])
    if cur.dim() not in (2, 3):
        raise ValueError(f"p2p_step: cur must be ([B,] M, D), got "
                         f"{tuple(cur.shape)}")
    batch, m, dev = (lead[0] if lead else 1), cur.shape[-2], cur.device
    if dev.type != "cuda" or m == 0:
        raise ValueError(f"p2p_step: cur must be a non-empty CUDA tensor, "
                         f"got {tuple(cur.shape)} on {dev}")
    k, e = (6, 4) if d == 3 else (3, 3)
    for name, t, dtype, shape in (
            ("cur", cur, torch.float32, (*lead, m, d)),
            ("q", q, torch.float32, (*lead, m, d)),
            ("gate", gate, torch.float32, (*lead, m)),
            ("d2", d2, torch.float32, (*lead, m)),
            ("src_mask_f", src_mask_f, torch.float32, (m,))):
        _require(name, t, dtype, shape, dev)
    for i, (t, (dtype, shape)) in enumerate(zip(state, (
            (torch.float32, (e, e)), (torch.float32, ()),
            (torch.int32, ()), (torch.bool, ()), (torch.float32, (k,)),
            (torch.float32, (k,)), (torch.int32, ())))):
        _require(f"state field {i}", t, dtype, (*lead, *shape), dev)
    trust = cfg.max_total_trans > 0.0 or cfg.max_total_rot > 0.0
    if trust:
        _require("T0", T0, torch.float32, (*lead, e, e), dev)
        _require("T0_inv", T0_inv, torch.float32, (*lead, e, e), dev)
    if batch > 65535:
        raise ValueError(f"p2p_step: batch {batch} > 65535")
    params = _Params(
        min_inliers=max(cfg.min_inliers, d + 1), max_iters=cfg.max_iters,
        it=-1 if it is None else int(it), unrolled=int(unrolled),
        anderson=int(cfg.anderson), trust=int(trust),
        huber=cfg.huber_delta, step_scale=cfg.step_scale,
        max_total_trans=cfg.max_total_trans,
        max_total_rot=cfg.max_total_rot, tol=cfg.tol,
        tol_update=cfg.tol_update)
    st = _State(*(t.data_ptr() for t in state))
    # about two blocks an SM over the whole batch, none idle
    n_blocks = max(1, min(-(-m // 256),
                          -(-2 * _build.sm_count(dev.index) // batch)))
    partial, ticket, stats = _device_scratch(dev, batch, n_blocks)
    err = _build.load().p2p_step_f32(
        cur.data_ptr(), q.data_ptr(), gate.data_ptr(), d2.data_ptr(),
        src_mask_f.data_ptr(), m, d, batch, ctypes.addressof(params),
        ctypes.addressof(st), T0.data_ptr() if trust else None,
        T0_inv.data_ptr() if trust else None, n_blocks, partial.data_ptr(),
        ticket.data_ptr(), stats.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "p2p_step_f32")
    p2p_step.launches += 1


p2p_step.launches = 0  # every call (two kernel launches)
