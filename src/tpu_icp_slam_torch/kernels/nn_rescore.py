"""K4: the rescore nearest neighbour — a bf16 packed shortlist over the
dealt target, then an exact float32 rescore — CUDA kernel and plain version.

`nn_rescore(src, dst, tile_n=0)` is the port of
nn_bruteforce_pallas(precision="rescore") (tpu_icp_slam/kernels/
nn_pallas.py:214-373, groups = 1):

  - recentre both clouds on the bounding-box midpoint of the valid targets
    (nn_bf16.recentre) and pad the target to Np = S·TN rows with the 1e6
    sentinel (`slots`: the reference's tile rule);
  - slot j holds the targets whose original index is j mod S, in ascending
    order (the reference's deal-interleave); per source row and slot, the
    first minimum of the packed hi/lo bf16 score (K3's 13 exact products)
    is that slot's candidate;
  - the exact float32 difference-form d² of the S candidates picks the
    winner, first minimum IN SLOT ORDER: an exact tie goes to the lowest
    slot, not to the lowest index.

It returns (idx (M,) int32, d² (M,) float32); d² is already exact. idx
indexes the padded target, as the reference's does: a padded (sentinel)
source row may pick a padded target row >= N when N is not a multiple of
TN; a real source row never does. CUDA tensors launch csrc/nn_shortlist.cu
(shortlist kernel, then rescore kernel); CPU tensors run `nn_rescore_ref`,
which scores each slot with a float32 product of the same packed operands
and rescores with torch ops. The source tile size of the reference
(`tile_m`) does not change the result, so neither version takes it.
"""

from __future__ import annotations

import torch

from tpu_icp_slam_torch.kernels import _build
from tpu_icp_slam_torch.kernels.nn_bf16 import (
    pack_source,
    pack_target,
    packed_argmin_ref,
    recentre,
)

PAD = 1.0e6  # the reference pads the recentred target with this


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def slots(n: int, tile_n: int = 0) -> tuple[int, int]:
    """(TN, S) for an n-row target, as nn_pallas.py:220-230 sets them:
    TN defaults to 2048, is shrunk to max(128, round_up(ceil(n/8), 128)) so
    that about 8 slots cover the target — a given tile_n too, when larger —
    and capped at round_up(n, 128); S = round_up(n, TN) / TN."""
    tn = tile_n or 2048
    tn = min(tn, max(128, _round_up(-(-n // 8), 128)))
    tn = min(tn, _round_up(n, 128))
    return tn, _round_up(n, tn) // tn


def _prepare(src: torch.Tensor, dst: torch.Tensor, tile_n: int):
    """Recentred source, recentred target padded to S·TN rows, TN, S."""
    n = dst.shape[0]
    tn, s = slots(n, tile_n)
    sc, dc = recentre(src, dst)
    dp = torch.cat([dc, torch.full((s * tn - n, 3), PAD, dtype=dc.dtype,
                                   device=dc.device)])
    return sc, dp, tn, s


def nn_rescore_ref(src: torch.Tensor, dst: torch.Tensor, tile_n: int = 0,
                   chunk: int = 2048) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain torch: (M, 3), (N, 3) f32 -> (idx (M,) int32, d2 (M,) f32).
    Each slot's candidate is the first minimum of the float32 product of
    the packed operands; the winner the first minimum, in slot order, of
    d² = (dx² + dy²) + dz² in float32."""
    sc, dp, _, s = _prepare(src, dst, tile_n)
    a_aug, b_aug = pack_source(sc), pack_target(dp)
    cand = torch.stack([
        packed_argmin_ref(a_aug, b_aug[j::s], chunk=chunk)[0] * s + j
        for j in range(s)])  # (S, M) original indices
    diff = sc[None] - dp[cand.long()]  # (S, M, 3)
    d2 = (diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1]) \
        + diff[..., 2] * diff[..., 2]
    best, slot = torch.min(d2, dim=0)  # first minimum on ties
    return torch.gather(cand, 0, slot[None])[0], best


def nn_rescore(src: torch.Tensor, dst: torch.Tensor, tile_n: int = 0
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """(M, 3), (N, 3) f32 -> (idx (M,) int32, d2 (M,) f32): rescore-mode
    nearest neighbour (module docstring). CPU tensors take the plain
    version."""
    if src.device.type == "cpu" and dst.device.type == "cpu":
        return nn_rescore_ref(src, dst, tile_n)
    _build.require_points("nn_rescore", src=src, dst=dst)
    m = src.shape[0]
    sc, dp, tn, s = _prepare(src, dst, tile_n)
    a_aug, b_aug = pack_source(sc), pack_target(dp)
    lib = _build.load()
    cand = torch.empty((s, m), dtype=torch.int32, device=src.device)
    idx = torch.empty(m, dtype=torch.int32, device=src.device)
    d2 = torch.empty(m, dtype=torch.float32, device=src.device)
    stream = torch.cuda.current_stream(src.device).cuda_stream
    err = lib.nn_rescore_f32(
        a_aug.data_ptr(), b_aug.data_ptr(), sc.data_ptr(), dp.data_ptr(), m,
        s, tn, cand.data_ptr(), idx.data_ptr(), d2.data_ptr(), stream)
    _build.check(err, "nn_rescore_f32")
    nn_rescore.launches += 1
    return idx, d2


nn_rescore.launches = 0
