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
TN; a real source row never does. The source tile size of the reference
(`tile_m`) does not change the result, so neither version takes it.

CUDA tensors launch csrc/nn_shortlist.cu: the recentring and packing on the
device (two launches, bit-equal to `_prepare`, `pack_source` and
`pack_target`; csrc/packed_prep.cuh, shared with K3), the shortlist on the
tensor cores (csrc/packed_scan.cuh, K3's scan over the slots) and the
rescore. Its scores follow the tensor core's float32 rounding, so a
candidate may differ from the plain version's on a near-tie of one slot
(packed_mma.near_ties). CPU tensors run `nn_rescore_ref`: `shortlist_ref`
scores each slot with a float32 product of the same packed operands, and the
candidates are rescored with torch ops.

Batched form, the reference's vmap of the same kernel in the sharded align:
src (B, M, 3) and dst (B/G, N, 3), row b against target b // G, each target
recentred on its own valid rows and padded to the same slots (they depend
on N only). On CUDA tensors it is the same four launches whatever B is, and
row b is bit-equal to the unbatched call on (src[b], dst[b // G]); the
plain version computes each row as its unbatched call does.
"""

from __future__ import annotations

import torch

from tpu_icp_slam_torch.kernels import _build
from tpu_icp_slam_torch.kernels.nn_bf16 import (
    pack_source,
    pack_target,
    packed_argmin_ref,
    recentre,
    scan_grid,
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
    """Recentred source, recentred target padded to S·TN rows, TN, S;
    batched, every target on its own (recentre) and padded alike."""
    n = dst.shape[-2]
    tn, s = slots(n, tile_n)
    sc, dc = recentre(src, dst)
    dp = torch.cat([dc, torch.full((*dc.shape[:-2], s * tn - n, 3), PAD,
                                   dtype=dc.dtype, device=dc.device)], dim=-2)
    return sc, dp, tn, s


def _candidates(a_aug: torch.Tensor, b_aug: torch.Tensor, s: int,
                chunk: int) -> torch.Tensor:
    """(S, M) int32: each slot's first minimum of the packed score."""
    return torch.stack([
        packed_argmin_ref(a_aug, b_aug[j::s], chunk=chunk)[0] * s + j
        for j in range(s)])


def shortlist_ref(src: torch.Tensor, dst: torch.Tensor, tile_n: int = 0,
                  chunk: int = 2048) -> dict[str, torch.Tensor]:
    """Plain torch: the recentred source `sc` and padded target `dp`, their
    packed rows `a_aug` and `b_aug`, and `cand` (S, M) int32, each slot's
    candidate (an original index into dp): the first minimum of the float32
    product of the packed operands over the slot's rows j, j + S, ...
    Batched (B, M, 3), (B/G, N, 3): sc, a_aug and cand (B, S, M) a row, dp
    and b_aug a target, row b against target b // G."""
    sc, dp, _, s = _prepare(src, dst, tile_n)
    a_aug, b_aug = pack_source(sc), pack_target(dp)
    if src.dim() == 2:
        cand = _candidates(a_aug, b_aug, s, chunk)
    else:
        group = src.shape[0] // dst.shape[0]
        cand = torch.stack([_candidates(a, b_aug[b // group], s, chunk)
                            for b, a in enumerate(a_aug)])
    return {"sc": sc, "dp": dp, "a_aug": a_aug, "b_aug": b_aug, "cand": cand}


def rescore_ref(sc: torch.Tensor, dp: torch.Tensor, cand: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """The winner among the candidates (S, M): the first minimum, in slot
    order, of d² = (dx² + dy²) + dz² in float32 -> (idx, d2); batched
    (B, M, 3), (B/G, Np, 3), (B, S, M) -> (B, M), row by row."""
    if sc.dim() == 3:
        group = sc.shape[0] // dp.shape[0]
        out = [rescore_ref(x, dp[b // group], cand[b])
               for b, x in enumerate(sc)]
        return (torch.stack([o[0] for o in out]),
                torch.stack([o[1] for o in out]))
    diff = sc[None] - dp[cand.long()]  # (S, M, 3)
    d2 = (diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1]) \
        + diff[..., 2] * diff[..., 2]
    best, slot = torch.min(d2, dim=0)  # first minimum on ties
    return torch.gather(cand, 0, slot[None])[0], best


def nn_rescore_ref(src: torch.Tensor, dst: torch.Tensor, tile_n: int = 0,
                   chunk: int = 2048) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain torch: (M, 3), (N, 3) f32 -> (idx (M,) int32, d2 (M,) f32),
    the rescore of `shortlist_ref`'s candidates; batched (B, M, 3),
    (B/G, N, 3) -> (B, M), each row what its unbatched call gives."""
    sl = shortlist_ref(src, dst, tile_n, chunk)
    return rescore_ref(sl["sc"], sl["dp"], sl["cand"])


# K4's scratch, carved from one device buffer: name -> (dtype, shape), the
# shape in m (source rows), np (padded target rows) and s (slots).
_SCRATCH = {"centre": (torch.float32, (3,)), "sc": (torch.float32, ("m", 3)),
            "dp": (torch.float32, ("np", 3)),
            "a_aug": (torch.bfloat16, ("m", 16)),
            "b_aug": (torch.bfloat16, ("np", 16)),
            "cand": (torch.int32, ("s", "m"))}


def _workspace(m: int, np_: int, s: int, device: torch.device,
               batch: tuple[int, int] | None = None):
    """The scratch buffer and its layout, name -> (byte offset, dtype,
    shape), each array 256-byte aligned. batch = (B, B/G) gives every array
    a leading axis: B/G for the centre, dp and b_aug, B for the rest."""
    dims = {"m": m, "np": np_, "s": s}
    if batch is None:
        return _build.workspace(_SCRATCH, dims, device)
    spec = _build.batched(_SCRATCH, ("centre", "dp", "b_aug"))
    return _build.workspace(spec, {**dims, "b": batch[0], "t": batch[1]},
                            device)


def _launch(src, dst, tile_n, keep):
    if src.dim() == 3:
        _build.require_batched_points("nn_rescore", src, dst)
        batch, targets = src.shape[0], dst.shape[0]
    else:
        _build.require_points("nn_rescore", src=src, dst=dst)
        batch, targets = 1, 1
    lead = tuple(src.shape[:-2])
    m, n = src.shape[-2], dst.shape[-2]
    tn, s = slots(n, tile_n)
    ws, layout = _workspace(m, s * tn, s, src.device,
                            (batch, targets) if lead else None)
    ptr = _build.pointers(ws, layout)
    idx = torch.empty((*lead, m), dtype=torch.int32, device=src.device)
    d2 = torch.empty((*lead, m), dtype=torch.float32, device=src.device)
    scores = (torch.empty((*lead, s, m), dtype=torch.float32,
                          device=src.device) if keep else None)
    grid = scan_grid(m, s, src.device.index, batch)
    err = _build.load().nn_rescore_batched_f32(
        src.data_ptr(), dst.data_ptr(), m, n, batch, batch // targets, s, tn,
        grid, ptr["centre"], ptr["sc"], ptr["dp"], ptr["a_aug"],
        ptr["b_aug"], ptr["cand"],
        None if scores is None else scores.data_ptr(), idx.data_ptr(),
        d2.data_ptr(), torch.cuda.current_stream(src.device).cuda_stream)
    _build.check(err, "nn_rescore_batched_f32")
    nn_rescore.launches += 1
    nn_rescore.batched_launches += bool(lead)
    if not keep:
        return idx, d2
    return {"idx": idx, "d2": d2, "cand_score": scores,
            **_build.views(ws, layout)}


def nn_rescore(src: torch.Tensor, dst: torch.Tensor, tile_n: int = 0
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """(M, 3), (N, 3) f32 -> (idx (M,) int32, d2 (M,) f32): rescore-mode
    nearest neighbour (module docstring); batched (B, M, 3), (B/G, N, 3) ->
    (B, M), one call of four launches whatever B is. CPU tensors take the
    plain version."""
    if src.device.type == "cpu" and dst.device.type == "cpu":
        return nn_rescore_ref(src, dst, tile_n)
    return _launch(src, dst, tile_n, keep=False)


def nn_rescore_detail(src: torch.Tensor, dst: torch.Tensor, tile_n: int = 0
                      ) -> dict[str, torch.Tensor]:
    """CUDA only: one call of K4 that also keeps what it computed on the
    way: idx, d2, the packed operands and recentred points (as
    `shortlist_ref` names them), the centre, cand (S, M) and the tensor
    cores' score of each candidate, cand_score (S, M); each with a leading
    batch axis (the targets' for centre, dp and b_aug) when the call is
    batched."""
    return _launch(src, dst, tile_n, keep=True)


nn_rescore.launches = 0  # every call (four kernels)
nn_rescore.batched_launches = 0  # calls of the batched form
