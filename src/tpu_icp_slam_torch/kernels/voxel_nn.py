"""Voxel-bucket nearest neighbour, `icp.nn_backend="voxel"` (port of
tpu_icp_slam/kernels/voxel_nn.py).

The reference's hash grid is XLA ops, not a Pallas kernel, and so this is
torch ops: quantize the target points to voxels, hash the voxel ids into a
power-of-two table of fixed-size buckets (one stable sort, one
searchsorted, one scatter), then answer each query from the 3^D neighbour
buckets (one gather and a small dense distance block).

The reference's contract holds: exact whenever the true nearest neighbour
lies within one voxel ring (always, when the correspondence gate is at most
the voxel) and its bucket did not overflow; overflowing points are dropped;
a query with no candidate gets index 0 and d2 = +inf, which the distance
gate rejects. Built once per align, queried every iteration.

The hash is computed in int64 and masked to the table: its low bits are
those of the reference's wrapping int32 products and XORs. Coordinates are
divided by the voxel as a tensor, so that CUDA divides in float32 and does
not multiply by a rounded reciprocal (which could move a point across a
voxel face).
"""

from __future__ import annotations

import dataclasses

import torch

# three large primes for the spatial hash (Teschner et al.)
_P1, _P2, _P3 = 73856093, 19349669, 83492791


@dataclasses.dataclass(frozen=True)
class VoxelHashGrid:
    table: torch.Tensor  # (H, B) int32 indices into points; -1 = empty
    points: torch.Tensor  # (N, D) the target cloud (padded slots = sentinel)


def _hash(q: torch.Tensor, table_size: int) -> torch.Tensor:
    """(..., D) integer voxel coords (D = 2 or 3) -> (...) slot in
    [0, table_size), table_size a power of two."""
    q = q.to(torch.int64)
    h = (q[..., 0] * _P1) ^ (q[..., 1] * _P2)
    if q.shape[-1] >= 3:
        h = h ^ (q[..., 2] * _P3)
    return (h & (table_size - 1)).to(torch.int32)


def _voxel_coords(points: torch.Tensor, voxel: float) -> torch.Tensor:
    v = torch.full((), voxel, dtype=points.dtype, device=points.device)
    return torch.floor(points / v).to(torch.int32)


def build(points: torch.Tensor, mask: torch.Tensor, voxel: float,
          table_size: int = 1 << 14, bucket: int = 16) -> VoxelHashGrid:
    """Bucket the valid target points by hashed voxel id."""
    n = points.shape[0]
    slot = torch.where(mask, _hash(_voxel_coords(points, voxel), table_size),
                       table_size)  # invalid rows fall off the table
    order = torch.sort(slot, stable=True).indices
    slot_s = slot[order]
    # position within each equal-slot run
    first = torch.searchsorted(slot_s, slot_s, side="left")
    pos = torch.arange(n, device=points.device) - first
    # overflow (pos >= bucket) and invalid (slot == table_size) rows land in
    # the extra row and column, which are cut off
    col = torch.clamp(pos, max=bucket)
    table = torch.full((table_size + 1, bucket + 1), -1, dtype=torch.int32,
                       device=points.device)
    table[slot_s.long(), col] = order.to(torch.int32)
    return VoxelHashGrid(table=table[:table_size, :bucket].contiguous(),
                         points=points)


def query(grid: VoxelHashGrid, src: torch.Tensor, voxel: float):
    """(M, D) queries -> (idx (M,) int32, d2 (M,)); d2 = +inf and idx 0
    where no candidate lies in the 3^D neighbour voxels."""
    table_size = grid.table.shape[0]
    m, d = src.shape
    q = _voxel_coords(src, voxel)
    r = torch.arange(-1, 2, device=src.device, dtype=torch.int32)
    off = torch.stack(torch.meshgrid(*([r] * d), indexing="ij"),
                      dim=-1).reshape(3 ** d, d)
    slots = _hash(q[:, None, :] + off[None, :, :], table_size)  # (M, 3^D)
    cand = grid.table[slots.long()].reshape(m, -1)  # (M, 3^D B)
    valid = cand >= 0
    cand_safe = torch.where(valid, cand, torch.zeros_like(cand)).long()
    diff = grid.points[cand_safe] - src[:, None, :]
    d2 = torch.sum(diff * diff, dim=-1)
    d2 = torch.where(valid, d2, torch.full_like(d2, float("inf")))
    best = torch.argmin(d2, dim=-1, keepdim=True)  # first minimum on ties
    idx = torch.gather(cand_safe, 1, best)[:, 0]
    return idx.to(torch.int32), torch.gather(d2, 1, best)[:, 0]
