"""Fixed-capacity padded point clouds (port of tpu_icp_slam/core/pointcloud.py).

Padded slots hold the PAD_COORD sentinel: its squared distance to any scene
point (~1e12) is finite in float32 and always loses a nearest-neighbour
argmin, so no mask enters the hot loop.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

PAD_COORD = 1.0e6


@dataclasses.dataclass(frozen=True)
class PointCloud:
    """points: (C, D) float; mask: (C,) bool; normals: optional (C, D)."""

    points: torch.Tensor
    mask: torch.Tensor
    normals: Optional[torch.Tensor] = None

    @property
    def capacity(self) -> int:
        return self.points.shape[0]

    @property
    def dim(self) -> int:
        return self.points.shape[1]


def make(points, capacity: Optional[int] = None, normals=None, *,
         device: torch.device | str = "cuda") -> PointCloud:
    """Build a padded float32 cloud on `device` (the card unless the caller
    asks for another) from an (N, D) array; pads (sentinel points, zero
    normals) or truncates to `capacity`."""
    points = torch.as_tensor(points, dtype=torch.float32, device=device)
    n, d = points.shape
    cap = capacity if capacity is not None else n
    n = min(n, cap)
    out = torch.full((cap, d), PAD_COORD, dtype=torch.float32, device=device)
    out[:n] = points[:n]
    mask = torch.zeros(cap, dtype=torch.bool, device=device)
    mask[:n] = True
    nrm = None
    if normals is not None:
        normals = torch.as_tensor(normals, dtype=torch.float32, device=device)
        nrm = torch.zeros((cap, d), dtype=torch.float32, device=device)
        nrm[:n] = normals[:n]
    return PointCloud(points=out, mask=mask, normals=nrm)


def count(pc: PointCloud) -> torch.Tensor:
    return torch.sum(pc.mask.to(torch.int32))


def fill_invalid(pc: PointCloud) -> PointCloud:
    """Force padded slots to the sentinel coordinate (idempotent)."""
    pts = torch.where(pc.mask[:, None], pc.points,
                      torch.full_like(pc.points, PAD_COORD))
    return dataclasses.replace(pc, points=pts)


def transform(T: torch.Tensor, pc: PointCloud) -> PointCloud:
    """Apply a rigid transform; sentinel slots are re-pinned afterwards."""
    d = pc.dim
    R = T[..., :d, :d]
    t = T[..., :d, d]
    pts = pc.points @ R.T + t
    pts = torch.where(pc.mask[:, None], pts, torch.full_like(pts, PAD_COORD))
    normals = None
    if pc.normals is not None:
        normals = torch.where(pc.mask[:, None], pc.normals @ R.T,
                              torch.zeros_like(pc.normals))
    return PointCloud(points=pts, mask=pc.mask, normals=normals)


def valid_points_np(pc: PointCloud) -> np.ndarray:
    """Host-side: extract only the valid points as a NumPy array."""
    return pc.points.cpu().numpy()[pc.mask.cpu().numpy()]


def round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def voxel_downsample_np(points: np.ndarray, voxel: float) -> np.ndarray:
    """Host-side voxel-grid downsample: first point per voxel, in scan order.

    Same function as the reference's: the port's native C pass
    (`tpu_icp_slam_torch.native`), the numpy sort without it.
    """
    from tpu_icp_slam_torch import native

    out = native.voxel_downsample(points, voxel)
    if out is not None:
        return out
    keys = np.floor(points / voxel).astype(np.int64)
    _, idx = np.unique(keys, axis=0, return_index=True)
    return points[np.sort(idx)]
