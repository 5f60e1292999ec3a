"""2D log-odds occupancy grid (port of tpu_icp_slam/mapping/occupancy2d.py).

Each beam adds `hit` at its endpoint cell and `free` at `ray_samples`
evenly spaced samples along the ray, which stop 1.5 cells short of the
endpoint so that a beam never clears its own hit cell; then the grid is
clipped to ±clip. The reference's two `.at[].add(mode="drop")` scatters
become two accumulating `index_put_` into the flat grid, in its order (hits,
then free samples, then the clip). The reference drops the entries that
fall off the grid; here each goes to a spare cell of its own past the grid
(entry i of a scatter to flat index h * w + i, in a buffer of h * w + B * K
floats), and the spares are dropped, so no host sync filters them and no
one cell piles them up. Masked beams inside the grid add their zero, as in
the reference.

Float sums into one cell run in the scatter's order. On CUDA,
`index_put_(accumulate=True)` sorts the indices (stably) and sums each
cell's run, so a grid is reproducible (measured on an H100), but its
log-odds may differ from a CPU run by a few ulps. Every spare index sorts
after every grid cell, so where the spares go changes no grid cell's run,
its place in the sort or its summing order. The grid never feeds back into
a pose.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpu_icp_slam_torch.datasets import png


@dataclasses.dataclass(frozen=True)
class OccupancyGrid2D:
    logodds: torch.Tensor  # (H, W) float32
    origin: torch.Tensor  # (2,) world coords of the corner of cell (0, 0)
    resolution: torch.Tensor  # () metres per cell


def create(size: int, resolution: float, center: tuple = (0.0, 0.0),
           device: torch.device | str = "cuda") -> OccupancyGrid2D:
    half = size * resolution / 2.0
    return OccupancyGrid2D(
        logodds=torch.zeros((size, size), dtype=torch.float32, device=device),
        origin=torch.tensor([center[0] - half, center[1] - half],
                            dtype=torch.float32, device=device),
        resolution=torch.tensor(resolution, dtype=torch.float32,
                                device=device),
    )


def world_to_cell(grid: OccupancyGrid2D, pts: torch.Tensor) -> torch.Tensor:
    """(N, 2) world -> (N, 2) int32 cell indices (iy, ix)."""
    rel = (pts - grid.origin) / grid.resolution
    return torch.floor(rel).to(torch.int32).flip(-1)


def _flat_cells(cells: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(N, 2) (iy, ix) -> (N,) flat indices, h * w + i for entry i if its
    cell is off the grid; and the inside mask."""
    inside = ((cells[:, 0] >= 0) & (cells[:, 0] < h) & (cells[:, 1] >= 0)
              & (cells[:, 1] < w))
    flat = cells[:, 0].long() * w + cells[:, 1].long()
    spare = h * w + torch.arange(flat.shape[0], device=flat.device)
    return torch.where(inside, flat, spare), inside


def update(grid: OccupancyGrid2D, pose: torch.Tensor, points: torch.Tensor,
           mask: torch.Tensor, hit: float = 0.9, free: float = -0.4,
           clip: float = 10.0, ray_samples: int = 128) -> OccupancyGrid2D:
    """Fold one registered scan into the grid: pose (3, 3) SE(2) world <-
    sensor, points (B, 2) beam endpoints in the sensor frame, mask (B,)
    real hits. Returns a new grid."""
    h, w = grid.logodds.shape
    sensor = pose[:2, 2]
    pts_w = points @ pose[:2, :2].T + sensor  # (B, 2)
    mf = mask.to(torch.float32)
    # a spare cell past the grid for each entry that falls off it
    lo = torch.cat([grid.logodds.reshape(-1),
                    torch.zeros(points.shape[0] * max(ray_samples, 1),
                                dtype=torch.float32,
                                device=grid.logodds.device)])

    # hit cells: one scatter-add per beam
    flat, inside = _flat_cells(world_to_cell(grid, pts_w), h, w)
    lo.index_put_((flat,), mf * inside * hit, accumulate=True)

    # free space: ray_samples samples strictly inside each ray, stopping 1.5
    # cells short of the endpoint (the worst diagonal crossing is sqrt(2))
    ray = pts_w - sensor
    ray_len = torch.linalg.vector_norm(ray, dim=-1)
    u_stop = torch.clamp(
        1.0 - 1.5 * grid.resolution / torch.clamp(ray_len, min=1e-6),
        0.0, 1.0)
    u = (torch.arange(ray_samples, dtype=torch.float32, device=pts_w.device)
         + 0.5) / ray_samples
    u_scaled = u[None, :] * u_stop[:, None]  # (B, K)
    samples = sensor + u_scaled[:, :, None] * ray[:, None, :]  # (B, K, 2)
    sflat, sinside = _flat_cells(world_to_cell(grid, samples.reshape(-1, 2)),
                                 h, w)
    lo.index_put_((sflat,),
                  torch.repeat_interleave(mf, ray_samples) * sinside * free,
                  accumulate=True)

    lo = torch.clamp(lo[:h * w], -clip, clip).reshape(h, w)
    return dataclasses.replace(grid, logodds=lo)


def to_probability(grid: OccupancyGrid2D) -> torch.Tensor:
    return torch.sigmoid(grid.logodds)


def render_png(grid: OccupancyGrid2D, path: str, trajectory=None) -> None:
    """The grid as an 8-bit RGB PNG, one pixel a cell, north up: free space
    white, occupied black, unknown grey (1 - p), the trajectory (N, 2) in
    world metres drawn red.

    Written with numpy and zlib alone, so it needs no plotting package. It
    is not pixel-equal to the reference's matplotlib figure (no axes, no
    legend, no resampling).
    """
    p = to_probability(grid).cpu().numpy().astype(np.float64)
    h, w = p.shape
    grey = np.round(255.0 * (1.0 - p)).astype(np.uint8)[::-1]  # row 0 = top
    img = np.repeat(grey[..., None], 3, axis=2)
    if trajectory is not None:
        traj = np.asarray(trajectory, np.float64)[:, :2]
        res = float(grid.resolution)
        org = grid.origin.cpu().numpy().astype(np.float64)
        if len(traj) > 1:
            n = max(int(np.abs(np.diff(traj, axis=0)).max() / res) + 2, 2)
            s = np.linspace(0.0, 1.0, n)[:, None, None]
            traj = (traj[:-1] + s * (traj[1:] - traj[:-1])).reshape(-1, 2)
        c = np.floor((traj[:, 0] - org[0]) / res).astype(int)
        r = h - 1 - np.floor((traj[:, 1] - org[1]) / res).astype(int)
        keep = (c >= 0) & (c < w) & (r >= 0) & (r < h)
        img[r[keep], c[keep]] = (255, 0, 0)
    png.write_rgb8(path, np.ascontiguousarray(img))
