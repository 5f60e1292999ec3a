"""The occupancy grid's fold as it was with one spare cell for every
off-grid entry (all of them summed into one cell past the grid), kept as
the reference of the fold's bit-equality on the CPU and on the card, and
the scans both tests fold. Imports no jax."""

import dataclasses

import numpy as np
import torch

from tpu_icp_slam_torch.mapping import occupancy2d as occ


def update_one_spare(grid, pose, points, mask, hit=0.9, free=-0.4,
                     clip=10.0, ray_samples=128):
    """occupancy2d.update as it was with one spare cell for every off-grid
    entry, kept as the reference of the fold's bit-equality."""
    h, w = grid.logodds.shape
    sensor = pose[:2, 2]
    pts_w = points @ pose[:2, :2].T + sensor
    mf = mask.to(torch.float32)
    lo = torch.cat([grid.logodds.reshape(-1),
                    torch.zeros(1, dtype=torch.float32,
                                device=grid.logodds.device)])

    def flat_cells(cells):
        inside = ((cells[:, 0] >= 0) & (cells[:, 0] < h) & (cells[:, 1] >= 0)
                  & (cells[:, 1] < w))
        flat = cells[:, 0].long() * w + cells[:, 1].long()
        return torch.where(inside, flat, torch.full_like(flat, h * w)), inside

    flat, inside = flat_cells(occ.world_to_cell(grid, pts_w))
    lo.index_put_((flat,), mf * inside * hit, accumulate=True)
    ray = pts_w - sensor
    ray_len = torch.linalg.vector_norm(ray, dim=-1)
    u_stop = torch.clamp(
        1.0 - 1.5 * grid.resolution / torch.clamp(ray_len, min=1e-6),
        0.0, 1.0)
    u = (torch.arange(ray_samples, dtype=torch.float32, device=pts_w.device)
         + 0.5) / ray_samples
    u_scaled = u[None, :] * u_stop[:, None]
    samples = sensor + u_scaled[:, :, None] * ray[:, None, :]
    sflat, sinside = flat_cells(occ.world_to_cell(grid,
                                                  samples.reshape(-1, 2)))
    lo.index_put_((sflat,),
                  torch.repeat_interleave(mf, ray_samples) * sinside * free,
                  accumulate=True)
    lo = torch.clamp(lo[:h * w], -clip, clip).reshape(h, w)
    return dataclasses.replace(grid, logodds=lo)


def fold_scans(seed, n_beams=360, capacity=512):
    """Scans of beams at ranges 0.5-12 m around a pose, some beyond the
    grid's edge, some masked out, the rest padded at the sentinel."""
    rng = np.random.default_rng(seed)
    ang = np.linspace(-np.pi, np.pi, n_beams, endpoint=False)
    rng_m = rng.uniform(0.5, 12.0, n_beams)
    pts = np.full((capacity, 2), 1.0e6, np.float32)
    pts[:n_beams] = np.stack([rng_m * np.cos(ang), rng_m * np.sin(ang)], -1)
    mask = np.zeros(capacity, bool)
    mask[:n_beams] = rng.uniform(size=n_beams) > 0.1
    th = rng.uniform(-0.3, 0.3)
    pose = np.array([[np.cos(th), -np.sin(th), rng.uniform(-1, 1)],
                     [np.sin(th), np.cos(th), rng.uniform(-1, 1)],
                     [0, 0, 1]], np.float32)
    return pose, pts, mask
