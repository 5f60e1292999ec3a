"""Scan padding for the pipelines (port of tpu_icp_slam/slam/runner.py::pad_scans)."""

from __future__ import annotations

import numpy as np

from tpu_icp_slam_torch.core.pointcloud import PAD_COORD


def pad_scans(scans: list, capacity: int):
    """list of (N_i, D) -> (F, C, D) float32 points + (F, C) masks.

    Oversized scans are subsampled uniformly, never truncated: scan points
    arrive ordered by ring or azimuth, so truncation would delete whole
    regions of the field of view.
    """
    f = len(scans)
    d = scans[0].shape[1]
    pts = np.full((f, capacity, d), PAD_COORD, np.float32)
    msk = np.zeros((f, capacity), bool)
    for i, s in enumerate(scans):
        if len(s) > capacity:
            s = s[np.linspace(0, len(s) - 1, capacity).astype(np.int64)]
        pts[i, :len(s)] = s
        msk[i, :len(s)] = True
    return pts, msk
