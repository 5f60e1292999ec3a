"""Persistent maps (port of tpu_icp_slam/slam/map_io.py): save a SLAM
session's map and keyframe database, load it later and localize a scan in
it.

One .npz holds the voxel map (points/normals/mask), the keyframe store
(padded scans + masks + world poses), the scan-context descriptors with
their geometry (max range, rings, sectors) and the accepted closures'
confidence metadata, under the reference's keys, so a map saved by either
package loads in the other. `load_map` rebuilds a LoopDetector over the
stored keyframes; `localize_in_map` answers the kidnapped-robot query
(descriptor ranking, then multi-yaw ICP verification, K1's batched form on
the card) with a world pose.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Optional

import numpy as np
import torch

from tpu_icp_slam_torch.backend.loop_closure import LoopDetector
from tpu_icp_slam_torch.config import BackendConfig
from tpu_icp_slam_torch.interop import load_detector_store
from tpu_icp_slam_torch.mapping.voxel_map import VoxelMap


@dataclasses.dataclass
class SavedMap:
    vmap: Optional[VoxelMap]  # the dense model (None if not stored)
    kf_scans: list  # [(pts (C, D), msk (C,))] per keyframe, numpy
    kf_poses: np.ndarray  # (K, D+1, D+1) world poses
    detector: LoopDetector
    # which accepted loop closures built this map, their PCM cycle scores
    # and suspect flags: a localize consumer can tell a clean map from one
    # with aliased closures
    closure_info: Optional[list] = None  # [{i, j, cycle_score_m, suspect}]

    @property
    def n_suspect_closures(self) -> int:
        if not self.closure_info:
            return 0
        return sum(1 for c in self.closure_info if c["suspect"])


def _np(x) -> np.ndarray:
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def save_map(path: str, kf_scans, kf_poses, vmap: Optional[VoxelMap] = None,
             detector: Optional[LoopDetector] = None,
             closure_info: Optional[list] = None) -> None:
    arrs = {
        "kf_pts": np.stack([_np(p) for p, _ in kf_scans]),
        "kf_msk": np.stack([_np(m) for _, m in kf_scans]),
        "kf_poses": np.asarray(kf_poses),
    }
    if vmap is not None:
        arrs["map_points"] = _np(vmap.points)
        arrs["map_normals"] = _np(vmap.normals)
        arrs["map_mask"] = _np(vmap.mask)
    if detector is not None and detector._descs:
        arrs["descs"] = np.stack(detector._descs)
        # the descriptor geometry travels with the descriptors: a query
        # binned with other ring/sector extents would mis-rank candidates
        arrs["desc_params"] = np.asarray([
            detector.max_range,
            detector.cfg.descriptor_rings,
            detector.cfg.descriptor_sectors,
        ])
    if closure_info:
        arrs["closure_meta"] = np.asarray([
            [c["i"], c["j"],
             np.nan if c.get("cycle_score_m") is None else c["cycle_score_m"],
             float(bool(c["suspect"]))]
            for c in closure_info
        ], np.float64)
    np.savez_compressed(path, **arrs)


def load_map(path: str, cfg: BackendConfig, max_range: float = 60.0,
             device: torch.device | str = "cuda") -> SavedMap:
    """The map at `path`, its voxel map and loop detector on `device`; the
    stored descriptor geometry wins over `cfg`'s and `max_range`."""
    data = np.load(path, allow_pickle=False)
    kf_pts = data["kf_pts"]
    kf_msk = data["kf_msk"]
    kf_poses = data["kf_poses"]
    vmap = None
    if "map_points" in data:
        vmap = VoxelMap(**{
            k: torch.as_tensor(data[f"map_{k}"], device=device,
                               dtype=torch.bool if k == "mask"
                               else torch.float32)
            for k in ("points", "normals", "mask")})
    if "desc_params" in data:
        s_range, s_rings, s_sectors = (
            float(data["desc_params"][0]),
            int(data["desc_params"][1]),
            int(data["desc_params"][2]),
        )
        if (s_rings != cfg.descriptor_rings
                or s_sectors != cfg.descriptor_sectors
                or abs(s_range - max_range) > 1e-6):
            logging.getLogger(__name__).warning(
                "map %s was built with descriptor geometry (max_range=%g, "
                "rings=%d, sectors=%d) != requested (%g, %d, %d) — using the "
                "stored geometry", path, s_range, s_rings, s_sectors,
                max_range, cfg.descriptor_rings, cfg.descriptor_sectors,
            )
        cfg = dataclasses.replace(
            cfg, descriptor_rings=s_rings, descriptor_sectors=s_sectors
        )
        max_range = s_range
    det = LoopDetector(cfg, max_range=max_range, device=device)
    d = kf_poses.shape[-1] - 1
    if "descs" in data:
        load_detector_store(det, list(data["descs"]),
                            [kf_poses[i][:d, d] for i in range(len(kf_poses))])
    else:
        for i in range(len(kf_pts)):
            det.add_keyframe(kf_pts[i], kf_msk[i], position=kf_poses[i][:d, d])
    scans = [(kf_pts[i], kf_msk[i]) for i in range(len(kf_pts))]
    closure_info = None
    if "closure_meta" in data:
        closure_info = [
            {
                "i": int(row[0]), "j": int(row[1]),
                "cycle_score_m": None if np.isnan(row[2]) else float(row[2]),
                "suspect": bool(row[3]),
            }
            for row in data["closure_meta"]
        ]
        n_sus = sum(1 for c in closure_info if c["suspect"])
        if n_sus:
            logging.getLogger(__name__).warning(
                "map %s contains %d/%d SUSPECT loop closures (PCM cycle "
                "score above the alias threshold) — localization near those "
                "regions may be off by the alias spacing",
                path, n_sus, len(closure_info),
            )
    return SavedMap(vmap=vmap, kf_scans=scans, kf_poses=kf_poses,
                    detector=det, closure_info=closure_info)


def localize_in_map(saved: SavedMap, points, mask, topk: int = 3):
    """World pose of an arbitrary scan inside a loaded map:
    (pose (D+1, D+1), matched keyframe, rmse), or None."""
    return saved.detector.relocalize(
        points, mask, saved.kf_scans, list(saved.kf_poses), topk=topk
    )
