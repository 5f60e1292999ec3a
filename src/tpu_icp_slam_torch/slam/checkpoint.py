"""Checkpoint / resume (port of tpu_icp_slam/slam/checkpoint.py).

A run's front-end state — scan-to-scan (pose, motion, previous scan, and
in 2D the occupancy grid) or scan-to-map (pose, motion, voxel map, carried
local model) — the next frame index and the trajectory so far go to one
.npz; `run --resume` continues a log mid-stream from it.

Two granularities, as in the reference:
- `save_checkpoint`/`load_checkpoint`: odometry-only pipelines (front-end
  state + trajectory).
- `save_slam_checkpoint`/`load_slam_checkpoint`: full SLAM (Slam3D, Slam2D
  with its front end of kind "odom" or "scan_to_map") — the
  front-end state plus what the pose graph needs: keyframe frames, poses,
  descriptors and positions, per-frame anchors, accepted closures, the
  candidate count and the per-frame strain flags. The write is atomic (a
  temporary file, then `os.replace`).

The on-disk layout is the reference's: `kind`, `next_frame`, `poses`,
`n_leaves`, `leaf_{i}` in the reference's tree-flatten order (the state's
dataclass fields in order, the voxel map's points/normals/mask in place of
`vmap`, the grid's logodds/origin/resolution in place of `grid`, nothing for
a grid that is None; 14 leaves for `MapOdomState`, 5 for an `OdomState`
without a grid, 8 with one) and `config_hash`. A checkpoint written by
either package loads in the other.
Loaded leaves take the dtypes the state needs (float32, bool, int32).
"""

from __future__ import annotations

import dataclasses
import logging
import os

import numpy as np
import torch

from tpu_icp_slam_torch.backend.loop_closure import LoopClosure
from tpu_icp_slam_torch.config import config_hash
from tpu_icp_slam_torch.interop import load_detector_store, state_leaf
from tpu_icp_slam_torch.mapping.occupancy2d import OccupancyGrid2D
from tpu_icp_slam_torch.mapping.voxel_map import VoxelMap
from tpu_icp_slam_torch.slam.pipeline import OdomState
from tpu_icp_slam_torch.slam.scan_to_map import MapOdomState

_KINDS = {"scan_to_map": MapOdomState, "odom": OdomState}
_NESTED = {"vmap": VoxelMap, "grid": OccupancyGrid2D}  # inlined by flatten


def _kind_of(state) -> str:
    return "scan_to_map" if isinstance(state, MapOdomState) else "odom"


def _flatten(state) -> list:
    """The state's arrays in the reference's tree-flatten order: dataclass
    fields in order, nested dataclasses in place, None skipped."""
    out = []
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if dataclasses.is_dataclass(v):
            out.extend(_flatten(v))
        elif v is not None:
            out.append(v.cpu().numpy() if torch.is_tensor(v)
                       else np.asarray(v))
    return out


def _unflatten(kind: str, leaves: list, device):
    """Rebuild a front-end state from its leaves (no pickled structure: the
    state's own field list is the template; an `OdomState` has its grid iff
    the leaf count says so, as in the reference)."""
    cls = _KINDS[kind]
    fields = dataclasses.fields(cls)
    widths = {f.name: len(dataclasses.fields(_NESTED[f.name]))
              if f.name in _NESTED else 1 for f in fields}
    n_full = sum(widths.values())
    absent = set()
    if cls is OdomState and len(leaves) == n_full - widths["grid"]:
        absent = {"grid"}
    elif len(leaves) != n_full:
        raise ValueError(f"{kind} checkpoint has {len(leaves)} leaves, "
                         f"expected {n_full}")
    it = iter(state_leaf(a, device) for a in leaves)
    kw = {}
    for f in fields:
        if f.name in absent:
            kw[f.name] = None
        elif f.name in _NESTED:
            kw[f.name] = _NESTED[f.name](**{
                g.name: next(it) for g in dataclasses.fields(_NESTED[f.name])})
        else:
            kw[f.name] = next(it)
    return cls(**kw)


def _warn_config(path: str, data, cfg, what: str) -> None:
    if cfg is not None and "config_hash" in data:
        if str(data["config_hash"]) != config_hash(cfg):
            logging.getLogger(__name__).warning(
                "%s %s was written under a different config (hash %s != %s)"
                " — resuming anyway", what, path, data["config_hash"],
                config_hash(cfg))


def save_checkpoint(path: str, state, next_frame: int, poses: list,
                    cfg=None) -> None:
    leaves = _flatten(state)
    arrs = {f"leaf_{i}": v for i, v in enumerate(leaves)}
    extra = {}
    if cfg is not None:
        extra["config_hash"] = config_hash(cfg)
    np.savez(
        path,
        kind=_kind_of(state),
        next_frame=next_frame,
        poses=np.stack([np.asarray(p) for p in poses]),
        n_leaves=len(leaves),
        **extra,
        **arrs,
    )


def load_checkpoint(path: str, cfg, device: torch.device | str = "cuda"):
    """Returns (state on `device`, next_frame, poses list)."""
    data = np.load(path, allow_pickle=False)
    n = int(data["n_leaves"])
    leaves = [data[f"leaf_{i}"] for i in range(n)]
    kind = str(data["kind"]) if "kind" in data else "odom"
    _warn_config(path, data, cfg, "checkpoint")
    state = _unflatten(kind, leaves, device)
    return state, int(data["next_frame"]), [p for p in data["poses"]]


def save_slam_checkpoint(
    path: str,
    fe_kind: str,  # "scan_to_map" | "odom"
    fe_state,
    next_frame: int,
    poses: list,
    kf_frames: list,
    kf_poses: list,
    anchor_kf: list,
    descs: list,
    positions: list,  # per-keyframe odometry position (d,) or None
    closures: list,  # backend.loop_closure.LoopClosure
    n_cands: int,
    strain: list = None,  # per-frame front-end strain flags (len == next_frame)
    cfg=None,
) -> None:
    """Full SLAM state -> one .npz (atomic via tmp + rename)."""
    leaves = _flatten(fe_state)
    arrs = {f"leaf_{i}": v for i, v in enumerate(leaves)}
    if cfg is not None:
        arrs["config_hash"] = config_hash(cfg)
    d = np.asarray(poses[0]).shape[0] - 1
    pos_arr = np.full((len(positions), d), np.nan)
    for i, p in enumerate(positions):
        if p is not None:
            pos_arr[i, : len(p)] = p
    tij = (
        np.stack([np.asarray(c.T_ij) for c in closures])
        if closures
        else np.zeros((0, d + 1, d + 1))
    )
    tmp = path + ".tmp.npz"
    np.savez(
        tmp,
        kind="slam_backend",
        fe_kind=fe_kind,
        next_frame=next_frame,
        poses=np.stack([np.asarray(p) for p in poses]),
        n_leaves=len(leaves),
        kf_frames=np.asarray(kf_frames, np.int64),
        kf_poses=np.stack([np.asarray(p) for p in kf_poses]),
        anchor_kf=np.asarray(anchor_kf, np.int64),
        descs=np.stack(descs) if descs else np.zeros((0, 1, 1)),
        positions=pos_arr,
        cl_i=np.asarray([c.i for c in closures], np.int64),
        cl_j=np.asarray([c.j for c in closures], np.int64),
        cl_T=tij,
        cl_rmse=np.asarray([c.rmse for c in closures]),
        cl_inl=np.asarray([c.n_inliers for c in closures], np.int64),
        n_cands=n_cands,
        # the strain flags weight the pose graph's odometry factors: a
        # resume without them would not equal the uninterrupted run
        strain=np.asarray(strain if strain is not None else [], bool),
        **arrs,
    )
    os.replace(tmp, path)


def load_slam_checkpoint(path: str, cfg=None,
                         device: torch.device | str = "cuda") -> dict:
    """Returns a dict mirroring save_slam_checkpoint's arguments, the
    front-end state on `device`."""
    data = np.load(path, allow_pickle=False)
    if str(data["kind"]) != "slam_backend":
        raise ValueError(f"{path} is a {data['kind']} checkpoint, not a "
                         "full-SLAM one")
    _warn_config(path, data, cfg, "slam checkpoint")
    n = int(data["n_leaves"])
    leaves = [data[f"leaf_{i}"] for i in range(n)]
    closures = [
        LoopClosure(
            i=int(data["cl_i"][k]),
            j=int(data["cl_j"][k]),
            T_ij=data["cl_T"][k],
            rmse=float(data["cl_rmse"][k]),
            n_inliers=int(data["cl_inl"][k]),
        )
        for k in range(len(data["cl_i"]))
    ]
    positions = [
        None if np.isnan(row).any() else row for row in data["positions"]
    ]
    return {
        "fe_state": _unflatten(str(data["fe_kind"]), leaves, device),
        "next_frame": int(data["next_frame"]),
        "poses": [p for p in data["poses"]],
        "kf_frames": [int(f) for f in data["kf_frames"]],
        "kf_poses": [p for p in data["kf_poses"]],
        "anchor_kf": [int(a) for a in data["anchor_kf"]],
        "descs": [d for d in data["descs"]],
        "positions": positions,
        "closures": closures,
        "n_cands": int(data["n_cands"]),
        # None for a record written without strain flags (the caller warns)
        "strain": (
            [bool(s) for s in data["strain"]] if "strain" in data else None
        ),
    }


def restore_slam_session(path: str, cfg, detector) -> dict:
    """load_slam_checkpoint on the detector's device, and the detector's
    keyframe store (host lists and device store) rebuilt from it."""
    ck = load_slam_checkpoint(path, cfg, device=detector.device)
    load_detector_store(detector, ck["descs"], ck["positions"])
    return ck
