"""Carry state between the JAX package and this port as numpy.

The system has no weights: what a run carries is its state (pose, motion,
voxel map, carried local model), the loop detector's keyframe store and the
pose graph. `state_to_numpy` flattens a port state into a dict of numpy
arrays, with the map under "vmap" as a dict of points/normals/mask;
`state_from_numpy` builds a port state from such a dict. A reference
`MapOdomState` converted field by field with `np.asarray` has the same
layout, so both packages can start from one map. `rgbd_state_to_numpy` and
`rgbd_state_from_numpy` do the same for RGB-D odometry's `RGBDState`
(pose, motion, the previous frame's vertex, normal and validity maps). `load_detector_store`
gives a port LoopDetector the host store (descriptors, positions) of a
reference detector, and `pose_graph_from_numpy` builds a port PoseGraph from
a reference one, so both packages can work on identical inputs.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpu_icp_slam_torch.backend.loop_closure import LoopDetector
from tpu_icp_slam_torch.backend.pose_graph import PoseGraph
from tpu_icp_slam_torch.mapping.voxel_map import VoxelMap
from tpu_icp_slam_torch.slam.rgbd import RGBDState
from tpu_icp_slam_torch.slam.scan_to_map import MapOdomState

_VMAP_FIELDS = ("points", "normals", "mask")


def state_to_numpy(state: MapOdomState) -> dict:
    out = {}
    for f in dataclasses.fields(MapOdomState):
        v = getattr(state, f.name)
        if f.name == "vmap":
            out["vmap"] = {k: getattr(v, k).cpu().numpy()
                           for k in _VMAP_FIELDS}
        else:
            out[f.name] = v.cpu().numpy()
    return out


def state_leaf(a, device: torch.device | str = "cuda") -> torch.Tensor:
    """One array of a pipeline state as the port holds it: float arrays
    become float32, bools stay bool, integers become int32. The array is
    copied (a loaded .npz array may be read-only)."""
    a = np.array(a)
    if a.dtype == np.bool_:
        dtype = torch.bool
    elif np.issubdtype(a.dtype, np.integer):
        dtype = torch.int32
    else:
        dtype = torch.float32
    return torch.as_tensor(a, device=device).to(dtype).contiguous()


def state_from_numpy(d: dict, device: torch.device | str = "cuda"
                     ) -> MapOdomState:
    """Port state from a dict of numpy arrays (as `state_leaf` converts
    them)."""
    vm = VoxelMap(**{k: state_leaf(d["vmap"][k], device)
                     for k in _VMAP_FIELDS})
    return MapOdomState(**{
        f.name: vm if f.name == "vmap" else state_leaf(d[f.name], device)
        for f in dataclasses.fields(MapOdomState)})


def rgbd_state_to_numpy(state: RGBDState) -> dict:
    return {f.name: getattr(state, f.name).cpu().numpy()
            for f in dataclasses.fields(RGBDState)}


def rgbd_state_from_numpy(d: dict, device: torch.device | str = "cuda"
                          ) -> RGBDState:
    """Port RGBDState from a dict of numpy arrays keyed by its fields (a
    reference RGBDState's leaves), converted by `state_leaf`."""
    return RGBDState(**{f.name: state_leaf(d[f.name], device)
                        for f in dataclasses.fields(RGBDState)})


def load_detector_store(det: LoopDetector, descs, positions) -> None:
    """Replace det's keyframe store with (descs: list of (R, S) arrays,
    positions: list of (D,) arrays or None) — a reference detector's
    `_descs` and `_positions` — and rebuild its device store."""
    det._descs = [np.asarray(d, np.float32) for d in descs]
    det._positions = [None if p is None else np.asarray(p, np.float64)
                      for p in positions]
    det._sync_device_store()


def pose_graph_from_numpy(g, dtype=torch.float64,
                          device: torch.device | str = "cuda") -> PoseGraph:
    """Port PoseGraph from any object with PoseGraph's fields as arrays (a
    reference PoseGraph), poses/T_meas/weight as `dtype`."""
    def conv(name, dt):
        return torch.as_tensor(np.asarray(getattr(g, name)),
                               device=device).to(dt)

    return PoseGraph(poses=conv("poses", dtype),
                     pose_mask=conv("pose_mask", torch.bool),
                     fi=conv("fi", torch.int64), fj=conv("fj", torch.int64),
                     T_meas=conv("T_meas", dtype),
                     weight=conv("weight", dtype))
