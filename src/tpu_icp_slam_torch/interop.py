"""Carry scan-to-map state between the JAX package and this port as numpy.

The system has no weights: what a run carries is its state (pose, motion,
voxel map, carried local model). `state_to_numpy` flattens a port state
into a dict of numpy arrays, with the map under "vmap" as a dict of
points/normals/mask; `state_from_numpy` builds a port state from such a
dict. A reference `MapOdomState` converted field by field with
`np.asarray` has the same layout, so both packages can start from one map.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpu_icp_slam_torch.mapping.voxel_map import VoxelMap
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


def state_from_numpy(d: dict, device: torch.device | str = "cpu"
                     ) -> MapOdomState:
    """Port state from a dict of numpy arrays (float arrays become float32,
    bools stay bool, integers become int32)."""
    def conv(a):
        a = np.asarray(a)
        if a.dtype == np.bool_:
            dtype = torch.bool
        elif np.issubdtype(a.dtype, np.integer):
            dtype = torch.int32
        else:
            dtype = torch.float32
        return torch.as_tensor(a, device=device).to(dtype).contiguous()

    vm = VoxelMap(**{k: conv(d["vmap"][k]) for k in _VMAP_FIELDS})
    return MapOdomState(**{
        f.name: vm if f.name == "vmap" else conv(d[f.name])
        for f in dataclasses.fields(MapOdomState)})
