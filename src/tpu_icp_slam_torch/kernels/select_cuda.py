"""EX: the local model's select — the CUDA launch.

`local_select(points, normals, mask, center, size, radius)` launches
csrc/local_select.cu on CUDA tensors: the map's points and normals (C, 3)
float32 and mask (C,) bool, center three float32 (any stride) -> (pts
(size, 3), nrm (size, 3), msk (size,), r_cover ()), the nearest `size`
slots to center by d² with ties to the lower index, the kept rows (finite
d², within radius when radius > 0) in map order and then padding, and the
coverage radius. Four launches, no host read. The plain version, the
dispatch and the CPU path are mapping/voxel_map.py's (`extract_local_ref`,
`extract_local`); all four outputs equal the plain version's bit for bit.

The scratch (the keys, the histograms, the per-block counts and the
state the launches hand on) is allocated per device, zeroed once, and
left ready by every call; a larger map gets a new one and the old one is
kept, never freed, since a captured graph may still use it.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_icp_slam_torch.kernels import _build

_scratch: dict[torch.device, torch.Tensor] = {}
_outgrown: list = []  # scratch a captured graph may still use: never freed


def _device_scratch(device: torch.device, c: int) -> torch.Tensor:
    words = _build.load().local_select_scratch_words(c)
    have = _scratch.get(device)
    if have is None or have.numel() < words:
        if have is not None:
            _outgrown.append(have)
        have = torch.zeros(words, dtype=torch.int32, device=device)
        _scratch[device] = have
    return have


def gate_bits(radius: float) -> int:
    """The bit pattern of the largest d² kept: the largest finite float32,
    or radius² rounded to float32 (as torch compares a float32 tensor with
    a Python float) when radius > 0, whichever is lower."""
    top = int(np.array(np.finfo(np.float32).max, np.float32).view(np.uint32))
    if radius <= 0.0:
        return top
    r2 = np.array(radius * radius, np.float32).view(np.uint32)
    return min(int(r2), top)


def local_select(points: torch.Tensor, normals: torch.Tensor,
                 mask: torch.Tensor, center: torch.Tensor, size: int,
                 radius: float = 0.0):
    """One EX call on points' CUDA device (see the module docstring)."""
    _build.require_points("local_select", points=points, normals=normals)
    c = points.shape[0]
    if mask.device != points.device or mask.dtype != torch.bool or \
            tuple(mask.shape) != (c,) or not mask.is_contiguous():
        raise ValueError(f"local_select: mask must be contiguous bool ({c},) "
                         f"on {points.device}")
    if center.device != points.device or center.dtype != torch.float32 or \
            tuple(center.shape) != (3,):
        raise ValueError("local_select: center must be float32 (3,) on "
                         "points' device")
    if not 1 <= size <= c:
        raise ValueError(f"local_select: size {size} outside [1, {c}]")
    dev = points.device
    scratch = _device_scratch(dev, c)
    pts = torch.empty((size, 3), dtype=torch.float32, device=dev)
    nrm = torch.empty((size, 3), dtype=torch.float32, device=dev)
    msk = torch.empty(size, dtype=torch.bool, device=dev)
    r_cover = torch.empty((), dtype=torch.float32, device=dev)
    err = _build.load().local_select_f32(
        points.data_ptr(), normals.data_ptr(), mask.data_ptr(),
        center.data_ptr(), center.stride(0), c, size, gate_bits(radius),
        float(np.float32(max(radius, 0.0))), scratch.data_ptr(),
        pts.data_ptr(), nrm.data_ptr(), msk.data_ptr(), r_cover.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "local_select_f32")
    local_select.launches += 1
    return pts, nrm, msk, r_cover


local_select.launches = 0  # every launch
