"""KN: the k-NN plane fit of normal estimation — the CUDA launch.

`knn_normals(points, mask, k, ref_stride, viewpoint)` launches
csrc/knn_normals.cu on CUDA tensors: points (M, 3) float32 and mask (M,)
bool -> (normals (M, 3) float32, idx (M, k) int32), each row's k nearest
points of points[::ref_stride] by the reference's factored score, ties to
the lower index, and the unit normal of the plane fitted to them, facing
the viewpoint (default the origin), zero where the mask is false. Two
launches, no host read. The plain version, the dispatch and the CPU path
are mapping/normals.py's (`normals_knn_ref` over kernels/nn_plain.py):
idx equals the plain version's wherever the CPU's and cuBLAS's float32
products agree, and the normals are the same fit summed in the same order.

Its scratch (the targets packed as (x, y, z, |b|²) and each row's
threshold) is allocated per device and reused: calls on one stream never
overlap, and the port runs on one stream. A CUDA graph that captured a
launch keeps its pointers, so a buffer outgrown by a larger call is kept,
never freed.
"""

from __future__ import annotations

import torch

from tpu_icp_slam_torch.kernels import _build

MAX_K = 32

_scratch: dict[torch.device, torch.Tensor] = {}
_outgrown: list = []  # scratch a captured graph may still use: never freed


def _device_scratch(device: torch.device, words: int) -> torch.Tensor:
    """A float32 scratch of at least `words` on a CUDA device, made on
    first use and remade larger when a call needs more."""
    have = _scratch.get(device)
    if have is None or have.numel() < words:
        if have is not None:
            _outgrown.append(have)
        have = torch.empty(words, dtype=torch.float32, device=device)
        _scratch[device] = have
    return have


def knn_normals(points: torch.Tensor, mask: torch.Tensor, k: int,
                ref_stride: int = 1, viewpoint: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """One KN call on points' CUDA device (see the module docstring)."""
    _build.require_points("knn_normals", points=points)
    m, stride = points.shape[0], max(1, ref_stride)
    n = -(-m // stride)
    if mask.device != points.device or mask.dtype != torch.bool or \
            tuple(mask.shape) != (m,) or not mask.is_contiguous():
        raise ValueError(f"knn_normals: mask must be contiguous bool ({m},) "
                         f"on {points.device}, got {mask.dtype} "
                         f"{tuple(mask.shape)} on {mask.device}")
    if not 1 <= k <= min(MAX_K, n):
        raise ValueError(f"knn_normals: k = {k} outside [1, min({MAX_K}, "
                         f"{n} reference points)]")
    if viewpoint is not None and (
            viewpoint.device != points.device
            or viewpoint.dtype != torch.float32
            or tuple(viewpoint.shape) != (3,)
            or not viewpoint.is_contiguous()):
        raise ValueError("knn_normals: viewpoint must be a contiguous "
                         "float32 (3,) on points' device")
    scratch = _device_scratch(points.device, 4 * n + m)
    normals = torch.empty((m, 3), dtype=torch.float32, device=points.device)
    idx = torch.empty((m, k), dtype=torch.int32, device=points.device)
    err = _build.load().knn_normals_f32(
        points.data_ptr(), mask.data_ptr(), m, stride, k,
        None if viewpoint is None else viewpoint.data_ptr(),
        scratch.data_ptr(), scratch.data_ptr() + 16 * n, normals.data_ptr(),
        idx.data_ptr(), torch.cuda.current_stream(points.device).cuda_stream)
    _build.check(err, "knn_normals_f32")
    knn_normals.launches += 1
    return normals, idx


knn_normals.launches = 0  # every launch
