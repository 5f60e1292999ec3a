"""Normal estimation (port of tpu_icp_slam/mapping/normals.py), two paths:
cross products of central differences of an organized depth map's vertex
map (projective RGB-D ICP, config 3), and k-NN plane fits for unorganized
clouds."""

from __future__ import annotations

import math

import torch

from tpu_icp_slam_torch.kernels import knn_cuda
from tpu_icp_slam_torch.kernels.nn_plain import knn_bruteforce


def normals_from_depth(vertex_map: torch.Tensor, valid: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """(H, W, 3) camera-frame vertex map + (H, W) validity -> (H, W, 3)
    unit normals, zero where invalid, and their (H, W) validity.

    Normals face the camera (n_z < 0 for a surface seen down +z). The
    central differences wrap around the image, so the one-pixel border is
    invalid.
    """
    dx = torch.roll(vertex_map, -1, dims=1) - torch.roll(vertex_map, 1, dims=1)
    dy = torch.roll(vertex_map, -1, dims=0) - torch.roll(vertex_map, 1, dims=0)
    n = torch.linalg.cross(dx, dy, dim=-1)
    norm = torch.sqrt(torch.sum(n * n, dim=-1, keepdim=True))
    n = n / torch.clamp(norm, min=1e-12)
    flip = torch.sum(n * vertex_map, dim=-1, keepdim=True) > 0
    n = torch.where(flip, -n, n)
    ok = (valid
          & torch.roll(valid, -1, dims=1) & torch.roll(valid, 1, dims=1)
          & torch.roll(valid, -1, dims=0) & torch.roll(valid, 1, dims=0)
          & (norm[..., 0] > 1e-12))
    # fill_ on the border's views: no host value crosses to the device, so
    # a CUDA graph can capture it
    for border in (ok[0, :], ok[-1, :], ok[:, 0], ok[:, -1]):
        border.fill_(False)
    return torch.where(ok[..., None], n, torch.zeros_like(n)), ok


def smallest_eigvec_sym3(C: torch.Tensor) -> torch.Tensor:
    """Batched smallest eigenvector of symmetric 3x3 matrices, closed form.

    (..., 3, 3) -> (..., 3) unit vectors: trigonometric eigenvalue formula,
    then the largest cross product of two rows of (C − λ_min I). Degenerate
    (isotropic) neighbourhoods fall back to +z, as in the reference.
    """
    eye = torch.eye(3, dtype=C.dtype, device=C.device)
    q = (C[..., 0, 0] + C[..., 1, 1] + C[..., 2, 2]) / 3.0
    c00, c11, c22 = C[..., 0, 0], C[..., 1, 1], C[..., 2, 2]
    c01, c02, c12 = C[..., 0, 1], C[..., 0, 2], C[..., 1, 2]
    p1 = c01 * c01 + c02 * c02 + c12 * c12
    p2 = (c00 - q) ** 2 + (c11 - q) ** 2 + (c22 - q) ** 2 + 2.0 * p1
    p = torch.sqrt(torch.clamp(p2 / 6.0, min=1e-30))
    B = (C - q[..., None, None] * eye) / p[..., None, None]
    detB = (
        B[..., 0, 0] * (B[..., 1, 1] * B[..., 2, 2] - B[..., 1, 2] * B[..., 2, 1])
        - B[..., 0, 1] * (B[..., 1, 0] * B[..., 2, 2] - B[..., 1, 2] * B[..., 2, 0])
        + B[..., 0, 2] * (B[..., 1, 0] * B[..., 2, 1] - B[..., 1, 1] * B[..., 2, 0])
    )
    r = torch.clamp(detB / 2.0, -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    lam_min = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    A = C - lam_min[..., None, None] * eye
    r0, r1, r2 = A[..., 0, :], A[..., 1, :], A[..., 2, :]
    cands = torch.stack([
        torch.linalg.cross(r0, r1, dim=-1),
        torch.linalg.cross(r0, r2, dim=-1),
        torch.linalg.cross(r1, r2, dim=-1),
    ], dim=-2)  # (..., 3, 3)
    norms = torch.sum(cands * cands, dim=-1)
    best = torch.argmax(norms, dim=-1)
    v = torch.gather(
        cands, -2, best[..., None, None].expand(*best.shape, 1, 3))[..., 0, :]
    vn = torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True))
    fallback = torch.zeros_like(v)
    fallback[..., 2] = 1.0
    ok = vn[..., 0] > 1e-20
    return torch.where(ok[..., None], v / torch.clamp(vn, min=1e-30), fallback)


def normals_knn_ref(points: torch.Tensor, mask: torch.Tensor, k: int = 16,
                    viewpoint: torch.Tensor | None = None,
                    ref_stride: int = 1) -> torch.Tensor:
    """normals_knn in torch ops: KN's plain version, and the CPU path."""
    ref = points if ref_stride <= 1 else points[::ref_stride]
    idx, _ = knn_bruteforce(points, ref, k=k)
    nbrs = ref[idx.long()]  # (N, k, 3)
    x = nbrs - torch.mean(nbrs, dim=1, keepdim=True)
    cov = torch.einsum("nki,nkj->nij", x, x) / k
    n = smallest_eigvec_sym3(cov)
    vp = (torch.zeros(3, dtype=points.dtype, device=points.device)
          if viewpoint is None else viewpoint)
    flip = torch.sum(n * (vp[None, :] - points), dim=-1, keepdim=True) < 0
    n = torch.where(flip, -n, n)
    return torch.where(mask[:, None], n, torch.zeros_like(n))


def normals_knn(points: torch.Tensor, mask: torch.Tensor, k: int = 16,
                viewpoint: torch.Tensor | None = None, ref_stride: int = 1,
                approx: bool = True, oversample: int = 0) -> torch.Tensor:
    """(N, 3) cloud -> (N, 3) unit normals by local plane fit.

    Padded slots get zero normals; normals face `viewpoint` (default: the
    origin, the sensor). ref_stride > 1 fits each plane against every
    ref_stride-th point. `approx`/`oversample` are accepted for config
    compatibility: the selection is exact top-k, which is what the
    reference computes off the TPU (see kernels/nn_plain.py). CUDA tensors
    take KN (kernels/knn_cuda.py, one call, no fallback), CPU tensors the
    plain version `normals_knn_ref`.
    """
    del approx, oversample
    if points.device.type == "cpu":
        return normals_knn_ref(points, mask, k, viewpoint, ref_stride)
    return knn_cuda.knn_normals(points.contiguous(), mask.contiguous(), k,
                                ref_stride, viewpoint)[0]
