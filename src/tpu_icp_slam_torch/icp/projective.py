"""Projective data association for RGB-D ICP (port of
tpu_icp_slam/icp/projective.py).

KinectFusion-style frame-to-model association: each source point, already
in the target camera's frame, is projected through the intrinsics and its
correspondence is read off the target's vertex and normal maps at that
pixel: O(M) gathers, no distance matrix. The reference does it with XLA
gathers and elementwise ops (no Pallas kernel); the port's lookup is one
launch of PJ (kernels/projective_cuda.py) on CUDA and its plain version,
torch indexing (`_lookup_ref`), on the CPU.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tpu_icp_slam_torch.kernels import projective_cuda


class CameraIntrinsics(NamedTuple):
    """Pinhole intrinsics of the depth camera."""

    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int


def _const(v: float, like: torch.Tensor) -> torch.Tensor:
    """v as a 0-dim float32 tensor on like's device. Dividing by a Python
    float lets CUDA multiply by its reciprocal instead (one bit lost); a
    device scalar keeps the reference's true division on both devices."""
    return torch.full((), v, dtype=torch.float32, device=like.device)


def backproject_depth(depth: torch.Tensor, K: CameraIntrinsics
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """(H, W) float32 depth -> ((H, W, 3) camera-frame vertex map, (H, W)
    validity)."""
    h, w = depth.shape
    dev = depth.device
    us = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
    vs = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    x = (us - K.cx) / _const(K.fx, depth) * depth
    y = (vs - K.cy) / _const(K.fy, depth) * depth
    return torch.stack([x, y, depth], dim=-1), depth > 0


def projective_correspondence(K: CameraIntrinsics, dst_vertex: torch.Tensor,
                              dst_normal: torch.Tensor,
                              dst_valid: torch.Tensor, max_corr_dist: float,
                              normal_gate_cos: float = -1.0,
                              src_normals: torch.Tensor | None = None):
    """Returns corr(cur_pts (M, 3)) -> (q, n, gate, d2) for icp.loop.

    cur_pts must already be in the target camera's frame (the ICP loop
    applies the running transform before calling corr). dst_vertex and
    dst_normal are (H, W, 3), dst_valid (H, W) bool. The normal gate applies
    only with src_normals, as in the reference.

    The pixel is round-half-to-even of u = x / z * fx + cx (and v), as the
    reference's; it is clamped to the image in float before the cast to an
    integer, which gives the reference's index for every point in the image
    and keeps points far outside it (z near 0) clear of an undefined cast.
    """
    h, w = dst_valid.shape
    max_d2 = max_corr_dist * max_corr_dist
    fx, fy = _const(K.fx, dst_vertex), _const(K.fy, dst_vertex)
    gate_normals = (src_normals if src_normals is not None
                    and normal_gate_cos > -1.0 else None)
    fxy = torch.stack([fx, fy])  # PJ's (fx, fy)

    def corr(cur_pts: torch.Tensor):
        if cur_pts.device.type == "cpu":
            return _lookup_ref(K, dst_vertex, dst_normal, dst_valid, fx, fy,
                               max_d2, normal_gate_cos, gate_normals,
                               cur_pts)
        return projective_cuda.projective_lookup(
            cur_pts, dst_vertex, dst_normal, dst_valid, fxy, K.cx, K.cy,
            max_d2, gate_normals, normal_gate_cos)

    return corr


def _lookup_ref(K: CameraIntrinsics, dst_vertex, dst_normal, dst_valid, fx,
                fy, max_d2: float, normal_gate_cos: float, src_normals,
                cur_pts: torch.Tensor):
    """The lookup of `projective_correspondence`'s corr in torch ops: PJ's
    plain version, and the CPU's path."""
    h, w = dst_valid.shape
    z = cur_pts[:, 2]
    front = z > 1e-6
    safe_z = torch.where(front, z, torch.ones_like(z))
    u = cur_pts[:, 0] / safe_z * fx + K.cx
    v = cur_pts[:, 1] / safe_z * fy + K.cy
    ui = torch.clamp(torch.round(u), 0, w - 1).long()
    vi = torch.clamp(torch.round(v), 0, h - 1).long()
    inb = front & (u >= -0.5) & (u <= w - 0.5) & (v >= -0.5) & (
        v <= h - 0.5)
    q = dst_vertex[vi, ui]  # (M, 3)
    n = dst_normal[vi, ui]
    ok = inb & dst_valid[vi, ui]
    diff = cur_pts - q
    d2 = torch.sum(diff * diff, dim=-1)
    gate = ok & (d2 <= max_d2)
    if src_normals is not None:
        gate = gate & (torch.sum(src_normals * n, dim=-1) >= normal_gate_cos)
    return q, n, gate.to(cur_pts.dtype), d2
