"""SE(3) algebra for the plain reference, batched over leading dims.

A frozen copy of the functions of `tpu_icp_slam_torch/core/se3.py` that
the reference needs, with its conventions: (..., 4, 4) homogeneous
transforms, tangent vectors [rho, phi] (translation first), the same
small-angle and near-pi branches.
"""

from __future__ import annotations

import math

import torch

_EPS = 1e-8


def _eye(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(n, dtype=like.dtype, device=like.device)


def hat(w: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) skew-symmetric matrix."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack([torch.stack([z, -wz, wy], dim=-1),
                        torch.stack([wz, z, -wx], dim=-1),
                        torch.stack([-wy, wx, z], dim=-1)], dim=-2)


def vee(W: torch.Tensor) -> torch.Tensor:
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


def _so3_coeffs(theta_sq: torch.Tensor):
    theta = torch.sqrt(theta_sq + _EPS * _EPS)
    small = theta_sq < 1e-8
    A = torch.where(small, 1.0 - theta_sq / 6.0, torch.sin(theta) / theta)
    B = torch.where(small, 0.5 - theta_sq / 24.0,
                    (1.0 - torch.cos(theta)) / theta_sq)
    C = torch.where(small, 1.0 / 6.0 - theta_sq / 120.0,
                    (theta - torch.sin(theta)) / (theta_sq * theta))
    return A, B, C


def so3_log(R: torch.Tensor) -> torch.Tensor:
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    theta = torch.arccos(cos_theta)
    sin_theta = torch.sin(theta)
    vec = vee(R - R.transpose(-1, -2))  # = 2 sin(theta) * axis
    small = theta < 1e-4
    factor_generic = theta / torch.where(
        sin_theta < 1e-12, torch.ones_like(sin_theta), 2.0 * sin_theta)
    factor = torch.where(small, 0.5 + theta * theta / 12.0, factor_generic)
    phi_generic = factor[..., None] * vec
    S = 0.5 * (R + R.transpose(-1, -2))
    M = S - cos_theta[..., None, None] * _eye(3, R)
    diag = torch.stack([M[..., 0, 0], M[..., 1, 1], M[..., 2, 2]], dim=-1)
    k = torch.argmax(diag, dim=-1)
    row = torch.gather(M, -2, k[..., None, None].expand(*k.shape, 1, 3))[
        ..., 0, :]
    axis_pi = row / torch.clamp(
        torch.linalg.vector_norm(row, dim=-1, keepdim=True), min=1e-12)
    dot = torch.sum(axis_pi * vec, dim=-1, keepdim=True)
    axis_pi = torch.where(dot < 0.0, -axis_pi, axis_pi)
    near_pi = theta > (math.pi - 1e-3)
    return torch.where(near_pi[..., None], theta[..., None] * axis_pi,
                       phi_generic)


def from_rt(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = R.expand(*batch, 3, 3)
    t = t.expand(*batch, 3)
    top = torch.cat([R, t[..., :, None]], dim=-1)
    bottom = torch.zeros(*batch, 1, 4, dtype=R.dtype, device=R.device)
    bottom[..., 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def exp(xi: torch.Tensor) -> torch.Tensor:
    """(..., 6) [rho, phi] -> (..., 4, 4)."""
    rho, phi = xi[..., :3], xi[..., 3:]
    theta_sq = torch.sum(phi * phi, dim=-1)
    A, B, C = _so3_coeffs(theta_sq)
    W = hat(phi)
    WW = W @ W
    R = _eye(3, phi) + A[..., None, None] * W + B[..., None, None] * WW
    V = _eye(3, phi) + B[..., None, None] * W + C[..., None, None] * WW
    return from_rt(R, torch.einsum("...ij,...j->...i", V, rho))


def log(T: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) -> (..., 6) [rho, phi]."""
    R, t = T[..., :3, :3], T[..., :3, 3]
    phi = so3_log(R)
    theta_sq = torch.sum(phi * phi, dim=-1)
    theta = torch.sqrt(theta_sq + _EPS * _EPS)
    small = theta_sq < 1e-8
    one = torch.ones_like(theta_sq)
    D = torch.where(
        small, 1.0 / 12.0 + theta_sq / 720.0,
        (1.0 / torch.where(small, one, theta_sq))
        - (1.0 + torch.cos(theta))
        / torch.where(small, one, 2.0 * theta * torch.sin(theta)))
    W = hat(phi)
    Vinv = _eye(3, T) - 0.5 * W + D[..., None, None] * (W @ W)
    return torch.cat([torch.einsum("...ij,...j->...i", Vinv, t), phi], dim=-1)


def inverse(T: torch.Tensor) -> torch.Tensor:
    Rt = T[..., :3, :3].transpose(-1, -2)
    return from_rt(Rt, -torch.einsum("...ij,...j->...i", Rt, T[..., :3, 3]))


def rotation_angle(R: torch.Tensor) -> torch.Tensor:
    """Geodesic angle of R from the identity (radians)."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    return torch.arccos(torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0))


def adjoint(T: torch.Tensor) -> torch.Tensor:
    R, t = T[..., :3, :3], T[..., :3, 3]
    top = torch.cat([R, hat(t) @ R], dim=-1)
    bottom = torch.cat([torch.zeros_like(R), R], dim=-1)
    return torch.cat([top, bottom], dim=-2)


def right_jacobian_inv(xi: torch.Tensor) -> torch.Tensor:
    """Second-order Jr⁻¹(xi) ≈ I + ad(xi)/2 + ad(xi)²/12."""
    px, rx = hat(xi[..., 3:]), hat(xi[..., :3])
    ad = torch.cat([torch.cat([px, rx], dim=-1),
                    torch.cat([torch.zeros_like(px), px], dim=-1)], dim=-2)
    return _eye(6, xi) + 0.5 * ad + (ad @ ad) / 12.0
