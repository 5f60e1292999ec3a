"""SE(3) rigid-transform algebra on torch tensors, batched over leading dims.

Port of tpu_icp_slam/core/se3.py with the same conventions: transforms are
homogeneous (..., 4, 4) matrices, tangent vectors (..., 6) are [rho, phi]
(translation part first), exp(xi) = [[exp(phi^), V(phi) rho], [0, 1]].
Small-angle and near-pi cases use the reference's branch-free Taylor
fallbacks (`torch.where`), so the same inputs take the same branch.
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
    return torch.stack(
        [
            torch.stack([z, -wz, wy], dim=-1),
            torch.stack([wz, z, -wx], dim=-1),
            torch.stack([-wy, wx, z], dim=-1),
        ],
        dim=-2,
    )


def vee(W: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) skew -> (..., 3)."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


def _so3_coeffs(theta_sq: torch.Tensor):
    """(A, B, C) with exp(W) = I + A W + B W², V = I + B W + C W²:
    A = sin t / t, B = (1 - cos t)/t², C = (t - sin t)/t³, Taylor below 1e-8."""
    theta = torch.sqrt(theta_sq + _EPS * _EPS)
    small = theta_sq < 1e-8
    A = torch.where(small, 1.0 - theta_sq / 6.0, torch.sin(theta) / theta)
    B = torch.where(small, 0.5 - theta_sq / 24.0,
                    (1.0 - torch.cos(theta)) / theta_sq)
    C = torch.where(small, 1.0 / 6.0 - theta_sq / 120.0,
                    (theta - torch.sin(theta)) / (theta_sq * theta))
    return A, B, C


def so3_exp(phi: torch.Tensor) -> torch.Tensor:
    """(..., 3) rotation vector -> (..., 3, 3) rotation matrix (Rodrigues)."""
    theta_sq = torch.sum(phi * phi, dim=-1)
    A, B, _ = _so3_coeffs(theta_sq)
    W = hat(phi)
    return _eye(3, phi) + A[..., None, None] * W + B[..., None, None] * (W @ W)


def so3_left_jacobian(phi: torch.Tensor) -> torch.Tensor:
    """Left Jacobian V of SO(3): (..., 3) -> (..., 3, 3)."""
    theta_sq = torch.sum(phi * phi, dim=-1)
    _, B, C = _so3_coeffs(theta_sq)
    W = hat(phi)
    return _eye(3, phi) + B[..., None, None] * W + C[..., None, None] * (W @ W)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotation matrix -> (..., 3) rotation vector; near pi the
    axis is read off the dominant diagonal row of (R + Rᵀ)/2 - cos I."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    theta = torch.arccos(cos_theta)
    sin_theta = torch.sin(theta)
    vec = vee(R - R.transpose(-1, -2))  # = 2 sin(theta) * axis
    small = theta < 1e-4
    factor_generic = theta / torch.where(
        sin_theta < 1e-12, torch.ones_like(sin_theta), 2.0 * sin_theta)
    factor_small = 0.5 + theta * theta / 12.0
    factor = torch.where(small, factor_small, factor_generic)
    phi_generic = factor[..., None] * vec

    S = 0.5 * (R + R.transpose(-1, -2))
    M = S - cos_theta[..., None, None] * _eye(3, R)
    diag = torch.stack([M[..., 0, 0], M[..., 1, 1], M[..., 2, 2]], dim=-1)
    k = torch.argmax(diag, dim=-1)
    row = torch.gather(
        M, -2, k[..., None, None].expand(*k.shape, 1, 3))[..., 0, :]
    axis_pi = row / torch.clamp(
        torch.linalg.vector_norm(row, dim=-1, keepdim=True), min=1e-12)
    dot = torch.sum(axis_pi * vec, dim=-1, keepdim=True)
    axis_pi = torch.where(dot < 0.0, -axis_pi, axis_pi)
    phi_pi = theta[..., None] * axis_pi

    near_pi = theta > (math.pi - 1e-3)
    return torch.where(near_pi[..., None], phi_pi, phi_generic)


def exp(xi: torch.Tensor) -> torch.Tensor:
    """se(3) tangent (..., 6) [rho, phi] -> (..., 4, 4) transform."""
    rho, phi = xi[..., :3], xi[..., 3:]
    R = so3_exp(phi)
    V = so3_left_jacobian(phi)
    t = torch.einsum("...ij,...j->...i", V, rho)
    return from_rt(R, t)


def log(T: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) -> (..., 6) [rho, phi]."""
    R, t = rotation(T), translation(T)
    phi = so3_log(R)
    # V^{-1} = I - W/2 + D W², D = 1/t² - (1 + cos t)/(2 t sin t)
    theta_sq = torch.sum(phi * phi, dim=-1)
    theta = torch.sqrt(theta_sq + _EPS * _EPS)
    small = theta_sq < 1e-8
    one = torch.ones_like(theta_sq)
    D = torch.where(
        small,
        1.0 / 12.0 + theta_sq / 720.0,
        (1.0 / torch.where(small, one, theta_sq))
        - (1.0 + torch.cos(theta))
        / torch.where(small, one, 2.0 * theta * torch.sin(theta)),
    )
    W = hat(phi)
    Vinv = _eye(3, T) - 0.5 * W + D[..., None, None] * (W @ W)
    rho = torch.einsum("...ij,...j->...i", Vinv, t)
    return torch.cat([rho, phi], dim=-1)


def from_rt(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3), (..., 3) -> (..., 4, 4)."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = R.expand(*batch, 3, 3)
    t = t.expand(*batch, 3)
    top = torch.cat([R, t[..., :, None]], dim=-1)
    # built on the device: a tensor from a host list is a synchronizing copy
    bottom = torch.zeros(*batch, 1, 4, dtype=R.dtype, device=R.device)
    bottom[..., 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def rotation(T: torch.Tensor) -> torch.Tensor:
    return T[..., :3, :3]


def translation(T: torch.Tensor) -> torch.Tensor:
    return T[..., :3, 3]


def identity(dtype=torch.float32, batch: tuple = (),
             device: torch.device | str = "cuda") -> torch.Tensor:
    return torch.eye(4, dtype=dtype, device=device).expand(*batch, 4, 4)


def compose(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    return A @ B


def inverse(T: torch.Tensor) -> torch.Tensor:
    Rt = rotation(T).transpose(-1, -2)
    return from_rt(Rt, -torch.einsum("...ij,...j->...i", Rt, translation(T)))


def apply(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply (..., 4, 4) to points (..., N, 3) -> (..., N, 3)."""
    R = rotation(T)
    t = translation(T)
    return torch.einsum("...ij,...nj->...ni", R, pts) + t[..., None, :]


def rotation_geodesic(Ra: torch.Tensor, Rb: torch.Tensor) -> torch.Tensor:
    """Geodesic angle (radians) between rotations."""
    M = Ra.transpose(-1, -2) @ Rb
    trace = M[..., 0, 0] + M[..., 1, 1] + M[..., 2, 2]
    return torch.arccos(torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0))


def adjoint(T: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) -> (..., 6, 6) adjoint for the [rho, phi] tangent order:
    Ad(T) = [[R, [t]x R], [0, R]], so T exp(xi) T⁻¹ = exp(Ad(T) xi)."""
    R, t = rotation(T), translation(T)
    top = torch.cat([R, hat(t) @ R], dim=-1)
    bottom = torch.cat([torch.zeros_like(R), R], dim=-1)
    return torch.cat([top, bottom], dim=-2)


def ad(xi: torch.Tensor) -> torch.Tensor:
    """se(3) little adjoint: ad(xi) = [[phi^, rho^], [0, phi^]] (..., 6, 6)."""
    px, rx = hat(xi[..., 3:]), hat(xi[..., :3])
    top = torch.cat([px, rx], dim=-1)
    bottom = torch.cat([torch.zeros_like(px), px], dim=-1)
    return torch.cat([top, bottom], dim=-2)


def right_jacobian_inv(xi: torch.Tensor) -> torch.Tensor:
    """Second-order Jr⁻¹(xi) ≈ I + ad(xi)/2 + ad(xi)²/12, as the reference
    (exact enough for pose-graph Gauss-Newton, whose residuals are small)."""
    A = ad(xi)
    return _eye(6, xi) + 0.5 * A + (A @ A) / 12.0
