"""SE(2) rigid-transform algebra on torch tensors, batched over leading dims.

Port of tpu_icp_slam/core/se2.py with the same conventions: transforms are
homogeneous (..., 3, 3) matrices, tangents (..., 3) are [rho_x, rho_y, phi]
(translation first); the small-angle cases take the reference's branch-free
Taylor fallbacks (`torch.where`). Used by the 2D lidar pipeline (SE(2)
ICP, the occupancy grid, Slam2D).
"""

from __future__ import annotations

import torch


def _v_coeffs(phi: torch.Tensor):
    """(a, b) with V = [[a, -b], [b, a]] = the left Jacobian of SO(2):
    a = sin(phi)/phi, b = (1 - cos(phi))/phi, Taylor below 1e-5."""
    c, s = torch.cos(phi), torch.sin(phi)
    small = torch.abs(phi) < 1e-5
    phi_safe = torch.where(small, torch.ones_like(phi), phi)
    a = torch.where(small, 1.0 - phi * phi / 6.0, s / phi_safe)
    b = torch.where(small, phi / 2.0, (1.0 - c) / phi_safe)
    return c, s, a, b


def exp(xi: torch.Tensor) -> torch.Tensor:
    """(..., 3) [rho, phi] -> (..., 3, 3)."""
    rho, phi = xi[..., :2], xi[..., 2]
    c, s, a, b = _v_coeffs(phi)
    tx = a * rho[..., 0] - b * rho[..., 1]
    ty = b * rho[..., 0] + a * rho[..., 1]
    return from_rt_theta(c, s, torch.stack([tx, ty], dim=-1))


def log(T: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> (..., 3) [rho, phi]."""
    phi = torch.atan2(T[..., 1, 0], T[..., 0, 0])
    t = T[..., :2, 2]
    _, _, a, b = _v_coeffs(phi)
    det = a * a + b * b
    # V^{-1} = 1/det [[a, b], [-b, a]]
    rx = (a * t[..., 0] + b * t[..., 1]) / det
    ry = (-b * t[..., 0] + a * t[..., 1]) / det
    return torch.stack([rx, ry, phi], dim=-1)


def from_rt_theta(c: torch.Tensor, s: torch.Tensor, t: torch.Tensor
                  ) -> torch.Tensor:
    """cos, sin (...,) and translation (..., 2) -> (..., 3, 3)."""
    batch = torch.broadcast_shapes(c.shape, t.shape[:-1])
    c = c.expand(batch)
    s = s.expand(batch)
    t = t.expand(*batch, 2)
    z = torch.zeros(batch, dtype=t.dtype, device=t.device)
    one = torch.ones(batch, dtype=t.dtype, device=t.device)
    row0 = torch.stack([c, -s, t[..., 0]], dim=-1)
    row1 = torch.stack([s, c, t[..., 1]], dim=-1)
    row2 = torch.stack([z, z, one], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def from_xytheta(x, y, theta, device: torch.device | str = "cpu"
                 ) -> torch.Tensor:
    x, y, theta = (torch.as_tensor(v, dtype=torch.float32, device=device)
                   for v in (x, y, theta))
    return from_rt_theta(torch.cos(theta), torch.sin(theta),
                         torch.stack([x, y], dim=-1))


def to_xytheta(T: torch.Tensor) -> torch.Tensor:
    return torch.stack([T[..., 0, 2], T[..., 1, 2],
                        torch.atan2(T[..., 1, 0], T[..., 0, 0])], dim=-1)


def identity(dtype=torch.float32, batch: tuple = (),
             device: torch.device | str = "cpu") -> torch.Tensor:
    return torch.eye(3, dtype=dtype, device=device).expand(*batch, 3, 3)


def compose(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    return A @ B


def inverse(T: torch.Tensor) -> torch.Tensor:
    Rt = T[..., :2, :2].transpose(-1, -2)
    tinv = -torch.einsum("...ij,...j->...i", Rt, T[..., :2, 2])
    return from_rt_theta(Rt[..., 0, 0], Rt[..., 1, 0], tinv)


def apply(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) x (..., N, 2) -> (..., N, 2)."""
    return (torch.einsum("...ij,...nj->...ni", T[..., :2, :2], pts)
            + T[..., None, :2, 2])


def to_se3(T2: torch.Tensor) -> torch.Tensor:
    """Embed SE(2) into SE(3) (z = 0, rotation about z)."""
    batch = T2.shape[:-2]
    T3 = torch.eye(4, dtype=T2.dtype, device=T2.device).repeat(*batch, 1, 1)
    T3[..., :2, :2] = T2[..., :2, :2]
    T3[..., :2, 3] = T2[..., :2, 2]
    return T3
