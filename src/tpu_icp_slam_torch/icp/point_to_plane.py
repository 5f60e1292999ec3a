"""Point-to-plane Gauss-Newton step (port of tpu_icp_slam/icp/point_to_plane.py).

Residual r = nᵀ(p − q), Jacobian row [nᵀ, (p×n)ᵀ] (translation first, the
core.se3 tangent order). H and g come from kernel K2 (kernels/gn_cuda.py)
or its plain version; the solve is a damped 6×6 Cholesky with step clamps.
"""

from __future__ import annotations

import torch

from tpu_icp_slam_torch.core import se3
from tpu_icp_slam_torch.kernels.gn_cuda import gn_accum, gn_accum_ref

# plain normal-equation assembly IS K2's plain version
build_normal_equations = gn_accum_ref


def solve_increment(H: torch.Tensor, g: torch.Tensor, damping: float,
                    max_step_trans: float = 0.0, max_step_rot: float = 0.0,
                    degen_eps: float = 0.0, prior_w=None, xi_prior=None
                    ) -> torch.Tensor:
    """Damped solve of H xi = -g with optional per-block trust clamps.

    prior_w (6,) + xi_prior (6,) add the Tikhonov motion prior
    (H += diag(prior_w), g += prior_w * xi_prior). A system that is not
    positive definite, or a non-finite result, gives a zero update — the
    reference's NaN-from-Cholesky guard. `cholesky_ex` reports failure in
    `info` instead of raising (and does not sync the device).
    """
    if degen_eps > 0.0:
        raise NotImplementedError("degen_eps > 0 is not ported yet")
    k = H.shape[0]
    if prior_w is not None:
        H = H + torch.diag(prior_w)
        g = g + prior_w * xi_prior
    lam = damping * torch.clamp(torch.trace(H) / k, min=1.0)
    Hd = H + lam * torch.eye(k, dtype=H.dtype, device=H.device)
    L, info = torch.linalg.cholesky_ex(Hd)
    y = torch.linalg.solve_triangular(L, -g[:, None], upper=False)
    xi = torch.linalg.solve_triangular(L.T, y, upper=True)[:, 0]
    ok = (info == 0) & torch.all(torch.isfinite(xi))
    xi = torch.where(ok, xi, torch.zeros_like(xi))
    if max_step_trans > 0.0:
        tn = torch.linalg.vector_norm(xi[:3])
        xi = xi * torch.clamp(max_step_trans / torch.clamp(tn, min=1e-12),
                              max=1.0)
    if max_step_rot > 0.0:
        wn = torch.linalg.vector_norm(xi[3:])
        xi = xi * torch.clamp(max_step_rot / torch.clamp(wn, min=1e-12),
                              max=1.0)
    return xi


def gauss_newton_step(p: torch.Tensor, q: torch.Tensor, n: torch.Tensor,
                      w: torch.Tensor, damping: float = 1e-6,
                      max_step_trans: float = 0.0, max_step_rot: float = 0.0,
                      backend: str = "auto", degen_eps: float = 0.0,
                      prior_w=None, xi_prior=None) -> torch.Tensor:
    """One damped GN update: dT (4, 4) to left-compose onto T.

    backend "auto"/"pallas" runs kernel K2 (its plain version on CPU
    tensors); "xla" runs the plain normal-equation assembly on any device.
    """
    if backend in ("auto", "pallas"):
        H, g = gn_accum(p, q, n, w)
    elif backend == "xla":
        H, g = build_normal_equations(p, q, n, w)
    else:
        raise ValueError(f"unknown GN backend: {backend}")
    xi = solve_increment(H, g, damping, max_step_trans, max_step_rot,
                         degen_eps=degen_eps, prior_w=prior_w,
                         xi_prior=xi_prior)
    return se3.exp(xi)
