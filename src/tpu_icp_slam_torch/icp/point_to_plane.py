"""Point-to-plane Gauss-Newton step (port of tpu_icp_slam/icp/point_to_plane.py).

Residual r = nᵀ(p − q), Jacobian row [nᵀ, (p×n)ᵀ] in 3D, [nᵀ, p×n] (the
scalar 2D cross product) in 2D (translation first, the core.se3 / core.se2
tangent order). 3D H and g come from kernel K2 (kernels/gn_cuda.py) or its
plain version; 2D ones from plain torch ops, as the reference builds them
with XLA. The solve is a damped Cholesky with step clamps or, with
degen_eps > 0, the reference's eigen-remap.
"""

from __future__ import annotations

import torch

from tpu_icp_slam_torch.core import se2, se3
from tpu_icp_slam_torch.kernels.gn_cuda import gn_accum, gn_accum_ref


def build_normal_equations(p: torch.Tensor, q: torch.Tensor, n: torch.Tensor,
                           w: torch.Tensor):
    """H (K, K), g (K,) for K = 6 (3D, K2's plain version) or 3 (2D);
    batched (B, M, D) rows -> (B, K, K), (B, K)."""
    d = p.shape[-1]
    if d == 3:
        return gn_accum_ref(p, q, n, w)
    if d != 2:
        raise ValueError(f"unsupported dim {d}")
    r = torch.sum(n * (p - q), dim=-1)
    cross2 = p[..., 0] * n[..., 1] - p[..., 1] * n[..., 0]
    J = torch.cat([n, cross2[..., None]], dim=-1)  # (.., M, 3)
    Jw = J * w[..., None]
    if p.dim() == 2:
        return J.T @ Jw, Jw.T @ r
    return J.mT @ Jw, (Jw.mT @ r[..., None])[..., 0]


def _trace(H: torch.Tensor) -> torch.Tensor:
    """torch.trace of each matrix of H (..., k, k), summed as torch.trace
    sums one: on the CPU in index order in float64, then rounded to H's
    type; on CUDA the diagonal's sum."""
    d = torch.diagonal(H, dim1=-2, dim2=-1)
    if H.device.type != "cpu":
        return d.sum(-1)
    t = d[..., 0].double()
    for i in range(1, d.shape[-1]):
        t = t + d[..., i].double()
    return t.to(H.dtype)


def solve_increment(H: torch.Tensor, g: torch.Tensor, damping: float,
                    max_step_trans: float = 0.0, max_step_rot: float = 0.0,
                    degen_eps: float = 0.0, prior_w=None, xi_prior=None
                    ) -> torch.Tensor:
    """Damped solve of H xi = -g with optional per-block trust clamps.

    prior_w (k,) + xi_prior (k,) add the Tikhonov motion prior
    (H += diag(prior_w), g += prior_w * xi_prior) before anything else, so
    a prior-held direction counts as observed. A system that is not
    positive definite, or a non-finite result, gives a zero update — the
    reference's NaN-from-Cholesky guard. `cholesky_ex` reports failure in
    `info` instead of raising (and does not sync the device).

    degen_eps > 0 solves in the eigenbasis of the UNdamped H (damping
    would lift the spectrum's floor and hide the degeneracy) and zeroes the
    update along eigendirections whose eigenvalue is at most degen_eps × the
    largest: xi = −V diag(keep / (e + λ)) Vᵀ g. It is off by default; see
    the reference's docstring for where a relative threshold freezes the
    pose.

    Batched, H (..., k, k) and g (..., k) (prior_w, xi_prior (..., k)):
    every row is solved on its own, its trace, damping, guard and clamps its
    own, as the reference's vmap of this function computes; one call of
    each torch op for the whole batch. On the CPU each row of the Cholesky
    path is bit-equal to the unbatched call on it; the eigen path
    (degen_eps > 0) projects with batched products, which may round
    otherwise than the unbatched matrix-vector products.
    """
    if H.dim() > 2:
        return _solve_batched(H, g, damping, max_step_trans, max_step_rot,
                              degen_eps, prior_w, xi_prior)
    k = H.shape[0]
    if prior_w is not None:
        H = H + torch.diag(prior_w)
        g = g + prior_w * xi_prior
    lam = damping * torch.clamp(torch.trace(H) / k, min=1.0)
    if degen_eps > 0.0:
        evals, V = torch.linalg.eigh(H)
        keep = (evals > degen_eps * torch.clamp(evals[-1], min=1e-12)).to(
            H.dtype)
        xi = -(V @ (keep * (V.T @ g) / (evals + lam)))
        ok = torch.all(torch.isfinite(xi))
    else:
        Hd = H + lam * torch.eye(k, dtype=H.dtype, device=H.device)
        L, info = torch.linalg.cholesky_ex(Hd)
        y = torch.linalg.solve_triangular(L, -g[:, None], upper=False)
        xi = torch.linalg.solve_triangular(L.T, y, upper=True)[:, 0]
        ok = (info == 0) & torch.all(torch.isfinite(xi))
    xi = torch.where(ok, xi, torch.zeros_like(xi))
    d = 3 if k == 6 else 2  # tangent layout: [t (d), w (k - d)]
    if max_step_trans > 0.0:
        tn = torch.linalg.vector_norm(xi[:d])
        xi = xi * torch.clamp(max_step_trans / torch.clamp(tn, min=1e-12),
                              max=1.0)
    if max_step_rot > 0.0:
        wn = torch.linalg.vector_norm(xi[d:])
        xi = xi * torch.clamp(max_step_rot / torch.clamp(wn, min=1e-12),
                              max=1.0)
    return xi


def _solve_batched(H, g, damping, max_step_trans, max_step_rot, degen_eps,
                   prior_w, xi_prior) -> torch.Tensor:
    """`solve_increment` of every row of H (..., k, k), g (..., k)."""
    k = H.shape[-1]
    if prior_w is not None:
        H = H + torch.diag_embed(prior_w)
        g = g + prior_w * xi_prior
    lam = damping * torch.clamp(_trace(H) / k, min=1.0)
    if degen_eps > 0.0:
        evals, V = torch.linalg.eigh(H)
        keep = (evals > degen_eps * torch.clamp(evals[..., -1:], min=1e-12)
                ).to(H.dtype)
        proj = (V.mT @ g[..., None])[..., 0]
        xi = -(V @ (keep * proj / (evals + lam[..., None]))[..., None])[
            ..., 0]
        ok = torch.all(torch.isfinite(xi), dim=-1)
    else:
        Hd = H + lam[..., None, None] * torch.eye(k, dtype=H.dtype,
                                                  device=H.device)
        L, info = torch.linalg.cholesky_ex(Hd)
        y = torch.linalg.solve_triangular(L, -g[..., None], upper=False)
        xi = torch.linalg.solve_triangular(L.mT, y, upper=True)[..., 0]
        ok = (info == 0) & torch.all(torch.isfinite(xi), dim=-1)
    xi = torch.where(ok[..., None], xi, torch.zeros_like(xi))
    d = 3 if k == 6 else 2  # tangent layout: [t (d), w (k - d)]
    if max_step_trans > 0.0:
        tn = torch.linalg.vector_norm(xi[..., :d], dim=-1, keepdim=True)
        xi = xi * torch.clamp(max_step_trans / torch.clamp(tn, min=1e-12),
                              max=1.0)
    if max_step_rot > 0.0:
        wn = torch.linalg.vector_norm(xi[..., d:], dim=-1, keepdim=True)
        xi = xi * torch.clamp(max_step_rot / torch.clamp(wn, min=1e-12),
                              max=1.0)
    return xi


def gauss_newton_step(p: torch.Tensor, q: torch.Tensor, n: torch.Tensor,
                      w: torch.Tensor, damping: float = 1e-6,
                      max_step_trans: float = 0.0, max_step_rot: float = 0.0,
                      backend: str = "auto", degen_eps: float = 0.0,
                      prior_w=None, xi_prior=None) -> torch.Tensor:
    """One damped GN update: dT (D+1, D+1) to left-compose onto T.

    3D: backend "auto"/"pallas" runs kernel K2 (its plain version on CPU
    tensors); "xla" runs the plain normal-equation assembly on any device.
    2D always runs the plain assembly, as the reference does.
    """
    if backend not in ("auto", "pallas", "xla"):
        raise ValueError(f"unknown GN backend: {backend}")
    if backend in ("auto", "pallas") and p.shape[-1] == 3:
        H, g = gn_accum(p, q, n, w)
    else:
        H, g = build_normal_equations(p, q, n, w)
    xi = solve_increment(H, g, damping, max_step_trans, max_step_rot,
                         degen_eps=degen_eps, prior_w=prior_w,
                         xi_prior=xi_prior)
    return se3.exp(xi) if p.shape[-1] == 3 else se2.exp(xi)
