"""Point-to-point rigid solve: masked/weighted Umeyama (port of
tpu_icp_slam/icp/point_to_point.py).

Centroids and the D×D cross-covariance are masked reductions; the rigid fit
from them, `rigid_from_stats`, is batched over leading dims (loop-closure
verification solves candidates × yaw hypotheses at once). On CUDA tensors
it is RF (kernels/rigid_cuda.py, csrc/rigid_fit.cu): one launch and no host
read, where `torch.linalg.svd` checks its info on the host every call. On
CPU tensors it is the plain version, `rigid_from_stats_ref`, the
reference's SVD form. Two entry forms, as in the reference:
`umeyama_masked` (centred accumulation) and `moments` +
`umeyama_from_moments` (raw sums, reducible across devices); both end in
`rigid_from_stats`.
"""

from __future__ import annotations

import torch

from tpu_icp_slam_torch.kernels import rigid_cuda


def rigid_from_stats_ref(cov: torch.Tensor, mu_s: torch.Tensor,
                         mu_d: torch.Tensor) -> torch.Tensor:
    """Plain torch: (..., D, D) cross-covariance E_w[(dst - mu_d)(src -
    mu_s)ᵀ] + centroids -> (..., D+1, D+1) transform; SVD with reflection
    correction (the last left-singular column scaled by sign det(U Vᵀ))."""
    d = cov.shape[-1]
    U, _, Vt = torch.linalg.svd(cov)
    sign = torch.sign(torch.linalg.det(U @ Vt))
    d_vec = torch.ones((*sign.shape, d), dtype=cov.dtype, device=cov.device)
    d_vec[..., -1] = sign
    R = (U * d_vec[..., None, :]) @ Vt
    t = mu_d - torch.einsum("...ij,...j->...i", R, mu_s)
    T = torch.zeros((*R.shape[:-2], d + 1, d + 1), dtype=cov.dtype,
                    device=cov.device)
    T[..., :d, :d] = R
    T[..., :d, d] = t
    T[..., d, d] = 1.0
    return T


def rigid_from_stats(cov: torch.Tensor, mu_s: torch.Tensor,
                     mu_d: torch.Tensor) -> torch.Tensor:
    """rigid_from_stats_ref's function: the plain version on CPU tensors,
    one RF launch on CUDA tensors (float32, D = 2 or 3); anything else
    raises."""
    devices = {t.device.type for t in (cov, mu_s, mu_d)}
    if devices == {"cpu"}:
        return rigid_from_stats_ref(cov, mu_s, mu_d)
    if devices != {"cuda"}:
        raise ValueError(f"rigid_from_stats: inputs on {sorted(devices)}, "
                         "not all on the CPU or all on CUDA")
    T = rigid_cuda.rigid_fit(cov, mu_s, mu_d)
    rigid_from_stats.launches += 1
    return T


rigid_from_stats.launches = 0  # RF launches


def umeyama_masked(src: torch.Tensor, dst: torch.Tensor,
                   weights: torch.Tensor) -> torch.Tensor:
    """Weighted rigid least squares: T (..., D+1, D+1) with dst ≈ R src + t.

    src, dst: (..., M, D) paired points; weights (..., M) >= 0 (zeros =
    padding or gated correspondences)."""
    w = weights[..., None]  # (..., M, 1)
    wsum = torch.clamp(torch.sum(w, dim=-2, keepdim=True), min=1e-12)
    mu_s = torch.sum(w * src, dim=-2, keepdim=True) / wsum  # (..., 1, D)
    mu_d = torch.sum(w * dst, dim=-2, keepdim=True) / wsum
    xs = (src - mu_s) * w
    xd = dst - mu_d
    cov = xd.transpose(-1, -2) @ xs / wsum  # (..., D, D)
    return rigid_from_stats(cov, mu_s[..., 0, :], mu_d[..., 0, :])


def moments(src: torch.Tensor, dst: torch.Tensor, weights: torch.Tensor):
    """Raw weighted moments of a correspondence set, all sums: (wsum (...,),
    s_src (..., D), s_dst (..., D), s_ds (..., D, D)) with
    s_ds = Σ w · dst ⊗ src (dst rows, src cols)."""
    w = weights[..., None]
    wsum = torch.sum(weights, dim=-1)
    s_src = torch.sum(w * src, dim=-2)
    s_dst = torch.sum(w * dst, dim=-2)
    s_ds = dst.transpose(-1, -2) @ (w * src)
    return wsum, s_src, s_dst, s_ds


def umeyama_from_moments(wsum, s_src, s_dst, s_ds) -> torch.Tensor:
    """Rigid solve from (possibly collective-reduced) raw moments."""
    ws = torch.clamp(wsum, min=1e-12)[..., None]
    mu_s = s_src / ws  # (..., D)
    mu_d = s_dst / ws
    cov = s_ds / ws[..., None] - mu_d[..., :, None] * mu_s[..., None, :]
    return rigid_from_stats(cov, mu_s, mu_d)
