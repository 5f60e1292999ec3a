"""RF: the rigid fit of a point-to-point ICP step — the CUDA launch.

`rigid_fit(cov, mu_s, mu_d)` launches csrc/rigid_fit.cu on CUDA tensors:
cov (..., D, D), mu_s and mu_d (..., D) float32, D = 2 or 3, any leading
batch -> T (..., D+1, D+1), the weighted Umeyama transform with the
reflection correction (tpu_icp_slam/icp/point_to_point.py::rigid_from_stats,
whose jnp.linalg.svd at :33 RF replaces). One launch, one thread an
element, on the current stream, and no host read: the launch error is
checked, never the device.

The dispatch, the plain version and the launch counter live in
icp/point_to_point.py (`rigid_from_stats`, `rigid_from_stats_ref`,
`rigid_from_stats.launches`).
"""

from __future__ import annotations

import torch

from tpu_icp_slam_torch.kernels import _build


def rigid_fit(cov: torch.Tensor, mu_s: torch.Tensor,
              mu_d: torch.Tensor) -> torch.Tensor:
    """(..., D, D), (..., D), (..., D) float32 on one CUDA device ->
    (..., D+1, D+1) float32."""
    d = cov.shape[-1]
    lead = tuple(cov.shape[:-2])
    if cov.dim() < 2 or d not in (2, 3) or cov.shape[-2] != d:
        raise ValueError(f"rigid_fit: cov must be (..., D, D) with D 2 or "
                         f"3, got {tuple(cov.shape)}")
    for name, t, shape in (("cov", cov, (*lead, d, d)),
                           ("mu_s", mu_s, (*lead, d)),
                           ("mu_d", mu_d, (*lead, d))):
        if t.device.type != "cuda" or t.device != cov.device:
            raise ValueError(f"rigid_fit: {name} must be on cov's CUDA "
                             f"device, got {t.device}")
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"rigid_fit: {name} must be float32 {shape}, "
                             f"got {t.dtype} {tuple(t.shape)}")
    batch = cov.numel() // (d * d)
    # held until the launch: a freed copy could be reused before it runs
    cov, mu_s, mu_d = (t.contiguous() for t in (cov, mu_s, mu_d))
    T = torch.empty((*lead, d + 1, d + 1), dtype=torch.float32,
                    device=cov.device)
    err = _build.load().rigid_fit_f32(
        cov.data_ptr(), mu_s.data_ptr(), mu_d.data_ptr(), batch, d,
        T.data_ptr(), torch.cuda.current_stream(cov.device).cuda_stream)
    _build.check(err, "rigid_fit_f32")
    return T
