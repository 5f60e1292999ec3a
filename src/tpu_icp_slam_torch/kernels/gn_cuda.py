"""K2: point-to-plane Gauss-Newton accumulation — CUDA kernel and plain version.

`gn_accum(p, q, n, w)` launches csrc/gn_accum.cu on CUDA tensors (the port
of tpu_icp_slam/kernels/gn_pallas.py::_gn_kernel) and runs `gn_accum_ref`
on CPU tensors: H = Σ w JᵀJ, g = Σ w r J with J = [n, p×n], r = n·(p−q).
"""

from __future__ import annotations

import torch

from tpu_icp_slam_torch.kernels import _build

_SUMS = 27  # 21 upper-triangle entries of H + 6 of g


def gn_accum_ref(p: torch.Tensor, q: torch.Tensor, n: torch.Tensor,
                 w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain torch: (M, 3) p/q/n + (M,) w -> (H (6, 6), g (6,)) f32."""
    r = torch.sum(n * (p - q), dim=-1)
    J = torch.cat([n, torch.linalg.cross(p, n, dim=-1)], dim=-1)  # (M, 6)
    Jw = J * w[:, None]
    return J.T @ Jw, Jw.T @ r


def gn_accum(p: torch.Tensor, q: torch.Tensor, n: torch.Tensor,
             w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(M, 3) p/q/n + (M,) w f32 -> (H (6, 6), g (6,)). CPU tensors take the
    plain version."""
    if all(t.device.type == "cpu" for t in (p, q, n, w)):
        return gn_accum_ref(p, q, n, w)
    m = p.shape[0]
    for name, t, shape in (("p", p, (m, 3)), ("q", q, (m, 3)),
                           ("n", n, (m, 3)), ("w", w, (m,))):
        if t.device != p.device or t.device.type != "cuda":
            raise ValueError(f"gn_accum: {name} must be on p's CUDA device, "
                             f"got {t.device}")
        if t.dtype != torch.float32 or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(f"gn_accum: {name} must be contiguous float32 "
                             f"{shape}, got {t.dtype} {tuple(t.shape)}")
    lib = _build.load()
    sms = torch.cuda.get_device_properties(p.device).multi_processor_count
    n_blocks = max(1, min(-(-m // 256), 2 * sms))
    partial = torch.empty((n_blocks, _SUMS), dtype=torch.float32,
                          device=p.device)
    H = torch.empty((6, 6), dtype=torch.float32, device=p.device)
    g = torch.empty(6, dtype=torch.float32, device=p.device)
    stream = torch.cuda.current_stream(p.device).cuda_stream
    err = lib.gn_accum_f32(
        p.data_ptr(), q.data_ptr(), n.data_ptr(), w.data_ptr(), m, n_blocks,
        partial.data_ptr(), H.data_ptr(), g.data_ptr(), stream)
    _build.check(err, "gn_accum_f32")
    gn_accum.launches += 1
    return H, g


gn_accum.launches = 0
