"""Nearest-neighbour dispatch (counterpart of tpu_icp_slam/kernels/nn.py).

`nearest_neighbor(src, dst, backend=...)`, resolved by the tensors' device:
  - "auto" / "pallas": kernel K1 (nn_cuda.nn_bruteforce) — the CUDA kernel
    on CUDA tensors, its plain version on CPU tensors;
  - "xla": the plain version, as an explicit choice on any device;
  - "voxel": not ported yet.
Only nn_precision="highest" exists on CUDA: the bf16 and rescore kernels
(K3, K4) are not ported, and mapping them to K1 would hide that.
"""

from __future__ import annotations

import torch

from tpu_icp_slam_torch.kernels.nn_cuda import nn_bruteforce, nn_bruteforce_ref


def nearest_neighbor(src: torch.Tensor, dst: torch.Tensor,
                     backend: str = "auto", chunk: int = 2048,
                     precision: str = "highest"
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """(M, 3), (N, 3) -> (idx (M,) int32, dist_sq (M,) f32)."""
    if precision != "highest" and src.device.type == "cuda":
        raise NotImplementedError(
            f"nn_precision={precision!r} needs the bf16/rescore NN kernels, "
            "which are not ported to CUDA yet")
    if backend in ("auto", "pallas"):
        return nn_bruteforce(src, dst)
    if backend == "xla":
        return nn_bruteforce_ref(src, dst, chunk=chunk)
    if backend == "voxel":
        raise NotImplementedError("nn_backend='voxel' is not ported yet")
    raise ValueError(f"unknown NN backend: {backend}")
