"""Nearest-neighbour dispatch (counterpart of tpu_icp_slam/kernels/nn.py).

`nearest_neighbor(src, dst, backend=..., precision=...)`:
  - "pallas": the port's kernels — K1 (nn_cuda.nn_bruteforce) at "highest",
    K3 (nn_bf16.nn_bf16) at "bf16": the CUDA kernel on CUDA tensors, its
    plain version on CPU tensors. "rescore" needs K4, which is not ported:
    it raises on CUDA, and on the CPU takes K1's exact selection (what
    rescore promises, and what the reference's interpret mode returns up to
    near-ties);
  - "xla": the exact plain version on any device; a bf16 request is ignored
    with a one-time warning, as in the reference;
  - "auto": "pallas" on CUDA tensors, "xla" on CPU tensors — the
    reference's auto routes to its Pallas kernels on the accelerator only;
  - "voxel": not ported yet.
"""

from __future__ import annotations

import logging

import torch

from tpu_icp_slam_torch.kernels.nn_bf16 import nn_bf16
from tpu_icp_slam_torch.kernels.nn_cuda import nn_bruteforce, nn_bruteforce_ref

_warned_precision_ignored = False


def nearest_neighbor(src: torch.Tensor, dst: torch.Tensor,
                     backend: str = "auto", chunk: int = 2048,
                     precision: str = "highest"
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """(M, 3), (N, 3) -> (idx (M,) int32, dist_sq (M,) f32)."""
    if backend == "voxel":
        raise NotImplementedError("nn_backend='voxel' is not ported yet")
    if backend not in ("auto", "pallas", "xla"):
        raise ValueError(f"unknown NN backend: {backend}")
    if precision not in ("highest", "bf16", "rescore"):
        raise ValueError(f"unknown NN precision: {precision}")
    on_cuda = src.device.type == "cuda"
    if backend == "auto":
        backend = "pallas" if on_cuda else "xla"
    if backend == "pallas":
        if precision == "bf16":
            return nn_bf16(src, dst)
        if precision == "rescore" and on_cuda:
            raise NotImplementedError(
                "nn_precision='rescore' needs the shortlist NN kernel (K4), "
                "which is not ported to CUDA yet")
        return nn_bruteforce(src, dst)
    if precision == "bf16":
        # bf16 exists only in the packed kernel; running the exact version
        # silently would make cross-backend A/B comparisons vacuous
        global _warned_precision_ignored
        if not _warned_precision_ignored:
            _warned_precision_ignored = True
            logging.getLogger(__name__).warning(
                "nn_precision=%r requested but the nn backend resolved to "
                "'xla' (f32 only): the precision setting is ignored",
                precision)
    return nn_bruteforce_ref(src, dst, chunk=chunk)
