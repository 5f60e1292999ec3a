"""Nearest-neighbour dispatch (counterpart of tpu_icp_slam/kernels/nn.py).

`nearest_neighbor(src, dst, backend=..., tile_m=..., tile_n=...,
precision=...)`:
  - "pallas": the port's kernels — K1 (nn_cuda.nn_bruteforce) at "highest",
    K3 (nn_bf16.nn_bf16) at "bf16", K4 (nn_rescore.nn_rescore) at
    "rescore": the CUDA kernel on CUDA tensors, its plain version on CPU
    tensors, as the reference runs its Pallas kernels in interpret mode on
    the CPU;
  - "xla": the exact plain version on any device; a bf16 request is ignored
    with a one-time warning, as in the reference (rescore needs none: exact
    selection is what it promises);
  - "auto": "pallas" on CUDA tensors, "xla" on CPU tensors — the
    reference's auto routes to its Pallas kernels on the accelerator only;
  - "voxel" is no backend of this dispatch, as in the reference: the
    hash-grid search needs the correspondence gate as its voxel, and
    icp/loop.py builds it once per align (kernels/voxel_nn.py).

tile_n fixes K4's slots (which targets are candidates, so the result);
tile_m changes nothing in any mode, and K1/K3 take neither: their results do
not depend on tiles. Points are 3-D or 2-D. K1 searches 2-D points as they
are; K3 and K4 take 3-D operands, so a 2-D search at "bf16" or "rescore"
gets a zero z column, as the reference's kernel pads its lanes with zeros.
Batched clouds, src (B, M, D) and dst (B/G, N, D), run K1's batched form at
"highest" (any backend); at "bf16" and "rescore" K3/K4 run unbatched once a
row (the sharded align's local rows), which is what the reference's vmap of
the same kernel computes.
"""

from __future__ import annotations

import logging

import torch

from tpu_icp_slam_torch.kernels.nn_bf16 import nn_bf16
from tpu_icp_slam_torch.kernels.nn_cuda import nn_bruteforce, nn_bruteforce_ref
from tpu_icp_slam_torch.kernels.nn_rescore import nn_rescore

_warned_precision_ignored = False


def nearest_neighbor(src: torch.Tensor, dst: torch.Tensor,
                     backend: str = "auto", chunk: int = 2048,
                     tile_m: int = 0, tile_n: int = 0,
                     precision: str = "highest"
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """(M, D), (N, D) -> (idx (M,) int32, dist_sq (M,) f32); batched
    (B, M, D), (B/G, N, D) -> (B, M)."""
    del tile_m  # no port kernel's result depends on it
    if backend not in ("auto", "pallas", "xla"):
        raise ValueError(f"unknown NN backend: {backend}")
    if precision not in ("highest", "bf16", "rescore"):
        raise ValueError(f"unknown NN precision: {precision}")
    on_cuda = src.device.type == "cuda"
    if backend == "auto":
        backend = "pallas" if on_cuda else "xla"
    if src.dim() == 3 and precision != "highest" and backend == "pallas":
        # the reference vmaps the same pallas_call over the rows: one
        # unbatched K3/K4 call a row, row b against target b // G
        group = src.shape[0] // dst.shape[0]
        rows = [nearest_neighbor(s, dst[b // group], backend, chunk,
                                 tile_n=tile_n, precision=precision)
                for b, s in enumerate(src)]
        return (torch.stack([r[0] for r in rows]),
                torch.stack([r[1] for r in rows]))
    if backend == "pallas":
        if precision != "highest" and src.shape[-1] == 2:
            src, dst = (torch.nn.functional.pad(x, (0, 1)) for x in (src, dst))
        if precision == "bf16":
            return nn_bf16(src, dst)
        if precision == "rescore":
            return nn_rescore(src, dst, tile_n=tile_n)
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
