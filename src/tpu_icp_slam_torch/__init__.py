"""tpu_icp_slam_torch — the PyTorch/CUDA port of tpu_icp_slam for NVIDIA Hopper.

The JAX package `tpu_icp_slam` is the reference; this package reproduces its
3D scan-to-map path (both ICP loop backends, every NN precision) and full
config-4 SLAM (loop closure, pose graph) in PyTorch, with the Pallas kernels
rewritten as CUDA C++ kernels for sm_90a (`csrc/`, built on first use by
`kernels/_build.py`).

Layers, mirroring the reference:
  core/     — SE(3) algebra, padded point clouds
  kernels/  — CUDA kernels and their plain-torch versions: K1 exact NN, K2
              GN accumulation (the steps loop), K3 bf16 packed NN
              (nn_precision="bf16"), K4 the rescore shortlist NN
              (nn_precision="rescore"), K5 the whole fused ICP loop
              (icp.loop_backend="fused") and its capability probe
  icp/      — point-to-plane Gauss-Newton step, point-to-point Umeyama,
              the ICP loop and its batched form (loop verification)
  mapping/  — voxel map, k-NN normals
  backend/  — loop closure (scan context, candidates, batched
              verification) and the float64 pose graph
  slam/     — scan-to-map pipeline, full 3D SLAM (Slam3D), scan padding
  interop   — carry state (pipeline, loop detector store, pose graph)
              between the two packages as numpy

The numpy-only reference modules (config tree, synthetic datasets, metrics)
are shared by import; nothing here imports jax. Every constructor takes an
explicit `device`; a CPU tensor runs the plain-torch version of each kernel,
a CUDA tensor runs the kernel or raises.
"""

import torch

from tpu_icp_slam.config import (  # noqa: F401
    BackendConfig,
    ICPConfig,
    MappingConfig,
    PipelineConfig,
    SlamConfig,
    from_json,
)
from tpu_icp_slam.datasets import synthetic  # noqa: F401
from tpu_icp_slam.eval import metrics  # noqa: F401

# Pose math and the k-NN distance matrices must stay in full float32: TF32
# keeps ~10 mantissa bits, and low-mantissa correspondence selection is how
# the flagship lap diverged on the reference. The counterpart of the
# reference's jax_default_matmul_precision="highest" (tpu_icp_slam/core).
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")
