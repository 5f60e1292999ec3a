"""tpu_icp_slam_torch — the PyTorch/CUDA port of tpu_icp_slam for NVIDIA Hopper.

The JAX package `tpu_icp_slam` is the reference; this package reproduces its
3D scan-to-map path (both ICP loop backends, every NN precision, every ICP
option), scan-to-scan odometry in 3D and 2D, config 2's 2D lidar SLAM
(SE(2) ICP, occupancy grid, Slam2D), config 3's RGB-D projective
odometry (RGBDOdometry, TUM RGB-D directories), full config-4 SLAM (loop
closure, pose graph, checkpoint/resume, persistent maps and
relocalization), both mapping options, config 5's distributed layer (SPMD
over torch.distributed ranks: the point-sharded ICP, the multi-sequence
runner, the distributed Schur pose-graph solve) and the command line
(`python -m tpu_icp_slam_torch.cli align|run|eval|localize|bench`) in
PyTorch, with the Pallas kernels rewritten as CUDA C++ kernels for
sm_90a (`csrc/`, built on first use by `kernels/_build.py`).

Layers, mirroring the reference:
  core/     — SE(3) and SE(2) algebra, padded point clouds
  kernels/  — CUDA kernels and their plain-torch versions: K1 exact NN
              (3-D and 2-D points), K2 GN accumulation (the steps
              loop), K3 bf16 packed NN
              (nn_precision="bf16"), K4 the rescore shortlist NN
              (nn_precision="rescore"), K5 the whole fused ICP loop
              (icp.loop_backend="fused") and its capability probe; the
              voxel hash-grid NN (torch ops, nn_backend="voxel")
  icp/      — point-to-plane Gauss-Newton step, point-to-point Umeyama,
              projective correspondence (RGB-D), the ICP loop and its
              batched form (loop verification)
  mapping/  — voxel map (sort and hash inserts), k-NN and depth-map
              normals, 2D occupancy grid
  backend/  — loop closure (scan context, candidates, batched
              verification), the float64 pose graph and its distributed
              Schur solve
  dist/     — meshes over torch.distributed ranks and their collectives,
              the point-sharded ICP, the multi-sequence runner,
              communication accounting, the failure watchdog, a local
              launcher (spawn)
  slam/     — scan-to-map and scan-to-scan pipelines, RGB-D odometry,
              full 3D SLAM (Slam3D), 2D SLAM (Slam2D), checkpoints,
              persistent maps, the dataset runner
  obs/      — wall timers, host-copy fences, torch.profiler traces and
              spans, JSONL metrics, the benchmark harness (cli bench)
  cli       — align / run / eval / localize / bench (`--device`, default
              cuda)
  interop   — carry state (pipeline, loop detector store, pose graph)
              between the two packages as numpy
  config/, datasets/ (synthetic, kitti, carmen, tum), eval/ (metrics,
              trajectory_io, golden), native/ — the port's own copies of
              the reference's numpy and C modules (the config tree,
              two_scan_pair, lidar2d_log, velodyne_log and rgbd_log, the
              KITTI, CARMEN and TUM readers, ATE/RPE, TUM/KITTI
              trajectories, the float64 golden oracle, the C voxel
              downsample); datasets/png — PNG files with numpy and zlib
              (the map renders, TUM's 16-bit depth images) in place of
              cv2 and matplotlib

Nothing here imports jax, tpu_icp_slam or cv2: configs cross between the two
packages as JSON (`from_json(tpu_icp_slam.config.to_json(cfg))`). Every
entry point runs on the card unless the caller passes `device="cpu"`; a CPU
tensor runs the plain-torch version of each kernel, a CUDA tensor runs the
kernel or raises.
"""

import torch

from tpu_icp_slam_torch.config import (  # noqa: F401
    BackendConfig,
    ICPConfig,
    MappingConfig,
    PipelineConfig,
    SlamConfig,
    from_json,
    to_json,
)
from tpu_icp_slam_torch.datasets import synthetic  # noqa: F401
from tpu_icp_slam_torch.eval import metrics  # noqa: F401

# Pose math and the k-NN distance matrices must stay in full float32: TF32
# keeps ~10 mantissa bits, and low-mantissa correspondence selection is how
# the flagship lap diverged on the reference. The counterpart of the
# reference's jax_default_matmul_precision="highest".
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")
