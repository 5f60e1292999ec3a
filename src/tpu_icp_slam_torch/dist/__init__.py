"""Distributed layer (port of tpu_icp_slam/dist): meshes over
torch.distributed ranks, the point-sharded ICP, the multi-sequence runner,
the failure watchdog; `dist.comm` accounts the collectives' bytes and
`dist.spawn` starts a local world. The Schur pose-graph solve is
backend/schur.py."""

from tpu_icp_slam_torch.dist.failure import WorkerFailure, with_timeout
from tpu_icp_slam_torch.dist.mesh import make_mesh, multihost_init
from tpu_icp_slam_torch.dist.multi_seq import make_multi_sequence_runner
from tpu_icp_slam_torch.dist.sharded_icp import ShardedAligner, make_sharded_align

__all__ = [
    "make_mesh",
    "multihost_init",
    "ShardedAligner",
    "make_sharded_align",
    "make_multi_sequence_runner",
    "WorkerFailure",
    "with_timeout",
]
