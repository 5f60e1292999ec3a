"""Data-parallel multi-sequence SLAM (port of tpu_icp_slam/dist/multi_seq.py;
BASELINE.json config 5: "KITTI 00–10").

Each rank owns whole sequences: the padded logs split over the mesh axis,
every rank runs the SAME scan-to-map pipeline (`ScanToMapPipeline.
init_state` + `run_fused`, K5 at icp.loop_backend="fused") over its own
sequences one after another, and the only traffic is the final gather of
the trajectories. This is the embarrassingly parallel outer level of the
config-5 ladder; the inner levels (point-sharded ICP, Schur-reduced pose
graph) live in dist/sharded_icp.py and backend/schur.py.
"""

from __future__ import annotations

import torch

from tpu_icp_slam_torch.config import SlamConfig
from tpu_icp_slam_torch.dist.mesh import Mesh, all_gather
from tpu_icp_slam_torch.slam.scan_to_map import ScanToMapPipeline


def make_multi_sequence_runner(mesh: Mesh, cfg: SlamConfig, axis: str = "dp"):
    """fn(pts (S, F, C, 3), msk (S, F, C)) -> poses (S, F, 4, 4) on every
    rank, on the mesh's device; frame 0 of each sequence is the identity.

    S must divide by mesh[axis]; rank i of the axis runs sequences
    [i·S/n, (i+1)·S/n), each through the full scan-to-map pipeline."""
    n = mesh.shape[axis]
    i = mesh.index(axis)
    pipe = ScanToMapPipeline(cfg, device=mesh.device)

    def run(pts, msk):
        s = pts.shape[0]
        if s % n:
            raise ValueError(f"{s} sequences must divide by {axis}={n}")
        per = s // n
        out = []
        for seq in range(i * per, (i + 1) * per):
            state = pipe.init_state(pts[seq, 0], msk[seq, 0])
            _, infos = pipe.run_fused(state, pts[seq, 1:], msk[seq, 1:])
            first = torch.eye(4, dtype=infos["pose"].dtype,
                              device=mesh.device)[None]
            out.append(torch.cat([first, infos["pose"]]))
        return all_gather(torch.stack(out), mesh, axis)

    return run
