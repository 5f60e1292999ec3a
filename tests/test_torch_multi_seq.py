"""The port's multi-sequence runner (dist/multi_seq.py) against the JAX
reference's: S = 4 sequences over 2 gloo ranks (two a rank) against the
reference's runner on a 4-device mesh, at tests/test_torch_slice.py's
tolerance (3e-4 m, 6e-5 rad a frame: the front ends differ by float32
summation order), and each sequence bit-equal to the port's own
single-process `ScanToMapPipeline.run_fused` (the same torch ops, one
thread on both sides). Inputs: tests/test_multi_seq.py's four logs.
"""

import concurrent.futures
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist_workers as workers
from test_torch_slice import GAPS, _rot_gap
from tpu_icp_slam.config import (
    ICPConfig,
    MappingConfig,
    PipelineConfig,
    SlamConfig,
    to_json,
)
from tpu_icp_slam.core.pointcloud import voxel_downsample_np
from tpu_icp_slam.datasets import synthetic
from tpu_icp_slam.dist import make_mesh as jax_make_mesh
from tpu_icp_slam.dist import make_multi_sequence_runner as jax_runner
from tpu_icp_slam.slam.runner import pad_scans
from tpu_icp_slam_torch import from_json
from tpu_icp_slam_torch.dist import make_mesh, make_multi_sequence_runner
from tpu_icp_slam_torch.dist.spawn import spawn
from tpu_icp_slam_torch.slam.scan_to_map import ScanToMapPipeline

CFG = SlamConfig(
    icp=ICPConfig(method="point_to_point", max_iters=8, max_corr_dist=2.0,
                  nn_backend="xla"),
    mapping=MappingConfig(map_capacity=4096, local_model_size=512,
                          map_voxel=0.5),
    pipeline=PipelineConfig(mode="scan_to_map", scan_capacity=256,
                            keyframe_trans=1.5, keyframe_rot=0.3),
)


def _logs():
    seqs = []
    for s in range(4):
        scans, _ = synthetic.velodyne_log(
            n_frames=4, n_rings=6, n_azimuth=96, seed=s, path_fraction=0.15)
        scans = [voxel_downsample_np(sc, 0.8)[:256] for sc in scans]
        seqs.append(pad_scans(scans, 256))
    return (np.stack([p for p, _ in seqs]).astype(np.float32),
            np.stack([m for _, m in seqs]))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(every rank's poses, the reference's poses), the ranks running while
    the reference computes."""
    pts, msk = _logs()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        port = pool.submit(spawn, workers.multi_seq, 2, to_json(CFG), pts, msk,
                           2, init_file=str(tmp_path_factory.mktemp("ms")
                                            / "store"), num_threads=1)
        run = jax_runner(jax_make_mesh(4, axes=("dp",)), CFG)
        ref = np.asarray(run(jnp.asarray(pts), jnp.asarray(msk)))
        return port.result(), ref


def test_multi_sequence_matches_reference(runs):
    ranks, ref = runs
    got = ranks[0]
    assert got.shape == ref.shape == (4, 4, 4, 4) and np.isfinite(got).all()
    np.testing.assert_array_equal(ranks[1], got)  # gathered on every rank
    for s in range(4):
        gap = np.linalg.norm(got[s, :, :3, 3] - ref[s, :, :3, 3], axis=1)
        assert gap.max() <= GAPS["main"][0], (s, gap)
        assert _rot_gap(got[s], ref[s]).max() <= GAPS["main"][1], s


def test_each_sequence_bit_equal_to_its_own_run(runs):
    ranks, _ = runs
    pts, msk = _logs()
    pipe = ScanToMapPipeline(from_json(to_json(CFG)), device="cpu")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for s in range(4):
            _, infos = pipe.run_fused(pipe.init_state(pts[s, 0], msk[s, 0]),
                                      pts[s, 1:], msk[s, 1:])
            want = np.concatenate([np.eye(4, dtype=np.float32)[None],
                                   infos["pose"].numpy()])
            np.testing.assert_array_equal(ranks[0][s], want)
    finally:
        torch.set_num_threads(n)


def test_one_rank_runner_refuses_an_uneven_split():
    """Without a world the axis has one rank: every S divides; a 2-rank
    axis needs an even S, checked before any work."""
    mesh = make_mesh(1, axes=("dp",), device="cpu")
    pts, msk = _logs()
    run = make_multi_sequence_runner(mesh, from_json(to_json(CFG)))
    out = run(pts[:1], msk[:1])
    assert out.shape == (1, 4, 4, 4)
    two = dataclasses.replace(mesh, devices=np.arange(2))
    with pytest.raises(ValueError, match="must divide"):
        make_multi_sequence_runner(two, from_json(to_json(CFG)))(
            pts[:3], msk[:3])
