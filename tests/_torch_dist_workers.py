"""Rank functions of the port's multi-rank tests (tests/test_torch_dist.py,
test_torch_schur.py, test_torch_multi_seq.py on the CPU, the distributed
tests of test_torch_cuda.py on the card), run by
`tpu_icp_slam_torch.dist.spawn.spawn` as gloo ranks. They import torch and
the port only, never jax: each spawned rank pays a torch import, not a JAX
one. Each returns numpy arrays, so the test process compares them with the
reference's."""

from __future__ import annotations

import numpy as np


def align_cases(rank, cases, shape, device="cpu"):
    """ShardedAligner over a (dp, sp) mesh of `shape` on `device` for each
    case (cfg, src, msk, dst, nrm): T, iters, rmse, n_inliers, converged."""
    from tpu_icp_slam_torch.dist import ShardedAligner, make_mesh

    mesh = make_mesh(int(np.prod(shape)), axes=("dp", "sp"), shape=shape,
                     device=device)
    out = []
    for cfg, src, msk, dst, nrm in cases:
        res = ShardedAligner(mesh=mesh, cfg=cfg)(src, msk, dst, nrm)
        out.append({k: getattr(res, k).cpu().numpy() for k in
                    ("T", "iters", "rmse", "n_inliers", "converged")})
    return out


def dist_suite(rank, cases, shape):
    """The meshes this rank sees, then align_cases on the CPU."""
    from tpu_icp_slam_torch.dist import make_mesh

    auto = make_mesh(4, axes=("dp", "sp"), device="cpu")
    hosts = make_mesh(axes=("hosts",), device="cpu")
    return {"auto_shape": auto.devices.shape,
            "coords": auto.coords, "hosts_shape": hosts.devices.shape,
            "align": align_cases(rank, cases, shape)}


def fail_on_rank(rank, bad):
    """Raises on rank `bad`."""
    if rank == bad:
        raise ValueError(f"rank {rank} fails on purpose")
    return rank


def schur(rank, graphs, n_blocks):
    """optimize_distributed over n_blocks ranks for each graph (poses,
    factors, max_keyframes, max_factors, iters): (poses, chi2)."""
    import torch

    from tpu_icp_slam_torch.backend import pose_graph as pg
    from tpu_icp_slam_torch.backend import schur as schur_m
    from tpu_icp_slam_torch.dist import make_mesh

    mesh = make_mesh(n_blocks, axes=("graph",), device="cpu")
    out = []
    for poses, factors, kk, ff, iters in graphs:
        g = pg.from_arrays(poses, factors, max_keyframes=kk, max_factors=ff,
                           dtype=torch.float64, device="cpu")
        opt, chis = schur_m.optimize_distributed(g, mesh, iters=iters,
                                                 damping=1e-9)
        out.append((opt.poses.numpy(), chis.numpy()))
    return out


def slam3d(rank, cfg_json, pts, msk):
    """Slam3D.run(mode="fused") on the CPU: poses, keyframes, kept closures,
    chi2."""
    from tpu_icp_slam_torch import from_json
    from tpu_icp_slam_torch.slam.slam3d import Slam3D

    slam = Slam3D(from_json(cfg_json), device="cpu")
    poses, rep = slam.run(pts, msk, mode="fused")
    return {"poses": poses, "kf_frames": slam.kf_frames,
            "closures": [(lc.i, lc.j) for lc in slam.closures_kept],
            "chi2": rep.chi2}


def multi_seq(rank, cfg_json, pts, msk, n):
    """make_multi_sequence_runner over an n-rank "dp" mesh: poses."""
    from tpu_icp_slam_torch import from_json
    from tpu_icp_slam_torch.dist import make_mesh, make_multi_sequence_runner

    mesh = make_mesh(n, axes=("dp",), device="cpu")
    run = make_multi_sequence_runner(mesh, from_json(cfg_json))
    return run(pts, msk).numpy()
