"""Benchmark harness behind `cli bench` (port of tpu_icp_slam/obs/bench.py).

One rung per BASELINE.json config, at the reference's own sizes and
configurations, on the port's modules and the caller's device:
  1  single align, 4k points
  2  2D lidar fused pipeline frames/s
  3  RGB-D projective fused odometry frames/s
  4  scan-to-map fused pipeline frames/s (the KITTI regime)
  5  scaling harness: batched point-sharded ICP and the distributed Schur
     step over growing numbers of ranks, one a distinct card; throughput
     per count and parallel efficiency, and (from two cards up) the
     communication model of dist/comm.py

Measurement rules: wall time around the step, fenced by a host copy of its
result (`obs.realize`, which waits for the card), warm-up excluded, best of
`repeats`; device count, platform and device name recorded.

Rung 5 counts ranks on distinct cards only: two ranks that share one card
measure no scaling, so they make one row. Launched without torchrun there
is one rank, one row, and no communication model (the reference emits it
for two devices or more).
"""

from __future__ import annotations

import json
import os
import socket
import time

import numpy as np
import torch


def measurement_stamp(allow_dirty: bool | None = None,
                      root: str | None = None) -> dict:
    """Git SHA + dirty flag for every recorded perf/accuracy row.

    A dirty tree raises unless ALLOW_DIRTY_BENCH=1 (or allow_dirty=True),
    in which case the row is loudly marked {"git_dirty": true} so it can
    never masquerade as a reproducible record. root is the checkout (this
    repository by default; this file sits at the reference's depth).
    """
    import subprocess

    if root is None:
        root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__)))))
    try:
        sha = subprocess.run(
            ["git", "-C", root, "rev-parse", "--short", "HEAD"],
            capture_output=True, text=True, timeout=10,
        ).stdout.strip()
        dirty = bool(subprocess.run(
            ["git", "-C", root, "status", "--porcelain"],
            capture_output=True, text=True, timeout=10,
        ).stdout.strip())
    except Exception:
        return {"git_sha": "unknown", "git_dirty": None}
    if allow_dirty is None:
        allow_dirty = os.environ.get("ALLOW_DIRTY_BENCH") == "1"
    if dirty and not allow_dirty:
        raise RuntimeError(
            "refusing to record a measurement from a dirty tree: commit "
            "first, or set ALLOW_DIRTY_BENCH=1 to record a row loudly "
            "marked git_dirty=true"
        )
    return {"git_sha": sha or "unknown", "git_dirty": dirty}


def _steady(fn, repeats: int = 3) -> float:
    from tpu_icp_slam_torch.obs import realize

    realize(fn())  # warm-up; the host copy is the fence
    best = np.inf
    for _ in range(repeats):
        t0 = time.perf_counter()
        realize(fn())
        best = min(best, time.perf_counter() - t0)
    return best


def bench_align(n: int = 4096, repeats: int = 3, device="cuda") -> dict:
    from tpu_icp_slam_torch.config import ICPConfig
    from tpu_icp_slam_torch.core import pointcloud as pcm
    from tpu_icp_slam_torch.datasets import synthetic
    from tpu_icp_slam_torch.icp.loop import align

    src, dst, _ = synthetic.two_scan_pair(n=n, seed=0)
    cs, cd = pcm.make(src, n, device=device), pcm.make(dst, n, device=device)
    cfg = ICPConfig(max_iters=30)
    dt = _steady(lambda: align(cs, cd, cfg=cfg).T, repeats)
    return {"metric": "align_4k_solves_per_s", "value": round(1.0 / dt, 2),
            "unit": "solves/s", "n_points": n}


def _fused_frames(kind: str, frames: int, repeats: int,
                  device="cuda") -> dict:
    from tpu_icp_slam_torch.config import (
        ICPConfig, MappingConfig, PipelineConfig, SlamConfig,
    )
    from tpu_icp_slam_torch.core.pointcloud import voxel_downsample_np
    from tpu_icp_slam_torch.datasets import synthetic
    from tpu_icp_slam_torch.slam.runner import pad_scans

    if kind == "2d":
        log = synthetic.lidar2d_log(n_frames=frames, n_beams=360)
        scans = [
            synthetic.scan_to_points(log.ranges[i], log.angles, log.max_range)
            for i in range(frames)
        ]
        cfg = SlamConfig(pipeline=PipelineConfig(scan_capacity=512))
        pts, msk = pad_scans(scans, 512)
        from tpu_icp_slam_torch.slam.pipeline import OdometryPipeline

        pipe = OdometryPipeline(cfg, dim=2, device=device)
        state = pipe.init_state(pts[0], msk[0])
        dt = _steady(
            lambda: pipe.run_fused(state, pts[1:], msk[1:])[1]["pose"], repeats
        )
        name = "lidar2d_frames_per_s"
    elif kind == "rgbd":
        depths, _, K = synthetic.rgbd_log(n_frames=frames)
        from tpu_icp_slam_torch.icp.projective import CameraIntrinsics
        from tpu_icp_slam_torch.slam.rgbd import RGBDOdometry

        cfg = SlamConfig(icp=ICPConfig(method="point_to_plane"))
        pipe = RGBDOdometry(
            cfg,
            CameraIntrinsics(fx=K.fx, fy=K.fy, cx=K.cx, cy=K.cy,
                             width=K.width, height=K.height),
            device=device,
        )
        state = pipe.init_state(depths[0])
        dt = _steady(
            lambda: pipe.run_fused(state, depths[1:])[1]["pose"], repeats
        )
        name = "rgbd_frames_per_s"
    else:  # scan_to_map
        scans, _ = synthetic.velodyne_log(n_frames=frames, n_rings=16,
                                          n_azimuth=512)
        scans = [voxel_downsample_np(s, 0.3) for s in scans]
        cfg = SlamConfig(
            icp=ICPConfig(method="point_to_plane", max_iters=20,
                          max_corr_dist=1.5, damping=1e-3, max_step_trans=1.0,
                          max_step_rot=0.3, min_inliers=50, huber_delta=0.3,
                          tol=1e-5),
            mapping=MappingConfig(map_capacity=65536, local_model_size=8192,
                                  map_voxel=0.3),
            pipeline=PipelineConfig(mode="scan_to_map", scan_capacity=4096,
                                    keyframe_trans=2.0, keyframe_rot=0.2),
        )
        pts, msk = pad_scans(scans, 4096)
        from tpu_icp_slam_torch.slam.scan_to_map import ScanToMapPipeline

        pipe = ScanToMapPipeline(cfg, device=device)
        state = pipe.init_state(pts[0], msk[0])
        dt = _steady(
            lambda: pipe.run_fused(state, pts[1:], msk[1:])[1]["pose"], repeats
        )
        name = "scan_to_map_frames_per_s"
    return {"metric": name, "value": round((frames - 1) / dt, 2),
            "unit": "frames/s", "frames": frames}


def distinct_devices(device="cuda") -> int:
    """Distinct devices the world's ranks compute on: cards (by host and
    index), or one per host for the CPU; 1 without a process group."""
    import torch.distributed as dist

    from tpu_icp_slam_torch.dist.mesh import rank_device, world

    _, n = world()
    if n == 1:
        return 1
    dev = rank_device(device)
    ident = (socket.gethostname(), str(dev) if dev.type == "cuda" else "cpu")
    idents = [None] * n
    dist.all_gather_object(idents, ident)
    return len(set(idents))


def bench_scaling(repeats: int = 3, points: int = 4096,
                  device="cuda") -> dict:
    """Parallel efficiency of the point-sharded batched align vs 1 card,
    over the ranks of the world on distinct cards (every rank calls this;
    ranks beyond a row's count idle through it)."""
    from tpu_icp_slam_torch.config import ICPConfig
    from tpu_icp_slam_torch.core import pointcloud as pcm
    from tpu_icp_slam_torch.datasets import synthetic
    from tpu_icp_slam_torch.dist import ShardedAligner, make_mesh

    n_dev = distinct_devices(device)
    counts = [d for d in (1, 2, 4, 8, 16) if d <= n_dev]
    cfg = ICPConfig(method="point_to_point", max_iters=10, nn_backend="xla")
    rows = []
    for d in counts:
        mesh = make_mesh(d, axes=("dp", "sp"), shape=(1, d), device=device)
        if mesh.coords is None:
            continue
        batch = 4
        src_b, msk_b, dst_b = [], [], []
        for i in range(batch):
            src, dst, _ = synthetic.two_scan_pair(n=points - 5, seed=i)
            cs = pcm.make(src, capacity=points, device=mesh.device)
            cd = pcm.make(dst, capacity=points, device=mesh.device)
            src_b.append(cs.points)
            msk_b.append(cs.mask)
            dst_b.append(cd.points)
        aligner = ShardedAligner(mesh=mesh, cfg=cfg)
        sb, mb, db = map(torch.stack, (src_b, msk_b, dst_b))
        dt = _steady(lambda: aligner(sb, mb, db).T, repeats)
        rows.append({"devices": d, "aligns_per_s": round(batch / dt, 2)})
    # rank 0 holds every row (the 1-card row included); rank 0 reports
    base = rows[0]["aligns_per_s"] if rows and rows[0]["devices"] == 1 \
        else float("nan")
    for r in rows:
        r["efficiency"] = round(r["aligns_per_s"] / (base * r["devices"]), 3)

    # distributed Schur pose-graph step over the same counts
    from tpu_icp_slam_torch.backend import pose_graph as pgm
    from tpu_icp_slam_torch.backend import schur as schur_m
    from tpu_icp_slam_torch.dist.mesh import rank_device

    rng = np.random.default_rng(0)
    n_kf = 64
    chain = [np.eye(4)]
    factors = []
    for i in range(1, n_kf):
        rel = synthetic.rigid_transform(3, rng, rot_scale=0.1, trans_scale=1.0)
        chain.append(chain[-1] @ rel)
        factors.append((i - 1, i, rel, 1.0))
    factors.append((0, n_kf - 1, np.linalg.inv(chain[0]) @ chain[-1], 2.0))
    g = pgm.from_arrays(np.stack(chain), factors, dtype=torch.float32,
                        device=rank_device(device))
    schur_rows = []
    for d in counts:
        gmesh = make_mesh(d, axes=("graph",), device=device)
        if gmesh.coords is None:
            continue

        def one():
            out, _ = schur_m.optimize_distributed(
                g, gmesh, iters=2, damping=1e-6
            )
            return out.poses

        dt = _steady(one, repeats)
        schur_rows.append({"devices": d, "gn_steps_per_s": round(2.0 / dt, 2)})

    # communication-volume accounting: exact per-step collective payloads +
    # the analytic compute-vs-interconnect efficiency bound (dist/comm.py)
    from tpu_icp_slam_torch.dist import comm

    comm_rows = []
    for d in counts:
        if d < 2:
            continue
        comm_rows.append(comm.sharded_icp_scaling_model(
            m_points=points, n_points=points, iters=10, n_devices=d,
            method="point_to_point", lanes=8, passes=6,
        ))
        ns = comm.schur_separator_count(g, d)
        comm_rows.append(comm.schur_scaling_model(
            n_separator=ns,
            n_interior_max=max(1, (n_kf - ns) // d),
            n_factors=len(factors), iters=2, n_devices=d,
        ))
    return {"metric": "sharded_align_scaling", "rows": rows,
            "schur_rows": schur_rows, "comm_model": comm_rows,
            "unit": "aligns/s", "points": points}


def bench_from_cli(args) -> int:
    from tpu_icp_slam_torch.dist.mesh import multihost_init, world

    device = torch.device(getattr(args, "device", "cuda"))
    multihost_init(device=device)  # a no-op unless torchrun launched us
    cid = args.config_id
    if cid == 1:
        report = bench_align(repeats=3, device=device)
    elif cid == 2:
        report = _fused_frames("2d", args.frames, 3, device)
    elif cid == 3:
        report = _fused_frames("rgbd", min(args.frames, 20), 3, device)
    elif cid == 4:
        report = _fused_frames("scan_to_map", args.frames, 3, device)
    else:
        report = bench_scaling(device=device)
    report["platform"] = "cuda" if device.type == "cuda" else "cpu"
    report["devices"] = distinct_devices(device)
    report["impl"] = "torch"
    report["device_name"] = (torch.cuda.get_device_name(device)
                             if device.type == "cuda" else "cpu")
    if world()[0] == 0:
        if getattr(args, "json", False):
            print(json.dumps(report))
        else:
            print(json.dumps(report, indent=2))
    return 0
