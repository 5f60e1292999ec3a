#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (tpu_icp_slam_torch) on one card.

    python3 chip_smoke.py

Phases, each printing its own line; any failure raises, so the exit code is
nonzero and the final line is not printed:

  0. device: refuse to run without CUDA; print the card, its power limit
     and the torch/CUDA versions.
  1. build: compile the CUDA kernels from csrc/ (nvcc, sm_90a) into build/.
  2. K1 (nn_bruteforce) vs its plain torch version at the main-path shape
     (16,384 x 16,384, some targets padded with the 1e6 sentinel).
  3. K2 (gn_accum) vs its plain version at M = 16,384.
  4. The main path at full width: ScanToMapPipeline.run_fused on a 30-frame
     synthetic Velodyne log (16,384-point scans, 131,072-point map,
     16,384-point local model) under the flagship configuration; finite
     poses, ATE < 0.15 m against ground truth, and K1/K2 launch counts equal
     to the total ICP iterations of the timed run.
  5. The same pipeline on the card and on the CPU (plain kernel versions)
     on a small log: per-frame poses agree.
  6. K5's capability probe (the Hopper counterpart of the Mosaic probes
     P1-P6): cooperative launch support and K5's co-resident grid, then a
     cooperative kernel with grid syncs in a device-decided loop, a dynamic
     gather, a running argmin and scalar math, against known answers.
  7. K3 (nn_bf16) vs its plain version at 16,384 x 16,384, sentinel rows,
     under the tensor-core contract: the device packing bit-equal to the
     plain packing, every pick the plain version's or a near-tie of it (and
     equal on >= 0.99 of the rows), the float64 argmin of the packed score
     picked at least as often as the plain version picks it, each score
     within TAU of the exact packed score (the measured tau), d2 =
     max(e_min, 0) bit for bit, no real point matched to a sentinel row.
  8. K5 (icp_fused) vs its plain version: one align at the main-path shape
     (the first frame against the local model of the seeded map), at
     "highest" and "bf16", with the keyword arguments the main path passes;
     bit-reproducible across two launches; equal iterations, inliers and
     convergence, pose and rmse within K5_BOUNDS, and each precision's
     result rejected by the other precision's bounds.
  9. The main path with icp.loop_backend="fused" on phase 4's log, at
     "highest" and "bf16": finite poses, ATE < 0.15 m, one K5 launch per
     frame and no K1/K2/K3 launch; frames/s and host syncs/frame beside the
     steps path's.
 10. Ten frames of the steps path at nn_precision="bf16": one K3 launch per
     ICP iteration, no K1; its iterations and ATE.
 11. K4 (nn_rescore) vs its plain version at 16,384 x 16,384, sentinel rows:
     the device packing bit-equal to the plain packing, the tensor-core
     candidates equal to the plain version's on >= 0.999 of the (slot, row)
     entries and every difference a near-tie, each candidate's score within
     TAU of the exact packed score, picks and d2 as the plain version's;
     and K3's scan and fold on the same packed operands over the whole
     target (packed_mma_argmin), whose largest score error is a measured tau.
 12. K1's batched form (loop-closure verification) vs its plain version at
     B = 16 (two targets, eight yaws each), M = N = 16,384, and B = 1 bit
     for bit equal to phase 2's unbatched call.
 13. The slice of full SLAM: Slam3D.run(mode="fused") with
     configs/kitti_full_res.json at nn_precision="rescore" (front end, loop
     closure, pose graph) on a 180-frame loop log at full width; finite
     poses, >= 1 accepted closure, ATE < 0.5 m, K4 launches = the front
     end's ICP iterations, K3 = K5 = 0, and every K1 launch a batched
     verification launch, as many as the batched iterations verification
     ran.
 14. cli and state: the port's command line in this process with the
     default device, everything under build/chip_cli/. (1) Phase 4's log
     written as a KITTI sequence (datasets/kitti.write_sequence) and `cli
     run` over it with configs/kitti_full_res.json and --save-map: rc 0,
     finite poses, ATE < 0.15 m, K1 = K2 = the front end's ICP iterations
     beside the batched verification launches, every artifact written and
     map.png a PNG. (2) `cli localize` of frame 15 in that map: localized
     within 3.0 m of ground truth, on batched K1. (3) `cli eval` on the same
     sequence: tpu_ate < 0.15 m, golden_ate and tpu_vs_golden_ate finite.
     (4) Checkpoint and resume of full SLAM on phase 13's log: a streaming
     run of the first 90 frames checkpointing every 30, then a fresh Slam3D
     resuming the whole log from it: the same keyframes and kept closures
     as phase 13's run, poses within rtol 1e-5 / atol 1e-6. (5) `cli align
     --n 4096` recovers the transform, one K1 launch per ICP iteration. (6)
     `cli run --dataset sim3d --frames 20` with SlamConfig() (scan-to-scan,
     point-to-point): rc 0, one K1 launch per ICP iteration.
 15. config 2 (2D lidar SLAM), everything under build/chip_cli2d/. (1) K1
     at D = 2 against its plain version, idx and d2 bit for bit: M = N =
     4,096 (SlamConfig()'s scan capacity, sim2d frames 1 on 0), 16,384 x
     16,384 with sentinel rows, and batched at B = 32 (4 candidates x 8
     yaws), G = 8, M = N = 512, B = 1 equal to the unbatched call. (2) `cli
     eval --dataset sim2d_loop --frames 60 --config
     configs/lidar2d_scan_to_map.json`: rc 0, finite poses, tpu_ate <
     0.25 m, >= 1 accepted closure, K1 launches at D = 3 equal to the front
     end's ICP iterations, batched K1 launches at D = 2 equal to the
     verification iterations, K2 = K3 = K4 = K5 = 0; Slam2D.run's frames/s.
     (3) `cli run --dataset sim2d --frames 30` with SlamConfig(): rc 0,
     map.png a PNG, one K1 launch at D = 2 per ICP iteration; frames/s. (4)
     the same log written as a CARMEN .clf file (carmen.write_clf) and read
     back within the writer's precision, through `cli run`. (5) a
     Slam2D streaming run checkpointing every 20 frames, resumed, held to
     (2)'s run: the same keyframes and closures, poses within rtol 1e-5 /
     atol 1e-6.
 16. config 3 (RGB-D projective odometry) and the mapping options,
     everything under build/chip_cli3/. (1) K2 at the TUM sensor grid's M =
     307,200 rows (frame 1 of the 640x480 simrgbd_fullres log, one
     projective lookup into frame 0's maps) against its plain version, each
     entry of H and g within RGBD_K2_RTOL of the sum of its terms' absolute
     values; bit-reproducible. (2) `cli run --config configs/rgbd.json
     --dataset simrgbd_fullres --frames 30` (640x480, rgbd_src_stride 1):
     rc 0, finite poses, ATE < 0.03 m, one K2 launch per ICP iteration and
     no K1/K3/K4/K5; then RGBDOdometry.run_fused on the same log, timed
     (fenced) and bit-equal to a loop of step. (3) the same 30 frames
     written as a TUM directory (datasets/tum.write_sequence) read back as
     the written uint16 / 5000 exactly, and `cli run` over it: ATE <
     0.03 m. (4) `cli eval` on simrgbd_fullres, 30 frames, with the preset:
     tpu_ate < 0.03 m. (5) phase 4's log with mapping.insert_backend="hash"
     and mapping.extract_approx=True: ATE < 0.15 m, K1 = K2 = the ICP
     iterations, frames/s beside phase 4's; insert_hash on the card equal
     to its CPU run on one insert, entry for entry.
 17. config 5 (the distributed layer), everything under build/chip_dist/.
     (1) A world of one rank on NCCL (a FileStore): ShardedAligner on B = 4
     problems of phase 4's log (frame i+1's 16,384 points against frame
     i's, k-NN normals, point-to-plane at "highest", T0 the ground-truth
     motion) within 1e-4 / 1e-5 of the port's CPU run of them (run in a
     process of its own alongside), K1 launches = the loop's trips and K2 =
     B x trips; Slam3D on phase 13's loop with dist.mesh_shape=(4,) (one
     Schur block): phase 13's keyframes and kept closures, poses within
     1e-5 m of phase 13's, keyframe poses within rtol 1e-7 / atol 1e-8
     (the reference's Schur-vs-dense bound), and the Schur solve's wall
     beside the dense solve's on the same graph; make_multi_sequence_runner
     over S = 4 logs at phase 4's shape (seeds 0-3): each sequence
     bit-equal to its own run_fused, ATE < 0.15 m each, frames/s (fenced);
     one sequence at loop_backend="fused": one K5 launch a frame. (2) Two
     gloo ranks sharing the card (dist.spawn, every step under
     with_timeout): the sharded problems at sp = 2 within 1e-5 of (1)'s,
     optimize_distributed over 2 blocks on phase 13's pose graph within
     rtol 1e-7 / atol 1e-8 of the dense solve (chi2 rtol 1e-6), the runner
     at dp = 2 bit-equal to (1)'s; two ranks on one card measure no
     scaling. (3) `cli bench --config-id 1..5 --json` on the card: platform
     "cuda", the card's name, rung 5 one row.
 18. profile: torch.profiler over each kernel's back-to-back calls (its
     row's kernel_ms) and over K3's, K4's and K5's wrappers (launches and
     host time a call; K3 and K4 must make their four launches and no
     more). Last, because a process that has run the profiler keeps its
     tracing hooks and runs host-bound frames slower.

Every kernel's launch count is read from the path that runs it, with the
counts set to 0 just before and read just after. The line before the last
is a JSON summary of the kernels; the last line is {"ok": true, ...}.

Each kernel row of the summary holds: launches on its path and
launches_per_frame; max_abs_err against the plain version; ms, the device
time of one call (CUDA events around 50 back-to-back calls behind a sleep
kernel that keeps the card ahead of the host, divided by 50; 10 for K5);
kernel_ms, the device time of the port's own CUDA kernels in one call,
summed from a torch.profiler run over 20 back-to-back calls (10 for K5) in
phase 18, and kernel_parts, the same by kernel; call_ms, one call timed
alone (device time plus the wrapper's host work); plain_ms, the plain
version's time; bound_ms and bound_by, the least time the card could take
(FP32 or bf16 operations over the published H100 peak, or bytes over 3.35
TB/s, whichever is larger), from this run's shapes and iteration counts;
library_ms, null: no single PyTorch call computes any of these functions.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import functools
import io
import json
import math
import multiprocessing
import os
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

FRAMES = 30
SCAN_POINTS = 16384
# The compact loop route of scripts/exp_loop.py: ~100 m, back to the start.
LOOP_WAYPOINTS = [(-36, -4), (-12, -4), (-4, -4), (-2, 2), (-4, 13),
                  (-20, 13), (-34, 12), (-38, 4), (-35, -3.6), (-28, -4)]
# 0.56 m/frame. At 90 frames (1.13 m/frame) the route's first corner turns
# 29.5 degrees in one frame and the preset's front end (1.0 m gate, no
# range-rate allowance) loses track there at "highest" and "rescore" alike
# (front-end ATE 2.5 m and 3.0 m on an H100); at 180 frames it tracks.
LOOP_FRAMES = 180


def slice_config(**icp):
    """The flagship KITTI-scale scan-to-map configuration (bench.py's
    `_kitti_cfg` with its default environment); keyword arguments replace
    fields of its ICPConfig."""
    import dataclasses

    from tpu_icp_slam_torch import (
        ICPConfig, MappingConfig, PipelineConfig, SlamConfig,
    )

    cfg = SlamConfig(
        icp=ICPConfig(
            method="point_to_plane", max_iters=18, max_corr_dist=1.0,
            damping=1e-3, max_step_trans=1.0, max_step_rot=0.3,
            min_inliers=100, huber_delta=0.3, tol=1e-5, step_scale=1.4,
            tol_update=0.01, nn_precision="highest",
            prior_trans_weight=0.004, prior_rot_weight=0.04,
            max_total_trans=1.5, max_total_rot=0.5, loop_backend="steps",
        ),
        mapping=MappingConfig(map_capacity=131072, local_model_size=16384,
                              map_voxel=0.2),
        pipeline=PipelineConfig(
            mode="scan_to_map", scan_capacity=SCAN_POINTS,
            keyframe_trans=2.5, keyframe_rot=0.3, normal_ref_stride=4,
            normal_approx=True, normal_oversample=8,
        ),
    )
    return dataclasses.replace(cfg, icp=dataclasses.replace(cfg.icp, **icp))


def _scans(n_frames, n_rings, n_azimuth, path_fraction, voxel, capacity,
           waypoints=None, seed=0):
    from tpu_icp_slam_torch import synthetic
    from tpu_icp_slam_torch.core.pointcloud import voxel_downsample_np
    from tpu_icp_slam_torch.slam.runner import pad_scans

    scans, gt = synthetic.velodyne_log(
        n_frames=n_frames, n_rings=n_rings, n_azimuth=n_azimuth,
        path_fraction=path_fraction, waypoints=waypoints, seed=seed)
    scans = [voxel_downsample_np(s, voxel) for s in scans]
    pts, msk = pad_scans(scans, capacity)
    return pts, msk, gt


def _call_ms(fn, reps=30):
    """Median time of one call of fn, CUDA events around each call: the
    kernel's device time plus the wrapper's host work inside the window."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


@functools.cache
def _sleep_cycles_per_ms():
    """Clock cycles of torch.cuda._sleep per millisecond on this card."""
    torch.cuda._sleep(1000)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(50_000_000)
    end.record()
    torch.cuda.synchronize()
    return 50_000_000 / start.elapsed_time(end)


def _device_ms(fn, n=50, reps=5, strict=True):
    """Device time per call of fn: CUDA events around n back-to-back calls
    (after a warm-up), divided by n, median of reps windows. A sleep kernel
    queued ahead of each window keeps the card busy while the host queues
    the n calls, so the window holds the kernels' own time and the gaps
    between launches on the card, not the wrapper's host work. A window that
    the card reached before the host had queued it all is timed again with
    a longer sleep, then with fewer calls (a wrapper of many small launches
    fills the stream's launch queue); with strict=False (a plain version
    that synchronizes inside) it is kept as it is."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3 / 3
    torch.cuda.synchronize()
    sleep_ms = 2.0 + 2.0 * n * host_ms
    times, retries = [], 0
    while len(times) < reps:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(sleep_ms * _sleep_cycles_per_ms()))
        start.record()
        for _ in range(n):
            fn()
        end.record()
        ahead = not start.query()
        torch.cuda.synchronize()
        if ahead or not strict:
            times.append(start.elapsed_time(end) / n)
            continue
        retries += 1
        if retries > 8:
            raise RuntimeError("the host cannot queue the timed calls ahead "
                               "of the card")
        if retries % 2:
            sleep_ms *= 2
        else:
            n = max(1, n // 2)
    return statistics.median(times)


# The port's own CUDA kernels (csrc/*.cu), as the profiler names them.
OWN_KERNELS = ("nn_split_kernel", "nn_fold_kernel", "gn_accum_kernel",
               "nn_centre_kernel", "nn_pack_kernel", "packed_scan_kernel",
               "nn_rescore_kernel", "icp_fused_kernel", "coop_probe_kernel")


def _kernel_ms(fn, n=20, names=OWN_KERNELS):
    """Device time per call of the kernels `names` (the port's own) in fn:
    a torch.profiler run over n back-to-back calls (after a warm-up), the
    kernels' own time divided by n; (total, {kernel: ms}). Sleep kernels
    open the traced window: the tracer can miss the first kernels of a
    window (seen on an H100; once, on a slow host, the sleep and the one
    probe launch after it), and then misses a sleep instead."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            torch.cuda._sleep(int(0.5 * _sleep_cycles_per_ms()))
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    parts = {}
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        name = next((k for k in names if k in ev.key), None)
        if name:
            parts[name] = (parts.get(name, 0.0)
                           + ev.self_device_time_total / 1e3 / n)
    if not parts:
        raise RuntimeError("the profiler saw none of the port's kernels")
    return sum(parts.values()), parts


def _wrapper_profile(fn, n=10):
    """Where one call of a kernel's wrapper spends its time: a
    torch.profiler run over n calls after a warm-up; per call, the runtime
    launch calls (kernels started), the host time of the whole call, and
    the three torch ops with the most host time of their own."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        host_ms = (time.perf_counter() - t0) * 1e3 / n
        torch.cuda.synchronize()
    avgs = prof.key_averages()
    launches = sum(a.count for a in avgs
                   if a.key.startswith(("cudaLaunch", "cuLaunch"))) / n
    ops = sorted((a for a in avgs if a.key.startswith("aten::")),
                 key=lambda a: -a.self_cpu_time_total)[:3]
    top = ", ".join(f"{a.key} {a.count / n:.0f}x "
                    f"{a.self_cpu_time_total / 1e3 / n:.3f} ms" for a in ops)
    return launches, (f"{launches:.0f} launches a call, host {host_ms:.3f} "
                      f"ms a call (profiled), most host time in {top}")


def bits_equal(a, b):
    """Same dtype, shape and bits (so -0.0 differs from 0.0)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    view = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    return torch.equal(a.contiguous().view(view[a.element_size()]),
                       b.contiguous().view(view[b.element_size()]))


# Published peaks of one H100 SXM (NVIDIA's data sheet; dense, at 700 W).
H100_FP32_FLOPS = 67e12
H100_BF16_FLOPS = 989e12
H100_BYTES_PER_S = 3.35e12


def _bound(flops, nbytes, peak_flops=H100_FP32_FLOPS):
    """(least time in ms, what bounds it) for work of `flops` operations at
    `peak_flops` that must move `nbytes` (each input read once, each output
    written once)."""
    ops_ms = flops / peak_flops * 1e3
    bytes_ms = nbytes / H100_BYTES_PER_S * 1e3
    return ((ops_ms, "operations") if ops_ms >= bytes_ms
            else (bytes_ms, "bytes"))


def _timings(run, plain, bound, n=50, plain_n=3):
    """The timing keys of a kernel row: device time by the n-launch method,
    the single-call time, the plain version's time and the bound; and, under
    "_profile", what phase_profile needs for kernel_ms."""
    return {"ms": _device_ms(run, n), "call_ms": _call_ms(run),
            "plain_ms": _device_ms(plain, plain_n, reps=1, strict=False),
            "bound_ms": bound[0], "bound_by": bound[1], "library_ms": None,
            "_profile": (run, min(n, 20))}


def _fmt(t):
    return (f"device {t['ms']:.4f} ms a call ({t['call_ms']:.4f} ms one call "
            f"alone), bound {t['bound_ms']:.4f} ms ({t['bound_by']}), plain "
            f"{t['plain_ms']:.4f} ms")


def k1_bound(batch, group, m, n, dim=3):
    """K1's least time: 9 FP32 flops a pair at D = 3 (3 subtractions, a
    product, two fused multiply-adds, a compare), 6 at D = 2 (2
    subtractions, 2 products, an add, a compare), against its bytes (the
    points in, idx and d2 out)."""
    flops = 9.0 if dim == 3 else 6.0
    return _bound(flops * batch * m * n,
                  (4.0 * dim + 8.0) * batch * m + 4.0 * dim * batch // group
                  * n)


def k2_bound(m):
    """K2's least time: its bytes (p, q, n, w in; H, g out), ~61 flops a
    row."""
    return _bound(61.0 * m, 40.0 * m + 42 * 4)


def k5_bound(precision, iters, m, n):
    """K5's least time per align: the NN search of each of its iterations
    (K1's 9 FP32 flops a pair at "highest", the 16-lane bf16 contraction at
    "bf16"), against the scan (x, y, z, mask) and the model with normals
    (and packed operands at "bf16")."""
    if precision == "highest":
        return _bound(9.0 * iters * m * n, 16.0 * m + 32.0 * n)
    return _bound(32.0 * iters * m * n, 16.0 * m + 64.0 * n, H100_BF16_FLOPS)


def packed_bound(m, n):
    """K3's and K4's least time: the 16-lane bf16 contraction on the tensor
    cores (2 flops a lane), against the packed operands and the outputs."""
    return _bound(32.0 * m * n, 32.0 * (m + n) + 12.0 * (m + n) + 8.0 * m,
                  H100_BF16_FLOPS)


def _ate(poses, gt):
    from tpu_icp_slam_torch import metrics

    gt_rel = np.einsum("ij,fjk->fik", np.linalg.inv(gt[0]), gt)
    return metrics.ate_rmse(poses[:, :3, 3], gt_rel[: len(poses), :3, 3])


@functools.cache
def card():
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device — this script measures "
                         "the card and has no CPU mode")
    name = torch.cuda.get_device_name(0)
    print(f"[device] {name} | torch {torch.__version__} | "
          f"CUDA {torch.version.cuda}")
    print(card())
    return name


def phase_build():
    from tpu_icp_slam_torch.kernels import _build

    t0 = time.perf_counter()
    path = _build.build()
    _build.load()
    print(f"[build] {time.perf_counter() - t0:.2f} s -> "
          f"{os.path.relpath(path, ROOT)}")


def k1_inputs(pts):
    """Phase 2's inputs: frame 1 against frame 0 with its last 1,024 rows
    at the sentinel, (src, dst) on the card and dst as numpy."""
    dev = torch.device("cuda")
    src = torch.as_tensor(pts[1], device=dev).contiguous()
    dst_np = pts[0].copy()
    dst_np[-1024:] = 1.0e6  # sentinel-padded target rows
    return src, torch.as_tensor(dst_np, device=dev).contiguous(), dst_np


def phase_k1(pts, msk):
    from tpu_icp_slam_torch.kernels import nn_cuda

    src, dst, dst_np = k1_inputs(pts)
    idx_k, d2_k = nn_cuda.nn_bruteforce(src, dst)
    idx_r, d2_r = nn_cuda.nn_bruteforce_ref(src, dst)
    torch.cuda.synchronize()
    idx_k, idx_r = idx_k.cpu().numpy(), idx_r.cpu().numpy()
    agree = float(np.mean(idx_k == idx_r))
    s64, d64 = pts[1].astype(np.float64), dst_np.astype(np.float64)
    exact_k = ((s64 - d64[idx_k]) ** 2).sum(-1)
    exact_r = ((s64 - d64[idx_r]) ** 2).sum(-1)
    excess = exact_k - exact_r
    bound = np.maximum(1e-5, 1e-6 * exact_r)
    err = float(torch.max(torch.abs(d2_k - d2_r)))
    assert agree >= 0.999, f"K1 index agreement {agree}"
    assert np.all(excess <= bound), f"K1 picked-d2 excess {excess.max()}"
    # padded source rows (themselves at the sentinel) may match padded
    # targets; a real source point never does
    assert np.all(idx_k[msk[1]] < len(dst_np) - 1024), \
        "K1 matched a real point to a sentinel row"
    t = _timings(lambda: nn_cuda.nn_bruteforce(src, dst),
                 lambda: nn_cuda.nn_bruteforce_ref(src, dst),
                 bound=k1_bound(1, 1, src.shape[0], dst.shape[0]))
    print(f"[K1 nn_bruteforce] M=N={len(dst_np)} idx agree {agree:.6f} "
          f"max picked-d2 excess {excess.max():.3e} m^2 "
          f"max |d2 - plain| {err:.3e} | {_fmt(t)}")
    return {"name": "nn_bruteforce", "route": "cuda",
            "source": "src/tpu_icp_slam_torch/csrc/nn_bruteforce.cu",
            "replaces": "src/tpu_icp_slam/kernels/nn_pallas.py:111",
            "max_abs_err": err, **t}, src, dst


def k2_inputs(p, valid):
    """Phase 3's inputs: p (phase 2's source), q = p + 5 cm noise, random
    unit normals, weights in [0, 1) with the second half and the padded
    rows at 0."""
    rng = np.random.default_rng(0)
    m = p.shape[0]
    dev = p.device
    q = p + torch.as_tensor(0.05 * rng.standard_normal((m, 3)),
                            dtype=torch.float32, device=dev)
    n = rng.standard_normal((m, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    n = torch.as_tensor(n, device=dev)
    w_np = rng.uniform(0, 1, m).astype(np.float32)
    w_np[m // 2:] = 0.0  # gated rows contribute nothing
    w_np[~valid] = 0.0  # padded rows sit at the sentinel, as in the ICP loop
    return p, q, n, torch.as_tensor(w_np, device=dev)


def phase_k2(p, valid):
    from tpu_icp_slam_torch.kernels import gn_cuda

    p, q, n, w = k2_inputs(p, valid)
    m = p.shape[0]
    H_k, g_k = gn_cuda.gn_accum(p, q, n, w)
    H_r, g_r = gn_cuda.gn_accum_ref(p, q, n, w)
    torch.cuda.synchronize()
    # rtol 1e-4 per entry, plus 1e-4 of the largest entry for sums that
    # cancel to near zero (summation order differs from the plain matmul)
    torch.testing.assert_close(H_k, H_r, rtol=1e-4,
                               atol=1e-4 * float(H_r.abs().max()))
    torch.testing.assert_close(g_k, g_r, rtol=1e-4,
                               atol=1e-4 * float(g_r.abs().max()))
    err = float(max(torch.max(torch.abs(H_k - H_r)),
                    torch.max(torch.abs(g_k - g_r))))
    again = gn_cuda.gn_accum(p, q, n, w)
    assert torch.equal(again[0], H_k) and torch.equal(again[1], g_k), \
        "K2 is not bit-reproducible"
    t = _timings(lambda: gn_cuda.gn_accum(p, q, n, w),
                 lambda: gn_cuda.gn_accum_ref(p, q, n, w), plain_n=50,
                 bound=k2_bound(m))
    print(f"[K2 gn_accum] M={m} max |H,g - plain| {err:.3e} "
          f"(|H|max {float(H_r.abs().max()):.3e}) | {_fmt(t)}")
    return {"name": "gn_accum", "route": "cuda",
            "source": "src/tpu_icp_slam_torch/csrc/gn_accum.cu",
            "replaces": "src/tpu_icp_slam/kernels/gn_pallas.py:28",
            "max_abs_err": err, **t}


def phase_slice(pts, msk, gt):
    from tpu_icp_slam_torch.kernels import gn_cuda, nn_cuda
    from tpu_icp_slam_torch.slam.scan_to_map import ScanToMapPipeline

    pipe = ScanToMapPipeline(slice_config(), device="cuda")
    t0 = time.perf_counter()
    state0 = pipe.init_state(pts[0], msk[0])
    pipe.run_fused(state0, pts[1:], msk[1:])  # warm-up
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    nn_cuda.nn_bruteforce.launches = 0
    gn_cuda.gn_accum.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, infos = pipe.run_fused(state0, pts[1:], msk[1:])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    k1, k2 = nn_cuda.nn_bruteforce.launches, gn_cuda.gn_accum.launches
    poses = np.concatenate(
        [np.eye(4)[None], infos["pose"].cpu().numpy().astype(np.float64)])
    iters = infos["iters"].cpu().numpy()
    n_frames = len(pts) - 1
    ate = _ate(poses, gt)
    print(f"[slice] {n_frames} frames in {dt:.4f} s = "
          f"{n_frames / dt:.3f} frames/s (warm-up incl. init {warm_s:.2f} s)"
          f" | mean ICP iters {iters.mean():.3f} | host syncs/frame "
          f"{(iters.sum() + n_frames) / n_frames:.3f} | keyframes "
          f"{int(infos['is_keyframe'].sum())} | map inserts "
          f"{int(infos['map_inserted'].sum())} | map points "
          f"{int(infos['map_points'][-1])} | ATE {ate:.5f} m")
    print(f"[slice] launches K1 {k1} K2 {k2} total ICP iters "
          f"{int(iters.sum())}")
    assert np.isfinite(poses).all(), "non-finite pose"
    assert ate < 0.15, f"ATE {ate} m"
    assert k1 == k2 == int(iters.sum()) > 0, (k1, k2, int(iters.sum()))
    return k1, k2, n_frames, n_frames / dt


def phase_cpu_agreement():
    from tpu_icp_slam_torch import ICPConfig, MappingConfig, PipelineConfig
    from tpu_icp_slam_torch import SlamConfig
    from tpu_icp_slam_torch.slam.scan_to_map import ScanToMapPipeline

    cfg = SlamConfig(
        icp=ICPConfig(method="point_to_plane", max_iters=15,
                      max_corr_dist=1.5, damping=1e-3, max_step_trans=1.0,
                      max_step_rot=0.3, min_inliers=50, huber_delta=0.3),
        mapping=MappingConfig(map_capacity=32768, local_model_size=4096,
                              map_voxel=0.3),
        pipeline=PipelineConfig(mode="scan_to_map", scan_capacity=2048,
                                keyframe_trans=2.0, keyframe_rot=0.2),
    )
    pts, msk, _ = _scans(6, 16, 320, 0.08, 0.4, 2048)
    out = {}
    for dev in ("cuda", "cpu"):
        pipe = ScanToMapPipeline(cfg, device=dev)
        _, infos = pipe.run_fused(pipe.init_state(pts[0], msk[0]),
                                  pts[1:], msk[1:])
        out[dev] = infos["pose"].cpu().numpy()
    gap = float(np.abs(out["cuda"][:, :3, 3] - out["cpu"][:, :3, 3]).max())
    print(f"[cuda vs cpu] {len(pts) - 1} frames, max position gap "
          f"{gap:.3e} m")
    assert gap < 5e-3, gap


def _counters():
    from tpu_icp_slam_torch.kernels import (
        gn_cuda, icp_fused, nn_bf16, nn_cuda, nn_rescore,
    )

    return {"K1": nn_cuda.nn_bruteforce, "K2": gn_cuda.gn_accum,
            "K3": nn_bf16.nn_bf16, "K4": nn_rescore.nn_rescore,
            "K5": icp_fused.icp_fused}


def _zero_counts():
    for fn in _counters().values():
        fn.launches = 0
    _counters()["K1"].batched_launches = 0
    _counters()["K1"].launches_2d = 0


def _counts():
    return {k: fn.launches for k, fn in _counters().items()}


def _host_syncs(fn):
    """Synchronizing CUDA calls made by fn(), as torch's sync debug mode
    reports them (one warning each)."""
    import warnings

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return sum("synchroniz" in str(w.message) for w in caught)


def phase_probe():
    from tpu_icp_slam_torch.kernels import coop_probe

    coop_probe.capability_probe.launches = 0
    t0 = time.perf_counter()
    got = coop_probe.capability_probe("cuda")
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches = coop_probe.capability_probe.launches
    print(f"[K5 probe] cooperative launch ok; co-resident K5 blocks "
          f"{got['blocks']} (SMs "
          f"{torch.cuda.get_device_properties(0).multi_processor_count}); "
          f"checked {', '.join(got['checked'])} | {ms:.3f} ms host")
    assert launches == 1, launches
    # it synchronizes to read its answers: one call is its only time
    bound_ms, bound_by = _bound(0.0, 4.0 * (4 * got["blocks"]["highest"] + 88))
    return {"name": "coop_probe", "route": "cuda",
            "source": "src/tpu_icp_slam_torch/csrc/coop_probe.cu",
            "replaces": "scripts/probe_mosaic_caps.py:38",
            "launches": launches, "launches_per_frame": None,
            "max_abs_err": 0.0, "ms": ms, "call_ms": ms, "plain_ms": None,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "_profile": (lambda: coop_probe.capability_probe("cuda"), 3)}


def phase_k3(pts, msk):
    from tpu_icp_slam_torch.kernels import nn_bf16, packed_mma

    src, dst, dst_np = k1_inputs(pts)
    idx_k, d2_k = nn_bf16.nn_bf16(src, dst)
    det = nn_bf16.nn_bf16_detail(src, dst)
    idx_r, d2_r = nn_bf16.nn_bf16_ref(src, dst)
    s, d = nn_bf16.recentre(src, dst)
    a_aug, b_aug = nn_bf16.pack_source(s), nn_bf16.pack_target(d)
    torch.cuda.synchronize()
    # the device packing is the plain packing, bit for bit, and the call
    # that keeps its operands is the main path's call
    assert bits_equal(det["a_aug"], a_aug), "K3 device packing: a_aug"
    assert bits_equal(det["b_aug"], b_aug), "K3 device packing: b_aug"
    assert torch.equal(det["idx"], idx_k) and bits_equal(det["d2"], d2_k), \
        "K3 with its operands kept differs from the main path's call"
    assert bits_equal(d2_k, torch.clamp(det["e_min"], min=0.0)), \
        "K3 d2 is not max(e_min, 0)"
    # tensor-core picks: the plain version's but for near-ties, each score
    # within TAU of the exact packed score. These scans are dense in
    # near-ties, and the plain version's float32 sum is the coarser search
    # (it finds the float64 argmin of the packed score on fewer rows): the
    # picks must find it at least as often as the plain version does
    agree = float((idx_k == idx_r).float().mean())
    near = packed_mma.near_ties(a_aug, b_aug, idx_k, idx_r)
    best = packed_mma.exact_argmin(a_aug, b_aug)
    exact_k = float((idx_k == best).float().mean())
    exact_r = float((idx_r == best).float().mean())
    exact, mag = packed_mma.exact_scores(a_aug, b_aug, idx_k)
    tau = float(torch.max(torch.abs(det["e_min"].double() - exact)
                          / torch.clamp(mag, min=1e-30)))
    err = float(torch.max(torch.abs(d2_k - d2_r)))
    assert bool(near.all()), "K3 pick that is no near-tie"
    assert agree >= 0.99, f"K3 index agreement {agree}"
    assert exact_k >= exact_r, \
        f"K3 finds the float64 argmin on {exact_k} of the rows, the plain " \
        f"version on {exact_r}"
    assert tau <= packed_mma.TAU, f"K3 tau {tau}"
    idx_np = idx_k.cpu().numpy()
    assert np.all(idx_np[msk[1]] < len(dst_np) - 1024), \
        "K3 matched a real point to a sentinel row"
    t = _timings(lambda: nn_bf16.nn_bf16(src, dst),
                 lambda: nn_bf16.nn_bf16_ref(src, dst),
                 bound=packed_bound(src.shape[0], dst.shape[0]))
    k, length = nn_bf16.splits(src.shape[0], dst.shape[0],
                               torch.cuda.get_device_properties(0)
                               .multi_processor_count,
                               nn_bf16.blocks_per_sm(0))
    print(f"[K3 nn_bf16] {card()} | M=N={len(dst_np)}, {k} splits of "
          f"{length} | device packing bit-equal | idx agree {agree:.6f}, "
          f"differing ones near-ties {bool(near.all())} | picks at the "
          f"float64 argmin {exact_k:.6f} (plain {exact_r:.6f}) | max |e - E| / "
          f"sum|ab| {tau:.3e} (TAU {packed_mma.TAU:.3e}) | d2 = max(e_min, "
          f"0) bit for bit | max |d2 - plain| {err:.3e} | {_fmt(t)}, share "
          f"{t['bound_ms'] / t['ms']:.4f}")
    return {"name": "nn_bf16", "route": "cuda",
            "source": "src/tpu_icp_slam_torch/csrc/nn_bf16.cu",
            "replaces": "src/tpu_icp_slam/kernels/nn_pallas.py:111",
            "max_abs_err": err, "tau_measured": tau, "idx_agree": agree,
            "float64_argmin_share": exact_k,
            "_wrapper": (lambda: nn_bf16.nn_bf16(src, dst), 4), **t}


def _first_align_problem(pts, msk):
    """Frame 1 against the local model of the map seeded with frame 0, as
    the main path's first align sees them."""
    from tpu_icp_slam_torch.mapping import voxel_map
    from tpu_icp_slam_torch.slam.scan_to_map import ScanToMapPipeline

    cfg = slice_config()
    pipe = ScanToMapPipeline(cfg, device="cuda")
    state = pipe.init_state(pts[0], msk[0])
    loc, nrm, lmsk, r_cover = voxel_map.extract_local(
        state.vmap, torch.zeros(3, device="cuda"),
        cfg.mapping.local_model_size)
    src = torch.as_tensor(pts[1], device="cuda")
    smask = torch.as_tensor(msk[1], device="cuda")
    r_gate = torch.clamp(r_cover - cfg.icp.max_corr_dist, min=0.0)
    return (src, smask, loc, nrm, lmsk), r_gate


# Largest gaps of K5 from its plain version that phase 8 accepts: ~100x the
# pose gaps (4.9e-7 m at highest, 6.8e-6 m at bf16) and >= 25x the rmse gaps
# seen at this shape on an H100. The two differ only in the order of float32
# sums, so iterations, inliers and convergence must be equal.
K5_BOUNDS = {"highest": {"trans_m": 5e-5, "rot_rad": 5e-5, "rmse_m": 1e-5},
             "bf16": {"trans_m": 5e-4, "rot_rad": 5e-4, "rmse_m": 1e-4}}


def _k5_gaps(out, ref):
    """Translation (m), rotation (rad) and rmse gaps of one K5 result from
    another, in float64 (arctan2 keeps small angles exact)."""
    T, Tr = out[0].double().cpu(), ref[0].double().cpu()
    dR = T[:3, :3].T @ Tr[:3, :3]
    sin = 0.5 * torch.linalg.vector_norm(torch.stack(
        [dR[2, 1] - dR[1, 2], dR[0, 2] - dR[2, 0], dR[1, 0] - dR[0, 1]]))
    cos = 0.5 * (torch.trace(dR) - 1.0)
    return {"trans_m": float(torch.linalg.vector_norm(T[:3, 3] - Tr[:3, 3])),
            "rot_rad": float(torch.atan2(sin, cos)),
            "rmse_m": abs(float(out[1]) - float(ref[1]))}


def _k5_mismatches(out, ref, prec):
    """The checks of phase 8 at `prec` that `out` fails against `ref`."""
    gaps = _k5_gaps(out, ref)
    bad = [k for k, bound in K5_BOUNDS[prec].items() if not gaps[k] <= bound]
    bad += [k for k, i in (("iters", 2), ("inliers", 3), ("converged", 4))
            if int(out[i]) != int(ref[i])]
    return bad


def phase_k5(pts, msk):
    from tpu_icp_slam_torch.kernels import icp_fused

    args, r_gate = _first_align_problem(pts, msk)
    rows, results = [], {}
    for prec in ("highest", "bf16"):
        precision, kw = icp_fused.fused_args(
            slice_config(loop_backend="fused", nn_precision=prec).icp)
        run = lambda: icp_fused.icp_fused(*args, r_gate=r_gate,
                                          precision=precision, **kw)
        plain = lambda: icp_fused.icp_fused_ref(*args, r_gate=r_gate,
                                                precision=precision, **kw)
        out = run()
        T2 = run()[0]
        ref = plain()
        torch.cuda.synchronize()
        results[prec] = out, ref
        assert torch.equal(out[0], T2), f"K5 {prec} is not bit-reproducible"
        assert torch.isfinite(out[0]).all(), f"K5 {prec} non-finite pose"
        gaps = _k5_gaps(out, ref)
        err = float(torch.max(torch.abs(out[0] - ref[0])))
        m, n, iters = args[0].shape[0], args[2].shape[0], int(out[2])
        t = _timings(run, plain, k5_bound(prec, iters, m, n), n=10,
                     plain_n=1)
        print(f"[K5 icp_fused {prec}] M={args[0].shape[0]} "
              f"N={args[2].shape[0]} iters {int(out[2])} (plain "
              f"{int(ref[2])}) inliers {int(out[3])} ({int(ref[3])}) rmse "
              f"{float(out[1]):.9f} ({float(ref[1]):.9f}) converged "
              f"{bool(out[4])} ({bool(ref[4])}) | gaps "
              f"{', '.join(f'{k} {v:.3e}' for k, v in gaps.items())} "
              f"(bounds {K5_BOUNDS[prec]}), max |T - plain| {err:.3e} | "
              f"per align: {_fmt(t)}")
        bad = _k5_mismatches(out, ref, prec)
        assert not bad, f"K5 {prec} disagrees with its plain version: {bad}"
        rows.append({"name": f"icp_fused[{prec}]", "route": "cuda",
                     "source": "src/tpu_icp_slam_torch/csrc/icp_fused.cu",
                     "replaces":
                         "src/tpu_icp_slam/kernels/icp_fused_pallas.py:288",
                     "max_abs_err": err, "_wrapper": (run, None), **t})
    # the bounds tell the precisions apart: each kernel's result fails
    # against the other precision's plain version
    for prec, other in (("highest", "bf16"), ("bf16", "highest")):
        bad = _k5_mismatches(results[prec][0], results[other][1], other)
        print(f"[K5 bounds] {prec} kernel vs {other} plain at {other}'s "
              f"bounds: rejected by {bad}")
        assert bad, f"K5 {other} bounds accept the {prec} kernel's result"
    return rows


def _run_slice(cfg, pts, msk, gt, label):
    """Warm-up run, then a timed run with every launch count set to 0
    just before it; returns the counts, the ICP iterations, the frames and
    the ATE."""
    from tpu_icp_slam_torch.slam.scan_to_map import ScanToMapPipeline

    pipe = ScanToMapPipeline(cfg, device="cuda")
    state0 = pipe.init_state(pts[0], msk[0])
    pipe.run_fused(state0, pts[1:], msk[1:])  # warm-up
    torch.cuda.synchronize()
    _zero_counts()
    t0 = time.perf_counter()
    _, infos = pipe.run_fused(state0, pts[1:], msk[1:])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = _counts()
    n_frames = len(pts) - 1
    syncs = _host_syncs(lambda: pipe.run_fused(state0, pts[1:6], msk[1:6]))
    poses = np.concatenate(
        [np.eye(4)[None], infos["pose"].cpu().numpy().astype(np.float64)])
    iters = infos["iters"].cpu().numpy()
    ate = _ate(poses, gt)
    print(f"[{label}] {n_frames} frames in {dt:.4f} s = "
          f"{n_frames / dt:.3f} frames/s | mean ICP iters "
          f"{iters.mean():.3f} | host syncs/frame {syncs / 5:.3f} (sync "
          f"debug mode, frames 1-5) | keyframes "
          f"{int(infos['is_keyframe'].sum())} | map inserts "
          f"{int(infos['map_inserted'].sum())} | ATE {ate:.5f} m | "
          f"launches {counts}")
    assert np.isfinite(poses).all(), f"{label}: non-finite pose"
    assert ate < 0.15, f"{label}: ATE {ate} m"
    return counts, int(iters.sum()), n_frames, ate


def phase_fused_slice(pts, msk, gt):
    counts = {}
    for prec in ("highest", "bf16"):
        c, _, n_frames, _ = _run_slice(
            slice_config(loop_backend="fused", nn_precision=prec), pts, msk,
            gt, f"fused slice {prec}")
        assert c == {"K1": 0, "K2": 0, "K3": 0, "K4": 0, "K5": n_frames}, \
            (prec, c)
        counts[prec] = c["K5"], n_frames
    _run_slice(slice_config(), pts[:6], msk[:6], gt,
               "steps slice highest, 5 frames, for its host syncs")
    return counts


def phase_steps_bf16(pts, msk, gt):
    c, iters, n_frames, ate = _run_slice(slice_config(nn_precision="bf16"),
                                         pts[:11], msk[:11], gt,
                                         "steps slice bf16")
    print(f"[steps slice bf16] ICP iterations {iters}, ATE {ate:.5f} m "
          f"(K3 on the CUDA cores, commit ad1ed22, on an H100: 35 "
          f"iterations, 0.00638 m)")
    assert c["K3"] == c["K2"] == iters > 0, c
    assert c["K1"] == c["K4"] == c["K5"] == 0, c
    return c["K3"], n_frames


def phase_k4(pts, msk):
    from tpu_icp_slam_torch.kernels import (
        nn_bf16, nn_cuda, nn_rescore, packed_mma,
    )

    dev = torch.device("cuda")
    src, dst, dst_np = k1_inputs(pts)
    tn, n_slots = nn_rescore.slots(len(dst_np))
    idx_k, d2_k = nn_rescore.nn_rescore(src, dst)
    idx_r, d2_r = nn_rescore.nn_rescore_ref(src, dst)
    det = nn_rescore.nn_rescore_detail(src, dst)
    plain = nn_rescore.shortlist_ref(src, dst)
    torch.cuda.synchronize()
    same = idx_k == idx_r
    agree = float(same.float().mean())
    err = float(torch.max(torch.abs(d2_k - d2_r)))
    # the rescore's d2 is the same float32 arithmetic on both sides
    assert agree >= 0.999, f"K4 index agreement {agree}"
    assert torch.equal(d2_k[same], d2_r[same]), "K4 picked d2 != plain"
    assert torch.equal(det["idx"], idx_k) and torch.equal(det["d2"], d2_k), \
        "K4 with its scores kept differs from the main path's call"
    idx_np = idx_k.cpu().numpy()
    assert np.all(idx_np[msk[1]] < len(dst_np) - 1024), \
        "K4 matched a real point to a sentinel row"
    # the device packing is the plain packing, bit for bit
    for k in ("sc", "dp", "a_aug", "b_aug"):
        assert bits_equal(det[k], plain[k]), f"K4 device packing: {k}"
    # tensor-core candidates: the plain version's but for near-ties, and
    # each score within TAU of the exact packed score
    a_aug, b_aug = det["a_aug"], det["b_aug"]
    cand_agree = float((det["cand"] == plain["cand"]).float().mean())
    near = packed_mma.near_ties(a_aug, b_aug, det["cand"], plain["cand"])
    exact, mag = packed_mma.exact_scores(a_aug, b_aug, det["cand"])
    tau_k4 = float(torch.max(torch.abs(det["cand_score"].double() - exact)
                             / torch.clamp(mag, min=1e-30)))
    # the scorer over the whole target: the measured tau
    idx_w, e_w = packed_mma.packed_mma_argmin(a_aug, b_aug)
    exact_w, mag_w = packed_mma.exact_scores(a_aug, b_aug, idx_w)
    tau_w = float(torch.max(torch.abs(e_w.double() - exact_w)
                            / torch.clamp(mag_w, min=1e-30)))
    idx_wr, _ = nn_bf16.packed_argmin_ref(a_aug, b_aug)
    near_w = packed_mma.near_ties(a_aug, b_aug, idx_w, idx_wr)
    torch.cuda.synchronize()
    print(f"[K4 tensor cores] device packing bit-equal | candidates equal "
          f"{cand_agree:.6f} of {tuple(det['cand'].shape)}, differing ones "
          f"near-ties {bool(near.all())} | max |e - E| / sum|ab| "
          f"{tau_k4:.3e} (candidates), {tau_w:.3e} (whole target, "
          f"{float((idx_w == idx_wr).float().mean()):.6f} equal to the "
          f"plain argmin, the rest near-ties {bool(near_w.all())}); TAU "
          f"{packed_mma.TAU:.3e}")
    assert cand_agree >= 0.999, f"K4 candidate agreement {cand_agree}"
    assert bool(near.all()), "K4 candidate that is no near-tie"
    assert bool(near_w.all()), "scorer pick that is no near-tie"
    assert max(tau_k4, tau_w) <= packed_mma.TAU, (tau_k4, tau_w)
    # measured, not held: how often the pick is at the exact search's
    # distance (K1's plain version). The packed score drops the lo·lo terms
    # (~1e-2 m² at scene extent), so two near-tied points of one slot can
    # swap; the reference's design accepts that (nn_pallas.py header)
    _, d2_exact = nn_cuda.nn_bruteforce_ref(src, dst)
    real = torch.as_tensor(msk[1], device=dev)
    excess = (d2_k - d2_exact)[real]
    exact_share = float((excess <= 1e-6 * (1.0 + d2_exact[real])).float()
                        .mean())
    excess = float(torch.max(excess))
    t = _timings(lambda: nn_rescore.nn_rescore(src, dst),
                 lambda: nn_rescore.nn_rescore_ref(src, dst),
                 bound=packed_bound(src.shape[0], dst.shape[0]))
    print(f"[K4 nn_rescore] M=N={len(dst_np)} TN={tn} S={n_slots} idx agree "
          f"{agree:.6f} max |d2 - plain| {err:.3e} | exact search's "
          f"distance on {exact_share:.6f} of the rows, max excess "
          f"{excess:.3e} m^2 | {_fmt(t)}")
    return {"name": "nn_rescore", "route": "cuda",
            "source": "src/tpu_icp_slam_torch/csrc/nn_shortlist.cu",
            "replaces": "src/tpu_icp_slam/kernels/nn_pallas.py:142",
            "max_abs_err": err, "tau_measured": max(tau_k4, tau_w),
            "_wrapper": (lambda: nn_rescore.nn_rescore(src, dst), 4), **t}


def _yawed(points, yaws):
    """(M, 3) numpy points turned about z by each yaw -> (Y, M, 3)."""
    c, s = np.cos(yaws), np.sin(yaws)
    R = np.zeros((len(yaws), 3, 3), np.float32)
    R[:, 0, 0], R[:, 0, 1], R[:, 1, 0], R[:, 1, 1] = c, -s, s, c
    R[:, 2, 2] = 1.0
    return np.einsum("yij,mj->ymi", R, points).astype(np.float32)


def k1_batched_inputs(pts):
    """Phase 12's inputs, the verification shape: 2 candidates x 8 yaw
    hypotheses of one query, src (16, M, 3) over dst (2, N, 3)."""
    dev = torch.device("cuda")
    yaws = np.linspace(-np.pi, np.pi, 8, endpoint=False)
    src = torch.as_tensor(_yawed(pts[-1], yaws), device=dev)
    src = src.repeat(2, 1, 1).contiguous()  # (16, M, 3)
    dst = torch.as_tensor(np.stack([pts[0], pts[1]]), device=dev)
    return src, dst


def phase_k1_batched(pts, src1, dst1):
    """src1, dst1: phase 2's unbatched inputs."""
    from tpu_icp_slam_torch.kernels import nn_cuda

    src, dst = k1_batched_inputs(pts)
    idx_k, d2_k = nn_cuda.nn_bruteforce(src, dst)
    idx_r, d2_r = nn_cuda.nn_bruteforce_ref(src, dst)
    one = nn_cuda.nn_bruteforce(src1[None], dst1[None])
    ref1 = nn_cuda.nn_bruteforce(src1, dst1)
    torch.cuda.synchronize()
    agree = float((idx_k == idx_r).float().mean())
    err = float(torch.max(torch.abs(d2_k - d2_r)))
    assert idx_k.shape == (16, src.shape[1]), idx_k.shape
    assert agree >= 0.999, f"batched K1 index agreement {agree}"
    torch.testing.assert_close(d2_k, d2_r, rtol=1e-6, atol=1e-5)
    assert torch.equal(one[0][0], ref1[0]) and torch.equal(one[1][0],
                                                           ref1[1]), \
        "batched K1 at B = 1 differs from the unbatched call"
    t = _timings(lambda: nn_cuda.nn_bruteforce(src, dst),
                 lambda: nn_cuda.nn_bruteforce_ref(src, dst), plain_n=1,
                 bound=k1_bound(src.shape[0], 8, src.shape[1],
                                dst.shape[1]))
    print(f"[K1 batched] B={src.shape[0]} (G=8) M=N={src.shape[1]} idx agree "
          f"{agree:.6f} max |d2 - plain| {err:.3e}; B=1 equal to phase 2's "
          f"call bit for bit | {_fmt(t)}")
    return {"name": "nn_bruteforce[batched]", "route": "cuda",
            "source": "src/tpu_icp_slam_torch/csrc/nn_bruteforce.cu",
            "replaces": "src/tpu_icp_slam/kernels/nn_pallas.py:111",
            "max_abs_err": err, **t}


def full_slam_config():
    """configs/kitti_full_res.json (the full-width preset, backend on) at
    nn_precision="rescore"."""
    from tpu_icp_slam_torch import from_json

    with open(os.path.join(ROOT, "configs", "kitti_full_res.json")) as f:
        cfg = from_json(f.read())
    return dataclasses.replace(cfg, icp=dataclasses.replace(
        cfg.icp, nn_precision="rescore"))


def phase_full_slam():
    from tpu_icp_slam_torch.kernels import nn_cuda
    from tpu_icp_slam_torch.slam.slam3d import Slam3D

    cfg = full_slam_config()
    assert cfg.backend.enabled and cfg.icp.loop_backend == "steps"
    pts, msk, gt = _scans(LOOP_FRAMES, 48, 1024, 1.0,
                          cfg.pipeline.downsample_voxel,
                          cfg.pipeline.scan_capacity, LOOP_WAYPOINTS)
    slam = Slam3D(cfg, device="cuda")
    torch.cuda.synchronize()
    _zero_counts()
    t0 = time.perf_counter()
    poses, rep = slam.run(pts, msk, mode="fused")
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    c = _counts()
    batched = nn_cuda.nn_bruteforce.batched_launches
    iters = int(slam.frontend_iters.sum())
    n_frames = len(pts) - 1
    fe_s = sum(x[2] for x in slam.chunk_stats)
    ate = _ate(poses, gt)
    ate_fe = _ate(slam.frontend_poses, gt)
    # each kept closure's own error: its measured T_ij against ground truth
    kf = slam.kf_frames
    lc_err = [np.linalg.norm(lc.T_ij[:3, 3] - (np.linalg.inv(gt[kf[lc.i]])
                                               @ gt[kf[lc.j]])[:3, 3])
              for lc in slam.closures_kept] or [math.nan]
    print(f"[full slam] {len(pts)} frames of {int(msk.sum(1).max())} points "
          f"| front end {n_frames / fe_s:.3f} frames/s ({fe_s:.3f} s, mean "
          f"ICP iters {iters / n_frames:.3f}) | backend {slam.backend_s:.3f} "
          f"s | end to end {n_frames / dt:.3f} frames/s ({dt:.3f} s) | "
          f"keyframes {rep.n_keyframes} candidates {rep.n_loop_candidates} "
          f"closures {rep.n_loop_closures} (rejected {rep.n_loops_rejected}) "
          f"| kept closures' translation error vs ground truth median "
          f"{np.median(lc_err):.4f} m, max {np.max(lc_err):.4f} m | ATE "
          f"{ate:.5f} m (front end only {ate_fe:.5f} m) | launches "
          f"{c}, K1 batched {batched}, verify iterations "
          f"{slam.detector.verify_iters}")
    assert np.isfinite(poses).all(), "non-finite pose"
    assert rep.n_loop_closures >= 1, "no accepted closure"
    assert ate < 0.5, f"ATE {ate} m"
    assert c["K4"] == c["K2"] == iters > 0, (c, iters)
    assert c["K3"] == c["K5"] == 0, c
    assert c["K1"] == batched == slam.detector.verify_iters > 0, \
        (c["K1"], batched, slam.detector.verify_iters)
    return c["K4"], c["K1"], n_frames, (cfg, pts, msk, poses, slam)


CLI_DIR = os.path.join(ROOT, "build", "chip_cli")


def _cli(argv):
    """cli.main(argv) in this process: (rc, the JSON it printed, s)."""
    from tpu_icp_slam_torch import cli

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    return rc, json.loads(buf.getvalue()), time.perf_counter() - t0


def _events(path):
    with open(path) as fh:
        return {e["event"]: e for e in map(json.loads, fh)}


def phase_cli(full):
    """Phase 14, the command line and the state it carries; `full` is
    phase 13's (config, points, masks, poses, Slam3D)."""
    from tpu_icp_slam_torch import synthetic
    from tpu_icp_slam_torch.datasets import kitti
    from tpu_icp_slam_torch.kernels import nn_cuda
    from tpu_icp_slam_torch.slam.slam3d import Slam3D

    shutil.rmtree(CLI_DIR, ignore_errors=True)
    preset = os.path.join(ROOT, "configs", "kitti_full_res.json")
    t0 = time.perf_counter()
    scans, gt = synthetic.velodyne_log(n_frames=FRAMES, n_rings=48,
                                       n_azimuth=1024,
                                       path_fraction=FRAMES / 110.0)
    seq = os.path.join(CLI_DIR, "kitti", "00")
    kitti.write_sequence(seq, scans, gt)
    print(f"[cli] {FRAMES}-frame KITTI sequence written in "
          f"{time.perf_counter() - t0:.2f} s ({sum(map(len, scans))} points)")

    # (1) cli run over the KITTI directory, full SLAM, map saved
    out, map_file = os.path.join(CLI_DIR, "run"), os.path.join(CLI_DIR,
                                                               "map.npz")
    _zero_counts()
    rc, rep, dt = _cli(["run", "--dataset", seq, "--frames", str(FRAMES),
                        "--config", preset, "--out", out,
                        "--save-map", map_file])
    c, batched = _counts(), nn_cuda.nn_bruteforce.batched_launches
    ev = _events(os.path.join(out, "metrics.jsonl"))["slam3d_run"]
    poses = np.load(os.path.join(out, "trajectory.npz"))["poses"]
    run_s = rep["timers"]["slam3d"]["total_s"]
    print(f"[cli run] {card()} | {rep['frames']} frames, "
          f"{(FRAMES - 1) / run_s:.3f} frames/s in Slam3D.run "
          f"({run_s:.3f} s; {dt:.3f} s with "
          f"loading and artifacts) | ICP iterations {ev['icp_iters']} | "
          f"keyframes {rep['n_keyframes']} closures {rep['n_loop_closures']}"
          f" | ATE {rep['ate_rmse']:.5f} m | launches {c}, K1 batched "
          f"{batched}")
    assert rc == 0 and rep["mode"] == "slam3d", rep
    assert poses.shape == (FRAMES, 4, 4) and np.isfinite(poses).all()
    assert rep["ate_rmse"] < 0.15, rep["ate_rmse"]
    assert c["K2"] == c["K1"] - batched == ev["icp_iters"] > 0, (c, ev)
    assert batched == ev["verify_iters"] and c["K3"] == c["K4"] == \
        c["K5"] == 0, (c, ev)
    for name in ("trajectory.npz", "trajectory_tum.txt",
                 "trajectory_kitti.txt", "report.json", "metrics.jsonl",
                 "map.png"):
        assert os.path.exists(os.path.join(out, name)), name
    with open(os.path.join(out, "map.png"), "rb") as fh:
        assert fh.read(8) == b"\x89PNG\r\n\x1a\n", "map.png is no PNG"
    assert os.path.exists(map_file)

    # (2) localize a frame of the log in the saved map
    _zero_counts()
    rc, loc, dt = _cli(["localize", "--map", map_file, "--dataset", seq,
                        "--frame", "15", "--frames", str(FRAMES),
                        "--config", preset])
    batched = nn_cuda.nn_bruteforce.batched_launches
    print(f"[cli localize] frame 15: localized {loc['localized']}, error "
          f"{loc.get('error_vs_gt_m', math.nan):.5f} m, keyframe "
          f"{loc.get('match_keyframe')}, rmse {loc.get('rmse', math.nan):.5f}"
          f" | K1 batched launches {batched} | {dt:.3f} s")
    assert rc == 0 and loc["localized"], loc
    assert loc["error_vs_gt_m"] < 3.0, loc
    assert _counts()["K1"] == batched > 0

    # (3) the run against the golden float64 oracle
    rc, ev_rep, dt = _cli(["eval", "--dataset", seq, "--frames",
                           str(FRAMES), "--config", preset])
    print(f"[cli eval] tpu_ate {ev_rep['tpu_ate']:.5f} m | golden_ate "
          f"{ev_rep['golden_ate']:.5f} m | tpu_vs_golden_ate "
          f"{ev_rep['tpu_vs_golden_ate']:.5f} m | {dt:.3f} s (golden oracle "
          f"on the host included)")
    assert rc == 0
    assert all(np.isfinite(ev_rep[k]) for k in
               ("tpu_ate", "golden_ate", "tpu_vs_golden_ate")), ev_rep
    assert ev_rep["tpu_ate"] < 0.15, ev_rep

    # (4) checkpoint and resume of phase 13's full SLAM
    cfg, pts, msk, poses13, slam13 = full
    ck = os.path.join(CLI_DIR, "slam3d_ck.npz")
    t0 = time.perf_counter()
    Slam3D(cfg, device="cuda").run(pts[:90], msk[:90], checkpoint_path=ck,
                                   checkpoint_every=30)
    crash_s = time.perf_counter() - t0
    slam = Slam3D(cfg, device="cuda")
    t0 = time.perf_counter()
    res, rrep = slam.run(pts, msk, checkpoint_path=ck, resume=True)
    resume_s = time.perf_counter() - t0
    gap = float(np.abs(res - poses13).max())
    kept = [(lc.i, lc.j) for lc in slam.closures_kept]
    kept13 = [(lc.i, lc.j) for lc in slam13.closures_kept]
    print(f"[checkpoint] 90 frames streaming, a checkpoint every 30 "
          f"({crash_s:.3f} s), then resumed at frame 61 to {len(pts)} "
          f"({resume_s:.3f} s): keyframes {rrep.n_keyframes} (phase 13 "
          f"{len(slam13.kf_frames)}), kept closures {len(kept)} "
          f"({len(kept13)}), largest pose gap to phase 13 {gap:.3e}")
    assert slam.kf_frames == slam13.kf_frames
    assert kept == kept13
    np.testing.assert_allclose(res, poses13, rtol=1e-5, atol=1e-6)

    # (5) config 1: align two clouds
    _zero_counts()
    rc, al, dt = _cli(["align", "--n", "4096"])
    k1 = _counts()["K1"]
    print(f"[cli align] n 4096: iters {al['iters']}, rot err "
          f"{al['rot_err_rad']:.3e} rad, trans err {al['trans_err_m']:.3e} "
          f"m, recovered {al['recovered_under_1e-3']} | steady "
          f"{al['time_steady_s']} s | K1 launches {k1} | {dt:.3f} s")
    assert rc == 0 and al["recovered_under_1e-3"], al
    assert k1 == 2 * al["iters"] > 0, (k1, al["iters"])

    # (6) SlamConfig()'s default pipeline: scan-to-scan, point-to-point
    out = os.path.join(CLI_DIR, "sim3d")
    _zero_counts()
    rc, s2s, dt = _cli(["run", "--dataset", "sim3d", "--frames", "20",
                        "--out", out])
    c = _counts()
    ev = _events(os.path.join(out, "metrics.jsonl"))["fused_run"]
    print(f"[cli run sim3d] scan-to-scan, 20 frames: ATE "
          f"{s2s['ate_rmse']:.5f} m, ICP iterations {ev['icp_iters']} | "
          f"launches {c} | {dt:.3f} s")
    assert rc == 0 and s2s["mode"] == "fused", s2s
    assert c["K1"] == ev["icp_iters"] > 0 and c["K2"] == 0, (c, ev)


# ---- config 2: 2D lidar SLAM ------------------------------------------------

CONFIG2 = os.path.join(ROOT, "configs", "lidar2d_scan_to_map.json")
CLI2D_DIR = os.path.join(ROOT, "build", "chip_cli2d")
SIM2D_FRAMES = 60  # the reference's own verify command: sim2d_loop, 60


def _yawed2(points, yaws):
    """(M, 2) numpy points turned by each yaw -> (Y, M, 2)."""
    c, s = np.cos(yaws), np.sin(yaws)
    R = np.stack([np.stack([c, -s], -1), np.stack([s, c], -1)], -2)
    return np.einsum("yij,mj->ymi", R, points).astype(np.float32)


def _k1_bit_equal(src, dst):
    """K1 and its plain version on the same inputs: idx and d2 equal bit
    for bit (K1 scores 2-D points with the plain version's rounding)."""
    from tpu_icp_slam_torch.kernels import nn_cuda

    idx_k, d2_k = nn_cuda.nn_bruteforce(src, dst)
    idx_r, d2_r = nn_cuda.nn_bruteforce_ref(src, dst)
    torch.cuda.synchronize()
    assert torch.equal(idx_k, idx_r), "K1 2-D idx differs from plain"
    assert bits_equal(d2_k, d2_r), "K1 2-D d2 differs from plain"
    return idx_k


def phase_k1_2d():
    """K1 at D = 2 against its plain version, bit for bit: unbatched at the
    2D scan-to-scan shape (M = N = 4,096, SlamConfig()'s scan capacity:
    frames 1 and 0 of sim2d) and at 16,384 x 16,384 with sentinel rows;
    batched at loop verification's shape (B = 32 = 4 candidates x 8 yaws,
    G = 8, M = N = 512: the last frame of the 60-frame sim2d_loop yawed
    against four of its keyframe scans), B = 1 equal to the unbatched
    call."""
    from tpu_icp_slam_torch.kernels import nn_cuda
    from tpu_icp_slam_torch.slam import runner

    dev = torch.device("cuda")
    pts, msk = runner.pad_scans(runner.load_dataset("sim2d", 30).scans,
                                4096)
    src, dst = (torch.as_tensor(pts[i], device=dev) for i in (1, 0))
    idx = _k1_bit_equal(src, dst)
    real = torch.as_tensor(msk[1], device=dev)
    assert bool((idx[real] < int(msk[0].sum())).all()), \
        "K1 2-D matched a real point to a sentinel row"
    rng = np.random.default_rng(2)
    big = [torch.as_tensor(rng.uniform(-12, 12, (16384, 2)), device=dev,
                           dtype=torch.float32) for _ in range(2)]
    big[1][-2048:] = 1.0e6
    idx_big = _k1_bit_equal(*big)
    assert int(idx_big.max()) < 16384 - 2048
    lp, _ = runner.pad_scans(runner.load_dataset("sim2d_loop",
                                                 SIM2D_FRAMES).scans, 512)
    yaws = np.linspace(-np.pi, np.pi, 8, endpoint=False)
    bsrc = torch.as_tensor(_yawed2(lp[-1], yaws), device=dev).repeat(4, 1, 1)
    bdst = torch.as_tensor(lp[[0, 1, 2, 3]], device=dev)
    _k1_bit_equal(bsrc, bdst)
    one = nn_cuda.nn_bruteforce(bsrc[:1], bdst[:1])
    ref = nn_cuda.nn_bruteforce(bsrc[0].contiguous(), bdst[0].contiguous())
    torch.cuda.synchronize()
    assert torch.equal(one[0][0], ref[0]) and bits_equal(one[1][0], ref[1]), \
        "batched K1 2-D at B = 1 differs from the unbatched call"
    t1 = _timings(lambda: nn_cuda.nn_bruteforce(src, dst),
                  lambda: nn_cuda.nn_bruteforce_ref(src, dst),
                  bound=k1_bound(1, 1, 4096, 4096, dim=2))
    tb = _timings(lambda: nn_cuda.nn_bruteforce(bsrc, bdst),
                  lambda: nn_cuda.nn_bruteforce_ref(bsrc, bdst), plain_n=1,
                  bound=k1_bound(32, 8, 512, 512, dim=2))
    big_ms = _device_ms(lambda: nn_cuda.nn_bruteforce(*big))
    big_bound = k1_bound(1, 1, 16384, 16384, dim=2)[0]
    print(f"[K1 2-D] {card()} | idx and d2 bit-equal to the plain version "
          f"at M=N=4096 (sim2d frames 1 on 0), 16384x16384 (2048 sentinel "
          f"rows; device {big_ms:.4f} ms, bound {big_bound:.4f} ms) and "
          f"batched B=32 G=8 M=N=512 (B=1 = the unbatched call) | M=N=4096: "
          f"{_fmt(t1)} | batched: {_fmt(tb)}")
    src_file = "src/tpu_icp_slam_torch/csrc/nn_bruteforce.cu"
    return ({"name": "nn_bruteforce[2d]", "route": "cuda",
             "source": src_file,
             "replaces": "src/tpu_icp_slam/kernels/nn_pallas.py:111",
             "max_abs_err": 0.0, **t1},
            {"name": "nn_bruteforce[2d batched]", "route": "cuda",
             "source": src_file,
             "replaces": "src/tpu_icp_slam/kernels/nn_pallas.py:111",
             "max_abs_err": 0.0, **tb})


def phase_config2():
    """Config 2 through the command line with the default device, then a
    Slam2D resume; everything under build/chip_cli2d/. Returns the K1
    launch counts of the 2D paths and their frame counts."""
    from tpu_icp_slam_torch import from_json, synthetic
    from tpu_icp_slam_torch.datasets import carmen
    from tpu_icp_slam_torch.kernels import nn_cuda
    from tpu_icp_slam_torch.slam import runner, slam2d

    shutil.rmtree(CLI2D_DIR, ignore_errors=True)
    os.makedirs(CLI2D_DIR)
    k1 = nn_cuda.nn_bruteforce

    # (1) cli eval on the 60-frame loop with the preset: Slam2D (the z = 0
    # lift onto the scan-to-map front end, 2D loop verification), read
    # through the Slam2D the runner builds
    runs = []

    class Recorded(slam2d.Slam2D):
        def run(self, *args, **kw):
            t0 = time.perf_counter()
            out = super().run(*args, **kw)
            torch.cuda.synchronize()
            runs.append((self, out, time.perf_counter() - t0))
            return out

    runner.Slam2D = Recorded
    try:
        _zero_counts()
        rc, ev, dt = _cli(["eval", "--dataset", "sim2d_loop", "--frames",
                           str(SIM2D_FRAMES), "--config", CONFIG2])
        c, batched, k1_2d = _counts(), k1.batched_launches, k1.launches_2d
    finally:
        runner.Slam2D = slam2d.Slam2D
    slam, (poses, rep), run_s = runs[-1]
    fe_iters = int(slam.frontend_iters.sum())
    print(f"[config 2 eval] {card()} | sim2d_loop {SIM2D_FRAMES} frames, "
          f"configs/lidar2d_scan_to_map.json: Slam2D.run "
          f"{(SIM2D_FRAMES - 1) / run_s:.3f} frames/s ({run_s:.3f} s; "
          f"backend {slam.backend_s:.3f} s) | tpu_ate {ev['tpu_ate']:.5f} m "
          f"golden_ate {ev['golden_ate']:.5f} m tpu_vs_golden_ate "
          f"{ev['tpu_vs_golden_ate']:.5f} m | keyframes {rep.n_keyframes} "
          f"candidates {rep.n_loop_candidates} closures "
          f"{rep.n_loop_closures} (rejected {rep.n_loops_rejected}) | front "
          f"end ICP iterations {fe_iters}, verification iterations "
          f"{slam.detector.verify_iters} | launches {c}, K1 batched "
          f"{batched}, K1 on 2-D points {k1_2d} | {dt:.3f} s with the "
          f"golden oracle")
    assert rc == 0 and np.isfinite(poses).all(), "config 2 eval failed"
    assert all(np.isfinite(ev[k]) for k in
               ("tpu_ate", "golden_ate", "tpu_vs_golden_ate")), ev
    assert ev["tpu_ate"] < 0.25, ev
    assert ev["n_loop_closures"] >= 1, "no accepted closure"
    assert c["K1"] - k1_2d == fe_iters > 0, (c, k1_2d, fe_iters)
    assert k1_2d == batched == slam.detector.verify_iters > 0, \
        (k1_2d, batched, slam.detector.verify_iters)
    assert c["K2"] == c["K3"] == c["K4"] == c["K5"] == 0, c

    # (2) SlamConfig()'s 2D scan-to-scan run with its occupancy grid
    out = os.path.join(CLI2D_DIR, "sim2d")
    _zero_counts()
    rc, s2s, dt = _cli(["run", "--dataset", "sim2d", "--frames", "30",
                        "--out", out])
    c, run_k1_2d = _counts(), k1.launches_2d
    fused = _events(os.path.join(out, "metrics.jsonl"))["fused_run"]
    s2s_s = s2s["timers"]["compile+run_fused"]["total_s"]
    print(f"[config 2 run sim2d] SlamConfig(), 30 frames: "
          f"{29 / s2s_s:.3f} frames/s ({s2s_s:.3f} s; {dt:.3f} s with "
          f"loading and artifacts) | ICP iterations {fused['icp_iters']} | "
          f"ATE {s2s['ate_rmse']:.5f} m | launches {c}, K1 on 2-D points "
          f"{run_k1_2d}")
    assert rc == 0 and s2s["mode"] == "fused", s2s
    assert c["K1"] == run_k1_2d == fused["icp_iters"] > 0, (c, fused)
    assert c["K2"] == c["K3"] == c["K4"] == c["K5"] == 0, c
    with open(os.path.join(out, "map.png"), "rb") as fh:
        assert fh.read(8) == b"\x89PNG\r\n\x1a\n", "map.png is no PNG"

    # (3) the same log as a CARMEN .clf file through cli run
    log = synthetic.lidar2d_log(n_frames=30, n_beams=360, seed=0,
                                noise=0.002)
    xyt = np.stack([log.gt_poses[:, 0, 2], log.gt_poses[:, 1, 2],
                    np.arctan2(log.gt_poses[:, 1, 0], log.gt_poses[:, 0, 0])],
                   axis=1)
    clf = os.path.join(CLI2D_DIR, "sim2d.clf")
    carmen.write_clf(clf, log.ranges, xyt, max_range=log.max_range)
    out = os.path.join(CLI2D_DIR, "clf")
    _zero_counts()
    rc, crep, _ = _cli(["run", "--dataset", clf, "--frames", "30", "--out",
                        out])
    c = _counts()
    fused = _events(os.path.join(out, "metrics.jsonl"))["fused_run"]
    clf_poses = np.load(os.path.join(out, "trajectory.npz"))["poses"]
    back = carmen.load_clf(clf)
    err = float(np.abs(back.ranges - log.ranges).max())
    print(f"[config 2 run .clf] {crep['dataset']}: ranges read back within "
          f"{err:.1e} m of the log's, odometry within "
          f"{float(np.abs(back.odometry - xyt).max()):.1e} | {crep['frames']} "
          f"frames (the reader's 180-degree field of view), ICP iterations "
          f"{fused['icp_iters']} | launches {c}")
    assert rc == 0 and clf_poses.shape == (30, 3, 3), crep
    assert np.isfinite(clf_poses).all()
    assert err < 1e-3 and np.allclose(back.odometry, xyt, atol=1e-5)
    assert c["K1"] == fused["icp_iters"] > 0, (c, fused)

    # (4) Slam2D streaming with a checkpoint every 20 frames, cut at frame
    # 49, resumed from frame 41: held to the eval's uninterrupted run
    cfg = from_json(open(CONFIG2).read())
    pts, msk = runner.pad_scans(runner.load_dataset(
        "sim2d_loop", SIM2D_FRAMES).scans, cfg.pipeline.scan_capacity)
    ck = os.path.join(CLI2D_DIR, "slam2d_ck.npz")
    t0 = time.perf_counter()
    slam2d.Slam2D(cfg).run(pts[:50], msk[:50], checkpoint_path=ck,
                           checkpoint_every=20)
    crash_s = time.perf_counter() - t0
    again = slam2d.Slam2D(cfg)
    t0 = time.perf_counter()
    res, rrep = again.run(pts, msk, checkpoint_path=ck, resume=True)
    resume_s = time.perf_counter() - t0
    gap = float(np.abs(res - poses).max())
    print(f"[config 2 checkpoint] 50 frames streaming, a checkpoint every "
          f"20 ({crash_s:.3f} s), resumed at frame 41 to {SIM2D_FRAMES} "
          f"({resume_s:.3f} s): keyframes {rrep.n_keyframes} (eval "
          f"{rep.n_keyframes}), closures {rrep.n_loop_closures} "
          f"({rep.n_loop_closures}), largest pose gap to the eval's run "
          f"{gap:.3e}")
    assert again.kf_frames == slam.kf_frames
    assert [(lc.i, lc.j) for lc in again.closures] == [
        (lc.i, lc.j) for lc in slam.closures]
    np.testing.assert_allclose(res, poses, rtol=1e-5, atol=1e-6)
    return {"eval_batched": batched, "eval_frames": SIM2D_FRAMES - 1,
            "run_k1": run_k1_2d, "run_frames": 29}


# ---- config 3: RGB-D projective odometry, and the mapping options ---------

CONFIG3 = os.path.join(ROOT, "configs", "rgbd.json")
CLI3_DIR = os.path.join(ROOT, "build", "chip_cli3")
RGBD_FRAMES = 30
# Largest |K2 - plain| of an entry of H or g at M = 307,200 that phase 16
# accepts, over the sum of that entry's terms' absolute values (Σ|w J_a J_b|,
# Σ|w r J_a|): two float32 sums of the same terms in different orders.
RGBD_K2_RTOL = 1e-5


def k2_rgbd_inputs():
    """K2's inputs on the RGB-D path at full width, and the log: frame 1
    of the 640x480 log as the source (invalid pixels at the sentinel)
    looked up projectively in frame 0's maps at identity, with the weights
    the ICP loop gives it (gate x mask), all contiguous on the card;
    (depths, ground truth, intrinsics)."""
    from tpu_icp_slam_torch import synthetic
    from tpu_icp_slam_torch.core.pointcloud import PAD_COORD
    from tpu_icp_slam_torch.icp import projective
    from tpu_icp_slam_torch.mapping.normals import normals_from_depth

    depths, gt, ki = synthetic.rgbd_log(
        n_frames=RGBD_FRAMES, K=synthetic.Intrinsics.tum_default(640, 480))
    K = projective.CameraIntrinsics(ki.fx, ki.fy, ki.cx, ki.cy, ki.width,
                                    ki.height)
    maps = []
    for f in (0, 1):
        d = torch.as_tensor(depths[f], dtype=torch.float32, device="cuda")
        v, ok = projective.backproject_depth(d, K)
        n, nok = normals_from_depth(v, ok)
        maps.append((v, n, ok & nok))
    (v0, n0, ok0), (v1, _, ok1) = maps
    mask = ok1.reshape(-1)
    p = torch.where(mask[:, None], v1.reshape(-1, 3),
                    torch.full_like(v1.reshape(-1, 3), PAD_COORD))
    cfg = _rgbd_cfg()
    q, n, gate, _ = projective.projective_correspondence(
        K, v0, n0, ok0, max_corr_dist=cfg.icp.max_corr_dist)(p)
    return (p, q, n, gate * mask.to(gate.dtype)), (depths, gt, K)


def _rgbd_cfg():
    from tpu_icp_slam_torch import from_json

    with open(CONFIG3) as fh:
        return from_json(fh.read())


def phase_k2_rgbd():
    """K2 at M = 307,200 against its plain version; returns its row and
    the log."""
    from tpu_icp_slam_torch.kernels import gn_cuda

    (p, q, n, w), log = k2_rgbd_inputs()
    m = p.shape[0]
    assert all(t.is_contiguous() for t in (p, q, n, w))
    H_k, g_k = gn_cuda.gn_accum(p, q, n, w)
    H_r, g_r = gn_cuda.gn_accum_ref(p, q, n, w)
    # the sums of the terms' absolute values, in float64
    p64, q64, n64, w64 = (t.double() for t in (p, q, n, w))
    J = torch.cat([n64, torch.linalg.cross(p64, n64, dim=-1)], dim=-1)
    r = torch.sum(n64 * (p64 - q64), dim=-1)
    aJw = (J * w64[:, None]).abs()
    scale_H = (J.abs().T @ aJw).float()
    scale_g = (aJw.T @ r.abs()).float()
    rel = float(max(torch.max(torch.abs(H_k - H_r) / scale_H.clamp(min=1e-30)),
                    torch.max(torch.abs(g_k - g_r) / scale_g.clamp(min=1e-30))))
    err = float(max(torch.max(torch.abs(H_k - H_r)),
                    torch.max(torch.abs(g_k - g_r))))
    again = gn_cuda.gn_accum(p, q, n, w)
    assert torch.equal(again[0], H_k) and torch.equal(again[1], g_k), \
        "K2 is not bit-reproducible at M = 307,200"
    assert rel <= RGBD_K2_RTOL, f"K2 at M = {m}: relative error {rel}"
    t = _timings(lambda: gn_cuda.gn_accum(p, q, n, w),
                 lambda: gn_cuda.gn_accum_ref(p, q, n, w), plain_n=50,
                 bound=k2_bound(m))
    print(f"[K2 RGB-D] {card()} | M={m} (640x480, "
          f"{int((w > 0).sum())} weighted rows) max |H,g - plain| {err:.3e},"
          f" over the sum of |terms| {rel:.3e} (limit {RGBD_K2_RTOL:.0e}) | "
          f"{_fmt(t)} | share of bound {t['bound_ms'] / t['ms']:.1%}")
    return {"name": "gn_accum[rgbd]", "route": "cuda",
            "source": "src/tpu_icp_slam_torch/csrc/gn_accum.cu",
            "replaces": "src/tpu_icp_slam/kernels/gn_pallas.py:28",
            "max_abs_err": err, **t}, log


def _ate_ok(rep, limit, what):
    assert np.isfinite(rep["ate_rmse"]) and rep["ate_rmse"] < limit, \
        f"{what}: ATE {rep['ate_rmse']} m"


def phase_config3(log):
    """Config 3 through the command line with the default device, then
    RGBDOdometry directly; returns the K2 launches of the cli run and its
    frame count."""
    from tpu_icp_slam_torch.datasets import tum
    from tpu_icp_slam_torch.slam.rgbd import RGBDOdometry

    depths, gt, K = log
    shutil.rmtree(CLI3_DIR, ignore_errors=True)
    os.makedirs(CLI3_DIR)
    n_frames = RGBD_FRAMES - 1

    # (1) cli run at the TUM sensor grid, stride 1
    out = os.path.join(CLI3_DIR, "run")
    _zero_counts()
    rc, rep, dt = _cli(["run", "--config", CONFIG3, "--dataset",
                        "simrgbd_fullres", "--frames", str(RGBD_FRAMES),
                        "--out", out])
    c = _counts()
    iters = _events(os.path.join(out, "metrics.jsonl"))["rgbd_run"][
        "icp_iters"]
    poses = np.load(os.path.join(out, "trajectory.npz"))["poses"]
    run_s = rep["timers"]["compile+run"]["total_s"]
    print(f"[config 3 run] {card()} | simrgbd_fullres 640x480, "
          f"{RGBD_FRAMES} frames, configs/rgbd.json: {n_frames / run_s:.3f} "
          f"frames/s in RGBDOdometry.run_fused ({run_s:.3f} s, the first "
          f"run of the process; {dt:.3f} s with the log and artifacts) | "
          f"ICP iterations {iters} ({iters / n_frames:.3f} a frame) | ATE "
          f"{rep['ate_rmse']:.5f} m, RPE {rep['rpe_trans']:.5f} m "
          f"{rep['rpe_rot']:.5f} rad | launches {c}")
    assert rc == 0 and poses.shape == (RGBD_FRAMES, 4, 4), rep
    assert np.isfinite(poses).all()
    _ate_ok(rep, 0.03, "config 3 run")
    assert c["K2"] == iters > 0, (c, iters)
    assert c["K1"] == c["K3"] == c["K4"] == c["K5"] == 0, c
    k2_launches = c["K2"]

    # (2) RGBDOdometry itself: run_fused timed, and a loop of step
    cfg = _rgbd_cfg()
    odo = RGBDOdometry(cfg, K, device="cuda")
    dev_depths = torch.as_tensor(depths, dtype=torch.float32, device="cuda")
    state0 = odo.init_state(dev_depths[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, infos = odo.run_fused(state0, dev_depths[1:])
    torch.cuda.synchronize()
    fused_s = time.perf_counter() - t0
    st = state0
    for f in range(1, RGBD_FRAMES):
        st, info = odo.step(st, dev_depths[f])
        assert torch.equal(info["pose"], infos["pose"][f - 1]), \
            f"step and run_fused differ at frame {f}"
    gap = float(np.abs(infos["pose"].cpu().numpy() - poses[1:]).max())
    print(f"[config 3 odometry] RGBDOdometry.run_fused {n_frames} frames in "
          f"{fused_s:.4f} s = {n_frames / fused_s:.3f} frames/s (fenced, "
          f"warm) | a loop of step bit-equal | largest gap to the cli run "
          f"{gap:.3e}")

    # (3) the same frames as a TUM directory
    seq_dir = os.path.join(CLI3_DIR, "tum")
    t0 = time.perf_counter()
    tum.write_sequence(seq_dir, depths, gt_poses=gt)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    seq = tum.load_sequence(seq_dir)
    read_s = time.perf_counter() - t0
    img = np.clip(depths * tum.DEPTH_FACTOR, 0, 65535).astype(np.uint16)
    assert np.array_equal(seq.depths, img / tum.DEPTH_FACTOR), \
        "TUM depths read back differ from the written uint16 / 5000"
    rc, trep, dt = _cli(["run", "--config", CONFIG3, "--dataset", seq_dir,
                         "--frames", str(RGBD_FRAMES), "--out",
                         os.path.join(CLI3_DIR, "run_tum")])
    print(f"[config 3 TUM dir] {RGBD_FRAMES} frames written in {write_s:.3f}"
          f" s, read in {read_s:.3f} s (the port's PNG codec), depths equal "
          f"the written uint16 / 5000 | cli run: ATE {trep['ate_rmse']:.5f} m"
          f" | {dt:.3f} s")
    assert rc == 0 and trep["frames"] == RGBD_FRAMES, trep
    _ate_ok(trep, 0.03, "config 3 TUM dir")

    # (4) cli eval: the run's ATE alone (no scans, no golden oracle)
    rc, ev, dt = _cli(["eval", "--config", CONFIG3, "--dataset",
                       "simrgbd_fullres", "--frames", str(RGBD_FRAMES)])
    print(f"[config 3 eval] tpu_ate {ev['tpu_ate']:.5f} m (the run's "
          f"{rep['ate_rmse']:.5f}) | keys {sorted(ev)} | {dt:.3f} s")
    assert rc == 0 and set(ev) == {"dataset", "frames", "mode", "tpu_ate"}
    assert ev["tpu_ate"] < 0.03, ev
    return k2_launches, n_frames


def phase_mapping_options(pts, msk, gt, slice_fps):
    """Phase 4's log with both mapping options on; insert_hash on the card
    against the CPU on one insert."""
    from tpu_icp_slam_torch.mapping import voxel_map
    from tpu_icp_slam_torch.mapping.normals import normals_knn
    from tpu_icp_slam_torch.slam.scan_to_map import ScanToMapPipeline

    cfg = slice_config()
    cfg = dataclasses.replace(cfg, mapping=dataclasses.replace(
        cfg.mapping, insert_backend="hash", extract_approx=True))
    pipe = ScanToMapPipeline(cfg, device="cuda")
    state0 = pipe.init_state(pts[0], msk[0])
    pipe.run_fused(state0, pts[1:], msk[1:])  # warm-up
    _zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, infos = pipe.run_fused(state0, pts[1:], msk[1:])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    c = _counts()
    n_frames = len(pts) - 1
    iters = int(infos["iters"].sum())
    poses = np.concatenate(
        [np.eye(4)[None], infos["pose"].cpu().numpy().astype(np.float64)])
    ate = _ate(poses, gt)

    # one insert of frame 1 into the seeded map, on the card and the CPU
    p = state0.vmap
    pose = infos["pose"][0]
    pts1 = torch.as_tensor(pts[1], device="cuda")
    m1 = torch.as_tensor(msk[1], device="cuda")
    world = torch.where(m1[:, None], pts1 @ pose[:3, :3].T + pose[:3, 3],
                        torch.full_like(pts1, 1.0e6))
    nrm = normals_knn(pts1, m1, k=cfg.pipeline.normal_k,
                      ref_stride=cfg.pipeline.normal_ref_stride) \
        @ pose[:3, :3].T
    args = (world, m1, nrm)
    kw = dict(voxel=cfg.mapping.map_voxel, center=pose[:3, 3])

    def ins(fn):
        return fn(p, *args, **kw)

    card_map = ins(voxel_map.insert_hash)
    cpu = voxel_map.VoxelMap(*(t.cpu() for t in (p.points, p.normals,
                                                   p.mask)))
    cpu_map = voxel_map.insert_hash(cpu, *(a.cpu() for a in args),
                                    voxel=kw["voxel"],
                                    center=kw["center"].cpu())
    for f in ("points", "normals", "mask"):
        assert torch.equal(getattr(card_map, f).cpu(), getattr(cpu_map, f)), \
            f"insert_hash on the card differs from the CPU in {f}"
    # device time (events around 10 calls; a call that synchronizes puts
    # its host time in the window), one call alone, host syncs a call
    cost = {name: (_device_ms(lambda: ins(fn), n=10, strict=False),
                   _call_ms(lambda: ins(fn), reps=10),
                   _host_syncs(lambda: ins(fn)))
            for name, fn in (("hash", voxel_map.insert_hash),
                             ("sort", voxel_map.insert))}
    print(f"[mapping options] insert_backend=hash, extract_approx: "
          f"{n_frames / dt:.3f} frames/s (phase 4 in this call "
          f"{slice_fps:.3f}) | ICP iterations {iters} | map inserts "
          f"{int(infos['map_inserted'].sum())}, map points "
          f"{int(infos['map_points'][-1])} | ATE {ate:.5f} m | launches {c}"
          f" | insert_hash on the card = CPU entry for entry | an insert "
          f"(10 back to back, one alone, host syncs): hash "
          f"{cost['hash'][0]:.4f} / {cost['hash'][1]:.4f} ms, "
          f"{cost['hash'][2]}; the sort-based insert {cost['sort'][0]:.4f} "
          f"/ {cost['sort'][1]:.4f} ms, {cost['sort'][2]}")
    assert np.isfinite(poses).all() and ate < 0.15, ate
    assert c["K1"] == c["K2"] == iters > 0, (c, iters)


# ---- config 5: the distributed layer ---------------------------------------

DIST_DIR = os.path.join(ROOT, "build", "chip_dist")
N_SEQ = 4
STEP_TIMEOUT_S = 240.0  # a step of phase 17 that takes longer has hung


def _sharded_problems(pts, msk, gt):
    """Phase 17's sharded align: frame i+1 against frame i of phase 4's
    log (i < 4), the targets' k-NN normals made on the card as the main
    path makes them, T0 the ground-truth motion; (ICPConfig, arrays)."""
    from tpu_icp_slam_torch.mapping.normals import normals_knn

    cfg = slice_config()
    p = cfg.pipeline
    nrm = [normals_knn(torch.as_tensor(pts[i], device="cuda"),
                       torch.as_tensor(msk[i], device="cuda"), k=p.normal_k,
                       ref_stride=p.normal_ref_stride,
                       approx=p.normal_approx,
                       oversample=p.normal_oversample).cpu().numpy()
           for i in range(4)]
    T0 = np.stack([np.linalg.inv(gt[i]) @ gt[i + 1]
                   for i in range(4)]).astype(np.float32)
    return cfg.icp, (pts[1:5], msk[1:5], pts[:4], np.stack(nrm), T0)


def _sharded_cpu(icp, arrays):
    """The port's CPU run of the sharded problems (no world: one rank)."""
    from tpu_icp_slam_torch.dist import ShardedAligner, make_mesh

    res = ShardedAligner(make_mesh(1, device="cpu"), icp)(*arrays)
    return res.T.numpy(), res.iters.numpy()


def _graph_arrays(g):
    return {f.name: getattr(g, f.name).cpu().numpy()
            for f in dataclasses.fields(g)}


def _graph(arrays, device):
    from tpu_icp_slam_torch.backend import pose_graph as pg

    return pg.PoseGraph(**{k: torch.as_tensor(v, device=device)
                           for k, v in arrays.items()})


def _round_ms(mesh, axis, n=50):
    """Host ms of one all-reduce of the sharded align's (B, 45) float32
    statistics on the card over `axis`: n rounds back to back, fenced."""
    from tpu_icp_slam_torch.dist.mesh import all_reduce

    x = torch.zeros(4, 45, device=mesh.device)
    all_reduce(x, mesh, axis).cpu()  # the communicator's set-up
    t0 = time.perf_counter()
    for _ in range(n):
        x = all_reduce(x, mesh, axis)
    x.cpu()
    return (time.perf_counter() - t0) / n * 1e3


def _rank_config5(rank, icp, backend_kw):
    """Phase 17 (2): one of two gloo ranks sharing the card. Every step
    runs under the watchdog; a hang raises WorkerFailure."""
    from tpu_icp_slam_torch.backend import schur
    from tpu_icp_slam_torch.dist import (
        ShardedAligner, make_mesh, make_multi_sequence_runner, with_timeout,
    )

    dev = torch.device("cuda", 0)
    a = np.load(os.path.join(DIST_DIR, "sharded.npz"))
    arrays = tuple(a[k] for k in ("src", "msk", "dst", "nrm", "T0"))
    mesh = make_mesh(2, axes=("dp", "sp"), shape=(1, 2), device=dev)
    round_ms = with_timeout(lambda: _round_ms(mesh, "sp"), STEP_TIMEOUT_S)
    T = with_timeout(lambda: ShardedAligner(mesh, icp)(*arrays).T.cpu()
                     .numpy(), STEP_TIMEOUT_S)
    g = _graph(dict(np.load(os.path.join(DIST_DIR, "graph13.npz"))), dev)
    gmesh = make_mesh(2, axes=("graph",), device=dev)

    def solve():
        out, chis = schur.optimize_distributed(g, gmesh, **backend_kw)
        return out.poses.cpu().numpy(), chis.cpu().numpy()

    poses, chis = with_timeout(solve, STEP_TIMEOUT_S)
    P = np.load(os.path.join(DIST_DIR, "seq_pts.npy"))
    M = np.load(os.path.join(DIST_DIR, "seq_msk.npy"))
    run = make_multi_sequence_runner(make_mesh(2, axes=("dp",), device=dev),
                                     slice_config())
    seq = with_timeout(lambda: run(P, M).cpu().numpy(), STEP_TIMEOUT_S)
    return {"T": T, "graph_poses": poses, "chi2": chis, "seq": seq,
            "round_ms": round_ms}


def phase_config5(pts, msk, gt, full):
    """Phase 17; `full` is phase 13's (config, points, masks, poses,
    Slam3D)."""
    import torch.distributed as tdist

    from tpu_icp_slam_torch.backend import pose_graph as pg
    from tpu_icp_slam_torch.backend import schur
    from tpu_icp_slam_torch.dist import (
        ShardedAligner, make_mesh, make_multi_sequence_runner,
        multihost_init, with_timeout,
    )
    from tpu_icp_slam_torch.dist.spawn import spawn
    from tpu_icp_slam_torch.kernels import nn_cuda
    from tpu_icp_slam_torch.slam.scan_to_map import ScanToMapPipeline
    from tpu_icp_slam_torch.slam.slam3d import Slam3D

    shutil.rmtree(DIST_DIR, ignore_errors=True)
    os.makedirs(DIST_DIR)
    icp, arrays = _sharded_problems(pts, msk, gt)
    np.savez(os.path.join(DIST_DIR, "sharded.npz"),
             **dict(zip(("src", "msk", "dst", "nrm", "T0"), arrays)))
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(1, mp_context=ctx) as pool:
        cpu = pool.submit(_sharded_cpu, icp, arrays)  # alongside the card

        # (1) a world of one rank on NCCL
        multihost_init("file://" + os.path.join(DIST_DIR, "nccl_store"),
                       world_size=1, rank=0, device="cuda")
        assert tdist.get_backend() == "nccl"
        mesh = make_mesh(1, axes=("dp", "sp"))
        nccl_ms = with_timeout(lambda: _round_ms(mesh, "sp"), STEP_TIMEOUT_S)
        aligner = ShardedAligner(mesh, icp)
        with_timeout(lambda: aligner(*arrays).T.cpu(), STEP_TIMEOUT_S)
        _zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = with_timeout(lambda: aligner(*arrays), STEP_TIMEOUT_S)
        T1 = res.T.cpu().numpy()
        dt = time.perf_counter() - t0
        c, batched = _counts(), nn_cuda.nn_bruteforce.batched_launches
        iters = res.iters.cpu().numpy()
        trips = int(iters.max())
        print(f"[config 5] NCCL world of 1 | sharded align B=4 M=N="
              f"{arrays[0].shape[1]}: iterations {iters.tolist()}, "
              f"{dt:.4f} s | one NCCL all-reduce of the (4, 45) statistics "
              f"{nccl_ms:.4f} ms | launches K1 {c['K1']} (batched {batched}) = "
              f"trips {trips}; K2 {c['K2']} = B x trips = {4 * trips}")
        assert c["K1"] == batched == trips > 0 and c["K2"] == 4 * trips, c
        assert c["K3"] == c["K4"] == c["K5"] == 0, c

        # (1) Schur: phase 13's loop with dist.mesh_shape=(4,)
        cfg13, pts13, msk13, poses13, slam13 = full
        cfg = dataclasses.replace(cfg13, dist=dataclasses.replace(
            cfg13.dist, mesh_shape=(4,)))
        slam = Slam3D(cfg, device="cuda")
        t0 = time.perf_counter()
        poses, rep = slam.run(pts13, msk13, mode="fused")
        run_s = time.perf_counter() - t0
        kept = [(lc.i, lc.j) for lc in slam.closures_kept]
        gap = float(np.abs(poses[:, :3, 3] - poses13[:, :3, 3]).max())
        assert slam.kf_frames == slam13.kf_frames
        assert kept == [(lc.i, lc.j) for lc in slam13.closures_kept]
        assert gap < 1e-5, gap
        np.testing.assert_allclose(np.stack(slam.kf_poses_out),
                                   np.stack(slam13.kf_poses_out),
                                   rtol=1e-7, atol=1e-8)
        g13 = slam13.pose_graph
        np.savez(os.path.join(DIST_DIR, "graph13.npz"), **_graph_arrays(g13))
        scans = [(pts, msk, gt)] + [
            _scans(FRAMES, 48, 1024, FRAMES / 110.0, 0.15, SCAN_POINTS,
                   seed=s) for s in range(1, N_SEQ)]
        P = np.stack([x[0] for x in scans])
        M = np.stack([x[1] for x in scans])
        np.save(os.path.join(DIST_DIR, "seq_pts.npy"), P)
        np.save(os.path.join(DIST_DIR, "seq_msk.npy"), M)
        # untimed while the CPU run finishes: each sequence's own run, and
        # one sequence at loop_backend="fused"
        sl = slice_config()
        pipe = ScanToMapPipeline(sl, device="cuda")
        own = [pipe.run_fused(pipe.init_state(P[s, 0], M[s, 0]), P[s, 1:],
                              M[s, 1:])[1]["pose"].cpu().numpy()
               for s in range(N_SEQ)]
        fused = make_multi_sequence_runner(make_mesh(1, axes=("dp",)),
                                           slice_config(loop_backend="fused"))
        _zero_counts()
        fposes = fused(P[1:2], M[1:2]).cpu().numpy()
        fc = _counts()
        T_cpu, it_cpu = cpu.result(timeout=STEP_TIMEOUT_S)
    err = float(np.abs(T1 - T_cpu).max())
    print(f"[config 5] sharded align against the port's CPU run: largest "
          f"|T - T_cpu| {err:.3e}, iterations {it_cpu.tolist()}")
    np.testing.assert_allclose(T1, T_cpu, rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(iters, it_cpu)

    bk = dict(iters=cfg13.backend.pg_iters, damping=cfg13.backend.pg_damping,
              huber_delta=cfg13.backend.huber_delta)
    mesh1 = make_mesh(1, axes=("graph",))
    walls = {}
    for name, fn in (("schur", lambda: schur.optimize_distributed(
            g13, mesh1, **bk)), ("dense", lambda: pg.optimize(g13, **bk))):
        fn()[0].poses.cpu()
        t0 = time.perf_counter()
        fn()[0].poses.cpu()
        walls[name] = time.perf_counter() - t0
    print(f"[config 5] Slam3D with mesh_shape (4,), one Schur block: "
          f"{len(pts13)} frames in {run_s:.3f} s | keyframes "
          f"{rep.n_keyframes} kept closures {len(kept)} as phase 13 | "
          f"largest position gap to phase 13 {gap:.3e} m | pose graph of "
          f"{int(g13.pose_mask.sum())} keyframes, {bk['iters']} GN "
          f"iterations: Schur {walls['schur']:.4f} s, dense "
          f"{walls['dense']:.4f} s")

    # (1) the multi-sequence runner, timed, against the sequences' own runs
    run = make_multi_sequence_runner(make_mesh(1, axes=("dp",)), sl)
    run(P[:1, :3], M[:1, :3])  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    seq = with_timeout(lambda: run(P, M).cpu().numpy(), STEP_TIMEOUT_S)
    seq_s = time.perf_counter() - t0
    ates = []
    for s in range(N_SEQ):
        np.testing.assert_array_equal(seq[s, 1:], own[s])
        ates.append(_ate(seq[s].astype(np.float64), scans[s][2]))
    n_fr = N_SEQ * (FRAMES - 1)
    print(f"[config 5] multi-sequence S={N_SEQ} x {FRAMES} frames: "
          f"{n_fr / seq_s:.3f} frames/s ({seq_s:.3f} s, fenced), each "
          f"sequence bit-equal to its own run_fused, ATE "
          f"{', '.join(f'{a:.5f}' for a in ates)} m")
    assert max(ates) < 0.15, ates
    fate = _ate(fposes[0].astype(np.float64), scans[1][2])
    print(f"[config 5] one sequence at loop_backend=\"fused\": ATE "
          f"{fate:.5f} m, launches {fc}")
    assert fc["K5"] == FRAMES - 1 and fc["K1"] == fc["K2"] == 0, fc
    assert fate < 0.15, fate

    # (2) two gloo ranks sharing the card
    t0 = time.perf_counter()
    ranks = spawn(_rank_config5, 2, icp, bk,
                  init_file=os.path.join(DIST_DIR, "gloo_store"),
                  backend="gloo", timeout_s=2 * STEP_TIMEOUT_S)
    spawn_s = time.perf_counter() - t0
    dense, dchis = pg.optimize(g13, **bk)
    dense = dense.poses.cpu().numpy()
    for r, out in enumerate(ranks):
        np.testing.assert_allclose(out["T"], T1, rtol=0, atol=1e-5)
        np.testing.assert_allclose(out["graph_poses"], dense, rtol=1e-7,
                                   atol=1e-8)
        np.testing.assert_allclose(out["chi2"], dchis.cpu().numpy(),
                                   rtol=1e-6)
        np.testing.assert_array_equal(out["seq"], seq)
    rounds = ", ".join(f"{o['round_ms']:.4f}" for o in ranks)
    print(f"[config 5] two gloo ranks sharing the card ({spawn_s:.2f} s "
          f"with start-up): sharded align at sp=2 within "
          f"{max(float(np.abs(o['T'] - T1).max()) for o in ranks):.3e} of "
          f"the one-rank run; Schur over 2 blocks within "
          f"{max(float(np.abs(o['graph_poses'] - dense).max()) for o in ranks):.3e}"
          f" of the dense solve; the runner at dp=2 bit-equal | one gloo "
          f"all-reduce of the (4, 45) statistics {rounds} ms (ranks 0, 1)."
          f" Two ranks on one card measure no scaling.")

    # (3) cli bench, rungs 1-5, on the card
    name = torch.cuda.get_device_name(0)
    for cid in range(1, 6):
        rc, rep, dt = _cli(["bench", "--config-id", str(cid), "--frames",
                            "10", "--json"])
        assert rc == 0 and rep["platform"] == "cuda", rep
        assert rep["device_name"] == name and rep["devices"] == 1, rep
        if cid == 5:
            assert [r["devices"] for r in rep["rows"]] == [1], rep
            assert [r["devices"] for r in rep["schur_rows"]] == [1], rep
            assert rep["comm_model"] == [], rep
            what = (f"{rep['rows'][0]['aligns_per_s']} aligns/s, "
                    f"{rep['schur_rows'][0]['gn_steps_per_s']} GN steps/s "
                    f"(one row: one card)")
        else:
            what = f"{rep['metric']} {rep['value']} {rep['unit']}"
        print(f"[cli bench] config {cid}: {what} | {dt:.2f} s")
    tdist.destroy_process_group()


def phase_profile(rows):
    """Last: torch.profiler over each kernel's back-to-back calls gives its
    row's kernel_ms and kernel_parts (the port's own kernels alone), and
    over K4's and K5's wrappers where their host time goes. It runs after
    the end-to-end phases: once the profiler has traced the card, the
    process keeps its tracing hooks, and host-bound frames run slower."""
    for row in rows:
        run, n = row.pop("_profile")
        row["kernel_ms"], row["kernel_parts"] = _kernel_ms(run, n)
        parts = ", ".join(f"{k} {v:.4f}"
                          for k, v in row["kernel_parts"].items())
        print(f"[profile] {row['name']}: own kernels {row['kernel_ms']:.4f} "
              f"ms a call ({parts}) against {row['ms']:.4f} ms device time")
        wrapper, want = row.pop("_wrapper", (None, None))
        if wrapper is not None:
            launches, text = _wrapper_profile(wrapper)
            print(f"[profile] {row['name']} wrapper: {text}")
            assert want is None or round(launches) == want, \
                f"{row['name']}: {launches} launches a call, not {want}"


def _count(row, launches, n_frames):
    row["launches"] = launches
    row["launches_per_frame"] = launches / n_frames


def main() -> int:
    name = phase_device()
    phase_build()
    pts, msk, gt = _scans(FRAMES, 48, 1024, FRAMES / 110.0, 0.15,
                          SCAN_POINTS)
    k1_row, src, dst = phase_k1(pts, msk)
    k2_row = phase_k2(src, msk[1])
    k1, k2, n_frames, slice_fps = phase_slice(pts, msk, gt)
    phase_cpu_agreement()
    _count(k1_row, k1, n_frames)
    _count(k2_row, k2, n_frames)
    probe_row = phase_probe()
    k3_row = phase_k3(pts, msk)
    k5_rows = phase_k5(pts, msk)
    k5_launches = phase_fused_slice(pts, msk, gt)
    for row, prec in zip(k5_rows, ("highest", "bf16")):
        _count(row, *k5_launches[prec])
    _count(k3_row, *phase_steps_bf16(pts, msk, gt))
    k4_row = phase_k4(pts, msk)
    k1b_row = phase_k1_batched(pts, src, dst)
    k4, k1b, n_frames, full = phase_full_slam()
    _count(k4_row, k4, n_frames)
    _count(k1b_row, k1b, n_frames)
    t0 = time.perf_counter()
    phase_cli(full)
    print(f"[cli] phase 14 in {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    k1_2d_row, k1_2db_row = phase_k1_2d()
    c2 = phase_config2()
    _count(k1_2d_row, c2["run_k1"], c2["run_frames"])
    _count(k1_2db_row, c2["eval_batched"], c2["eval_frames"])
    print(f"[config 2] phase 15 in {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    k2_rgbd_row, log = phase_k2_rgbd()
    _count(k2_rgbd_row, *phase_config3(log))
    phase_mapping_options(pts, msk, gt, slice_fps)
    print(f"[config 3] phase 16 in {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    phase_config5(pts, msk, gt, full)
    print(f"[config 5] phase 17 in {time.perf_counter() - t0:.2f} s")
    rows = [k1_row, k2_row, k3_row, k4_row, *k5_rows, probe_row, k1b_row,
            k1_2d_row, k1_2db_row, k2_rgbd_row]
    phase_profile(rows)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
