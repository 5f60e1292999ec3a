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
     poses, ATE < 0.15 m against ground truth, K1 and K2S launch counts
     equal to the total ICP iterations of the timed run and no K2 launch
     (K2S sums H and g itself); ICP iterations a frame beside those of the
     torch step around K2 (PREV_ITERS).
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
     frame and no K1/K2/K2S/K3 launch; frames/s and host syncs/frame beside
     the steps path's.
 10. Ten frames of the steps path at nn_precision="bf16": one K3 and one
     K2S launch per ICP iteration, no K1 or K2; its iterations and ATE.
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
     poses, >= 1 accepted closure, ATE < 0.5 m, K4 and K2S launches = the
     front end's ICP iterations, K2 = K3 = K5 = 0, and every K1 launch a
     batched
     verification launch, as many as the batched iterations verification
     ran, as many K2P launches and no RF; then one verification of a kept
     closure under sync debug mode: host syncs a batched iteration.
 14. cli and state: the port's command line in this process with the
     default device, everything under build/chip_cli/. (1) Phase 4's log
     written as a KITTI sequence (datasets/kitti.write_sequence) and `cli
     run` over it with configs/kitti_full_res.json and --save-map: rc 0,
     finite poses, ATE < 0.15 m, K1 = K2S = the front end's ICP iterations
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
     point-to-point): rc 0, one K1 and one K2P launch per ICP iteration,
     no RF.
 15. config 2 (2D lidar SLAM), everything under build/chip_cli2d/. (1) K1
     at D = 2 against its plain version, idx and d2 bit for bit: M = N =
     4,096 (SlamConfig()'s scan capacity, sim2d frames 1 on 0), 16,384 x
     16,384 with sentinel rows, and batched at B = 32 (4 candidates x 8
     yaws), G = 8, M = N = 512, B = 1 equal to the unbatched call. (2) `cli
     eval --dataset sim2d_loop --frames 60 --config
     configs/lidar2d_scan_to_map.json`: rc 0, finite poses, tpu_ate <
     0.25 m, >= 1 accepted closure, K1 launches at D = 3 equal to the front
     end's ICP iterations, batched K1 launches at D = 2 equal to the
     verification iterations, K2 = K3 = K4 = K5 = 0, K2P launches = front-
     end plus verification iterations and no RF; Slam2D.run's frames/s;
     host syncs
     an ICP iteration of one front-end align (at most one) and a batched
     iteration of one verification. (3) `cli run --dataset sim2d --frames
     30` with SlamConfig(): rc 0, map.png a PNG, one K1 launch at D = 2
     and one K2P launch per ICP iteration; frames/s. (4)
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
     rc 0, finite poses, ATE < 0.03 m, one K2S and one PJ launch per ICP
     iteration and no K1/K2/K3/K4/K5; then RGBDOdometry.run_fused on the same log (its
     frame graphs on CUDA, captured by the cli run), timed (fenced) and
     bit-equal to a loop of step (the same graphs, a frame a call, as the
     streaming `cli run` calls them; phase 22 holds both against the eager
     _step). (3) the same 30 frames
     written as a TUM directory (datasets/tum.write_sequence) read back as
     the written uint16 / 5000 exactly, and `cli run` over it: ATE <
     0.03 m. (4) `cli eval` on simrgbd_fullres, 30 frames, with the preset:
     tpu_ate < 0.03 m. (5) phase 4's log with mapping.insert_backend="hash"
     and mapping.extract_approx=True: ATE < 0.15 m, K1 = K2S = the ICP
     iterations, frames/s beside phase 4's; insert_hash on the card equal
     to its CPU run on one insert, entry for entry.
 17. config 5 (the distributed layer), everything under build/chip_dist/.
     (1) A world of one rank on NCCL (a FileStore): ShardedAligner on B = 4
     problems of phase 4's log (frame i+1's 16,384 points against frame
     i's, k-NN normals, point-to-plane, T0 the ground-truth motion) at
     nn_precision "highest", "bf16" and "rescore", against the port's CPU
     run of it (run in a process of its own alongside): at "highest" within
     1e-4 / 1e-5 with the same iterations, at "bf16" and "rescore" (the
     tensor cores' near-tie picks) each pose within K5_BOUNDS["bf16"]'s
     translation and rotation and the iterations within one; one launch
     a trip of each kernel in its batched form: K1 at "highest", K3 at
     "bf16", K4 at "rescore" (one call of four kernels each), and K2 at
     every precision (batched K2 launches = the loop's trips); ms a trip;
     Slam3D on phase 13's loop with dist.mesh_shape=(4,) (one Schur
     block): phase 13's keyframes and kept closures, poses within 1e-5 m
     of phase 13's, keyframe poses within rtol 1e-7 / atol 1e-8 (the
     reference's Schur-vs-dense bound), and the Schur solve's wall
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
 18. The batched forms of K2, K3 and K4 (the sharded align's local rows,
     the reference's vmap of the same kernels) at B = 4 on phase 4's
     shapes: rows of 16,384 points (frames 1-4) against 16,384-point
     targets (frames 0-3, the first with phase 2's sentinel rows, the last
     all sentinel rows); K2 on phase 3's inputs of frames 1-4. Each row bit
     for bit the unbatched call on it; against the batched plain versions,
     K2's entries within 1e-5 of their terms' absolute sum, K3 and K4 under
     the tensor-core contract of phases 7 and 11 on the rows with a real
     target (the device packing bit-equal to the batched plain packing),
     the all-sentinel row's picks the plain version's.
 20. RF (the rigid fit of every point-to-point iteration, in place of
     torch.linalg.svd) and the graphed verification, run before the
     profile: RF against a float64 numpy Umeyama (within 1e-5 where the
     rotation is unique) and its plain version (within 1e-5 beyond the plain
     version's own gap to float64; at rank D-1 the rotation within 1e-5) at
     B = 1, 16 and 32, D = 2 and 3, on well-conditioned, reflecting, rank
     D-1, near-equal, zero and (D = 3) collinear covariances, a proper
     rotation on every case, non-finite in non-finite out; umeyama_masked
     at B = 16 x 16,384 with no sync under sync debug mode "error"; RF's
     launches where it still runs, the sharded align at point_to_point
     (one rank, phase 17's frame pairs: one a trip); then
     align_batched at phase 13's shape (frame 6 against frames 0 and 3,
     eight yaws each: B = 16, 16,384 points, the backend's coarse
     settings): every trip's carried state bit-equal to the trip function
     driven eagerly on the card, one host sync a trip (the condition read;
     none after a trip that reaches max_iters), batched K1
     and K2P one launch a trip with the graph's replays counted, the memory
     one graph holds, and ms a trip eager and graphed.
 21. The frame graphs (ScanToMapPipeline.run_fused on CUDA replays
     slam/scan_to_map.FrameGraphs, a CUDA graph a stage of the frame)
     against the eager _step loop on the same log: the four slice cells
     (chip_ab.CELLS) on phase 4's log, full SLAM's front end at "rescore"
     (configs/kitti_full_res.json) on phase 4's log, config 2's lifted
     point-to-point front end on phase 15's log, and
     configs/kitti_scan_to_map.json and sim3d_loop.json on 10 frames of
     phase 4's route. Every info (iterations,
     keyframes, inserts, map counts, poses) and every state field bit-equal
     to the eager loop's, since the same kernels run in the same order; two
     runs from one state equal; call 1's returned state unchanged after
     two later runs; each kernel's launches equal with the replays counted;
     host syncs the ICP trips' condition reads plus the insert read a frame
     at "steps", the insert read at "fused". Frames/s eager, call 1 (the
     captures included) and call 2, and the MiB the graphs hold. Phases 4,
     9, 10, 13 and 15 print their front ends' host syncs a frame (frames
     1-5, inputs on the card) beside the graphs' count, and hold them to
     it.
 22. The frame-to-frame odometries as frame graphs: RGBDOdometry.run_fused
     (slam/rgbd.RGBDFrameGraphs on CUDA) on phase 16's 640x480
     simrgbd_fullres log with configs/rgbd.json, and
     OdometryPipeline.run_fused (slam/pipeline.OdomFrameGraphs) on phase
     15(3)'s 30-frame sim2d log with SlamConfig() and its occupancy grid,
     each against the eager _step loop on the same inputs on the card:
     every info and every state field (the grid's log-odds included)
     bit-equal, two runs from one state equal, call 1's returned state
     unchanged after later runs, K1 (2-D), K2S and K2P launches equal with
     the replays counted, host syncs a frame the ICP's condition reads
     (trip replays + 1, one fewer when max_iters stops the loop), and a
     loop of step (the same graphs, a frame a call) bit-equal to run_fused.
     Frames/s eager, call 1 (the captures included) and call 2, and the MiB
     the graphs hold.
 23. K2S (csrc/gn_step.cu: the point-to-plane iteration after the
     correspondence, one launch a trip on the 3D point-to-plane paths)
     against its plain version (icp/loop.trip_ref: the torch step
     around K2, on the card) on phase 4's trip inputs (frame 1 against the
     local model of the seeded map, K1's correspondence at identity) under
     slice_config()'s and configs/kitti_full_res.json's ICP, and on phase
     16's (the 640x480 RGB-D frame 1 looked up in frame 0) under
     configs/rgbd.json's: at trips 0 and 1 of the preset, Anderson, a
     min_inliers hold, a non-PD H (a zero step) and a converged state (left
     as it was), T within K2S_T_TOL, rmse within K2S_RMSE_RTOL, inliers and
     iterations equal, converged equal but within K2S_TOL_BAND of tol; two
     launches bit-equal; H and g bit-equal to K2's on the same weights;
     device ms, call ms and bound, and the plain version's device ms (the
     torch step it replaces, a trip). PJ (csrc/projective.cu: RGB-D's
     projective lookup, one launch a trip) against its plain version
     (icp/projective._lookup_ref) on phase 16's source at identity and
     moved 2 cm and 0.5 degrees, with and without a normal gate: q and n
     bit-equal, d2 within 2 ulps, the gate equal but at its edge;
     bit-reproducible; its times, with the L2 emptied before each call (its
     bound is device memory's) and back to back. Then the configurations that keep K2
     (degen_eps > 0: the eager loop): 5 frames of phase 4's log and of
     phase 16's, K2 = ICP iterations and no K2S; these give K2's rows their
     launches.
 24. KN (csrc/knn_normals.cu: the k-NN plane fit of normals_knn, one call
     of two launches at the seed frame and at each map insert) against the
     plain k-NN and fit on phase 4's frame 1 at 16,384 x 4,096 (the
     slice's normal_ref_stride 4) and 16,384 x 16,384
     (configs/kitti_full_res.json): the picks equal to the plain version's
     on every row whose scores are clear by KN_TAU_REL and on at least
     KN_ROWS_EQUAL of all rows, the normals within KN_DOT_TOL on every
     well-posed row, zero off the mask, bit-reproducible; on 600 integer
     lattice points (exact ties) the picks bit-equal at strides 1 and 2.
     EX (csrc/local_select.cu: extract_local's select, four launches an
     extracting frame) against extract_local_ref at C = 131,072 -> 16,384
     on the map after phase 4's run (radius 0 and 20 m, another centre),
     the seeded map and a lattice map with exact d² ties: the four outputs
     bit-equal. An eager pre runs no sort or top-k kernel. Their launches
     a frame come from phase 4 (KN at stride 4, EX) and phase 13 (KN at
     kitti_full_res.json); EX's library_ms is torch.topk of the same d².
 25. K2P (csrc/p2p_step.cu: the point-to-point iteration after the
     correspondence, two launches a trip on every point-to-point path,
     unbatched and batched) against its plain version (icp/loop.trip_ref on
     the card: the torch step around umeyama_masked and RF) on phase
     15(3)'s 2D scan-to-scan trip (SE(2), 4,096 points), phase 4's frame 2
     against frame 1 (SE(3), 16,384 points, the verification's fine
     settings) and phase 20's verification shape (B = 16, 16,384²), over
     the option sets (the preset, Anderson, a trust region, both, a
     min_inliers hold, a frozen state; no Anderson at the verification's
     yaws, whose poses near a rotation of pi make AA's twists
     ill-conditioned in float32) at trips 0 and 1: T within
     K2P_T_TOL, rmse within K2P_RMSE_TOL, inliers and iterations equal,
     converged equal but within K2S_TOL_BAND of tol, frozen elements
     bit-unchanged, two launches bit-equal; device, call and plain ms and
     the bound. Launches a frame from phase 15(3) (2D), phase 15(2)'s
     front end (Slam2D's z = 0 lift, 3D) and phase 13 (batched).
 19. profile: torch.profiler over each kernel's back-to-back calls (its
     row's kernel_ms) and over K3's, K4's and K5's wrappers (launches and
     host time a call; K3 and K4, batched or not, must make their four
     launches and no more); then the host launch calls a frame of the
     front ends of phases 4, 9, 10, 13 and 15 and of phase 22's two
     odometries (frames 1-5). Last, because a process that has run the
     profiler keeps its tracing hooks and runs host-bound frames slower.

Every kernel's launch count is read from the path that runs it, with the
counts set to 0 just before and read just after. The line before the last
is a JSON summary of the kernels; the last line is {"ok": true, ...}.

Each kernel row of the summary holds: launches on its path and
launches_per_frame; max_abs_err against the plain version; ms, the device
time of one call (CUDA events around 50 back-to-back calls behind a sleep
kernel that keeps the card ahead of the host, divided by 50; 10 for K5);
kernel_ms, the device time of the port's own CUDA kernels in one call,
summed from a torch.profiler run over 20 back-to-back calls (10 for K5) in
phase 19, and kernel_parts, the same by kernel; call_ms, one call timed
alone (device time plus the wrapper's host work); plain_ms, the plain
version's time; bound_ms and bound_by, the least time the card could take
(FP32 or bf16 operations over the published H100 peak, or bytes over 3.35
TB/s, whichever is larger), from this run's shapes and iteration counts;
library_ms, null but for RF's and EX's rows: no single PyTorch call
computes the other functions, RF's is torch.linalg.svd alone on the same
(B, 3, 3), which the port never calls on the card; share, bound_ms / ms. RF's bound counts
its float64 operations over the H100's FP64 peak. The batched rows (phase
18) count their launches on phase 17's sharded align and give
launches_per_trip, as RF's row, whose launches are the sharded
point-to-point align's (phase 20) since K2P took its place on the main
path. K2S's rows and PJ's count theirs on phase 4 and phase
16's cli run; K2's unbatched rows, which the main path no longer launches,
on phase 23's degen_eps runs; KN's and EX's on phases 4 and 13, and EX's
library_ms is torch.topk(d², size) alone, the select without the
map-order pass. PJ's ms, kernel_ms and plain_ms are taken
with the L2 cache emptied before each call, so that its bound by bytes over
3.35 TB/s bounds them; ms_l2_warm is its back-to-back device time, with
the maps in L2 as on the main path.
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


@functools.cache
def _l2_flush():
    """A write over twice the card's L2 cache: run before a call, it leaves
    nothing of the last call's data there, so the call reads its inputs
    from device memory."""
    size = getattr(torch.cuda.get_device_properties(0), "L2_cache_size", 0)
    buf = torch.empty(2 * max(size, 50 << 20) // 4, dtype=torch.float32,
                      device="cuda")
    return lambda: buf.fill_(0.0)


def _cold_ms(fn, n=20, reps=5, strict=True):
    """Device time per call of fn with the L2 cache emptied before each call
    (_l2_flush): CUDA events around fn alone, n calls a window, their mean,
    the median of reps windows. As in _device_ms, a sleep kernel ahead of
    each window lets the host queue it whole, so a window holds no host
    gaps; one the card reached early is timed again with a longer sleep
    (kept as it is with strict=False)."""
    flush = _l2_flush()
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        flush()
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3 / 3
    torch.cuda.synchronize()
    sleep_ms = 2.0 + 2.0 * n * host_ms
    times, retries = [], 0
    while len(times) < reps:
        pairs = [(torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True)) for _ in range(n)]
        torch.cuda._sleep(int(sleep_ms * _sleep_cycles_per_ms()))
        for start, end in pairs:
            flush()
            start.record()
            fn()
            end.record()
        ahead = not pairs[0][0].query()
        torch.cuda.synchronize()
        if ahead or not strict:
            times.append(sum(s.elapsed_time(e) for s, e in pairs) / n)
            continue
        retries += 1
        if retries > 8:
            raise RuntimeError("the host cannot queue the timed calls ahead "
                               "of the card")
        sleep_ms *= 2
    return statistics.median(times)


# The port's own CUDA kernels (csrc/*.cu), as the profiler names them.
OWN_KERNELS = ("nn_split_kernel", "nn_fold_kernel", "gn_accum_kernel",
               "gn_step_kernel", "p2p_sums_kernel", "p2p_cov_kernel",
               "projective_kernel", "knn_probe_kernel", "knn_select_kernel",
               "ex_keys_kernel", "ex_refine_kernel",
               "ex_count_kernel", "ex_write_kernel",
               "nn_centre_kernel", "nn_pack_kernel", "packed_scan_kernel",
               "nn_rescore_kernel", "icp_fused_kernel", "coop_probe_kernel",
               "rigid_fit_kernel")


def _kernel_ms(fn, n=20, names=OWN_KERNELS, tries=3, label=""):
    """Device time per call of the kernels `names` (the port's own) in fn:
    a torch.profiler run over n back-to-back calls (after a warm-up), the
    kernels' own time divided by n; (total, {kernel: ms}). Sleep kernels
    open the traced window: the tracer can miss the first kernels of a
    window (seen on an H100; once, on a slow host, the sleep and the one
    probe launch after it), and then misses a sleep instead. A window in
    which the tracer recorded none of the port's kernels at all (seen once
    on an H100, after the kernels had launched and been counted) is traced
    again, up to `tries` windows; the counts of launches come from the
    wrappers' counters, never from here."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    seen = []
    for attempt in range(1, tries + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(2):
                torch.cuda._sleep(int(0.5 * _sleep_cycles_per_ms()))
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        parts = {}
        seen = []
        for ev in prof.key_averages():
            if ev.device_type != DeviceType.CUDA:
                continue
            seen.append(ev.key)
            name = next((k for k in names if k in ev.key), None)
            if name:
                parts[name] = (parts.get(name, 0.0)
                               + ev.self_device_time_total / 1e3 / n)
        if parts:
            return sum(parts.values()), parts
        print(f"[profile] {label}: window {attempt} of {tries} recorded "
              f"none of the port's kernels (device events: {seen[:8]})",
              flush=True)
    raise RuntimeError(f"{label}: the profiler saw none of the port's "
                       f"kernels in {tries} windows (device events: "
                       f"{seen[:8]})")


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


def packed_bound(m, n, batch=1, targets=1):
    """K3's and K4's least time: the 16-lane bf16 contraction on the tensor
    cores (2 flops a lane), against the packed operands and the outputs;
    batched, `batch` rows over `targets` targets."""
    return _bound(32.0 * batch * m * n,
                  44.0 * (batch * m + targets * n) + 8.0 * batch * m,
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
    from tpu_icp_slam_torch.kernels import gn_cuda, gn_step, nn_cuda
    from tpu_icp_slam_torch.slam.scan_to_map import ScanToMapPipeline

    pipe = ScanToMapPipeline(slice_config(), device="cuda")
    t0 = time.perf_counter()
    state0 = pipe.init_state(pts[0], msk[0])
    pipe.run_fused(state0, pts[1:], msk[1:])  # warm-up
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    _zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, infos = pipe.run_fused(state0, pts[1:], msk[1:])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    k1, k2 = nn_cuda.nn_bruteforce.launches, gn_cuda.gn_accum.launches
    k2s = gn_step.gn_step.launches
    kn, ex = _counts()["KN"], _counts()["EX"]
    inserts = int(infos["map_inserted"].sum())
    poses = np.concatenate(
        [np.eye(4)[None], infos["pose"].cpu().numpy().astype(np.float64)])
    iters = infos["iters"].cpu().numpy()
    n_frames = len(pts) - 1
    ate = _ate(poses, gt)
    syncs, want = _frame_syncs(slice_config(), pts, msk)
    print(f"[slice] {n_frames} frames in {dt:.4f} s = "
          f"{n_frames / dt:.3f} frames/s (warm-up incl. init and the graphs' "
          f"captures {warm_s:.2f} s) | mean ICP iters {iters.mean():.3f} | "
          f"host syncs/frame {syncs:.3f} (sync debug mode, frames 1-5; the "
          f"frame graphs' count {want:.3f}; launch calls a frame in the "
          f"profile phase) | keyframes "
          f"{int(infos['is_keyframe'].sum())} | map inserts "
          f"{int(infos['map_inserted'].sum())} | map points "
          f"{int(infos['map_points'][-1])} | ATE {ate:.5f} m")
    print(f"[slice] launches K1 {k1} K2S {k2s} K2 {k2} total ICP iters "
          f"{int(iters.sum())} | KN {kn} (map inserts {inserts}) EX {ex} "
          f"(extracts: one a frame) | {_iters_beside_prev('slice', iters)}")
    assert np.isfinite(poses).all(), "non-finite pose"
    assert ate < 0.15, f"ATE {ate} m"
    assert k1 == k2s == int(iters.sum()) > 0 and k2 == 0, \
        (k1, k2s, k2, int(iters.sum()))
    assert kn == inserts > 0 and ex == n_frames, (kn, inserts, ex, n_frames)
    assert syncs == want, (syncs, want)
    return k1, k2s, n_frames, n_frames / dt, kn, ex


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
        gn_cuda, gn_step, icp_fused, knn_cuda, nn_bf16, nn_cuda, nn_rescore,
        p2p_step, projective_cuda, select_cuda,
    )

    return {"K1": nn_cuda.nn_bruteforce, "K2": gn_cuda.gn_accum,
            "K3": nn_bf16.nn_bf16, "K4": nn_rescore.nn_rescore,
            "K5": icp_fused.icp_fused, "K2S": gn_step.gn_step,
            "K2P": p2p_step.p2p_step,
            "PJ": projective_cuda.projective_lookup,
            "KN": knn_cuda.knn_normals, "EX": select_cuda.local_select}


def _rf():
    """RF's wrapper, whose `launches` counts its launches."""
    from tpu_icp_slam_torch.icp.point_to_point import rigid_from_stats

    return rigid_from_stats


def _zero_counts():
    for fn in (*_counters().values(), _rf()):
        fn.launches = 0
    for k in ("K1", "K2", "K3", "K4"):
        _counters()[k].batched_launches = 0
    _counters()["K1"].launches_2d = 0


def _counts():
    return {k: fn.launches for k, fn in _counters().items()}


def _batched_counts():
    """Launches of each kernel's batched form since _zero_counts."""
    return {k: _counters()[k].batched_launches
            for k in ("K1", "K2", "K3", "K4")}


SYNC_WARNING = "called a synchronizing CUDA operation"


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
    # the mode's own "prototype feature" warning, once a process, is no sync
    return sum(SYNC_WARNING in str(w.message) for w in caught)


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
# sums (and, at bf16, the tensor cores' near-tie picks), so iterations,
# inliers and convergence must be equal. With both gathering q and n as
# bf16 hi/lo halves the bf16 gaps read 4.0e-5 m, 2.9e-6 rad and rmse
# 1.6e-5 on an H100 (the bounds stayed).
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


# ICP iterations (total, frames) of the point-to-plane runs with the
# iteration's step as torch ops around K2 (before K2S, whose float32 sums
# round otherwise), read by this script on an NVIDIA H100 80GB HBM3 at
# 700 W: phases 4, 9, 10, 13's front end and 16's cli run.
PREV_ITERS = {"slice": (92, 29), "fused slice highest": (94, 29),
              "fused slice bf16": (94, 29),
              "steps slice highest, 5 frames, for its host syncs": (16, 5),
              "steps slice bf16": (35, 10), "full slam": (733, 179),
              "rgbd": (113, 29)}


def _iters_beside_prev(label, iters, n_frames=None):
    """ICP iterations a frame of a run, beside PREV_ITERS[label]."""
    total = int(np.sum(iters))
    n = n_frames or len(iters)
    prev = PREV_ITERS.get(label)
    text = f"ICP iterations a frame {total / n:.3f} ({total} over {n})"
    if prev:
        text += (f", with the torch step around K2 {prev[0] / prev[1]:.3f} "
                 f"({prev[0]} over {prev[1]})")
    return text


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
    syncs, want = _frame_syncs(cfg, pts, msk)
    poses = np.concatenate(
        [np.eye(4)[None], infos["pose"].cpu().numpy().astype(np.float64)])
    iters = infos["iters"].cpu().numpy()
    ate = _ate(poses, gt)
    print(f"[{label}] {n_frames} frames in {dt:.4f} s = "
          f"{n_frames / dt:.3f} frames/s | mean ICP iters "
          f"{iters.mean():.3f} | host syncs/frame {syncs:.3f} (sync "
          f"debug mode, frames 1-5; the frame graphs' count {want:.3f}) | "
          f"keyframes "
          f"{int(infos['is_keyframe'].sum())} | map inserts "
          f"{int(infos['map_inserted'].sum())} | ATE {ate:.5f} m | "
          f"launches {counts}")
    assert np.isfinite(poses).all(), f"{label}: non-finite pose"
    assert ate < 0.15, f"{label}: ATE {ate} m"
    assert syncs == want, (label, syncs, want)
    print(f"[{label}] {_iters_beside_prev(label, iters)}")
    # KN at each map insert, EX once a frame
    inserts = int(infos["map_inserted"].sum())
    assert counts["KN"] == inserts and counts["EX"] == n_frames, \
        (label, counts, inserts)
    return counts, int(iters.sum()), n_frames, ate


def phase_fused_slice(pts, msk, gt):
    counts = {}
    for prec in ("highest", "bf16"):
        c, _, n_frames, _ = _run_slice(
            slice_config(loop_backend="fused", nn_precision=prec), pts, msk,
            gt, f"fused slice {prec}")
        assert c == {"K1": 0, "K2": 0, "K3": 0, "K4": 0, "K5": n_frames,
                     "K2S": 0, "K2P": 0, "PJ": 0, "KN": c["KN"],
                     "EX": n_frames}, \
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
    assert c["K3"] == c["K2S"] == iters > 0, c
    assert c["K1"] == c["K2"] == c["K4"] == c["K5"] == 0, c
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
    rf = _rf().launches
    k2p = c["K2P"]
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
          f"{c}, K1 batched {batched}, RF {rf}, verify iterations "
          f"{slam.detector.verify_iters} | front end "
          f"{_iters_beside_prev('full slam', slam.frontend_iters)}")
    assert np.isfinite(poses).all(), "non-finite pose"
    assert rep.n_loop_closures >= 1, "no accepted closure"
    assert ate < 0.5, f"ATE {ate} m"
    assert c["K4"] == c["K2S"] == iters > 0, (c, iters)
    assert c["K2"] == c["K3"] == c["K5"] == 0, c
    # one extract a frame; KN at the seed frame and at each map insert
    assert c["EX"] == n_frames and c["KN"] > 1, (c, n_frames)
    assert c["K1"] == batched == k2p == slam.detector.verify_iters > 0, \
        (c["K1"], batched, k2p, slam.detector.verify_iters)
    assert rf == 0, rf  # K2P fits inside the step
    _verify_syncs(slam.detector, pts, msk, slam.kf_frames,
                  (slam.closures_kept or slam.closures)[0], "full slam")
    syncs, want = _frame_syncs(cfg, pts, msk)
    print(f"[full slam] front end: host syncs/frame {syncs:.3f} (sync debug "
          f"mode, frames 1-5; the frame graphs' count {want:.3f}; launch "
          f"calls a frame in the profile phase)")
    assert syncs == want, (syncs, want)
    return (c["K4"], c["K1"], n_frames, (cfg, pts, msk, poses, slam), k2p,
            c["KN"], c["EX"])


def _verify_syncs(det, pts, msk, kf_frames, closure, label):
    """Host syncs of one verification of a kept closure (its two keyframes'
    scans, the detector's yaw hypotheses) a batched iteration: one a trip
    (the loop's condition; chip_smoke phase 20 holds align_batched to it)
    plus the verify call's own reads (its inputs, descriptors and
    results)."""
    from tpu_icp_slam_torch.backend.loop_closure import LoopCandidate

    cand = LoopCandidate(query_idx=closure.j, match_idx=closure.i,
                         score=1.0, yaw=0.0)
    q, mt = kf_frames[closure.j], kf_frames[closure.i]

    def run():
        det.verify_batch([cand], pts[q], msk[q], pts[mt][None],
                         msk[mt][None])

    run()  # the trip graphs of this batch exist from here on
    n0 = det.verify_iters
    syncs = _host_syncs(run)
    trips = det.verify_iters - n0
    print(f"[{label}] one verification (closure {closure.i}-{closure.j}, "
          f"B = {det.cfg.verify_yaws}): {trips} batched iterations, {syncs} "
          f"host syncs, {syncs / trips:.3f} a trip ({syncs - trips} of them "
          f"the verify call's own reads)")


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
    assert c["K2S"] == c["K1"] - batched == ev["icp_iters"] > 0, (c, ev)
    assert c["K2"] == 0, c
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
    assert c["K1"] == c["K2P"] == ev["icp_iters"] > 0, (c, ev)
    assert c["K2"] == c["K2S"] == _rf().launches == 0, (c, ev)


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


def _frontend_syncs(cfg, pts, msk):
    """Host syncs a point-to-point ICP iteration of config 2's front end:
    one align of frame 1 onto frame 0, both lifted to z = 0 as Slam2D
    lifts them, at the preset's ICP settings. One a trip: the loop's
    condition read."""
    from tpu_icp_slam_torch.core.pointcloud import PointCloud
    from tpu_icp_slam_torch.icp import loop

    dev = torch.device("cuda")
    lifted = [PointCloud(points=torch.as_tensor(np.pad(
        pts[f], ((0, 0), (0, 1))), device=dev), mask=torch.as_tensor(
        msk[f], device=dev)) for f in (1, 0)]
    loop.align(*lifted, cfg=cfg.icp)  # warm-up
    out = {}
    syncs = _host_syncs(lambda: out.update(r=loop.align(*lifted,
                                                        cfg=cfg.icp)))
    iters = out["r"].iters
    print(f"[config 2 front end] one point-to-point align (frame 1 on 0, "
          f"z = 0 lift): {iters} ICP iterations, {syncs} host syncs, "
          f"{syncs / iters:.3f} an iteration")
    assert syncs <= iters, (syncs, iters)


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
        rf = _rf().launches
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
          f"{batched}, K1 on 2-D points {k1_2d}, RF {rf} | {dt:.3f} s with "
          f"the golden oracle")
    assert rc == 0 and np.isfinite(poses).all(), "config 2 eval failed"
    assert all(np.isfinite(ev[k]) for k in
               ("tpu_ate", "golden_ate", "tpu_vs_golden_ate")), ev
    assert ev["tpu_ate"] < 0.25, ev
    assert ev["n_loop_closures"] >= 1, "no accepted closure"
    assert c["K1"] - k1_2d == fe_iters > 0, (c, k1_2d, fe_iters)
    assert k1_2d == batched == slam.detector.verify_iters > 0, \
        (k1_2d, batched, slam.detector.verify_iters)
    assert c["K2"] == c["K3"] == c["K4"] == c["K5"] == 0, c
    assert c["K2P"] == fe_iters + batched and rf == 0, \
        (c["K2P"], rf, fe_iters, batched)
    cfg = from_json(open(CONFIG2).read())
    pts, msk = runner.pad_scans(runner.load_dataset(
        "sim2d_loop", SIM2D_FRAMES).scans, cfg.pipeline.scan_capacity)
    _frontend_syncs(cfg, pts, msk)
    syncs, want = _frame_syncs(*_lifted_config2())
    print(f"[config 2 front end] Slam2D's lifted scan-to-map frames: host "
          f"syncs/frame {syncs:.3f} (sync debug mode, frames 1-5; the frame "
          f"graphs' count {want:.3f}; launch calls a frame in the profile "
          f"phase)")
    assert syncs == want, (syncs, want)
    _verify_syncs(slam.detector, pts, msk, slam.kf_frames,
                  (slam.closures_kept or slam.closures)[0], "config 2 eval")

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
    assert c["K1"] == run_k1_2d == c["K2P"] == fused["icp_iters"] > 0, \
        (c, fused)
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
            "eval_k2p_front": fe_iters, "run_k1": run_k1_2d,
            "run_frames": 29}


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
    p, mask, corr, log, _ = rgbd_problem()
    q, n, gate, _ = corr(p)
    return (p, q, n, gate * mask.to(gate.dtype)), log


def rgbd_problem():
    """The RGB-D path's first align at full width: frame 1 of the 640x480
    log as the source (invalid pixels at the sentinel), its mask, the
    projective lookup into frame 0's maps, the log (depths, ground truth,
    intrinsics) and the lookup's arguments (intrinsics, frame 0's vertex
    map, normal map and validity, the gate's distance)."""
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
    corr = projective.projective_correspondence(
        K, v0, n0, ok0, max_corr_dist=cfg.icp.max_corr_dist)
    return p, mask, corr, (depths, gt, K), (K, v0, n0, ok0,
                                            cfg.icp.max_corr_dist)


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
    RGBDOdometry directly; returns the K2S and the PJ launches of the cli
    run, each with its frame count."""
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
          f"{rep['rpe_rot']:.5f} rad | launches {c} | "
          f"{_iters_beside_prev('rgbd', iters, n_frames)}")
    assert rc == 0 and poses.shape == (RGBD_FRAMES, 4, 4), rep
    assert np.isfinite(poses).all()
    _ate_ok(rep, 0.03, "config 3 run")
    assert c["K2S"] == c["PJ"] == iters > 0, (c, iters)
    assert c["K1"] == c["K2"] == c["K3"] == c["K4"] == c["K5"] == 0, c
    k2s_launches, pj_launches = c["K2S"], c["PJ"]

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
    return (k2s_launches, n_frames), (pj_launches, n_frames)


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
    assert c["K1"] == c["K2S"] == iters > 0 and c["K2"] == 0, (c, iters)


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
    from tpu_icp_slam_torch.slam.scan_to_map import ScanToMapPipeline
    from tpu_icp_slam_torch.slam.slam3d import Slam3D

    shutil.rmtree(DIST_DIR, ignore_errors=True)
    os.makedirs(DIST_DIR)
    icp, arrays = _sharded_problems(pts, msk, gt)
    np.savez(os.path.join(DIST_DIR, "sharded.npz"),
             **dict(zip(("src", "msk", "dst", "nrm", "T0"), arrays)))
    precisions = ("highest", "bf16", "rescore")
    # nn_backend "pallas": the port's kernels on the card (what "auto"
    # picks there) and their plain versions in the CPU run ("auto" would
    # give it the exact search at every precision)
    icps = {p: dataclasses.replace(icp, nn_precision=p, nn_backend="pallas")
            for p in precisions}
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(1, mp_context=ctx) as pool:
        # alongside the card
        cpu = {p: pool.submit(_sharded_cpu, icps[p], arrays)
               for p in precisions}

        # (1) a world of one rank on NCCL
        multihost_init("file://" + os.path.join(DIST_DIR, "nccl_store"),
                       world_size=1, rank=0, device="cuda")
        assert tdist.get_backend() == "nccl"
        mesh = make_mesh(1, axes=("dp", "sp"))
        nccl_ms = with_timeout(lambda: _round_ms(mesh, "sp"), STEP_TIMEOUT_S)
        # one launch a trip of each kernel of the precision, in its batched
        # form: the NN (K1, K3 or K4; a K3/K4 call is four kernels) and K2
        nn_kernel = {"highest": "K1", "bf16": "K3", "rescore": "K4"}
        sharded = {}
        for prec in precisions:
            aligner = ShardedAligner(mesh, icps[prec])
            with_timeout(lambda: aligner(*arrays).T.cpu(), STEP_TIMEOUT_S)
            _zero_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = with_timeout(lambda: aligner(*arrays), STEP_TIMEOUT_S)
            T_p = res.T.cpu().numpy()
            dt = time.perf_counter() - t0
            c, cb = _counts(), _batched_counts()
            iters = res.iters.cpu().numpy()
            trips = int(iters.max())
            nn = nn_kernel[prec]
            print(f"[config 5] NCCL world of 1 | sharded align B=4 M=N="
                  f"{arrays[0].shape[1]} at {prec}: iterations "
                  f"{iters.tolist()}, {dt:.4f} s = {dt / trips * 1e3:.4f} "
                  f"ms a trip | launches {c}, batched {cb}: {nn} "
                  f"{c[nn]} = K2 {c['K2']} = trips {trips}")
            assert c[nn] == cb[nn] == trips > 0, (prec, c, cb)
            assert c["K2"] == cb["K2"] == trips, (prec, c, cb)
            assert all(v == 0 for k, v in c.items()
                       if k not in (nn, "K2")), (prec, c)  # K2S too
            sharded[prec] = {"T": T_p, "iters": iters, "trips": trips,
                             "s": dt, "launches": c}
        T1 = sharded["highest"]["T"]
        print(f"[config 5] one NCCL all-reduce of the (4, 45) statistics "
              f"{nccl_ms:.4f} ms")

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
        for prec in precisions:
            T_cpu, it_cpu = cpu[prec].result(timeout=3 * STEP_TIMEOUT_S)
            got = sharded[prec]
            err = float(np.abs(got["T"] - T_cpu).max())
            gaps = [_k5_gaps((torch.as_tensor(a), 0.0),
                             (torch.as_tensor(b), 0.0))
                    for a, b in zip(got["T"], T_cpu)]
            print(f"[config 5] sharded align at {prec} against the port's "
                  f"CPU run: largest |T - T_cpu| {err:.3e}, largest pose "
                  f"gap {max(g['trans_m'] for g in gaps):.3e} m, "
                  f"{max(g['rot_rad'] for g in gaps):.3e} rad, iterations "
                  f"{it_cpu.tolist()}")
            if prec == "highest":
                np.testing.assert_allclose(got["T"], T_cpu, rtol=1e-4,
                                           atol=1e-5)
                np.testing.assert_array_equal(got["iters"], it_cpu)
                continue
            # K3's and K4's picks on the tensor cores are the plain
            # version's but for near-ties (phases 7, 11 and 18): a pose
            # moves by ~1e-5 (on an H100 largest |T - T_cpu| 3.970e-05 at
            # bf16, 2.366e-05 at rescore) and a row may end one iteration
            # apart. Held to K5's bf16 bounds, set for the same near-ties
            bound = K5_BOUNDS["bf16"]
            assert all(g["trans_m"] <= bound["trans_m"]
                       and g["rot_rad"] <= bound["rot_rad"] for g in gaps), \
                (prec, gaps)
            assert np.abs(got["iters"] - it_cpu).max() <= 1, \
                (prec, got["iters"], it_cpu)

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
    assert fc["K2S"] == 0, fc
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
    return sharded


BATCH = 4  # phase 18's rows, the sharded align's B


def batched_inputs(pts, msk):
    """Phase 18's inputs, B = 4 rows at phase 4's shape: the NN's sources
    frames 1-4 against targets frames 0-3 (the first with phase 2's 1,024
    sentinel rows, the last all sentinel rows); K2's rows phase 3's inputs
    of frames 1-4."""
    dev = torch.device("cuda")
    src = torch.as_tensor(pts[1:1 + BATCH], device=dev).contiguous()
    dst_np = pts[:BATCH].copy()
    dst_np[0, -1024:] = 1.0e6
    dst_np[-1] = 1.0e6  # a target with no valid row
    dst = torch.as_tensor(dst_np, device=dev).contiguous()
    rows = [k2_inputs(src[b].contiguous(), msk[1 + b]) for b in range(BATCH)]
    gn = tuple(torch.stack([r[i] for r in rows]).contiguous()
               for i in range(4))
    return src, dst, gn


def _gn_magnitudes(p, q, n, w):
    """Σ|terms| of every entry of H (B, 6, 6) and g (B, 6), in float64."""
    p, q, n, w = (x.double() for x in (p, q, n, w))
    J = torch.cat([n, torch.linalg.cross(p, n, dim=-1)], -1).abs()
    r = torch.sum(n * (p - q), -1).abs()
    aw = w.abs()[..., None] * J
    return aw.mT @ J, (aw.mT @ r[..., None])[..., 0]


def _rows_bit_equal(batched, per_row):
    """Every output of a batched call bit-equal, row for row, to the
    unbatched calls' (lists of tensors)."""
    return all(bits_equal(out[b], one[i])
               for b, one in enumerate(per_row)
               for i, out in enumerate(batched))


def phase_batched_k2(gn):
    from tpu_icp_slam_torch.kernels import gn_cuda

    p, q, n, w = gn
    out = gn_cuda.gn_accum(p, q, n, w)
    again = gn_cuda.gn_accum(p, q, n, w)
    rows = [gn_cuda.gn_accum(p[b], q[b], n[b], w[b]) for b in range(BATCH)]
    H_r, g_r = gn_cuda.gn_accum_ref(p, q, n, w)
    mag_H, mag_g = _gn_magnitudes(p, q, n, w)
    torch.cuda.synchronize()
    assert _rows_bit_equal(out, rows), "batched K2 row != its unbatched call"
    assert _rows_bit_equal(again, [(o[0], o[1]) for o in zip(*out)]), \
        "batched K2 is not bit-reproducible"
    rel = float(max(torch.max((out[0] - H_r).abs().double() / mag_H.clamp(
        min=1e-30)), torch.max((out[1] - g_r).abs().double()
                               / mag_g.clamp(min=1e-30))))
    assert rel <= 1e-5, f"batched K2: |H, g - plain| / sum|terms| {rel}"
    err = float(max(torch.max(torch.abs(out[0] - H_r)),
                    torch.max(torch.abs(out[1] - g_r))))
    m = p.shape[1]
    t = _timings(lambda: gn_cuda.gn_accum(p, q, n, w),
                 lambda: gn_cuda.gn_accum_ref(p, q, n, w), plain_n=50,
                 bound=k2_bound(BATCH * m))
    print(f"[K2 batched] {card()} | B={BATCH} M={m} one launch | rows bit "
          f"for bit the unbatched calls | max |H,g - plain| / sum|terms| "
          f"{rel:.3e} (bound 1e-5), max abs {err:.3e} | {_fmt(t)}, share "
          f"{t['bound_ms'] / t['ms']:.4f}")
    return {"name": "gn_accum[batched]", "route": "cuda",
            "source": "src/tpu_icp_slam_torch/csrc/gn_accum.cu",
            "replaces": "src/tpu_icp_slam/kernels/gn_pallas.py:28",
            "max_abs_err": err, "max_rel_terms": rel, **t}


def phase_batched_k3(src, dst, real, valid1):
    """`real`: the rows whose target has valid points; valid1: row 0's
    real (unpadded) source points."""
    from tpu_icp_slam_torch.kernels import nn_bf16, packed_mma

    idx_k, d2_k = nn_bf16.nn_bf16(src, dst)
    det = nn_bf16.nn_bf16_detail(src, dst)
    rows = [nn_bf16.nn_bf16(src[b], dst[b]) for b in range(BATCH)]
    idx_r, d2_r = nn_bf16.nn_bf16_ref(src, dst)
    s, d = nn_bf16.recentre(src, dst)
    a_aug, b_aug = nn_bf16.pack_source(s), nn_bf16.pack_target(d)
    torch.cuda.synchronize()
    assert _rows_bit_equal((idx_k, d2_k), rows), \
        "batched K3 row != its unbatched call"
    assert bits_equal(det["a_aug"], a_aug) and bits_equal(det["b_aug"],
                                                          b_aug), \
        "batched K3 device packing != the batched plain packing"
    assert torch.equal(det["idx"], idx_k) and bits_equal(det["d2"], d2_k)
    assert bits_equal(d2_k, torch.clamp(det["e_min"], min=0.0))
    agree, taus, exact_k, exact_r = [], [], [], []
    for b in real:
        near = packed_mma.near_ties(a_aug[b], b_aug[b], idx_k[b], idx_r[b])
        assert bool(near.all()), f"batched K3 row {b}: pick that is no " \
            f"near-tie"
        agree.append(float((idx_k[b] == idx_r[b]).float().mean()))
        best = packed_mma.exact_argmin(a_aug[b], b_aug[b])
        exact_k.append(float((idx_k[b] == best).float().mean()))
        exact_r.append(float((idx_r[b] == best).float().mean()))
        exact, mag = packed_mma.exact_scores(a_aug[b], b_aug[b], idx_k[b])
        taus.append(float(torch.max(torch.abs(det["e_min"][b].double()
                                               - exact)
                                     / torch.clamp(mag, min=1e-30))))
    none = [b for b in range(BATCH) if b not in real]
    for b in none:  # no valid target: the plain version's picks
        assert torch.equal(idx_k[b], idx_r[b]), b
    tau = max(taus)
    err = float(max(torch.max(torch.abs(d2_k[b] - d2_r[b])) for b in real))
    assert min(agree) >= 0.99, f"batched K3 index agreement {agree}"
    assert min(k - r for k, r in zip(exact_k, exact_r)) >= 0, \
        (exact_k, exact_r)
    assert tau <= packed_mma.TAU, f"batched K3 tau {tau}"
    assert bool((idx_k[0][valid1] < dst.shape[1] - 1024).all()), \
        "batched K3 matched a real point to a sentinel row"
    m, n = src.shape[1], dst.shape[1]
    k, length = nn_bf16.splits(m, n, torch.cuda.get_device_properties(0)
                               .multi_processor_count,
                               nn_bf16.blocks_per_sm(0), BATCH)
    t = _timings(lambda: nn_bf16.nn_bf16(src, dst),
                 lambda: nn_bf16.nn_bf16_ref(src, dst), plain_n=1,
                 bound=packed_bound(m, n, BATCH, BATCH))
    print(f"[K3 batched] {card()} | B={BATCH} M=N={m}, {k} splits of "
          f"{length}, row {none} against an all-sentinel target | rows bit "
          f"for bit the unbatched calls | device packing bit-equal to the "
          f"batched plain packing | idx agree {min(agree):.6f}-"
          f"{max(agree):.6f}, differing ones near-ties | picks at the "
          f"float64 argmin {', '.join(f'{x:.6f}' for x in exact_k)} (plain "
          f"{', '.join(f'{x:.6f}' for x in exact_r)}) | max |e - E| / "
          f"sum|ab| {tau:.3e} "
          f"| max |d2 - plain| {err:.3e} | {_fmt(t)}, share "
          f"{t['bound_ms'] / t['ms']:.4f}")
    return {"name": "nn_bf16[batched]", "route": "cuda",
            "source": "src/tpu_icp_slam_torch/csrc/nn_bf16.cu",
            "replaces": "src/tpu_icp_slam/kernels/nn_pallas.py:111",
            "max_abs_err": err, "tau_measured": tau,
            "idx_agree": min(agree),
            "_wrapper": (lambda: nn_bf16.nn_bf16(src, dst), 4), **t}


def phase_batched_k4(src, dst, real, valid1):
    from tpu_icp_slam_torch.kernels import nn_rescore, packed_mma

    idx_k, d2_k = nn_rescore.nn_rescore(src, dst)
    det = nn_rescore.nn_rescore_detail(src, dst)
    rows = [nn_rescore.nn_rescore(src[b], dst[b]) for b in range(BATCH)]
    idx_r, d2_r = nn_rescore.nn_rescore_ref(src, dst)
    plain = nn_rescore.shortlist_ref(src, dst)
    torch.cuda.synchronize()
    assert _rows_bit_equal((idx_k, d2_k), rows), \
        "batched K4 row != its unbatched call"
    for k in ("sc", "dp", "a_aug", "b_aug"):
        assert bits_equal(det[k], plain[k]), f"batched K4 device packing: {k}"
    assert torch.equal(det["idx"], idx_k) and torch.equal(det["d2"], d2_k)
    agree, cand_agree, taus = [], [], []
    for b in range(BATCH):
        a_aug, b_aug = det["a_aug"][b], det["b_aug"][b]
        same = idx_k[b] == idx_r[b]
        agree.append(float(same.float().mean()))
        assert torch.equal(d2_k[b][same], d2_r[b][same]), b
        cand_agree.append(float((det["cand"][b] == plain["cand"][b])
                                .float().mean()))
        near = packed_mma.near_ties(a_aug, b_aug, det["cand"][b],
                                    plain["cand"][b])
        assert bool(near.all()), f"batched K4 row {b}: candidate that is " \
            f"no near-tie"
        if b in real:
            exact, mag = packed_mma.exact_scores(a_aug, b_aug,
                                                 det["cand"][b])
            taus.append(float(torch.max(torch.abs(
                det["cand_score"][b].double() - exact)
                / torch.clamp(mag, min=1e-30))))
    tau = max(taus)
    err = float(torch.max(torch.abs(d2_k - d2_r)[list(real)]))
    assert min(agree) >= 0.999, f"batched K4 index agreement {agree}"
    assert min(cand_agree) >= 0.999, f"batched K4 candidates {cand_agree}"
    assert tau <= packed_mma.TAU, f"batched K4 tau {tau}"
    assert bool((idx_k[0][valid1] < dst.shape[1] - 1024).all()), \
        "batched K4 matched a real point to a sentinel row"
    m, n = src.shape[1], dst.shape[1]
    tn, n_slots = nn_rescore.slots(n)
    t = _timings(lambda: nn_rescore.nn_rescore(src, dst),
                 lambda: nn_rescore.nn_rescore_ref(src, dst), plain_n=1,
                 bound=packed_bound(m, n, BATCH, BATCH))
    print(f"[K4 batched] {card()} | B={BATCH} M=N={m} TN={tn} S={n_slots} "
          f"| rows bit for bit the unbatched calls | device packing "
          f"bit-equal to the batched plain packing | candidates equal "
          f"{min(cand_agree):.6f}-{max(cand_agree):.6f}, differing ones "
          f"near-ties | idx agree {min(agree):.6f}-{max(agree):.6f}, d2 "
          f"equal where they agree | max |e - E| / sum|ab| {tau:.3e} | max "
          f"|d2 - plain| {err:.3e} | {_fmt(t)}, share "
          f"{t['bound_ms'] / t['ms']:.4f}")
    return {"name": "nn_rescore[batched]", "route": "cuda",
            "source": "src/tpu_icp_slam_torch/csrc/nn_shortlist.cu",
            "replaces": "src/tpu_icp_slam/kernels/nn_pallas.py:142",
            "max_abs_err": err, "tau_measured": tau,
            "idx_agree": min(agree),
            "_wrapper": (lambda: nn_rescore.nn_rescore(src, dst), 4), **t}


def phase_batched(pts, msk):
    """Phase 18: batched K2, K3 and K4 at B = 4 on phase 4's shapes."""
    src, dst, gn = batched_inputs(pts, msk)
    valid1 = torch.as_tensor(msk[1], device=src.device)
    real = range(BATCH - 1)  # the last target has no valid row
    return [phase_batched_k2(gn), phase_batched_k3(src, dst, real, valid1),
            phase_batched_k4(src, dst, real, valid1)]


# ---- phase 20: RF and the graphed verification ------------------------------

# FP64 peak of one H100 SXM outside the tensor cores (NVIDIA's data sheet)
H100_FP64_FLOPS = 34e12


def rf_bound(batch, d):
    """RF's least time: its bytes (cov, mu_s, mu_d in; T out) against its
    float64 operations, ~1,300 an element at D = 3 (A = covᵀ cov, eight
    Jacobi sweeps of three rotations, the vectors and R) and ~40 at D = 2
    (atan2, sincos, t)."""
    flops = 1300.0 if d == 3 else 40.0
    return _bound(flops * batch,
                  4.0 * batch * (d * d + 2 * d + (d + 1) ** 2),
                  H100_FP64_FLOPS)


def _rf_cases(d, batch, rng):
    """name -> ((cov (B, d, d), mu_s, mu_d (B, d)) float32 numpy, whether
    Umeyama's rotation is unique): well-conditioned, reflecting (det(U Vᵀ)
    = -1), rank D-1 (at D = 3 the z = 0 lift of config 2), near-equal
    singular values, cov = 0, and at D = 3 collinear inliers (rank 1)."""
    q, r = np.linalg.qr(rng.normal(size=(batch, d, d)))
    R0 = q * np.sign(np.diagonal(r, axis1=-2, axis2=-1))[:, None, :]
    R0[:, :, 0] *= np.sign(np.linalg.det(R0))[:, None]
    a, b = rng.normal(size=(2, batch, d))
    rank = a[:, :, None] * b[:, None, :]
    if d == 3:
        rank = np.zeros((batch, 3, 3))
        rank[:, :2, :2] = rng.normal(size=(batch, 2, 2))
    cases = {"random": (rng.normal(size=(batch, d, d)), True),
             "reflecting": (R0 * np.asarray([3.0, 2.0, -1.0][3 - d:]), True),
             "rank_d_minus_1": (rank, True),
             "near_equal": (R0 * np.asarray([1.0, 1 + 1e-6, 1 - 1e-6][:d]),
                            True),
             "zero": (np.zeros((batch, d, d)), True)}
    if d == 3:
        cases["collinear"] = (a[:, :, None] * b[:, None, :], False)
    mu = rng.normal(size=(2, batch, d)) * 5.0
    return {k: ((c.astype(np.float32), mu[0].astype(np.float32),
                 mu[1].astype(np.float32)), unique)
            for k, (c, unique) in cases.items()}


def _umeyama64(cov, mu_s, mu_d):
    """Float64 numpy Umeyama: (R, t)."""
    U, _, Vt = np.linalg.svd(cov.astype(np.float64))
    corr = np.ones(cov.shape[:-1])
    corr[..., -1] = np.sign(np.linalg.det(U @ Vt))
    R = (U * corr[..., None, :]) @ Vt
    return R, mu_d - np.einsum("...ij,...j->...i", R,
                               mu_s.astype(np.float64))


def _rf_sharded(pts, msk, gt):
    """RF where it still runs: the sharded align's point-to-point rows
    (dist/sharded_icp._align_shard, whose moments cross an all-reduce
    before the fit; one rank here, the reduction the identity) on phase
    17's four frame pairs. Returns (RF launches, trips): one a trip."""
    from tpu_icp_slam_torch.dist import sharded_icp

    icp, (src, smsk, dst, nrm, T0) = _sharded_problems(pts, msk, gt)
    icp = dataclasses.replace(icp, method="point_to_point", max_iters=8)
    _zero_counts()
    res = sharded_icp._align_shard(*_on_card(src, smsk, dst, nrm, T0),
                                   cfg=icp, reduce=lambda t: t)
    trips = int(res.iters.max())
    rf = _rf().launches
    print(f"[RF] the sharded align at point_to_point, B = 4 (phase 17's "
          f"frame pairs, one rank): {rf} RF launches over {trips} trips")
    assert rf == trips > 0 and _counts()["K2P"] == 0, (rf, trips)
    return rf, trips


def phase_rf(pts, msk, gt):
    """RF against its plain version (torch's SVD form on the card) and a
    float64 numpy Umeyama at B = 1, 16 and 32, D = 2 and 3; a non-finite
    input; no sync in umeyama_masked; its launches where it still runs
    (the sharded point-to-point align); RF's row, timed at phase 13's
    verification shape (B = 16, D = 3)."""
    from tpu_icp_slam_torch.icp import point_to_point as p2p

    dev = torch.device("cuda")
    rng = np.random.default_rng(20)
    err_plain = gap64 = 0.0
    n_cases = 0
    for d in (2, 3):
        for batch in (1, 16, 32):
            for name, ((cov, mu_s, mu_d), unique) in _rf_cases(
                    d, batch, rng).items():
                args = [torch.as_tensor(a, device=dev)
                        for a in (cov, mu_s, mu_d)]
                n0 = p2p.rigid_from_stats.launches
                T = p2p.rigid_from_stats(*args)
                assert p2p.rigid_from_stats.launches == n0 + 1
                plain = p2p.rigid_from_stats_ref(*args)
                T, plain = (x.cpu().numpy().astype(np.float64)
                            for x in (T, plain))
                R = T[:, :d, :d]
                tag = f"RF D={d} B={batch} {name}"
                assert np.isfinite(T).all(), tag
                assert np.abs(np.linalg.det(R) - 1.0).max() < 1e-5, tag
                assert np.abs(R @ R.transpose(0, 2, 1) - np.eye(d)).max() \
                    < 1e-5, tag
                n_cases += 1
                if not unique:
                    continue
                R64, t64 = _umeyama64(cov, mu_s, mu_d)

                def gap(x):
                    return max(np.abs(x[:, :d, :d] - R64).max(),
                               np.abs(x[:, :d, d] - t64).max())

                # the plain version (torch's float32 SVD on the card) is
                # itself up to ~5e-5 off on ill-conditioned random cases
                g, e = gap(T), np.abs(T - plain).max()
                assert g < 1e-5 and e <= 1e-5 + gap(plain), (tag, g, e)
                if name == "rank_d_minus_1":
                    assert np.abs(R - plain[:, :d, :d]).max() < 1e-5, tag
                if name == "zero":
                    assert (R == np.eye(d)).all(), tag
                gap64, err_plain = max(gap64, g), max(err_plain, e)
    bad = torch.ones(4, 3, 3, device=dev)
    bad[1, 2, 0] = math.nan
    bad[2, 0, 1] = math.inf
    T = p2p.rigid_from_stats(bad, torch.zeros(4, 3, device=dev),
                             torch.zeros(4, 3, device=dev)).cpu()
    assert not torch.isfinite(T[1:3, :3]).any() and \
        torch.isfinite(T[[0, 3]]).all(), T

    rng = np.random.default_rng(21)
    src = torch.as_tensor(rng.uniform(-20, 20, (16, SCAN_POINTS, 3)),
                          dtype=torch.float32, device=dev)
    w = torch.rand(16, SCAN_POINTS, device=dev)
    p2p.umeyama_masked(src, src + 0.5, w)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        Tm = p2p.umeyama_masked(src, src + 0.5, w)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.allclose(Tm[:, :3, 3], torch.full_like(Tm[:, :3, 3], 0.5),
                          atol=1e-4), Tm[:, :3, 3]

    launches = _rf_sharded(pts, msk, gt)
    cov, mu_s, mu_d = (torch.as_tensor(a, device=dev) for a in _rf_cases(
        3, 16, np.random.default_rng(22))["random"][0])
    t = _timings(lambda: p2p.rigid_from_stats(cov, mu_s, mu_d),
                 lambda: p2p.rigid_from_stats_ref(cov, mu_s, mu_d),
                 bound=rf_bound(16, 3))
    t["library_ms"] = _device_ms(lambda: torch.linalg.svd(cov), reps=3,
                                 strict=False)
    print(f"[RF] {n_cases} cases (D = 2, 3; B = 1, 16, 32): proper "
          f"rotations on every case, max |RF - plain| {err_plain:.3e} (the "
          f"plain version's own gap to float64 included), max gap to "
          f"float64 Umeyama {gap64:.3e} where the rotation is unique, "
          f"non-finite in -> non-finite out, umeyama_masked at B = 16 x "
          f"{SCAN_POINTS} without a sync | B = 16, D = 3: {_fmt(t)}, "
          f"torch.linalg.svd alone {t['library_ms']:.4f} ms")
    return {"name": "rigid_fit", "route": "cuda",
            "source": "src/tpu_icp_slam_torch/csrc/rigid_fit.cu",
            "replaces": "src/tpu_icp_slam/icp/point_to_point.py:33",
            "max_abs_err": err_plain, "gap_float64": gap64,
            "launches": launches[0], "launches_per_frame": None,
            "launches_per_trip": launches[0] / launches[1], **t}


def _verification_inputs(pts, msk):
    """Phase 13's verification shape on phase 4's log: frame 6's 16,384
    points against frames 0 and 3, eight yaws each (B = 16), the backend
    preset's coarse ICP settings."""
    from tpu_icp_slam_torch.backend.loop_closure import LoopDetector
    from tpu_icp_slam_torch.core.pointcloud import PointCloud

    dev = torch.device("cuda")
    icp = LoopDetector(full_slam_config().backend, device=dev).icp_coarse
    src = PointCloud(points=torch.as_tensor(pts[6], device=dev),
                     mask=torch.as_tensor(msk[6], device=dev))
    dst = torch.as_tensor(pts[[0, 3]], device=dev)
    yaws = np.tile(np.linspace(-np.pi, np.pi, 8, endpoint=False), 2)
    inits = np.tile(np.eye(4, dtype=np.float32), (16, 1, 1))
    inits[:, 0, 0] = inits[:, 1, 1] = np.cos(yaws)
    inits[:, 0, 1], inits[:, 1, 0] = -np.sin(yaws), np.sin(yaws)
    return (icp, src, dst, torch.as_tensor(msk[[0, 3]], device=dev),
            torch.as_tensor(inits, device=dev))


def phase_graphed_verification(pts, msk):
    """align_batched's trip as a CUDA graph at phase 13's shape: every
    trip's state bit-equal to the trip function driven eagerly on the
    card; one host sync a trip; batched K1 and K2P one launch a trip,
    replays included; the memory one graph holds; ms a trip eager and
    graphed (host clock, fenced)."""
    from tpu_icp_slam_torch.icp import loop

    icp, src, dst, dmask, inits = _verification_inputs(pts, msk)
    trip = loop._batched_trip(loop._batched_step(icp, src, dst, dmask,
                                                 inits, None))
    eager = trip(loop._init_state(inits), 0)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    held0 = torch.cuda.memory_reserved()
    graph = loop._TripGraph(icp, 16, 8, SCAN_POINTS, SCAN_POINTS, 3,
                            torch.float32, inits.device)
    graph.start(src, dst, inits, None)
    trips = 1
    while True:
        for a, b in zip(graph.state, eager):
            assert bits_equal(a, b), f"trip {trips}: graph differs"
        if trips >= icp.max_iters or bool(eager[3].all()):
            break
        eager = trip(eager, 1)
        graph.step()
        trips += 1
    torch.cuda.synchronize()
    held_mib = (torch.cuda.memory_reserved() - held0) / 2**20
    assert graph.graph is not None and trips == int(eager[6].max()) > 2

    def graphed():
        return loop.align_batched(src, dst, dmask, inits, icp)

    def eager_run():
        return loop._drive_batched(icp, loop._batched_step(
            icp, src, dst, dmask, inits, None), inits)

    graphed()  # the cached graph of this key
    _zero_counts()
    syncs = _host_syncs(graphed)
    k1, k2p = _counters()["K1"].batched_launches, _counts()["K2P"]
    # the condition is read before every trip after the first and once
    # more to stop, unless max_iters stopped the loop
    assert syncs == trips - (trips == icp.max_iters) and \
        k1 == k2p == trips and _rf().launches == 0, (syncs, k1, k2p, trips)
    times = {}
    for name, fn in (("eager", eager_run), ("graphed", graphed),
                     ("graphed", graphed), ("eager", eager_run)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.setdefault(name, []).append(
            (time.perf_counter() - t0) * 1e3 / trips)
    print(f"[graphed verification] B = 16, {SCAN_POINTS}² points, "
          f"{trips} trips: every trip's state bit-equal to the eager trip "
          f"function's; {syncs} host syncs ({syncs / trips:.3f} a trip); "
          f"K1 batched {k1}, K2P {k2p} launches, replays included; one graph "
          f"holds {held_mib:.1f} MiB | ms a trip, eager "
          f"{', '.join(f'{v:.4f}' for v in times['eager'])}, graphed "
          f"{', '.join(f'{v:.4f}' for v in times['graphed'])}")


def _on_card(*arrays):
    return tuple(torch.as_tensor(a, device="cuda") for a in arrays)


def _expected_syncs(cfg, iters):
    """Host syncs of the frame graphs over frames with these ICP
    iterations: the insert read a frame (and the hysteresis read), and at
    loop_backend "steps" the while condition, read before every trip after
    the first and once more to stop unless max_iters stopped the loop. (The
    ICP that icp.loop.eager_loop keeps out of the graphs makes its own.)"""
    from tpu_icp_slam_torch.slam.scan_to_map import _fused

    ic = cfg.icp
    per_frame = 1 + (cfg.mapping.extract_hysteresis > 0.0)
    if _fused(ic) or ic.unroll_iters > 0:
        return len(iters) * per_frame
    return _condition_reads(iters, ic.max_iters) + len(iters) * per_frame


def _condition_reads(iters, max_iters):
    """The ICP's while-condition reads over frames with these iterations,
    one after every trip unless max_iters stopped the loop (trip replays
    + 1 a frame, one fewer at max_iters): the frame-to-frame graphs' host
    syncs."""
    iters = np.asarray(iters)
    return int((iters - (iters >= max_iters)).sum())


def _frame_syncs(cfg, pts, msk, n=5):
    """(host syncs a frame, the frame graphs' expected count a frame) of
    ScanToMapPipeline.run_fused over frames 1..n of this log, inputs on the
    card, after a run that captures the graphs."""
    from tpu_icp_slam_torch.slam.scan_to_map import ScanToMapPipeline

    pipe = ScanToMapPipeline(cfg, device="cuda")
    P, M = _on_card(pts[:n + 1], msk[:n + 1])
    state0 = pipe.init_state(P[0], M[0])
    pipe.run_fused(state0, P[1:], M[1:])
    out = {}
    syncs = _host_syncs(lambda: out.update(
        i=pipe.run_fused(state0, P[1:], M[1:])[1]))
    return syncs / n, _expected_syncs(cfg, out["i"]["iters"].cpu()) / n


def _launch_calls(cfg, pts, msk, n=5):
    """Host launch calls a frame (runtime kernel and graph launches, from a
    torch.profiler run) of ScanToMapPipeline.run_fused over frames 1..n,
    inputs on the card, after a run that captures the graphs. It runs in
    the profile phase: a process that ran the profiler runs slower."""
    from tpu_icp_slam_torch.slam.scan_to_map import ScanToMapPipeline

    pipe = ScanToMapPipeline(cfg, device="cuda")
    P, M = _on_card(pts[:n + 1], msk[:n + 1])
    state0 = pipe.init_state(P[0], M[0])
    return _launch_calls_of(lambda: pipe.run_fused(state0, P[1:], M[1:]), n)


def _launch_calls_of(run, n):
    """Host launch calls a frame of run(), n frames, after a warm-up run
    (which captures the graphs)."""
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    calls = {}
    for a in prof.key_averages():
        if a.key.startswith(("cudaLaunch", "cuLaunch", "cudaGraphLaunch",
                             "cuGraphLaunch")):
            calls[a.key] = calls.get(a.key, 0) + a.count
    return sum(calls.values()) / n, calls


def _lifted_config2():
    """Config 2's front end as Slam2D runs it: configs/lidar2d_scan_to_map
    .json over phase 15's sim2d_loop log lifted to z = 0."""
    from tpu_icp_slam_torch import from_json
    from tpu_icp_slam_torch.slam import runner

    cfg = from_json(open(CONFIG2).read())
    pts, msk = runner.pad_scans(runner.load_dataset(
        "sim2d_loop", SIM2D_FRAMES).scans, cfg.pipeline.scan_capacity)
    pts3 = np.concatenate([pts, np.zeros_like(pts[..., :1])], axis=-1)
    return cfg, pts3.astype(np.float32), msk


def _eager_frames(step, state0, logs, **kw):
    """The eager `_step` frame after frame on the card, over the stacked
    logs' frames: the pipeline as it ran before its frames were graphed,
    and the graphs' reference. Infos stacked on the host."""
    st, infos = state0, []
    for inputs in zip(*logs):
        st, info = step(st, *inputs, **kw)
        infos.append(info)
    return st, {k: torch.stack([torch.as_tensor(i[k]).cpu() for i in infos])
                for k in infos[0]}


def _leaves(x, prefix=""):
    """The tensor fields of a state dataclass, nested ones (the voxel map,
    the occupancy grid) by dotted name."""
    out = {}
    for f in dataclasses.fields(x):
        v = getattr(x, f.name)
        if dataclasses.is_dataclass(v):
            out.update(_leaves(v, f"{prefix}{f.name}."))
        elif v is not None:
            out[prefix + f.name] = v
    return out


def _states_equal(a, b):
    """The state fields whose values differ, bit for bit."""
    la, lb = _leaves(a), _leaves(b)
    return [k for k in lb if not bits_equal(la[k], lb[k])]


def _infos_equal(got, want):
    """The keys whose values differ: every info bit for bit, iters (int32
    from the graphs, a host count from the eager steps loop) by value."""
    bad = []
    for k, w in want.items():
        g = got[k].cpu()
        if k == "iters":
            g, w = g.long(), w.long()
        if not bits_equal(g, w.to(g.dtype)):
            bad.append(k)
    return bad


def _graph_check(tag, run, eager, n, want_syncs, describe):
    """Phases 21 and 22: run() is a pipeline's run_fused from its seed
    state over n frames (its frame graphs on CUDA, the cache cleared so
    that call 1 captures), eager() the eager _step loop on the same
    inputs. Every info and state field bit-equal in calls 1 and 2, call
    1's returned state unchanged after later runs, each kernel's launches
    equal with the replays counted, and the host syncs of call 3 equal to
    want_syncs(the eager run's iterations); describe(infos) adds to the
    printed line. Returns the cell's frames/s, syncs and memory."""
    def timed(fn):
        _zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, {
            **_counts(), "K1 2-D": _counters()["K1"].launches_2d,
            "RF": _rf().launches}

    (st_e, inf_e), eager_s, c_e = timed(eager)
    torch.cuda.empty_cache()
    held0 = torch.cuda.memory_reserved()
    (st_1, inf_1), call1_s, c_1 = timed(run)
    held_mib = (torch.cuda.memory_reserved() - held0) / 2**20
    kept = {k: v.clone() for k, v in _leaves(st_1).items()}
    (st_2, inf_2), graph_s, c_2 = timed(run)
    syncs = _host_syncs(run)
    # a returned state read after later frames: call 1's, after calls 2-3
    changed = [k for k, v in _leaves(st_1).items()
               if not bits_equal(v, kept[k])]
    iters = inf_e["iters"].numpy()
    want = want_syncs(iters)
    bad = {"call 1 infos": _infos_equal(inf_1, inf_e),
           "call 2 infos": _infos_equal(inf_2, inf_e),
           "call 1 state": _states_equal(st_1, st_e),
           "call 2 state": _states_equal(st_2, st_e),
           "returned state after later frames": changed}
    pos_gap = float((inf_2["pose"].cpu() - inf_e["pose"]).abs().max())
    print(f"{tag}: {n} frames | eager _step {n / eager_s:.3f} frames/s, "
          f"graphed call 1 {n / call1_s:.3f} frames/s ({call1_s:.3f} s with "
          f"the captures), call 2 {n / graph_s:.3f} frames/s | ICP "
          f"iterations {int(iters.sum())}, {describe(inf_e)} | host syncs "
          f"{syncs} ({syncs / n:.3f} a frame; expected {want}) | launches "
          f"eager {c_e}, graphed call 1 {c_1}, call 2 {c_2} | graphs hold "
          f"{held_mib:.1f} MiB | largest pose gap to eager {pos_gap:.3e} | "
          f"mismatches {bad}")
    assert not any(bad.values()), (tag, bad)
    assert c_e == c_1 == c_2, (tag, c_e, c_1, c_2)
    assert syncs == want, (tag, syncs, want)
    return {"eager_fps": n / eager_s, "call1_s": call1_s,
            "graph_fps": n / graph_s, "syncs_per_frame": syncs / n,
            "held_mib": held_mib}


def _graph_cell(label, cfg, pts, msk):
    """Phase 21's check of one configuration on one log (see
    phase_frame_graphs)."""
    from tpu_icp_slam_torch.slam import frame_graphs
    from tpu_icp_slam_torch.slam import scan_to_map as s2m

    P, M = _on_card(pts, msk)
    pipe = s2m.ScanToMapPipeline(cfg, device="cuda")
    state0 = pipe.init_state(P[0], M[0])
    frame_graphs.clear()  # call 1 captures this cell's graphs
    return _graph_check(
        f"[frame graphs] {label}",
        lambda: pipe.run_fused(state0, P[1:], M[1:]),
        lambda: _eager_frames(s2m._step, state0, (P[1:], M[1:]), cfg=cfg),
        len(P) - 1, lambda iters: _expected_syncs(cfg, iters),
        lambda inf: f"keyframes {int(inf['is_keyframe'].sum())}, inserts "
                    f"{int(inf['map_inserted'].sum())}, map points "
                    f"{int(inf['map_points'][-1])}")


def phase_frame_graphs(pts, msk):
    """Phase 21: the graphed frame (ScanToMapPipeline.run_fused on CUDA,
    slam/scan_to_map.FrameGraphs) against the eager _step loop on the
    same log, for the four slice cells (chip_ab.CELLS), full SLAM's front
    end at "rescore" (configs/kitti_full_res.json on phase 4's log),
    config 2's lifted point-to-point front end (phase 15's log) and the
    other two 3D presets (10 frames of phase 4's route at their own voxel
    and capacity): every
    info (iterations, keyframes, inserts, map counts, poses) and every
    state field bit-equal, since the same kernels run in the same order;
    two runs from one state equal, and call 1's returned state unchanged
    after two later runs; every kernel's launches equal with the replays
    counted; host syncs ICP trips + 1 a frame at "steps", 1 at "fused".
    Frames/s eager, graphed call 1 (captures included) and call 2, and
    the memory the graphs hold."""
    cells = [(f"{b} {p}", slice_config(loop_backend=b, nn_precision=p), pts,
              msk) for b, p in (("steps", "highest"), ("fused", "highest"),
                                ("fused", "bf16"), ("steps", "bf16"))]
    cells.append(("full-SLAM front end, rescore", full_slam_config(), pts,
                  msk))
    cells.append(("config 2 lifted point-to-point", *_lifted_config2()))
    from tpu_icp_slam_torch import from_json

    for name in ("kitti_scan_to_map.json", "sim3d_loop.json"):
        # the other 3D presets, on the first 10 frames of phase 4's route
        # at their own voxel and scan capacity
        cfg = from_json(open(os.path.join(ROOT, "configs", name)).read())
        p, m, _ = _scans(11, 48, 1024, 11 / 110.0,
                         cfg.pipeline.downsample_voxel,
                         cfg.pipeline.scan_capacity)
        cells.append((f"configs/{name} front end", cfg, p, m))
    return {label: _graph_cell(label, cfg, p, m) for label, cfg, p, m in cells}


# ---- phase 22: the frame-to-frame odometries as frame graphs --------------

S2S_FRAMES = 30  # phase 15(3)'s `cli run --dataset sim2d --frames 30`


def _s2s2d_log():
    """Phase 15(3)'s run: SlamConfig()'s 2D scan-to-scan with its occupancy
    grid over 30 frames of sim2d, padded as `cli run` pads them; (config,
    points, masks) on the card."""
    from tpu_icp_slam_torch import SlamConfig
    from tpu_icp_slam_torch.slam import runner

    cfg = SlamConfig()
    data = runner.load_dataset("sim2d", S2S_FRAMES)
    pts, msk = runner.pad_scans(runner.preprocess(cfg, data.scans),
                                cfg.pipeline.scan_capacity)
    return (cfg, *_on_card(pts, msk))


def phase_odometry_graphs(log):
    """Phase 22: RGBDOdometry.run_fused (RGBDFrameGraphs on CUDA) on
    phase 16's 640x480 simrgbd_fullres log with configs/rgbd.json, and
    OdometryPipeline.run_fused (OdomFrameGraphs) on phase 15(3)'s sim2d log
    with SlamConfig() and its occupancy grid, each against the eager _step
    loop on the same inputs: every info and state field (the grid's
    log-odds included) bit-equal, two runs from one state equal, call 1's
    returned state unchanged after later runs, K1 (2-D), K2 and RF
    launches equal with the replays counted, host syncs the ICP's
    condition reads; then a loop of step (the same graphs, a frame a call)
    bit-equal to run_fused. Returns {label: run over frames 1-5} for the
    launch calls of the profile phase."""
    from tpu_icp_slam_torch.slam import frame_graphs, pipeline, rgbd

    depths, _, K = log
    cfg3 = _rgbd_cfg()
    odo = rgbd.RGBDOdometry(cfg3, K, device="cuda")
    D = torch.as_tensor(depths, dtype=torch.float32, device="cuda")
    s3 = odo.init_state(D[0])
    cfg2, P, M = _s2s2d_log()
    pipe = pipeline.OdometryPipeline(cfg2, dim=2, device="cuda")
    s2 = pipe.init_state(P[0], M[0])
    cells = [
        (f"RGB-D configs/rgbd.json {D.shape[2]}x{D.shape[1]}",
         lambda: odo.run_fused(s3, D[1:]),
         lambda: _eager_frames(rgbd._step, s3, (D[1:],), cfg=cfg3, K=K),
         lambda: _eager_frames(odo.step, s3, (D[1:],)),
         len(D) - 1, cfg3.icp.max_iters),
        ("2D scan-to-scan SlamConfig() sim2d",
         lambda: pipe.run_fused(s2, P[1:], M[1:]),
         lambda: _eager_frames(pipeline._step, s2, (P[1:], M[1:]), cfg=cfg2),
         lambda: _eager_frames(pipe.step, s2, (P[1:], M[1:])),
         len(P) - 1, cfg2.icp.max_iters)]
    for label, run, eager, stepped, n, max_iters in cells:
        frame_graphs.clear()  # call 1 captures this cell's graphs
        tag = f"[odometry graphs] {label}"
        _graph_check(
            tag, run, eager, n,
            lambda iters: _condition_reads(iters, max_iters),
            lambda inf: f"{int((inf['iters'] >= max_iters).sum())} frames "
                        f"at max_iters {max_iters}")
        # step() replays the same graphs a frame a call (streaming cli run)
        (st_r, inf_r), (st_s, inf_s) = run(), stepped()
        bad = {"infos": _infos_equal(inf_s, {k: v.cpu()
                                             for k, v in inf_r.items()}),
               "state": _states_equal(st_s, st_r)}
        print(f"{tag}: a loop of step bit-equal to run_fused | mismatches "
              f"{bad}")
        assert not any(bad.values()), (tag, bad)
    return {"phase 22 RGB-D": lambda: odo.run_fused(s3, D[1:6]),
            "phase 22 2D scan-to-scan": lambda: pipe.run_fused(
                s2, P[1:6], M[1:6])}


def phase_launch_calls(pts, msk, full, odometry):
    """Host launch calls a frame of the frame graphs (runtime kernel and
    graph launches, torch.profiler) on the front ends of phases 4, 9, 10,
    13 and 15 and on phase 22's two odometries, frames 1-5 of each phase's
    log. Run in the profile phase."""
    cfg13, pts13, msk13 = full[:3]
    runs = [("phase 4 steps highest", slice_config(), pts, msk),
            ("phase 9 fused highest", slice_config(loop_backend="fused"),
             pts, msk),
            ("phase 9 fused bf16", slice_config(loop_backend="fused",
                                                nn_precision="bf16"),
             pts, msk),
            ("phase 10 steps bf16", slice_config(nn_precision="bf16"), pts,
             msk),
            ("phase 13 front end rescore", cfg13, pts13, msk13),
            ("phase 15 config 2 lifted", *_lifted_config2())]
    for label, cfg, p, m in runs:
        per_frame, calls = _launch_calls(cfg, p, m)
        print(f"[launch calls] {label}: {per_frame:.1f} host launch calls a "
              f"frame (frames 1-5, profiled) {calls}")
    for label, run in odometry.items():
        per_frame, calls = _launch_calls_of(run, 5)
        print(f"[launch calls] {label}: {per_frame:.1f} host launch calls a "
              f"frame (frames 1-5, profiled) {calls}")


# ---- K2S: the point-to-plane iteration after the correspondence ------------

# Largest gaps of one K2S trip from its plain version (the torch step
# around K2, on the card, on the same inputs and state) that phase 23
# accepts: >= 10x the largest seen on an H100 (T 1.19e-7 at M = 16,384 and
# 3.7e-9 at 307,200; rmse 1.8e-7 relative), the two differing only in the
# order of float32 sums (Σw, Σw·d², the trace) and in the 6x6 solve and
# SE(3) functions; and the band around `tol` within which `converged` may
# differ.
K2S_T_TOL = 2e-6
K2S_RMSE_RTOL = 2e-6
K2S_TOL_BAND = 1e-7


def k2s_bound(m):
    """K2S's least time: its bytes (cur, q, n 36 bytes a row, gate, d2 and
    the mask 12; the state, T0, T0⁻¹, the prior's scale, H and g out, under
    512 bytes), ~75 FP32 operations a row."""
    return _bound(75.0 * m, 48.0 * m + 512)


def _k2s_options(base):
    """Phase 23's option sets on an ICPConfig: name -> (cfg, variant)."""
    rep = dataclasses.replace
    return {"preset": (base, None),
            "anderson": (rep(base, anderson=True), None),
            "min_inliers hold": (rep(base, min_inliers=10 ** 7), None),
            "non-PD": (rep(base, damping=0.0, prior_trans_weight=0.0,
                           prior_rot_weight=0.0), "non-PD"),
            "frozen": (base, "frozen")}


def _k2s_trip(icp, src, mask_f, corr, it, variant=None):
    """One trip of K2S and of its plain version from the same state on the
    card (trip 0 from loop._init_state, or trip 1 after a plain trip 0):
    (kernel state, plain state, inputs, the kernel's H and g, a second
    launch's state, the anchors, the rmse before the trip). "non-PD" moves every row onto the z axis with normal
    z (H of rank 1, no damping: a zero step); "frozen" starts converged."""
    from tpu_icp_slam_torch.icp import loop
    from tpu_icp_slam_torch.kernels import gn_step as k2s

    T0 = torch.eye(4, device="cuda")
    use_prior = icp.prior_trans_weight > 0.0 or icp.prior_rot_weight > 0.0
    T0_inv, prior_scale = loop._anchor(icp, T0, use_prior)
    anchors = (T0, T0_inv, prior_scale)
    state = tuple(t.clone() for t in loop._init_state(T0))

    def inputs(st):
        cur = loop._moved(src, st[0])
        q, n, gate, d2 = corr(cur)
        if variant == "non-PD":
            cur = cur.clone()
            cur[:, :2] = 0.0
            n = torch.zeros_like(n)
            n[:, 2] = 1.0
        return cur, q, n, gate, d2

    if it == 1:
        loop.trip_ref(icp, mask_f, *inputs(state), state, 0, *anchors)
    if variant == "frozen":
        state[3].fill_(True)
    prev = float(state[1])
    args = inputs(state)
    got, want, again = (tuple(t.clone() for t in state) for _ in range(3))
    k2s.gn_step(icp, mask_f, *args, got, it, *anchors)
    H, g = (t.clone() for t in k2s.last_hg(src.device))
    k2s.gn_step(icp, mask_f, *args, again, it, *anchors)
    loop.trip_ref(icp, mask_f, *args, want, it, *anchors)
    return got, want, args, (H, g), again, anchors, prev


def _k2s_gaps(got, want):
    """(T gap, rmse gap, the fields that disagree) of a K2S state against
    the plain one: T and rmse beyond their limits, n_inliers, iters or
    converged unequal (the caller forgives converged within K2S_TOL_BAND
    of tol)."""
    T_gap = float(torch.max(torch.abs(got[0] - want[0])))
    r, rw = float(got[1]), float(want[1])
    rmse_rel = abs(r - rw) / max(abs(rw), 1e-30)
    bad = [name for name, i in (("n_inliers", 2), ("iters", 6))
           if int(got[i]) != int(want[i])]
    if bool(got[3]) != bool(want[3]):
        bad.append("converged")
    if not T_gap <= K2S_T_TOL:
        bad.append(f"T {T_gap:.3e}")
    if not (rmse_rel <= K2S_RMSE_RTOL or (math.isnan(r) and math.isnan(rw))):
        bad.append(f"rmse {rmse_rel:.3e}")
    return T_gap, rmse_rel, bad


def _k2s_row(label, base, src, mask_f, corr, m):
    """K2S against its plain version over _k2s_options(base) at trips 0 and
    1 on one problem; its H and g against K2's; its timings."""
    from tpu_icp_slam_torch.icp import loop
    from tpu_icp_slam_torch.kernels import gn_cuda
    from tpu_icp_slam_torch.kernels import gn_step as k2s

    worst = {"T": 0.0, "rmse": 0.0}
    parts = []
    for name, (icp, variant) in _k2s_options(base).items():
        for it in (0, 1):
            got, want, args, (H, g), again, _, prev = _k2s_trip(
                icp, src, mask_f, corr, it, variant)
            torch.cuda.synchronize()
            assert all(bits_equal(a, b) for a, b in zip(got, again)), \
                f"K2S {label} {name}: not bit-reproducible"
            if variant == "frozen":
                assert all(bits_equal(a, b) for a, b in zip(got, want)), \
                    f"K2S {label}: a frozen state changed"
                parts.append(f"{name} t{it} unchanged")
                continue
            T_gap, rmse_rel, bad = _k2s_gaps(got, want)
            if bad == ["converged"] and min(
                    abs(abs(prev - float(x[1])) - icp.tol)
                    for x in (got, want)) <= K2S_TOL_BAND:
                bad = []
            assert not bad, f"K2S {label} {name} trip {it}: {bad}"
            cur, q, n, gate, d2 = args
            w = loop.huber(icp, gate * mask_f, d2)
            H2, g2 = gn_cuda.gn_accum(cur, q, n, w)
            assert bits_equal(H, H2) and bits_equal(g, g2), \
                f"K2S {label} {name} trip {it}: H, g differ from K2's"
            worst["T"] = max(worst["T"], T_gap)
            worst["rmse"] = max(worst["rmse"], rmse_rel)
            parts.append(f"{name} t{it} T {T_gap:.2e} rmse {rmse_rel:.2e} "
                         f"iters {int(got[6])} inl {int(got[2])} conv "
                         f"{bool(got[3])}")
            if variant == "non-PD":
                assert torch.equal(got[0], torch.eye(4, device="cuda")), \
                    "K2S: a non-PD H gave a step"
    # timings: a configuration that never converges, so that every launch
    # does the whole trip (the state walks on under a fixed correspondence)
    icp = dataclasses.replace(base, tol=0.0, tol_update=0.0,
                              max_iters=2 ** 30)
    got, want, args, _, _, anchors, _ = _k2s_trip(icp, src, mask_f, corr,
                                                  1)
    t = _timings(lambda: k2s.gn_step(icp, mask_f, *args, got, 1, *anchors),
                 lambda: loop.trip_ref(icp, mask_f, *args, want, 1,
                                      *anchors),
                 bound=k2s_bound(m), plain_n=20)
    t["_wrapper"] = (lambda: k2s.gn_step(icp, mask_f, *args, got, 1,
                                         *anchors), 1)
    print(f"[K2S gn_step {label}] {card()} | M={m} | largest gaps to the "
          f"plain version T {worst['T']:.3e} (limit {K2S_T_TOL:.0e}), rmse "
          f"{worst['rmse']:.3e} relative (limit {K2S_RMSE_RTOL:.0e}); H, g "
          f"bit-equal to K2's; bit-reproducible | {'; '.join(parts)} | "
          f"{_fmt(t)} (plain: the torch step around K2, a trip)")
    return {"name": "gn_step" if label == "scan-to-map" else "gn_step[rgbd]",
            "route": "cuda",
            "source": "src/tpu_icp_slam_torch/csrc/gn_step.cu",
            "replaces": "src/tpu_icp_slam/icp/loop.py:150",
            "max_abs_err": worst["T"], **t}


def _degen_k2(pts, msk, gt, rgbd_log):
    """The configurations that keep K2 (degen_eps > 0, the eager loop):
    phase 4's first 5 frames and phase 16's first 5 RGB-D frames with
    degen_eps = 1e-6; K2 = ICP iterations, K2S = 0. Returns the K2
    launches and frames of each."""
    from tpu_icp_slam_torch.slam.rgbd import RGBDOdometry
    from tpu_icp_slam_torch.slam.scan_to_map import ScanToMapPipeline

    out = {}
    cfg = slice_config(degen_eps=1e-6)
    pipe = ScanToMapPipeline(cfg, device="cuda")
    P, M = _on_card(pts[:6], msk[:6])
    state0 = pipe.init_state(P[0], M[0])
    _zero_counts()
    _, infos = pipe.run_fused(state0, P[1:], M[1:])
    c, iters = _counts(), int(infos["iters"].sum())
    poses = np.concatenate(
        [np.eye(4)[None], infos["pose"].cpu().numpy().astype(np.float64)])
    ate = _ate(poses, gt)
    print(f"[K2S degen_eps] scan-to-map, degen_eps 1e-6, 5 frames: ICP "
          f"iterations {iters}, ATE {ate:.5f} m | launches {c}")
    assert c["K2"] == iters > 0 and c["K2S"] == 0, (c, iters)
    assert ate < 0.15, ate
    out["scan-to-map"] = c["K2"], 5
    depths, _, K = rgbd_log
    rc = _rgbd_cfg()
    rc = dataclasses.replace(rc, icp=dataclasses.replace(rc.icp,
                                                         degen_eps=1e-6))
    odo = RGBDOdometry(rc, K, device="cuda")
    d = torch.as_tensor(depths[:6], dtype=torch.float32, device="cuda")
    _zero_counts()
    _, infos = odo.run_fused(odo.init_state(d[0]), d[1:])
    c, iters = _counts(), int(infos["iters"].sum())
    print(f"[K2S degen_eps] RGB-D, degen_eps 1e-6, 5 frames: ICP iterations "
          f"{iters} | launches {c}")
    assert c["K2"] == iters > 0 and c["K2S"] == 0, (c, iters)
    out["rgbd"] = c["K2"], 5
    return out


def phase_k2s(pts, msk, gt, rgbd_log):
    """Phase 23: K2S against its plain version on phase 4's and phase 16's
    trip inputs; the configurations that keep K2. Returns K2S's two rows
    and the K2 launches of _degen_k2."""
    from tpu_icp_slam_torch import from_json
    from tpu_icp_slam_torch.core.pointcloud import PointCloud
    from tpu_icp_slam_torch.icp import loop

    (src, smask, loc, nrm, lmsk), _ = _first_align_problem(pts, msk)
    with open(os.path.join(ROOT, "configs", "kitti_full_res.json")) as fh:
        kitti = from_json(fh.read()).icp
    rows = []
    for label, base in (("scan-to-map", slice_config().icp),
                        ("scan-to-map, kitti_full_res.json", kitti)):
        corr = loop._nn_correspondence(
            base, PointCloud(points=loc, mask=lmsk, normals=nrm))
        row = _k2s_row(label, base, src, smask.float(), corr, src.shape[0])
        if label == "scan-to-map":
            rows.append(row)
    p, mask, corr, _, lookup = rgbd_problem()
    rows.append(_k2s_row("rgbd", _rgbd_cfg().icp, p, mask.float(), corr,
                         p.shape[0]))
    rows.append(_pj_row(p, *lookup))
    return rows, _degen_k2(pts, msk, gt, rgbd_log)


def pj_bound(m):
    """PJ's least time: its bytes (cur and the gathered q, n and valid
    flag in, 37 bytes a row; q, n, gate and d2 out, 32) over the device
    memory's rate, ~30 FP32 operations a row. It bounds a call that reads
    its inputs from device memory, so PJ is timed with the L2 emptied
    before each call (_cold_ms); back to back, or on the main path, the
    maps stay in the 50 MB L2 and a call may take less."""
    return _bound(30.0 * m, 69.0 * m)


def _pj_row(p, K, v0, n0, ok0, max_corr_dist):
    """PJ against its plain version (icp/projective._lookup_ref) at phase
    16's shape, at identity and with the source moved 2 cm and 0.5 degrees
    (other pixels), with and without a normal gate: q and n bit-equal, d2
    within 2 ulps, gate equal but where d2 lies within 2 ulps of the gate's
    distance; bit-reproducible; its timings."""
    from tpu_icp_slam_torch.icp import projective
    from tpu_icp_slam_torch.kernels import projective_cuda

    fx, fy = (torch.full((), v, device="cuda") for v in (K.fx, K.fy))
    max_d2 = max_corr_dist * max_corr_dist
    c, s_ = math.cos(0.0087), math.sin(0.0087)
    moved = (p @ torch.tensor([[c, -s_, 0.0], [s_, c, 0.0], [0.0, 0.0, 1.0]],
                              device="cuda").T
             + torch.tensor([0.02, -0.01, 0.01], device="cuda")).contiguous()
    nrm = torch.nn.functional.normalize(p - p.mean(0), dim=-1).contiguous()
    err, n_gate = 0.0, 0
    for cur in (p, moved):
        for src_normals, cos in ((None, -1.0), (nrm, 0.0)):
            args = (v0, n0, ok0, torch.stack([fx, fy]), K.cx, K.cy, max_d2,
                    src_normals, cos)
            got = projective_cuda.projective_lookup(cur, *args)
            again = projective_cuda.projective_lookup(cur, *args)
            want = projective._lookup_ref(K, v0, n0, ok0, fx, fy, max_d2,
                                          cos, src_normals, cur)
            assert all(bits_equal(a, b) for a, b in zip(got, again)), \
                "PJ is not bit-reproducible"
            assert bits_equal(got[0], want[0]) and bits_equal(got[1],
                                                              want[1]), \
                "PJ's q or n differ from the plain version's"
            ulp = torch.abs(torch.nextafter(want[3], torch.full_like(
                want[3], math.inf)) - want[3])
            gap = torch.abs(got[3] - want[3])
            assert bool(torch.all(gap <= 2 * ulp)), float(gap.max())
            near = torch.abs(want[3] - max_d2) <= 2 * ulp
            if src_normals is not None:
                near = near | (torch.abs(torch.sum(src_normals * want[1], -1)
                                         - cos) <= 1e-6)
            differ = got[2] != want[2]
            assert not bool(torch.any(differ & ~near)), \
                int((differ & ~near).sum())
            err = max(err, float(gap.max()))
            n_gate += int(want[2].sum())
    args = (v0, n0, ok0, torch.stack([fx, fy]), K.cx, K.cy, max_d2, None,
            -1.0)

    def run():
        return projective_cuda.projective_lookup(moved, *args)

    def plain():
        return projective._lookup_ref(K, v0, n0, ok0, fx, fy, max_d2, -1.0,
                                      None, moved)

    # the bound is device memory's, so the device, kernel and plain times
    # are taken with the L2 emptied before each call; call_ms is one call
    # alone, as in every row, and ms_l2_warm the back-to-back time
    flush = _l2_flush()
    bound = pj_bound(p.shape[0])
    t = {"ms": _cold_ms(run), "call_ms": _call_ms(run),
         "plain_ms": _cold_ms(plain, strict=False), "bound_ms": bound[0],
         "bound_by": bound[1], "library_ms": None,
         "ms_l2_warm": _device_ms(run),
         "_profile": (lambda: (flush(), run()), 20)}
    print(f"[PJ projective] {card()} | M={p.shape[0]} (640x480) at identity "
          f"and moved, with and without a normal gate ({n_gate} gated rows "
          f"over the four): q, n bit-equal to the plain version, max |d2 - "
          f"plain| {err:.3e}, the gate equal but at the gate's edge | "
          f"{_fmt(t)}, each with the L2 emptied before a call; back to back "
          f"(the maps in L2) {t['ms_l2_warm']:.4f} ms a call (plain: the "
          f"torch lookup, ~30 launches)")
    return {"name": "projective", "route": "cuda",
            "source": "src/tpu_icp_slam_torch/csrc/projective.cu",
            "replaces": "src/tpu_icp_slam/icp/projective.py:60",
            "max_abs_err": err, **t}


def kn_bound(m, n, k):
    """KN's least time: 9 FP32 operations a pair, as K1's row counts a
    pair (the factored score is a product, three fused multiply-adds and
    an add, then a compare), against its bytes (points and mask in;
    normals and the (M, k) picks out)."""
    return _bound(9.0 * m * n, 13.0 * m + (12.0 + 4.0 * k) * m)


def ex_bound(c, size):
    """EX's least time: its bytes (the map's points and mask in, the kept
    rows' normals, the outputs out); a few operations a slot."""
    return _bound(8.0 * c, 13.0 * c + 12.0 * size + 25.0 * size + 4.0)


# KN's picks against the plain version's: where the plain version's
# (k+1)-th score lies more than KN_TAU_REL * (|a|² + |b|²) above its k-th
# (a few float32 roundings of the factored score at that magnitude, the
# most by which cuBLAS's product, if it summed a·b in another order, could
# move a score), the ordered lists must be equal; the whole must agree on
# KN_ROWS_EQUAL of the rows.
KN_TAU_REL = 2.0 ** -20
KN_ROWS_EQUAL = 0.999
# KN's normals against the plain fit (the same picks, sums in another
# order): dot >= 1 - KN_DOT_TOL on every masked row whose fit is well
# posed (an eigen-gap above 1e-2 of the largest eigenvalue and a normal
# more than 1e-2 off the view ray, float64 on the picks); elsewhere
# (nearly collinear ring segments, the orientation's tie) only counted.
KN_DOT_TOL = 1e-4


def _kn_check(p, m, k, stride):
    """KN against its plain versions on one scan: picks, normals; returns
    (rows equal, ill-posed rows, worst well-posed dot)."""
    from tpu_icp_slam_torch.kernels import knn_cuda
    from tpu_icp_slam_torch.kernels.nn_plain import knn_bruteforce
    from tpu_icp_slam_torch.mapping import normals

    nrm, idx = knn_cuda.knn_normals(p, m, k, stride)
    again, idx2 = knn_cuda.knn_normals(p, m, k, stride)
    assert bits_equal(nrm, again) and bits_equal(idx, idx2), \
        "KN is not bit-reproducible"
    ref = p[::stride].contiguous()
    want_i, want_d = knn_bruteforce(p, ref, k + 1)
    plain = normals.normals_knn_ref(p, m, k, None, stride)
    same = (idx == want_i[:, :k]).all(1)
    scale = (torch.sum(p * p, -1)[:, None]
             + torch.sum(ref * ref, -1)[want_i.long()]).amax(1)
    clear = (want_d[:, k] - want_d[:, k - 1]) > KN_TAU_REL * scale
    gaps = want_d[:, 1:] - want_d[:, :-1]
    clear_all = clear & (gaps[:, :k - 1] > KN_TAU_REL * scale[:, None]).all(1)
    assert bool(same[clear_all].all()), int((~same & clear_all).sum())
    assert float(same.float().mean()) >= KN_ROWS_EQUAL, \
        float(same.float().mean())
    nb = ref[idx.long()].double()
    x = nb - nb.mean(1, keepdim=True)
    ev, V = torch.linalg.eigh(torch.einsum("nki,nkj->nij", x, x) / k)
    P = p.double()
    view = (torch.abs(torch.sum(V[:, :, 0] * P, -1))
            / torch.clamp(torch.linalg.vector_norm(P, dim=-1), min=1e-9))
    posed = m & ((ev[:, 1] - ev[:, 0]) > 1e-2 * ev[:, 2]) & (view > 1e-2)
    dot = torch.sum(nrm * plain, -1)
    worst = float(dot[posed].min())
    assert worst >= 1 - KN_DOT_TOL, worst
    assert bool((nrm[~m] == 0).all()), "a masked-off row has a normal"
    unit = torch.linalg.vector_norm(nrm[m], dim=-1)
    assert float(torch.abs(unit - 1).max()) < 1e-5
    return (float(same.float().mean()), int((m & ~posed).sum()), worst,
            int((dot[m & ~posed] < 1 - KN_DOT_TOL).sum()))


def _kn_row(p, m, k, stride, label):
    from tpu_icp_slam_torch.kernels import knn_cuda
    from tpu_icp_slam_torch.mapping import normals

    same, ill, worst, ill_off = _kn_check(p, m, k, stride)
    n = -(-p.shape[0] // stride)
    t = _timings(lambda: knn_cuda.knn_normals(p, m, k, stride),
                 lambda: normals.normals_knn_ref(p, m, k, None, stride),
                 kn_bound(p.shape[0], n, k))
    print(f"[KN knn_normals] {card()} | {label}: M={p.shape[0]} N={n} "
          f"k={k}: picks equal to the plain k-NN on {same:.6f} of the rows "
          f"(every row whose scores are clear by KN_TAU_REL), normals "
          f"within {1 - worst:.2e} of the plain fit on the well-posed rows "
          f"({ill} ill-posed rows, {ill_off} of them beyond {KN_DOT_TOL}) | "
          f"{_fmt(t)} (plain: the torch k-NN and fit) | library: none (no "
          f"one PyTorch call computes a k-NN from points)")
    return {"name": f"knn_normals[{label}]", "route": "cuda",
            "source": "src/tpu_icp_slam_torch/csrc/knn_normals.cu",
            "replaces": "src/tpu_icp_slam/mapping/normals.py:98",
            "max_abs_err": 1 - worst, **t}


def _lattice_map(c, n_on, seed):
    """c slots, n_on of them on the integer lattice [-20, 20]³ (exact d²
    from an integer centre, many ties), the rest padding."""
    from tpu_icp_slam_torch.mapping import voxel_map

    g = torch.Generator().manual_seed(seed)
    pts = torch.full((c, 3), 1e6)
    on = torch.randperm(c, generator=g)[:n_on]
    pts[on] = torch.randint(-20, 21, (n_on, 3), generator=g).float()
    nrm = torch.zeros(c, 3)
    nrm[on] = torch.randn(n_on, 3, generator=g)
    msk = torch.zeros(c, dtype=torch.bool)
    msk[on] = True
    return voxel_map.VoxelMap(points=pts.cuda(), normals=nrm.cuda(),
                              mask=msk.cuda())


def _ex_row(vm, center, size, seeded):
    """EX against extract_local_ref: the four outputs bit-equal on the
    main path's map (radius 0 and 20 m, another centre), on the map seeded
    with one scan (fewer points than size), and on a lattice map with exact
    d² ties (radius 0 and 6.5 m); its timings on the main path's map."""
    from tpu_icp_slam_torch.kernels import select_cuda
    from tpu_icp_slam_torch.mapping import voxel_map

    lattice = _lattice_map(vm.points.shape[0], 100_000, 0)
    other = torch.tensor([5.0, -3.0, 1.0], device="cuda")
    near = torch.tensor([1.0, -2.0, 0.0], device="cuda")
    cases = [(vm, center, 0.0), (vm, center, 20.0), (vm, other, 0.0),
             (seeded, center, 0.0), (lattice, near, 0.0),
             (lattice, near, 6.5)]
    for i, (v, c, r) in enumerate(cases):
        got = select_cuda.local_select(v.points, v.normals, v.mask, c, size,
                                       r)
        want = voxel_map.extract_local_ref(v, c, size, r)
        assert all(bits_equal(a, b) for a, b in zip(got, want)), \
            (i, r, [bits_equal(a, b) for a, b in zip(got, want)])
    diff = vm.points - center[None, :]
    d2 = torch.where(vm.mask, diff[:, 0] * diff[:, 0] + diff[:, 1]
                     * diff[:, 1] + diff[:, 2] * diff[:, 2],
                     torch.full_like(vm.points[:, 0], math.inf))

    def run():
        return select_cuda.local_select(vm.points, vm.normals, vm.mask,
                                        center, size, 0.0)

    t = _timings(run, lambda: voxel_map.extract_local_ref(vm, center, size),
                 ex_bound(vm.points.shape[0], size))
    t["library_ms"] = _device_ms(
        lambda: torch.topk(d2, size, largest=False), strict=False)
    print(f"[EX local_select] {card()} | C={vm.points.shape[0]} -> "
          f"size={size}, map points {int(vm.mask.sum())}: pts, nrm, msk, "
          f"r_cover bit-equal to extract_local_ref over {len(cases)} cases "
          f"(the main path's map at radius 0 and 20 m and another centre, "
          f"the seeded map ({int(seeded.mask.sum())} points), a lattice map "
          f"with exact d² ties at radius 0 and 6.5 m) | "
          f"{_fmt(t)} (plain: the two sorts) | library "
          f"{t['library_ms']:.4f} ms (torch.topk of the same d², the "
          f"select alone: no map-order pass, no gather)")
    return {"name": "local_select", "route": "cuda",
            "source": "src/tpu_icp_slam_torch/csrc/local_select.cu",
            "replaces": "src/tpu_icp_slam/mapping/voxel_map.py:229",
            "max_abs_err": 0.0, **t}


def _pre_sorts(pipe, state):
    """Device kernels of one eager `pre` (extract at the prediction) whose
    names say sort or top-k."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from tpu_icp_slam_torch.slam import scan_to_map as s2m

    init = s2m._predict(state, pipe.cfg)
    s2m._pre(state, init, pipe.cfg, True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        s2m._pre(state, init, pipe.cfg, True)
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA]
    return [k for k in names if any(w in k.lower() for w in ("sort",
                                                                "topk"))]


def phase_map_kernels(pts, msk):
    """Phase 24: KN and EX, the map stages, against their plain versions
    at the main path's shapes; no sort of the map's d² in `pre`."""
    from tpu_icp_slam_torch.kernels import knn_cuda
    from tpu_icp_slam_torch.kernels.nn_plain import knn_bruteforce
    from tpu_icp_slam_torch.slam.scan_to_map import ScanToMapPipeline

    cfg = slice_config()
    full = full_slam_config()
    k = cfg.pipeline.normal_k
    assert full.pipeline.normal_k == k
    p = torch.as_tensor(pts[1], device="cuda")
    m = torch.as_tensor(msk[1], device="cuda")
    rows = [_kn_row(p, m, k, cfg.pipeline.normal_ref_stride, "stride 4"),
            _kn_row(p, m, k, full.pipeline.normal_ref_stride,
                    "kitti_full_res")]
    # exact ties: integer lattice points, the reference's lower-index rule
    g = torch.Generator().manual_seed(1)
    q = torch.randint(-3, 4, (600, 3), generator=g).float().cuda()
    for stride in (1, 2):
        _, idx = knn_cuda.knn_normals(q, torch.ones(600, dtype=torch.bool,
                                                    device="cuda"), k, stride)
        want, _ = knn_bruteforce(q, q[::stride].contiguous(), k)
        assert bits_equal(idx, want), f"KN's lattice ties, stride {stride}"
    pipe = ScanToMapPipeline(cfg, device="cuda")
    state0 = pipe.init_state(pts[0], msk[0])
    state, _ = pipe.run_fused(state0, pts[1:], msk[1:])
    rows.append(_ex_row(state.vmap, state.pose[:3, 3],
                        cfg.mapping.local_model_size, state0.vmap))
    sorts = _pre_sorts(pipe, state)
    print(f"[map kernels] lattice ties: KN's picks bit-equal to the plain "
          f"k-NN at strides 1 and 2 | an eager pre's sort and top-k "
          f"kernels: {sorts or 'none'}")
    assert not sorts, sorts
    return rows


# ---- phase 25: K2P, the point-to-point iteration -------------------------

# K2P's result against its plain version (loop.trip_ref on the card: the
# torch step around umeyama_masked and RF) from the same state and inputs:
# T within K2P_T_TOL and rmse within K2P_RMSE_TOL, absolute (the sums run
# in another order, and the rigid fit's float64 rotation is RF's where the
# plain version's is RF's of torch's covariance); inliers and iterations
# equal; converged equal but where |prev - rmse| lies within K2S_TOL_BAND
# of tol. Measured by this phase on an H100: T at most 1.8e-6, rmse 2.4e-7.
K2P_T_TOL = 2e-5
K2P_RMSE_TOL = 2e-6


def k2p_bound(batch, m, d):
    """K2P's least time: its bytes (cur and q, D floats each a row, gate
    and d2 a row each, the shared mask; the state, T0 and T0⁻¹ of each
    element under 256 bytes) against ~(6D + 12) FP32 operations a row
    (the Huber weight, the first pass's 2D + 3 sums and the second's D²
    centred terms)."""
    return _bound((6.0 * d + 12.0) * batch * m,
                  (8.0 * d + 8.0) * batch * m + 4.0 * m + 256.0 * batch)


def _k2p_options(base, anderson=True):
    """Phase 25's option sets on an ICPConfig: name -> (cfg, variant).
    anderson=False leaves out AA(1): its twists of absolute poses are
    ill-conditioned near a rotation of pi (so3_log's arccos: at phase 20's
    verification yaws the kernel and the plain step part far beyond
    K2P_T_TOL), and verification never runs it."""
    rep = dataclasses.replace
    sets = {"preset": (base, None),
            "anderson": (rep(base, anderson=True), None),
            "trust region": (rep(base, max_total_trans=0.05,
                                 max_total_rot=0.02), None),
            "anderson, trust region": (rep(base, anderson=True,
                                           max_total_trans=0.05,
                                           max_total_rot=0.02), None),
            "min_inliers hold": (rep(base, min_inliers=10 ** 7), None),
            "frozen": (base, "frozen")}
    return {k: v for k, v in sets.items()
            if anderson or not v[0].anderson}


def _k2p_problems(pts, msk):
    """(label, ICPConfig, source points, source float mask, step inputs
    from a state: state -> (cur, q, gate, d2), T0) of phase 25: the 2D
    scan-to-scan trip of phase 15(3) (sim2d frame 1 against frame 0,
    SlamConfig()), phase 4's frame 2 against frame 1 in 3D (16,384 points,
    the verification's fine settings), and phase 13's verification shape
    (B = 16, 16,384², the coarse settings)."""
    from tpu_icp_slam_torch.backend.loop_closure import LoopDetector
    from tpu_icp_slam_torch.core.pointcloud import PointCloud
    from tpu_icp_slam_torch.icp import loop

    cfg2, P, M = _s2s2d_log()
    icp, src, dst, dmask, inits = _verification_inputs(pts, msk)
    fine = LoopDetector(full_slam_config().backend,
                        device=torch.device("cuda")).icp_fine
    out = []
    for label, cfg, s, sm, t, tm in (
            ("2D, B=1, M=4096", cfg2.icp, P[1], M[1], P[0], M[0]),
            ("3D, B=1, M=16384", fine, *_on_card(pts[2], msk[2], pts[1],
                                                 msk[1]))):
        corr = loop._nn_correspondence(cfg, PointCloud(points=t, mask=tm))

        def inputs(state, s=s, corr=corr):
            cur = loop._moved(s, state[0])
            q, _, gate, d2 = corr(cur)
            return cur, q, gate, d2

        out.append((label, cfg, s, sm.float(), inputs,
                    torch.eye(s.shape[1] + 1, device="cuda")))
    corr = loop._batched_correspondence(icp, dst, dmask, inits.shape[0])

    def batched_inputs(state):
        cur = loop._moved(src.points, state[0])
        return (cur, *corr(cur))

    out.append(("3D, B=16, 16384x16384", icp, src.points,
                src.mask.float(), batched_inputs, inits))
    return out


def _k2p_trip(icp, mask_f, inputs, T0, it, variant=None):
    """One trip of K2P and of its plain version from the same state on the
    card (trip 0 from loop._init_state, or trip `it` after plain trips):
    (kernel state, plain state, a second launch's state, inputs, the rmse
    before the trip)."""
    from tpu_icp_slam_torch.icp import loop
    from tpu_icp_slam_torch.kernels import p2p_step

    T0_inv, _ = loop._anchor(icp, T0, False)
    state = tuple(t.clone() for t in loop._init_state(T0))
    for i in range(it):
        cur, q, gate, d2 = inputs(state)
        loop.trip_ref(icp, mask_f, cur, q, None, gate, d2, state, i, T0,
                      T0_inv, None)
    if variant == "frozen":
        state[3].fill_(True)
    prev = state[1].clone()
    cur, q, gate, d2 = inputs(state)
    got, want, again = (tuple(t.clone() for t in state) for _ in range(3))
    p2p_step.p2p_step(icp, mask_f, cur, q, gate, d2, got, it, T0, T0_inv)
    p2p_step.p2p_step(icp, mask_f, cur, q, gate, d2, again, it, T0, T0_inv)
    loop.trip_ref(icp, mask_f, cur, q, None, gate, d2, want, it, T0, T0_inv,
                  None)
    return got, want, again, (cur, q, gate, d2, T0_inv), prev


def _k2p_gaps(icp, got, want, prev):
    """(T gap, rmse gap, the fields that disagree) of a K2P state against
    its plain version's; converged may differ where |prev - rmse| lies
    within K2S_TOL_BAND of tol."""
    T_gap = float((got[0] - want[0]).abs().max())
    rmse_gap = float((got[1] - want[1]).abs().max())
    bad = [name for name, i in (("n_inliers", 2), ("iters", 6))
           if not bits_equal(got[i], want[i])]
    differ = got[3] != want[3]
    if bool(differ.any()):
        edge = torch.minimum((prev - got[1]).abs() - icp.tol,
                             (prev - want[1]).abs() - icp.tol).abs()
        if not bool((edge[differ] <= K2S_TOL_BAND).all()):
            bad.append("converged")
    if T_gap > K2P_T_TOL:
        bad.append("T")
    if rmse_gap > K2P_RMSE_TOL:
        bad.append("rmse")
    return T_gap, rmse_gap, bad


def phase_k2p(pts, msk):
    """Phase 25: K2P against its plain version at the point-to-point
    paths' shapes over the option sets, trips 0 and 1; frozen elements
    bit-unchanged; two launches bit-equal; its rows' timings."""
    from tpu_icp_slam_torch.icp import loop
    from tpu_icp_slam_torch.kernels import p2p_step

    rows = []
    for label, base, src, mask_f, inputs, T0 in _k2p_problems(pts, msk):
        worst = {"T": 0.0, "rmse": 0.0}
        parts = []
        options = _k2p_options(base, anderson=T0.dim() == 2)
        for name, (icp, variant) in options.items():
            for it in (0, 1):
                got, want, again, args, prev = _k2p_trip(
                    icp, mask_f, inputs, T0, it, variant)
                assert all(bits_equal(a, b) for a, b in zip(got, again)), \
                    f"K2P {label} {name}: not bit-reproducible"
                if variant == "frozen":
                    assert all(bits_equal(a, b) for a, b in zip(got, want)), \
                        f"K2P {label}: a frozen state changed"
                    parts.append(f"{name} t{it} unchanged")
                    continue
                T_gap, rmse_gap, bad = _k2p_gaps(icp, got, want, prev)
                assert not bad, (f"K2P {label} {name} trip {it}: {bad} "
                                 f"(T {T_gap:.3e}, rmse {rmse_gap:.3e})")
                worst["T"] = max(worst["T"], T_gap)
                worst["rmse"] = max(worst["rmse"], rmse_gap)
                parts.append(f"{name} t{it} T {T_gap:.2e} rmse "
                             f"{rmse_gap:.2e} inl {got[2].tolist()} conv "
                             f"{got[3].tolist()}")
                if name == "min_inliers hold":
                    assert bits_equal(got[0], want[0]), "K2P: hold moved T"
        # timings: a configuration that never converges, so that every
        # call does the whole step
        icp = dataclasses.replace(base, tol=0.0, tol_update=0.0,
                                  max_iters=2 ** 30)
        _, _, _, (cur, q, gate, d2, T0_inv), _ = _k2p_trip(
            icp, mask_f, inputs, T0, 1)
        state = tuple(t.clone() for t in loop._init_state(T0))
        batch = T0.shape[0] if T0.dim() == 3 else 1
        # this problem's tensors bound now: the profile phase calls these
        # after the loop has moved on
        args = (icp, mask_f, cur, q, gate, d2, state, T0, T0_inv)
        t = _timings(
            lambda a=args: p2p_step.p2p_step(*a[:7], 1, *a[7:]),
            lambda a=args: loop.trip_ref(*a[:4], None, *a[4:7], 1, *a[7:],
                                         None),
            k2p_bound(batch, cur.shape[-2], cur.shape[-1]))
        print(f"[K2P p2p_step] {card()} | {label}: against the plain step "
              f"(loop.trip_ref on the card) over {len(parts)} trips, worst "
              f"T {worst['T']:.3e} (K2P_T_TOL {K2P_T_TOL}), rmse "
              f"{worst['rmse']:.3e} (K2P_RMSE_TOL {K2P_RMSE_TOL}), inliers "
              f"and iterations equal, frozen unchanged, bit-reproducible | "
              f"{_fmt(t)} (plain: the torch step, umeyama_masked and RF) | "
              f"library: none | {'; '.join(parts)}")
        rows.append({"name": f"p2p_step[{label}]", "route": "cuda",
                     "source": "src/tpu_icp_slam_torch/csrc/p2p_step.cu",
                     "replaces": "src/tpu_icp_slam/icp/loop.py:202",
                     "max_abs_err": worst["T"], "rmse_err": worst["rmse"],
                     **t})
    return rows


def phase_profile(rows):
    """Last: torch.profiler over each kernel's back-to-back calls gives its
    row's kernel_ms and kernel_parts (the port's own kernels alone), and
    over K4's and K5's wrappers where their host time goes. It runs after
    the end-to-end phases: once the profiler has traced the card, the
    process keeps its tracing hooks, and host-bound frames run slower.
    One discarded window over the first row's calls starts the tracer
    before any window is read."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        rows[0]["_profile"][0]()
        torch.cuda.synchronize()
    for row in rows:
        run, n = row.pop("_profile")
        row["kernel_ms"], row["kernel_parts"] = _kernel_ms(run, n,
                                                           label=row["name"])
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
    k1, k2s, n_frames, slice_fps, kn, ex = phase_slice(pts, msk, gt)
    phase_cpu_agreement()
    _count(k1_row, k1, n_frames)
    slice_k2s = k2s, n_frames
    slice_map = {"KN": (kn, n_frames), "EX": (ex, n_frames)}
    probe_row = phase_probe()
    k3_row = phase_k3(pts, msk)
    k5_rows = phase_k5(pts, msk)
    k5_launches = phase_fused_slice(pts, msk, gt)
    for row, prec in zip(k5_rows, ("highest", "bf16")):
        _count(row, *k5_launches[prec])
    _count(k3_row, *phase_steps_bf16(pts, msk, gt))
    k4_row = phase_k4(pts, msk)
    k1b_row = phase_k1_batched(pts, src, dst)
    k4, k1b, n_frames, full, k2p13, kn13, _ = phase_full_slam()
    full_kn = kn13, n_frames
    full_k2p = k2p13, n_frames
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
    rgbd_k2s, rgbd_pj = phase_config3(log)
    phase_mapping_options(pts, msk, gt, slice_fps)
    print(f"[config 3] phase 16 in {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    sharded = phase_config5(pts, msk, gt, full)
    print(f"[config 5] phase 17 in {time.perf_counter() - t0:.2f} s")
    batched_rows = phase_batched(pts, msk)
    t0 = time.perf_counter()
    rf_row = phase_rf(pts, msk, gt)
    phase_graphed_verification(pts, msk)
    print(f"[RF and graphs] phase 20 in {time.perf_counter() - t0:.2f} s")
    # launches a sharded trip, from phase 17's run at each row's precision
    for row, prec, kernel in zip(batched_rows,
                                 ("highest", "bf16", "rescore"),
                                 ("K2", "K3", "K4")):
        run = sharded[prec]
        row["launches"] = run["launches"][kernel]
        row["launches_per_frame"] = None
        row["launches_per_trip"] = run["launches"][kernel] / run["trips"]
        row["trip_ms"] = run["s"] / run["trips"] * 1e3
    t0 = time.perf_counter()
    phase_frame_graphs(pts, msk)
    print(f"[frame graphs] phase 21 in {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    odometry = phase_odometry_graphs(log)
    print(f"[odometry graphs] phase 22 in {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    (k2s_row, k2s_rgbd_row, pj_row), degen = phase_k2s(pts, msk, gt, log)
    _count(k2s_row, *slice_k2s)
    _count(k2s_rgbd_row, *rgbd_k2s)
    _count(pj_row, *rgbd_pj)
    _count(k2_row, *degen["scan-to-map"])
    _count(k2_rgbd_row, *degen["rgbd"])
    print(f"[K2S] phase 23 in {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    kn_row, kn_full_row, ex_row = phase_map_kernels(pts, msk)
    _count(kn_row, *slice_map["KN"])
    _count(kn_full_row, *full_kn)
    _count(ex_row, *slice_map["EX"])
    print(f"[map kernels] phase 24 in {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    k2p_2d_row, k2p_3d_row, k2p_b_row = phase_k2p(pts, msk)
    _count(k2p_2d_row, c2["run_k1"], c2["run_frames"])
    _count(k2p_3d_row, c2["eval_k2p_front"], c2["eval_frames"])
    _count(k2p_b_row, *full_k2p)
    print(f"[K2P] phase 25 in {time.perf_counter() - t0:.2f} s")
    rows = [k1_row, k2_row, k3_row, k4_row, *k5_rows, probe_row, k1b_row,
            k1_2d_row, k1_2db_row, k2_rgbd_row, *batched_rows, rf_row,
            k2s_row, k2s_rgbd_row, pj_row, kn_row, kn_full_row, ex_row,
            k2p_2d_row, k2p_3d_row, k2p_b_row]
    phase_profile(rows)
    phase_launch_calls(pts, msk, full, odometry)
    for row in rows:
        row["share"] = row["bound_ms"] / row["ms"]
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
