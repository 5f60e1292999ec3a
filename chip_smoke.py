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
  7. K3 (nn_bf16) vs its plain version at 16,384 x 16,384, sentinel rows.
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
     ICP iteration, no K1.
 11. K4 (nn_rescore) vs its plain version at 16,384 x 16,384, sentinel rows.
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

Every kernel's launch count is read from the path that runs it, with the
counts set to 0 just before and read just after. The line before the last
is a JSON summary of the kernels; the last line is {"ok": true, ...}.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
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
           waypoints=None):
    from tpu_icp_slam_torch import synthetic
    from tpu_icp_slam_torch.core.pointcloud import voxel_downsample_np
    from tpu_icp_slam_torch.slam.runner import pad_scans

    scans, gt = synthetic.velodyne_log(
        n_frames=n_frames, n_rings=n_rings, n_azimuth=n_azimuth,
        path_fraction=path_fraction, waypoints=waypoints)
    scans = [voxel_downsample_np(s, voxel) for s in scans]
    pts, msk = pad_scans(scans, capacity)
    return pts, msk, gt


def _median_ms(fn, reps=30):
    """Median per-call time of fn on the card, CUDA events around each call."""
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


def _ate(poses, gt):
    from tpu_icp_slam_torch import metrics

    gt_rel = np.einsum("ij,fjk->fik", np.linalg.inv(gt[0]), gt)
    return metrics.ate_rmse(poses[:, :3, 3], gt_rel[: len(poses), :3, 3])


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device — this script measures "
                         "the card and has no CPU mode")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"[device] {name} | torch {torch.__version__} | "
          f"CUDA {torch.version.cuda}")
    print(smi)
    return name


def phase_build():
    from tpu_icp_slam_torch.kernels import _build

    t0 = time.perf_counter()
    path = _build.build()
    _build.load()
    print(f"[build] {time.perf_counter() - t0:.2f} s -> "
          f"{os.path.relpath(path, ROOT)}")


def phase_k1(pts, msk):
    from tpu_icp_slam_torch.kernels import nn_cuda

    dev = torch.device("cuda")
    src = torch.as_tensor(pts[1], device=dev).contiguous()
    dst_np = pts[0].copy()
    dst_np[-1024:] = 1.0e6  # sentinel-padded target rows
    dst = torch.as_tensor(dst_np, device=dev).contiguous()
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
    ms = _median_ms(lambda: nn_cuda.nn_bruteforce(src, dst))
    plain_ms = _median_ms(lambda: nn_cuda.nn_bruteforce_ref(src, dst), 10)
    print(f"[K1 nn_bruteforce] M=N={len(dst_np)} idx agree {agree:.6f} "
          f"max picked-d2 excess {excess.max():.3e} m^2 "
          f"max |d2 - plain| {err:.3e} | kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms")
    return {"name": "nn_bruteforce", "route": "cuda",
            "source": "src/tpu_icp_slam_torch/csrc/nn_bruteforce.cu",
            "replaces": "src/tpu_icp_slam/kernels/nn_pallas.py:111",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms}, src, dst


def phase_k2(p, valid):
    from tpu_icp_slam_torch.kernels import gn_cuda

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
    w = torch.as_tensor(w_np, device=dev)
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
    ms = _median_ms(lambda: gn_cuda.gn_accum(p, q, n, w))
    plain_ms = _median_ms(lambda: gn_cuda.gn_accum_ref(p, q, n, w))
    print(f"[K2 gn_accum] M={m} max |H,g - plain| {err:.3e} "
          f"(|H|max {float(H_r.abs().max()):.3e}) | kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms")
    return {"name": "gn_accum", "route": "cuda",
            "source": "src/tpu_icp_slam_torch/csrc/gn_accum.cu",
            "replaces": "src/tpu_icp_slam/kernels/gn_pallas.py:28",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


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
    return k1, k2


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
    return {"name": "coop_probe", "route": "cuda",
            "source": "src/tpu_icp_slam_torch/csrc/coop_probe.cu",
            "replaces": "scripts/probe_mosaic_caps.py:38",
            "launches": launches, "max_abs_err": 0.0, "ms": ms,
            "plain_ms": None}


def phase_k3(pts, msk):
    from tpu_icp_slam_torch.kernels import nn_bf16

    dev = torch.device("cuda")
    src = torch.as_tensor(pts[1], device=dev).contiguous()
    dst_np = pts[0].copy()
    dst_np[-1024:] = 1.0e6  # sentinel-padded target rows
    dst = torch.as_tensor(dst_np, device=dev).contiguous()
    idx_k, d2_k = nn_bf16.nn_bf16(src, dst)
    idx_r, d2_r = nn_bf16.nn_bf16_ref(src, dst)
    # float32 sums of the same 13 exact products: kernel and plain differ by
    # at most 2 * 13 * 2^-24 * sum|a_k b_k| of the picked pair
    s, d = nn_bf16.recentre(src, dst)
    a_aug, b_aug = nn_bf16.pack_source(s).float(), nn_bf16.pack_target(d).float()
    mag = torch.sum(torch.abs(a_aug * b_aug[idx_r.long()]), dim=1)
    bound = 2 * 13 * 2.0 ** -24 * mag
    torch.cuda.synchronize()
    agree = float((idx_k == idx_r).float().mean())
    over = float(torch.max(torch.abs(d2_k - d2_r) / bound))
    err = float(torch.max(torch.abs(d2_k - d2_r)))
    assert agree >= 0.999, f"K3 index agreement {agree}"
    assert over <= 1.0, f"K3 score gap {over:.3f} of the summation bound"
    idx_np = idx_k.cpu().numpy()
    assert np.all(idx_np[msk[1]] < len(dst_np) - 1024), \
        "K3 matched a real point to a sentinel row"
    ms = _median_ms(lambda: nn_bf16.nn_bf16(src, dst))
    plain_ms = _median_ms(lambda: nn_bf16.nn_bf16_ref(src, dst), 10)
    print(f"[K3 nn_bf16] M=N={len(dst_np)} idx agree {agree:.6f} "
          f"max |d2 - plain| {err:.3e} ({over:.3f} of the float32 sum "
          f"bound) | kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    return {"name": "nn_bf16", "route": "cuda",
            "source": "src/tpu_icp_slam_torch/csrc/nn_bf16.cu",
            "replaces": "src/tpu_icp_slam/kernels/nn_pallas.py:111",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


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
        ms = _median_ms(run, 10)
        plain_ms = _median_ms(plain, 3)
        print(f"[K5 icp_fused {prec}] M={args[0].shape[0]} "
              f"N={args[2].shape[0]} iters {int(out[2])} (plain "
              f"{int(ref[2])}) inliers {int(out[3])} ({int(ref[3])}) rmse "
              f"{float(out[1]):.9f} ({float(ref[1]):.9f}) converged "
              f"{bool(out[4])} ({bool(ref[4])}) | gaps "
              f"{', '.join(f'{k} {v:.3e}' for k, v in gaps.items())} "
              f"(bounds {K5_BOUNDS[prec]}), max |T - plain| {err:.3e} | "
              f"kernel {ms:.4f} ms/align, plain {plain_ms:.4f} ms/align")
        bad = _k5_mismatches(out, ref, prec)
        assert not bad, f"K5 {prec} disagrees with its plain version: {bad}"
        rows.append({"name": f"icp_fused[{prec}]", "route": "cuda",
                     "source": "src/tpu_icp_slam_torch/csrc/icp_fused.cu",
                     "replaces":
                         "src/tpu_icp_slam/kernels/icp_fused_pallas.py:288",
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms})
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
    just before it; returns the counts, frames/s and ATE."""
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
    return counts, int(iters.sum()), n_frames


def phase_fused_slice(pts, msk, gt):
    counts = {}
    for prec in ("highest", "bf16"):
        c, _, n_frames = _run_slice(
            slice_config(loop_backend="fused", nn_precision=prec), pts, msk,
            gt, f"fused slice {prec}")
        assert c == {"K1": 0, "K2": 0, "K3": 0, "K4": 0, "K5": n_frames}, \
            (prec, c)
        counts[prec] = c["K5"]
    _run_slice(slice_config(), pts[:6], msk[:6], gt,
               "steps slice highest, 5 frames, for its host syncs")
    return counts


def phase_steps_bf16(pts, msk, gt):
    c, iters, _ = _run_slice(slice_config(nn_precision="bf16"), pts[:11],
                             msk[:11], gt, "steps slice bf16")
    assert c["K3"] == c["K2"] == iters > 0, c
    assert c["K1"] == c["K4"] == c["K5"] == 0, c
    return c["K3"]


def phase_k4(pts, msk):
    from tpu_icp_slam_torch.kernels import nn_cuda, nn_rescore

    dev = torch.device("cuda")
    src = torch.as_tensor(pts[1], device=dev).contiguous()
    dst_np = pts[0].copy()
    dst_np[-1024:] = 1.0e6  # sentinel-padded target rows
    dst = torch.as_tensor(dst_np, device=dev).contiguous()
    tn, n_slots = nn_rescore.slots(len(dst_np))
    idx_k, d2_k = nn_rescore.nn_rescore(src, dst)
    idx_r, d2_r = nn_rescore.nn_rescore_ref(src, dst)
    torch.cuda.synchronize()
    same = idx_k == idx_r
    agree = float(same.float().mean())
    err = float(torch.max(torch.abs(d2_k - d2_r)))
    # the rescore's d2 is the same float32 arithmetic on both sides
    assert agree >= 0.999, f"K4 index agreement {agree}"
    assert torch.equal(d2_k[same], d2_r[same]), "K4 picked d2 != plain"
    idx_np = idx_k.cpu().numpy()
    assert np.all(idx_np[msk[1]] < len(dst_np) - 1024), \
        "K4 matched a real point to a sentinel row"
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
    ms = _median_ms(lambda: nn_rescore.nn_rescore(src, dst))
    plain_ms = _median_ms(lambda: nn_rescore.nn_rescore_ref(src, dst), 10)
    print(f"[K4 nn_rescore] M=N={len(dst_np)} TN={tn} S={n_slots} idx agree "
          f"{agree:.6f} max |d2 - plain| {err:.3e} | exact search's "
          f"distance on {exact_share:.6f} of the rows, max excess "
          f"{excess:.3e} m^2 | kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    return {"name": "nn_rescore", "route": "cuda",
            "source": "src/tpu_icp_slam_torch/csrc/nn_shortlist.cu",
            "replaces": "src/tpu_icp_slam/kernels/nn_pallas.py:142",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


def _yawed(points, yaws):
    """(M, 3) numpy points turned about z by each yaw -> (Y, M, 3)."""
    c, s = np.cos(yaws), np.sin(yaws)
    R = np.zeros((len(yaws), 3, 3), np.float32)
    R[:, 0, 0], R[:, 0, 1], R[:, 1, 0], R[:, 1, 1] = c, -s, s, c
    R[:, 2, 2] = 1.0
    return np.einsum("yij,mj->ymi", R, points).astype(np.float32)


def phase_k1_batched(pts, src1, dst1):
    """src1, dst1: phase 2's unbatched inputs."""
    from tpu_icp_slam_torch.kernels import nn_cuda

    dev = torch.device("cuda")
    yaws = np.linspace(-np.pi, np.pi, 8, endpoint=False)
    # the verification shape: 2 candidates x 8 yaw hypotheses of one query
    src = torch.as_tensor(_yawed(pts[-1], yaws), device=dev)
    src = src.repeat(2, 1, 1).contiguous()  # (16, M, 3)
    dst = torch.as_tensor(np.stack([pts[0], pts[1]]), device=dev)
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
    ms = _median_ms(lambda: nn_cuda.nn_bruteforce(src, dst))
    plain_ms = _median_ms(lambda: nn_cuda.nn_bruteforce_ref(src, dst), 3)
    print(f"[K1 batched] B={src.shape[0]} (G=8) M=N={src.shape[1]} idx agree "
          f"{agree:.6f} max |d2 - plain| {err:.3e}; B=1 equal to phase 2's "
          f"call bit for bit | kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    return {"name": "nn_bruteforce[batched]", "route": "cuda",
            "source": "src/tpu_icp_slam_torch/csrc/nn_bruteforce.cu",
            "replaces": "src/tpu_icp_slam/kernels/nn_pallas.py:111",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


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
    return c["K4"], c["K1"]


def main() -> int:
    name = phase_device()
    phase_build()
    pts, msk, gt = _scans(FRAMES, 48, 1024, FRAMES / 110.0, 0.15,
                          SCAN_POINTS)
    k1_row, src, dst = phase_k1(pts, msk)
    k2_row = phase_k2(src, msk[1])
    k1, k2 = phase_slice(pts, msk, gt)
    phase_cpu_agreement()
    k1_row["launches"], k2_row["launches"] = k1, k2
    probe_row = phase_probe()
    k3_row = phase_k3(pts, msk)
    k5_rows = phase_k5(pts, msk)
    k5_launches = phase_fused_slice(pts, msk, gt)
    for row, prec in zip(k5_rows, ("highest", "bf16")):
        row["launches"] = k5_launches[prec]
    k3_row["launches"] = phase_steps_bf16(pts, msk, gt)
    k4_row = phase_k4(pts, msk)
    k1b_row = phase_k1_batched(pts, src, dst)
    k4_row["launches"], k1b_row["launches"] = phase_full_slam()
    print(json.dumps({"kernels": [k1_row, k2_row, k3_row, k4_row, *k5_rows,
                                  probe_row, k1b_row]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
