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

The line before the last is a JSON summary of the kernels; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
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


def slice_config():
    """The flagship KITTI-scale scan-to-map configuration (bench.py's
    `_kitti_cfg` with its default environment)."""
    from tpu_icp_slam_torch import (
        ICPConfig, MappingConfig, PipelineConfig, SlamConfig,
    )

    return SlamConfig(
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


def _scans(n_frames, n_rings, n_azimuth, path_fraction, voxel, capacity):
    from tpu_icp_slam_torch import synthetic
    from tpu_icp_slam_torch.core.pointcloud import voxel_downsample_np
    from tpu_icp_slam_torch.slam.runner import pad_scans

    scans, gt = synthetic.velodyne_log(
        n_frames=n_frames, n_rings=n_rings, n_azimuth=n_azimuth,
        path_fraction=path_fraction)
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
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms}, src


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


def main() -> int:
    name = phase_device()
    phase_build()
    pts, msk, gt = _scans(FRAMES, 48, 1024, FRAMES / 110.0, 0.15,
                          SCAN_POINTS)
    k1_row, src = phase_k1(pts, msk)
    k2_row = phase_k2(src, msk[1])
    k1, k2 = phase_slice(pts, msk, gt)
    phase_cpu_agreement()
    k1_row["launches"], k2_row["launches"] = k1, k2
    print(json.dumps({"kernels": [k1_row, k2_row]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
