#!/usr/bin/env python3
"""A/B of the port's four scan-to-map cells on one card.

    python3 chip_ab.py [--rounds 5]

The cells are chip_smoke.slice_config() on chip_smoke.py's 30-frame
KITTI-scale log (29 timed frames), at icp.loop_backend "steps" and "fused"
and nn_precision "highest" and "bf16". Each cell's pipeline is built and
warmed up once; then:

  ab       frames/s of every cell in each of --rounds rounds, the order of
           the cells reversed every other round (host clock, fenced by
           torch.cuda.synchronize());
  syncs    host syncs over the 29 frames, as torch's sync debug mode counts
           them;
  prof     one torch.profiler run of each cell: kernel launches (runtime
           launch calls), device time (sum of the kernels' own time), the
           busy share device time / profiled wall (the profiler slows the
           wall, so it is a lower bound) and the eight costliest kernels;
  K5       one align of chip_smoke's phase-8 problem at a fixed 1, 4 and 8
           iterations (tol and tol_update off), per precision, median of
           CUDA-event timings around the wrapper.

Prints one line per measurement and, last, {"done": true}. Exits nonzero
without CUDA.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import torch

import chip_smoke

CELLS = (("steps", "highest"), ("fused", "highest"), ("fused", "bf16"),
         ("steps", "bf16"))


def _cells(pts, msk):
    from tpu_icp_slam_torch.slam.scan_to_map import ScanToMapPipeline

    runs = {}
    for backend, prec in CELLS:
        pipe = ScanToMapPipeline(chip_smoke.slice_config(
            loop_backend=backend, nn_precision=prec), device="cuda")
        state0 = pipe.init_state(pts[0], msk[0])
        run = (lambda pipe=pipe, state0=state0:
               pipe.run_fused(state0, pts[1:], msk[1:]))
        run()  # warm-up
        runs[f"{backend}-{prec}"] = run
    torch.cuda.synchronize()
    return runs


def _ab(runs, rounds, n_frames):
    rates = {name: [] for name in runs}
    iters = {}
    for r in range(rounds):
        order = list(runs) if r % 2 == 0 else list(reversed(runs))
        for name in order:
            t0 = time.perf_counter()
            _, infos = runs[name]()
            torch.cuda.synchronize()
            rates[name].append(n_frames / (time.perf_counter() - t0))
            iters[name] = float(infos["iters"].float().mean())
    for name, vals in rates.items():
        print(f"[ab] {name}: frames/s runs "
              f"{[f'{v:.3f}' for v in sorted(vals)]} median "
              f"{statistics.median(vals):.3f} | mean iters "
              f"{iters[name]:.3f}")


def _prof(name, run, n_frames):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    avgs = prof.key_averages()
    launches = sum(a.count for a in avgs
                   if a.key.startswith(("cudaLaunch", "cuLaunch")))
    kernels = sorted((a for a in avgs if a.device_type == DeviceType.CUDA),
                     key=lambda a: -a.self_device_time_total)
    device_ms = sum(a.self_device_time_total for a in kernels) / 1e3
    print(f"[prof] {name}: wall {wall_ms:.2f} ms (profiled), launches "
          f"{launches} ({launches / n_frames:.1f}/frame), device time "
          f"{device_ms:.3f} ms, busy {device_ms / wall_ms:.3f}")
    for a in kernels[:8]:
        print(f"    {a.key[:60]:<60} {a.count:6d} "
              f"{a.self_device_time_total / 1e3:9.3f} ms")


def _k5_per_align(pts, msk):
    from tpu_icp_slam_torch.kernels import icp_fused

    args, r_gate = chip_smoke._first_align_problem(pts, msk)
    for prec in ("highest", "bf16"):
        precision, kw = icp_fused.fused_args(chip_smoke.slice_config(
            loop_backend="fused", nn_precision=prec).icp)
        for n_iters in (1, 4, 8):
            kw.update(max_iters=n_iters, tol=0.0, tol_update=0.0)
            run = lambda: icp_fused.icp_fused(*args, r_gate=r_gate,
                                              precision=precision, **kw)
            assert int(run()[2]) == n_iters
            ms = chip_smoke._median_ms(run, 10)
            print(f"[K5] {prec} iterations {n_iters}: {ms:.4f} ms/align")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=5)
    args = ap.parse_args()
    chip_smoke.phase_device()
    chip_smoke.phase_build()
    pts, msk, _ = chip_smoke._scans(
        chip_smoke.FRAMES, 48, 1024, chip_smoke.FRAMES / 110.0, 0.15,
        chip_smoke.SCAN_POINTS)
    n_frames = len(pts) - 1
    runs = _cells(pts, msk)
    _ab(runs, args.rounds, n_frames)
    for name, run in runs.items():
        syncs = chip_smoke._host_syncs(run)
        print(f"[syncs] {name}: {syncs} in {n_frames} frames = "
              f"{syncs / n_frames:.3f}/frame")
    for name, run in runs.items():
        _prof(name, run, n_frames)
    _k5_per_align(pts, msk)
    print(json.dumps({"done": True}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
