#!/usr/bin/env python3
"""A/B of the port's four scan-to-map cells on one card, or of two
builds of the kernels K1, K3, K4 and K5.

    python3 chip_ab.py [--rounds 5]
    python3 chip_ab.py --old-csrc DIR
    python3 chip_ab.py --profiler-effect
    python3 chip_ab.py --span-split [--rounds 5]
    python3 chip_ab.py --sass
    python3 chip_ab.py --trip-ab OLD_ROOT
    python3 chip_ab.py --loop-profile ROOT
    python3 chip_ab.py --loop-ab OLD_ROOT [--rounds 2]
    python3 chip_ab.py --frame-profile ROOT
    python3 chip_ab.py --frame-ab OLD_ROOT [--rounds 3]

With --sass, the kernels are built anew with ptxas's register, shared-memory
and spill report, the library is disassembled with cuobjdump, and for the
packed scan (K3's and K4's, one per source file that compiles it), K5 at
both precisions, K1 and KN's select the innermost loop that holds the work
(the mma, the FMNMX of a pair, or the FMUL that starts KN's score of a
pair) is counted: static instructions, and lane-instructions per
score or pair (SASS_LOOPS).

With --old-csrc, only the kernels are compared: DIR holds an earlier
csrc/ with the C entry points of commit ad1ed22 (nn_bruteforce_f32,
nn_bruteforce_blocks_per_sm, nn_bf16_f32 taking host-packed operands,
nn_rescore_f32, nn_shortlist_blocks_per_sm, icp_fused_f32 and
icp_fused_max_blocks), unpacked from git with

    mkdir -p build/old_csrc
    git archive ad1ed22 src/tpu_icp_slam_torch/csrc \
        | tar -x -C build/old_csrc --strip-components=3

It is compiled into build/ beside the current kernels. On the inputs of
chip_smoke's phases 2 (K1, 16,384 x 16,384), 12 (batched K1, B = 16, G = 8),
7 (K3), 11 (K4) and 8 (K5, one align of the first frame at "highest" and
"bf16"):

  K1       outputs bit-equal to the old;
  K3       the old kernel (CUDA cores, its wrapper's torch-op packing and
           clamp) against the new (device packing, tensor cores): every
           pick that differs a near-tie of the old one
           (kernels/packed_mma.near_ties), picks equal on >= 0.99 of the
           rows, and equal to the old one-slot tensor-core scorer's
           (packed_mma_argmin) on all; the share of equal picks between
           each two of new, old, that scorer, the plain version and the
           float64 argmin of the packed score;
  K4       packing, candidates, their scores, picks and d2 bit-equal to the
           old;
  K5       both kernels at the same grid: T, rmse, iterations, inliers and
           convergence bit-equal at "highest" and "bf16";

then each is timed old, new, new, old (chip_smoke._device_ms, one call
alone as call_ms, and the port's own kernels' device time from a
torch.profiler run as kernel_ms).

With --profiler-effect, the fused "highest" and steps "highest" cells run
--rounds times each, then one torch.profiler run traces one frame-loop of
each, then they run --rounds times again in the same process: frames/s
before and after the process has used the profiler.

With --span-split, the steps "highest" cell runs as a replay (run_fused)
and online (step, the pose copied to the host after each frame), each
--rounds times plain (ms a frame, host clock), then --rounds times under
a CPU-only torch.profiler and --rounds times under a CPU and CUDA one: ms
a frame, the program's spans a frame (obs/profile.span) and the host us a
frame in each span name, step's own time (step less its frame) apart. The
CPU-only run leaves out CUDA activity tracing, whose cost per launch (the
more, the more nodes a graph has) the benchmark's traced idle carries.

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
           iterations (tol and tol_update off), per precision, device time
           per align (chip_smoke._device_ms).

With --trip-ab OLD_ROOT, the sharded align of chip_smoke's phase 17 (B = 4
of phase 4's frame pairs, 16,384 points each, point-to-plane, T0 the
ground-truth motion) runs on one card without a process group (every
collective the identity) at nn_precision "highest", "bf16" and "rescore",
in four processes taking the package from OLD_ROOT/src, this tree's src,
this tree's again and OLD_ROOT's again (each builds its own kernels).
Each prints its ms a trip (host clock, fenced by the result's copy to the
host) over --rounds runs after a warm-up, and the kernel launches a trip
from the package's counters. OLD_ROOT is a checkout of an earlier commit,
e.g. `git archive <commit> | tar -x -C build/old_tree`.

With --loop-profile ROOT, ROOT's package (ROOT/src) runs two point-to-point
paths, each in a process of its own: chip_smoke's phase 15(2) Slam2D.run
(sim2d_loop, 60 frames, configs/lidar2d_scan_to_map.json) and one backend
verify_batch at phase 13's shape (the full-SLAM preset's detector, a
16,384-point query against two candidates, eight yaws each: B = 16). Each
runs once as a warm-up, then under torch's sync debug mode (every host sync
counted by the two innermost frames of the port that made it), then once
under torch.profiler: the profiled wall, the device's own time and its busy
and idle shares, launches, and the ops with the most host and device time.

With --loop-ab OLD_ROOT, phase 15(2)'s Slam2D.run (frames/s), the
verify_batch above (ms a batched iteration, host clock) and phase 13's
Slam3D.run on its 180-frame loop (backend seconds, frames/s, verification
iterations, closures, ATE, a hash of the poses and of the verified
closures' T_ij, and where the package keeps them the batched 3-D scan's
counts) run --rounds times each after a warm-up, in four processes:
OLD_ROOT's package, this tree's, this tree's again, OLD_ROOT's again; then
the medians of each tree, and whether every run's poses and closures are
bit-equal. The loop log is made once and kept
in build/chip_ab_loop_scans.npz.

With --frame-profile ROOT, ROOT's package runs each cell of FRAME_CELLS
in a process of its own: the four slice cells above (run_fused, 29
frames), phase 15(2)'s Slam2D.run, phase 13's front end (run_fused of
the full-SLAM preset over the 180-frame loop log), "rgbd" (phase 16(2):
RGBDOdometry.run_fused with configs/rgbd.json over the 640x480
simrgbd_fullres log, 29 frames) and "s2s2d" (phase 15(3):
OdometryPipeline.run_fused of SlamConfig()'s 2D scan-to-scan with its
occupancy grid over the sim2d log, 29 frames; its "insert" stage is the
fold into the grid). --frame-cells picks some of them. Each process reports
call 1 (the warm-up, graph captures included where the tree makes them),
one timed run, the host syncs by source line (as --loop-profile), the
bytes torch's allocator reserves, then one torch.profiler run (the first
SLAM3D_WINDOW frames of phase 13's log) with the frame split into its
stages: pre (prediction, extract, the model moved into the sensor frame),
icp, post (the gates) and insert, each stage's host ms, launch calls
(graph replays apart), device kernels and device ms a frame; and, where
the ICP's later trips are graph replays, one later trip: trips a frame,
its device kernels and device ms, and its device time by op family
(_FAMILIES: the port's kernels, cuSOLVER/cuBLAS, gemm, reductions,
elementwise ops, ...); pre's and insert's device time a frame by op
family; and, in the scan-to-map cells, the map stages called eagerly on
the map after a run (_map_stages: extract_local, normals_knn and the map
insert, kernels and device ms a call by op family), which splits the
insert graph's one replay into its two parts. The stages are profiler
ranges that this script wraps around the package's functions; the package
is not edited.

With --frame-ab OLD_ROOT, the same cells run --rounds times after call 1,
OLD_ROOT's package, this tree's, this tree's again and OLD_ROOT's again,
each turn in a process of its own (the cells one after another); then the
medians of each tree.

Prints one line per measurement and, last, {"done": true}. Exits nonzero
without CUDA.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import hashlib
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
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
            ms = chip_smoke._device_ms(run, 10)
            print(f"[K5] {prec} iterations {n_iters}: {ms:.4f} ms/align")


def _old_library(csrc):
    """The kernel entry points of an earlier csrc/, built by nvcc."""
    from tpu_icp_slam_torch.kernels import _build

    out = Path(chip_smoke.ROOT) / "build" / "ab_old" / "libold.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out),
                    *(str(f) for f in sorted(csrc.glob("*.cu")))], check=True)
    lib = ctypes.CDLL(str(out))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.nn_bruteforce_f32.argtypes = [
        ptr, ptr, i32, i32, i32, i32, i32, ptr, ptr, ptr, ptr, ptr]
    lib.nn_bruteforce_f32.restype = i32
    lib.nn_bruteforce_blocks_per_sm.argtypes = [ptr]
    lib.nn_bruteforce_blocks_per_sm.restype = i32
    lib.nn_bf16_f32.argtypes = [
        ptr, ptr, i32, i32, i32, ptr, ptr, ptr, ptr, ptr]
    lib.nn_bf16_f32.restype = i32
    lib.nn_rescore_f32.argtypes = [
        ptr, ptr, i32, i32, i32, i32, i32, ptr, ptr, ptr, ptr, ptr, ptr, ptr,
        ptr, ptr, ptr]
    lib.nn_rescore_f32.restype = i32
    lib.nn_shortlist_blocks_per_sm.argtypes = [ptr]
    lib.nn_shortlist_blocks_per_sm.restype = i32
    lib.packed_mma_argmin.argtypes = [ptr, ptr, i32, i32, ptr, ptr, ptr]
    lib.packed_mma_argmin.restype = i32
    lib.icp_fused_max_blocks.argtypes = [i32, ptr]
    lib.icp_fused_max_blocks.restype = i32
    lib.icp_fused_f32.argtypes = [
        ptr, i32, ptr, ptr, ptr, ptr, i32, ptr, ptr, ptr, i32, i32, ptr, ptr,
        ptr]
    lib.icp_fused_f32.restype = i32
    return lib


def _int_out(fn):
    out = ctypes.c_int(0)
    fn(ctypes.addressof(out))
    return out.value


def _old_k1(lib, src, dst):
    """K1 of the earlier build, split as the current wrapper splits it for
    the earlier kernel's occupancy."""
    from tpu_icp_slam_torch.kernels import _build, nn_cuda

    batch = src.shape[0] if src.dim() == 3 else 1
    group = batch // dst.shape[0] if src.dim() == 3 else 1
    m, n = src.shape[-2], dst.shape[-2]
    splits = nn_cuda.n_split(m, n, batch, _build.sm_count(src.device.index),
                             _int_out(lib.nn_bruteforce_blocks_per_sm))
    part_d2 = torch.empty((batch, splits, m), device=src.device)
    part_idx = torch.empty((batch, splits, m), dtype=torch.int32,
                           device=src.device)
    d2 = torch.empty(src.shape[:-1], device=src.device)
    idx = torch.empty(src.shape[:-1], dtype=torch.int32, device=src.device)
    _build.check(lib.nn_bruteforce_f32(
        src.data_ptr(), dst.data_ptr(), batch, group, m, n, splits,
        part_d2.data_ptr(), part_idx.data_ptr(), d2.data_ptr(), idx.data_ptr(),
        torch.cuda.current_stream().cuda_stream), "old nn_bruteforce_f32")
    return idx, d2


def _old_k3(lib, src, dst):
    """K3 of the earlier build with its wrapper's work: recentring and
    packing in torch ops, its split kernel and fold (target splits so that
    about four of its 256-row blocks run per SM), then the clamp in a torch
    op. Returns (idx, d2)."""
    from tpu_icp_slam_torch.kernels import _build
    from tpu_icp_slam_torch.kernels.nn_bf16 import (
        pack_source, pack_target, recentre,
    )

    m, n = src.shape[0], dst.shape[0]
    s, d = recentre(src, dst)
    a_aug, b_aug = pack_source(s), pack_target(d)
    k = max(1, min(-(-4 * _build.sm_count(src.device.index) // -(-m // 256)),
                   -(-n // 256)))
    part_d2 = torch.empty((k, m), device=src.device)
    part_idx = torch.empty((k, m), dtype=torch.int32, device=src.device)
    e = torch.empty(m, device=src.device)
    idx = torch.empty(m, dtype=torch.int32, device=src.device)
    _build.check(lib.nn_bf16_f32(
        a_aug.data_ptr(), b_aug.data_ptr(), m, n, k, part_d2.data_ptr(),
        part_idx.data_ptr(), e.data_ptr(), idx.data_ptr(),
        torch.cuda.current_stream().cuda_stream), "old nn_bf16_f32")
    return idx, torch.clamp(e, min=0.0)


def _k4_launch(lib, src, dst, per_sm):
    """One K4 call through `lib`'s nn_rescore_f32 (the wrapper's work of
    kernels/nn_rescore.py, the grid from `per_sm` blocks an SM), keeping
    the candidates' scores: (idx, d2, cand_score, scratch views)."""
    from tpu_icp_slam_torch.kernels import _build, nn_rescore

    m, n = src.shape[0], dst.shape[0]
    tn, s = nn_rescore.slots(n)
    ws, layout = nn_rescore._workspace(m, s * tn, s, src.device)
    ptr = _build.pointers(ws, layout)
    idx = torch.empty(m, dtype=torch.int32, device=src.device)
    d2 = torch.empty(m, device=src.device)
    scores = torch.empty((s, m), device=src.device)
    grid = min(-(-m // 128) * s, _build.sm_count(src.device.index) * per_sm)
    _build.check(lib.nn_rescore_f32(
        src.data_ptr(), dst.data_ptr(), m, n, s, tn, grid, ptr["centre"],
        ptr["sc"], ptr["dp"], ptr["a_aug"], ptr["b_aug"], ptr["cand"],
        scores.data_ptr(), idx.data_ptr(), d2.data_ptr(),
        torch.cuda.current_stream().cuda_stream), "nn_rescore_f32")
    return idx, d2, scores, _build.views(ws, layout)


def _k5_launch(lib, args, r_gate, precision, kw, grid):
    """One align through `lib`'s icp_fused_f32 at a given grid, prepared as
    kernels/icp_fused.icp_fused prepares it."""
    from tpu_icp_slam_torch.kernels import _build, icp_fused
    from tpu_icp_slam_torch.kernels.nn_bf16 import pack_target

    bf16 = precision == "bf16"
    srcc, smask, dstc, nrmc, T0c, gate = icp_fused._prepare(*args, None,
                                                            r_gate)
    m, n = srcc.shape[0], dstc.shape[0]
    src4 = torch.cat([srcc, smask[:, None]], dim=1)
    model4 = torch.nn.functional.pad(dstc, (0, 1))
    nrm4 = torch.nn.functional.pad(nrmc, (0, 1))
    baug = pack_target(dstc) if bf16 else None
    partials = torch.empty((2, grid, icp_fused._SUMS_STRIDE),
                           device=srcc.device)
    out = torch.empty(20, device=srcc.device)
    params = icp_fused._Params(**icp_fused._params(**kw))
    _build.check(lib.icp_fused_f32(
        src4.data_ptr(), m, dstc.data_ptr(), model4.data_ptr(), nrm4.data_ptr(),
        None if baug is None else baug.data_ptr(), n, T0c.data_ptr(),
        gate.data_ptr(), ctypes.addressof(params), int(bf16), grid,
        partials.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream().cuda_stream), "icp_fused_f32")
    return (icp_fused._conjugate_out(out[:16].view(4, 4), gate[1:]), out[16],
            out[17].to(torch.int32), out[18].to(torch.int32), out[19] > 0.5)


# The kernels of the earlier build that the current one no longer has, for
# the old side's kernel ms.
OLD_KERNELS = ("nn_bf16_split_kernel", "nn_shortlist_kernel")


def _time_turns(old, new):
    """Device ms, call ms and kernel ms of old and new, in turns old, new,
    new, old."""
    out = {"device_ms": {"old": [], "new": []},
           "call_ms": {"old": [], "new": []},
           "kernel_ms": {"old": [], "new": []}}
    for which in ("old", "new", "new", "old"):
        fn = old if which == "old" else new
        out["device_ms"][which].append(chip_smoke._device_ms(fn))
        out["call_ms"][which].append(chip_smoke._call_ms(fn))
        out["kernel_ms"][which].append(chip_smoke._kernel_ms(
            fn, names=chip_smoke.OWN_KERNELS + OLD_KERNELS)[0])
    return out


def _fmt_turns(t):
    return " | ".join(
        f"{key} old {v['old'][0]:.4f}, new {v['new'][0]:.4f}, new "
        f"{v['new'][1]:.4f}, old {v['old'][1]:.4f}" for key, v in t.items())


def kernels_ab(old_csrc, pts, msk):
    from tpu_icp_slam_torch.kernels import (
        _build, icp_fused, nn_bf16, nn_cuda, nn_rescore, packed_mma,
    )

    lib = _old_library(Path(old_csrc))
    new_lib = _build.load()
    src, dst, _ = chip_smoke.k1_inputs(pts)
    bsrc, bdst = chip_smoke.k1_batched_inputs(pts)
    out = {}
    for name, new, old in (
            ("K1 16384x16384", lambda: nn_cuda.nn_bruteforce(src, dst),
             lambda: _old_k1(lib, src, dst)),
            ("K1 batched B=16 G=8", lambda: nn_cuda.nn_bruteforce(bsrc, bdst),
             lambda: _old_k1(lib, bsrc, bdst))):
        a, b = new(), old()
        torch.cuda.synchronize()
        equal = all(torch.equal(x, y) for x, y in zip(a, b))
        t = _time_turns(old, new)
        print(f"[kernels] {name}: new outputs equal the old bit for bit: "
              f"{equal} | {_fmt_turns(t)}")
        assert equal, f"{name}: the new kernel's outputs differ from the old"
        out[name] = {"equal": equal, **t}

    # K3: the old design (CUDA cores, torch-op packing) against the new;
    # the picks of both, of the plain version, of the old one-slot
    # tensor-core scorer and the float64 argmin of the packed score
    sc, dc = nn_bf16.recentre(src, dst)
    a_aug, b_aug = nn_bf16.pack_source(sc), nn_bf16.pack_target(dc)
    m = a_aug.shape[0]
    new_idx, new_d2 = nn_bf16.nn_bf16(src, dst)
    old_idx, old_d2 = _old_k3(lib, src, dst)
    slot_idx = torch.empty(m, dtype=torch.int32, device=src.device)
    slot_e = torch.empty(m, device=src.device)
    _build.check(lib.packed_mma_argmin(
        a_aug.data_ptr(), b_aug.data_ptr(), m, b_aug.shape[0],
        slot_e.data_ptr(), slot_idx.data_ptr(),
        torch.cuda.current_stream().cuda_stream), "old packed_mma_argmin")
    picks = {"new": new_idx, "old": old_idx, "old one-slot scorer": slot_idx,
             "plain": nn_bf16.nn_bf16_ref(src, dst)[0],
             "float64 argmin": packed_mma.exact_argmin(a_aug, b_aug)}
    torch.cuda.synchronize()
    agree = {f"{x} = {y}": float((picks[x] == picks[y]).float().mean())
             for i, x in enumerate(picks) for y in list(picks)[i + 1:]}
    near = packed_mma.near_ties(a_aug, b_aug, new_idx, old_idx)
    t = _time_turns(lambda: _old_k3(lib, src, dst),
                    lambda: nn_bf16.nn_bf16(src, dst))
    print(f"[kernels] K3 16384x16384: every pick that differs from the old "
          f"a near-tie {bool(near.all())} | equal picks: "
          f"{', '.join(f'{k} {v:.6f}' for k, v in agree.items())} | max "
          f"|d2 - old| {float(torch.max(torch.abs(new_d2 - old_d2))):.3e} | "
          f"{_fmt_turns(t)}")
    assert bool(near.all()) and agree["new = old"] >= 0.99, \
        "K3 disagrees with the old"
    assert agree["new = old one-slot scorer"] == 1.0, \
        "K3's splits changed the tensor-core picks"
    out["K3 16384x16384"] = {"agree": agree, **t}

    # K4: the same design, its scan now K3's: every output bit-equal
    old_per_sm = _int_out(lib.nn_shortlist_blocks_per_sm)
    new_per_sm = nn_bf16.blocks_per_sm(src.device.index)
    a, b = (_k4_launch(new_lib, src, dst, new_per_sm),
            _k4_launch(lib, src, dst, old_per_sm))
    torch.cuda.synchronize()
    equal = (all(chip_smoke.bits_equal(x, y) for x, y in zip(a[:3], b[:3]))
             and all(chip_smoke.bits_equal(a[3][k], b[3][k]) for k in a[3]))
    t = _time_turns(lambda: _k4_launch(lib, src, dst, old_per_sm)[:2],
                    lambda: nn_rescore.nn_rescore(src, dst))
    print(f"[kernels] K4 16384x16384 (blocks an SM: old {old_per_sm}, new "
          f"{new_per_sm}): packing, candidates, their scores, idx and d2 "
          f"bit-equal to the old: {equal} | {_fmt_turns(t)}")
    assert equal, "K4 differs from the old kernel"
    out["K4 16384x16384"] = {"equal": equal, **t}

    # K5 at the same grid for both builds
    args, r_gate = chip_smoke._first_align_problem(pts, msk)
    m = args[0].shape[0]
    for prec in ("highest", "bf16"):
        precision, kw = icp_fused.fused_args(chip_smoke.slice_config(
            loop_backend="fused", nn_precision=prec).icp)
        grid = min(-(-m // icp_fused._ROWS),
                   icp_fused.max_blocks(src.device, prec == "bf16"),
                   _int_out(lambda p: lib.icp_fused_max_blocks(
                       int(prec == "bf16"), p)))
        run = {which: (lambda which=which: _k5_launch(
            new_lib if which == "new" else lib, args, r_gate, precision, kw,
            grid)) for which in ("old", "new")}
        a, b = run["new"](), run["old"]()
        wrapper = icp_fused.icp_fused(*args, r_gate=r_gate,
                                      precision=precision, **kw)
        torch.cuda.synchronize()
        gaps = chip_smoke._k5_gaps(a, b)
        equal = all(torch.equal(x, y) for x, y in zip(a, b))
        as_wrapper = all(torch.equal(x, y) for x, y in zip(a, wrapper))
        t = _time_turns(run["old"], run["new"])
        print(f"[kernels] K5 {prec} (grid {grid}; the wrapper's result "
              f"equal: {as_wrapper}): new T/rmse/iters/inliers/converged "
              f"equal the old bit for "
              f"bit: {equal} | iters {int(a[2])} ({int(b[2])}) inliers "
              f"{int(a[3])} ({int(b[3])}) | gaps "
              f"{', '.join(f'{k} {v:.3e}' for k, v in gaps.items())} | "
              f"{_fmt_turns(t)}")
        assert equal, f"K5 {prec} differs from the old kernel"
        out[f"K5 {prec}"] = {"equal": equal, "grid": grid, "gaps": gaps, **t}
    return out


def profiler_effect(pts, msk, rounds):
    """Frames/s of two cells before and after one profiler run in the same
    process."""
    from torch.profiler import ProfilerActivity, profile

    n_frames = len(pts) - 1
    runs = {k: v for k, v in _cells(pts, msk).items()
            if k in ("fused-highest", "steps-highest")}

    def rates():
        out = {name: [] for name in runs}
        for _ in range(rounds):
            for name, run in runs.items():
                t0 = time.perf_counter()
                run()
                torch.cuda.synchronize()
                out[name].append(n_frames / (time.perf_counter() - t0))
        return out

    before = rates()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        for run in runs.values():
            run()
        torch.cuda.synchronize()
    after = rates()
    for name in runs:
        print(f"[profiler effect] {name}: frames/s before "
              f"{[f'{v:.3f}' for v in before[name]]} (median "
              f"{statistics.median(before[name]):.3f}), after one profiler "
              f"run {[f'{v:.3f}' for v in after[name]]} (median "
              f"{statistics.median(after[name]):.3f})")
    return {"before": before, "after": after}


def span_split(pts, msk, rounds):
    """--span-split: the program's spans in a replay and an online run of
    the steps "highest" cell, plain and under two profilers."""
    from torch.profiler import ProfilerActivity, profile

    from tpu_icp_slam_torch.obs.profile import PREFIX
    from tpu_icp_slam_torch.slam.scan_to_map import ScanToMapPipeline

    pipe = ScanToMapPipeline(chip_smoke.slice_config(
        loop_backend="steps", nn_precision="highest"), device="cuda")
    state0 = pipe.init_state(pts[0], msk[0])
    n = len(pts) - 1

    def replay():
        pipe.run_fused(state0, pts[1:], msk[1:])

    def online():
        state = state0
        for f in range(1, n + 1):
            state, info = pipe.step(state, pts[f], msk[f])
            info["pose"].cpu()

    def timed(run):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(rounds):
            run()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / (rounds * n)

    cpu = [ProfilerActivity.CPU]
    out = {}
    for drive, run in (("replay", replay), ("online", online)):
        run()  # call 1: the captures
        res = {"plain_ms_per_frame": timed(run)}
        for label, acts in (("cpu", cpu),
                            ("cpu_cuda", cpu + [ProfilerActivity.CUDA])):
            with profile(activities=acts) as prof:
                ms = timed(run)
            us, count = collections.Counter(), 0
            for e in prof.profiler.kineto_results.events():
                if e.name().startswith(PREFIX):
                    us[e.name()[len(PREFIX):]] += e.duration_ns() / 1e3
                    count += 1
            per = {k: v / (rounds * n) for k, v in sorted(us.items())}
            if "step" in per:
                per["step_self"] = per["step"] - per["frame"]
            res[label] = {"ms_per_frame": ms,
                          "spans_per_frame": count / (rounds * n),
                          "us_per_frame": per}
        print(f"[span split] {drive} {chip_smoke.card()}: ms a frame plain "
              f"{res['plain_ms_per_frame']:.4f}, CPU profiler "
              f"{res['cpu']['ms_per_frame']:.4f}, CPU+CUDA profiler "
              f"{res['cpu_cuda']['ms_per_frame']:.4f}")
        for name in res["cpu_cuda"]["us_per_frame"]:
            print(f"    {name:<14} us a frame: CPU profiler "
                  f"{res['cpu']['us_per_frame'].get(name, 0.0):9.2f}, "
                  f"CPU+CUDA {res['cpu_cuda']['us_per_frame'][name]:9.2f}")
        out[drive] = res
    return out


# The hot loops --sass reads: a piece of the kernel's mangled name -> (the
# opcode that does one unit of work, and the scores or pairs that one warp
# instruction of it does: an mma m16n8k16 scores 128 pairs, an FMNMX
# takes one pair a lane).
SASS_LOOPS = {
    "18packed_scan_kernel": ("HMMA", 128),
    "16icp_fused_kernelILb1E": ("HMMA", 128),
    "16icp_fused_kernelILb0E": ("FMNMX", 32),
    "15nn_split_kernel": ("FMNMX", 32),
    "24nn_split_kernel_factored": ("FMNMX", 32),
    "17knn_select_kernel": ("FMUL", 32),
}
_SASS_LINE = re.compile(
    r"\s*/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);")


def _sass_functions(text):
    """[(source, mangled name, [(address, opcode, branch target or None),
    ...]), ...]: one entry per compiled function, so that a kernel that two
    sources compile from one header appears twice. source is the fatbin's
    identifier where cuobjdump prints one, else the cubin's ordinal."""
    funcs, cubin, source = [], 0, None
    for line in text.splitlines():
        if line.strip().startswith("identifier"):
            source = line.split("=", 1)[1].strip()
        elif line.strip().startswith("Fatbin elf code"):
            cubin, source = cubin + 1, None
        elif "Function : " in line:
            funcs.append((source or f"cubin {cubin}",
                          line.split("Function : ", 1)[1].strip(), []))
        elif funcs and (m := _SASS_LINE.match(line)):
            op = m.group(2).split(".")[0]
            tgt = re.search(r"0x([0-9a-f]+)", m.group(3)) if op == "BRA" \
                else None
            funcs[-1][2].append((int(m.group(1), 16), op,
                                 int(tgt.group(1), 16) if tgt else None))
    return funcs


def _hot_loop(ins, op):
    """The loop (a backward branch's span) densest in `op`, so that neither
    a loop around it nor a small loop elsewhere that holds one (a shuffle
    reduction's FMNMX) is taken for the scan: (first address, last
    address, the opcodes in it), or None."""
    best = None
    for addr, o, tgt in ins:
        if o != "BRA" or tgt is None or tgt > addr:
            continue
        body = [x for a, x, _ in ins if tgt <= a <= addr]
        if op in body and (best is None or body.count(op) * len(best[2])
                           > best[2].count(op) * len(body)):
            best = (tgt, addr, body)
    return best


def sass_report():
    """Build the kernels with ptxas's report, disassemble the library with
    cuobjdump and count the static instructions of each SASS_LOOPS kernel's
    innermost loop that holds its work opcode."""
    from tpu_icp_slam_torch.kernels import _build

    lib = _build.library_path()
    lib.unlink(missing_ok=True)  # a fresh build, so ptxas reports
    _build.build(verbose=True)
    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(cuobjdump), "-sass", str(lib)], check=True,
                          capture_output=True, text=True).stdout
    out = {}
    for source, name, ins in _sass_functions(text):
        for key, (op, per) in SASS_LOOPS.items():
            loop = key in name and _hot_loop(ins, op)
            if not loop:
                continue
            lo, hi, body = loop
            work = body.count(op)
            ops = {o: body.count(o) for o in sorted(set(body),
                                                    key=body.count)[::-1]}
            per_unit = len(body) * 32 / (work * per)
            label = f"{key} ({source})"
            print(f"[sass] {label}: loop 0x{lo:x}-0x{hi:x}, {len(body)} "
                  f"instructions, {work} {op} -> {per_unit:.3f} "
                  f"lane-instructions per {'score' if op == 'HMMA' else 'pair'}"
                  f" | {ops}")
            out[label] = {"instructions": len(body), op: work,
                        "per_unit": per_unit, "opcodes": ops}
    return out


def trip_worker(src_dir, rounds):
    """One process of --trip-ab: the package from src_dir; prints one JSON
    line {"src", "trips", "trip_ms": {precision: [ms a trip, ...]},
    "launches_per_trip": {precision: {"wrapper.counter": n}}}, from the
    tree's own launch counters (kernels.graphs.launch_counters)."""
    sys.path.insert(0, str(Path(src_dir).resolve()))
    import dataclasses

    import tpu_icp_slam_torch
    from tpu_icp_slam_torch.dist import ShardedAligner, make_mesh
    from tpu_icp_slam_torch.kernels import _build, graphs

    assert Path(tpu_icp_slam_torch.__file__).resolve().is_relative_to(
        Path(src_dir).resolve()), tpu_icp_slam_torch.__file__
    _build.build()
    pts, msk, gt = chip_smoke._scans(
        chip_smoke.FRAMES, 48, 1024, chip_smoke.FRAMES / 110.0, 0.15,
        chip_smoke.SCAN_POINTS)
    icp, arrays = chip_smoke._sharded_problems(pts, msk, gt)
    mesh = make_mesh(1, axes=("dp", "sp"), device="cuda")
    out = {"src": str(src_dir), "trips": {}, "trip_ms": {},
           "launches_per_trip": {}}
    for prec in ("highest", "bf16", "rescore"):
        aligner = ShardedAligner(mesh, dataclasses.replace(
            icp, nn_precision=prec))
        trips = int(aligner(*arrays).iters.max())  # warm-up
        # the tree's own counters: chip_smoke's name this tree's kernels
        counters = graphs.launch_counters()
        for f, a in counters:
            setattr(f, a, 0)
        times = []
        for _ in range(rounds):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            aligner(*arrays).T.cpu()
            times.append((time.perf_counter() - t0) * 1e3 / trips)
        out["trips"][prec] = trips
        out["trip_ms"][prec] = times
        out["launches_per_trip"][prec] = {
            f"{f.__name__}.{a}": getattr(f, a) / (rounds * trips)
            for f, a in counters if getattr(f, a)}
    print(json.dumps(out))


def trip_ab(old_root, rounds):
    """--trip-ab: old, new, new, old, each in a process of its own."""
    trees = [Path(old_root) / "src", Path(chip_smoke.ROOT) / "src"]
    results = []
    for tree in (trees[0], trees[1], trees[1], trees[0]):
        proc = subprocess.run(
            [sys.executable, __file__, "--trip-worker", str(tree),
             "--rounds", str(rounds)], capture_output=True, text=True,
            cwd=chip_smoke.ROOT, timeout=900)
        if proc.returncode != 0:
            raise RuntimeError(f"trip worker on {tree} failed:\n"
                               f"{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        label = "old" if tree == trees[0] else "new"
        for prec, ms in res["trip_ms"].items():
            print(f"[trip {label}] {prec}: {res['trips'][prec]} trips, ms a "
                  f"trip {', '.join(f'{t:.4f}' for t in ms)} (median "
                  f"{statistics.median(ms):.4f}) | launches a trip "
                  f"{res['launches_per_trip'][prec]}")
        results.append({"tree": label, **res})
    return results


def _sync_sites(fn):
    """Synchronizing CUDA calls made by fn(), as torch's sync debug mode
    reports them, counted by where the port made each: the innermost two
    frames of the stack inside tpu_icp_slam_torch ("file:line <- caller")."""
    import collections
    import traceback
    import warnings

    sites = collections.Counter()

    def show(message, category, filename, lineno, file=None, line=None):
        if chip_smoke.SYNC_WARNING not in str(message):
            return
        own = [f for f in traceback.extract_stack()[:-1]
               if "tpu_icp_slam_torch" in f.filename]
        where = [f"{Path(f.filename).name}:{f.lineno}"
                 for f in reversed(own[-2:])]
        sites[" <- ".join(where) or f"{Path(filename).name}:{lineno}"] += 1

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return dict(sites.most_common())


def _profile_summary(fn, top=10):
    """One torch.profiler run of fn(): profiled wall, the device's own time
    (kernels, copies and fills) and busy share (a lower bound: the profiler
    slows the host), runtime launch calls, and the ops with the most host
    time and the most device time of their own."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    avgs = prof.key_averages()
    dev = sorted((a for a in avgs if a.device_type == DeviceType.CUDA),
                 key=lambda a: -a.self_device_time_total)
    host = sorted((a for a in avgs if a.device_type == DeviceType.CPU),
                  key=lambda a: -a.self_cpu_time_total)
    device_ms = sum(a.self_device_time_total for a in dev) / 1e3
    return {
        "wall_ms": wall_ms, "device_ms": device_ms,
        "busy": device_ms / wall_ms, "idle": 1.0 - device_ms / wall_ms,
        "kernels": sum(a.count for a in dev),
        "launches": sum(a.count for a in avgs if a.key.startswith(
            ("cudaLaunch", "cuLaunch", "cudaGraphLaunch"))),
        "top_host": [(a.key[:70], a.count, a.self_cpu_time_total / 1e3)
                     for a in host[:top]],
        "top_device": [(a.key[:70], a.count, a.self_device_time_total / 1e3)
                       for a in dev[:top]]}


def _loop_scans():
    """Phase 13's 180-frame loop log, made once and kept under build/ for
    the other worker processes."""
    path = Path(chip_smoke.ROOT) / "build" / "chip_ab_loop_scans.npz"
    if path.exists():
        with np.load(path) as z:
            return z["pts"], z["msk"], z["gt"]
    cfg = chip_smoke.full_slam_config()
    pts, msk, gt = chip_smoke._scans(
        chip_smoke.LOOP_FRAMES, 48, 1024, 1.0, cfg.pipeline.downsample_voxel,
        cfg.pipeline.scan_capacity, chip_smoke.LOOP_WAYPOINTS)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, pts=pts, msk=msk, gt=gt)
    return pts, msk, gt


def _slam2d_cell():
    """Phase 15(2)'s Slam2D.run: sim2d_loop, 60 frames, configs/
    lidar2d_scan_to_map.json; returns run() -> (slam, report, seconds)."""
    from tpu_icp_slam_torch import from_json
    from tpu_icp_slam_torch.slam import runner, slam2d

    with open(chip_smoke.CONFIG2) as f:
        cfg = from_json(f.read())
    pts, msk = runner.pad_scans(runner.load_dataset(
        "sim2d_loop", chip_smoke.SIM2D_FRAMES).scans,
        cfg.pipeline.scan_capacity)

    def run():
        slam = slam2d.Slam2D(cfg, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, rep = slam.run(pts, msk)
        torch.cuda.synchronize()
        return slam, rep, time.perf_counter() - t0

    return run


def _verify_cell():
    """One backend verify_batch at phase 13's shape: the full-SLAM preset's
    detector, a 16,384-point query (frame 6 of phase 4's log) against two
    candidates (frames 0 and 3), eight yaws each: B = 16. Returns run() ->
    (batched iterations, seconds); the call ends in host copies."""
    from tpu_icp_slam_torch.backend.loop_closure import (
        LoopCandidate, LoopDetector,
    )

    cfg = chip_smoke.full_slam_config()
    pts, msk, gt = chip_smoke._scans(
        chip_smoke.FRAMES, 48, 1024, chip_smoke.FRAMES / 110.0, 0.15,
        chip_smoke.SCAN_POINTS)
    det = LoopDetector(cfg.backend, device="cuda")
    for i in (0, 3, 6):
        det.add_keyframe(pts[i], msk[i], position=gt[i][:3, 3])
    cands = [LoopCandidate(query_idx=2, match_idx=k, score=1.0, yaw=0.0)
             for k in (0, 1)]
    match = [0, 3]

    def run():
        n0 = det.verify_iters
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        det.verify_batch(cands, pts[6], msk[6], pts[match], msk[match])
        return det.verify_iters - n0, time.perf_counter() - t0

    return run


def _slam3d_run(pts, msk, gt):
    """Phase 13's Slam3D.run once: end-to-end frames/s, backend seconds,
    verification iterations, closures, ATE."""
    from tpu_icp_slam_torch.slam.slam3d import Slam3D

    from tpu_icp_slam_torch.kernels import nn_cuda

    slam = Slam3D(chip_smoke.full_slam_config(), device="cuda")
    reset = getattr(nn_cuda, "reset_scan_counts", None)
    if reset:
        reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    poses, rep = slam.run(pts, msk, mode="fused")
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    verified = hashlib.sha256()
    for c in slam.closures:
        verified.update(np.asarray([c.i, c.j], np.int64).tobytes())
        verified.update(np.asarray(c.T_ij, np.float64).tobytes())
    out = {"fps": (len(pts) - 1) / dt, "backend_s": slam.backend_s,
           "verify_iters": slam.detector.verify_iters,
           "closures": rep.n_loop_closures,
           "ate": float(chip_smoke._ate(poses, gt)),
           # bit for bit: the poses, and the verified closures' T_ij
           "poses_sha": hashlib.sha256(np.ascontiguousarray(
               poses, np.float64).tobytes()).hexdigest()[:16],
           "closures_sha": verified.hexdigest()[:16]}
    if reset:
        out["scan_counts"] = nn_cuda.scan_counts()
    return out


LOOP_MODES = ("profile-slam2d", "profile-verify", "ab")


def loop_worker(src_dir, mode, rounds):
    """One process of --loop-profile or --loop-ab: the package from
    src_dir; prints one JSON line."""
    sys.path.insert(0, str(Path(src_dir).resolve()))
    import tpu_icp_slam_torch
    from tpu_icp_slam_torch.kernels import _build

    assert Path(tpu_icp_slam_torch.__file__).resolve().is_relative_to(
        Path(src_dir).resolve()), tpu_icp_slam_torch.__file__
    _build.build()
    out = {"src": str(src_dir), "mode": mode, "card": chip_smoke.card()}
    if mode == "profile-slam2d":
        run = _slam2d_cell()
        run()  # warm-up
        slam, rep, dt = run()
        out["fps"] = (chip_smoke.SIM2D_FRAMES - 1) / dt
        holder = {}
        out["syncs"] = _sync_sites(lambda: holder.update(s=run()[0]))
        slam = holder["s"]
        out["frontend_iters"] = int(slam.frontend_iters.sum())
        out["verify_iters"] = slam.detector.verify_iters
        out["keyframes"] = rep.n_keyframes
        out["profile"] = _profile_summary(run)
    elif mode == "profile-verify":
        run = _verify_cell()
        run()  # warm-up
        trips, times = 0, []
        for _ in range(max(rounds, 1)):
            n, dt = run()
            trips = n
            times.append(dt * 1e3 / n)
        out["trips"] = trips
        out["trip_ms"] = times
        out["syncs"] = _sync_sites(run)
        out["profile"] = _profile_summary(run)
    else:
        s2 = _slam2d_cell()
        s2()  # warm-up
        out["slam2d_fps"] = [(chip_smoke.SIM2D_FRAMES - 1) / s2()[2]
                             for _ in range(rounds)]
        ver = _verify_cell()
        ver()
        out["verify_trip_ms"] = []
        for _ in range(rounds):
            n, dt = ver()
            out["verify_trip_ms"].append(dt * 1e3 / n)
        pts, msk, gt = _loop_scans()
        out["slam3d"] = [_slam3d_run(pts, msk, gt) for _ in range(rounds)]
    print(json.dumps(out))


def _loop_process(tree, mode, rounds):
    proc = subprocess.run(
        [sys.executable, __file__, "--loop-worker", str(tree), "--loop-mode",
         mode, "--rounds", str(rounds)], capture_output=True, text=True,
        cwd=chip_smoke.ROOT, timeout=1200)
    if proc.returncode != 0:
        raise RuntimeError(f"loop worker {mode} on {tree} failed:\n"
                           f"{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def loop_profile(root, rounds):
    """--loop-profile: the Slam2D run and one verify_batch, each profiled in
    a process of its own (sync sites, then one torch.profiler run)."""
    out = []
    for mode in ("profile-slam2d", "profile-verify"):
        res = _loop_process(Path(root) / "src", mode, rounds)
        print(f"[loop profile] {mode} {res['card']}: "
              f"{json.dumps({k: v for k, v in res.items() if k != 'profile'})}")
        prof = res["profile"]
        print(f"    profiled wall {prof['wall_ms']:.3f} ms, device "
              f"{prof['device_ms']:.3f} ms, busy {prof['busy']:.4f}, idle "
              f"{prof['idle']:.4f}, launches {prof['launches']}, device "
              f"kernels {prof['kernels']}"
              + (f" ({prof['kernels'] / res['trips']:.1f} a trip)"
                 if "trips" in res else ""))
        for kind in ("top_host", "top_device"):
            for key, count, ms in prof[kind]:
                print(f"    {kind} {key:<70} {count:7d} {ms:10.3f} ms")
        out.append(res)
    return out


FRAME_CELLS = ("steps-highest", "fused-highest", "fused-bf16", "steps-bf16",
               "slam2d", "slam3d", "rgbd", "s2s2d")
# cells that --frame-cells may name but that no default run takes:
# "steps-degen" is "steps-highest" at degen_eps 1e-6, whose ICP is the
# eager host loop (icp.loop.eager_loop)
EXTRA_FRAME_CELLS = ("steps-degen",)
SLAM3D_WINDOW = 60  # frames of phase 13's log that a profile of it traces


def _frame_cell(name):
    """(run(frames) -> None, frames): a cell of --frame-profile and
    --frame-ab. The four slice cells and "steps-degen" run
    ScanToMapPipeline.run_fused over chip_smoke's 30-frame log; "slam2d" is phase 15(2)'s Slam2D.run (its
    front end the z = 0 lift onto the same pipeline); "slam3d" is phase 13's
    front end, run_fused over the 180-frame loop log with the full-SLAM
    preset; "rgbd" and "s2s2d" are _odometry_cell's. run(k) runs the first
    k frames after the seed frame."""
    from tpu_icp_slam_torch.slam.scan_to_map import ScanToMapPipeline

    if name in ("rgbd", "s2s2d"):
        return _odometry_cell(name)
    if name == "slam2d":
        s2 = _slam2d_cell()
        return (lambda k=None: s2()), chip_smoke.SIM2D_FRAMES - 1
    if name == "slam3d":
        cfg = chip_smoke.full_slam_config()
        pts, msk, _ = _loop_scans()
    else:
        if name == "steps-degen":
            cfg = chip_smoke.slice_config(degen_eps=1e-6)
        else:
            backend, prec = name.split("-")
            cfg = chip_smoke.slice_config(loop_backend=backend,
                                          nn_precision=prec)
        pts, msk, _ = chip_smoke._scans(
            chip_smoke.FRAMES, 48, 1024, chip_smoke.FRAMES / 110.0, 0.15,
            chip_smoke.SCAN_POINTS)
    pipe = ScanToMapPipeline(cfg, device="cuda")
    state0 = pipe.init_state(pts[0], msk[0])
    n = len(pts) - 1

    def run(k=None):
        k = n if k is None else k
        pipe.run_fused(state0, pts[1:k + 1], msk[1:k + 1])

    run.map_parts = (pipe, state0, pts, msk)
    return run, n


def _map_stages(pipe, state0, pts, msk, reps=5):
    """Device kernels and ms a call of the map stages, each called eagerly
    `reps` times (after one warm-up call) on the map after a run over the
    cell's log and on its last frame: pre's extract_local at the last pose,
    and insert's two parts, normals_knn and the map insert. A graph replays
    the same kernels; this splits the insert graph, which the profiler sees
    as one replay."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from tpu_icp_slam_torch.mapping import normals, voxel_map

    state, _ = pipe.run_fused(state0, pts[1:], msk[1:])
    m, p = pipe.cfg.mapping, pipe.cfg.pipeline
    points = torch.as_tensor(pts[-1], device="cuda")
    mask = torch.as_tensor(msk[-1], device="cuda")
    center = state.pose[:3, 3]
    world = torch.where(mask[:, None], points @ state.pose[:3, :3].T + center,
                        torch.full_like(points, 1e6))

    def knn():
        return normals.normals_knn(
            points, mask, k=p.normal_k, ref_stride=p.normal_ref_stride,
            approx=p.normal_approx, oversample=p.normal_oversample)

    nrm = knn()
    insert = (voxel_map.insert_hash if m.insert_backend == "hash"
              else voxel_map.insert)
    calls = {
        "extract_local": lambda: voxel_map.extract_local(
            state.vmap, center, m.local_model_size, approx=m.extract_approx),
        "normals_knn": knn,
        "voxel_map.insert": lambda: insert(state.vmap, world, mask, nrm,
                                           voxel=m.map_voxel, center=center)}
    out = {}
    for name, fn in calls.items():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        dev = [e for e in prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA
               and e.name() not in STAGE_RANGES]
        fams = {}
        for e in dev:
            f = fams.setdefault(_family(e.name()), [0.0, 0.0])
            f[0] += 1 / reps
            f[1] += e.duration_ns() / 1e6 / reps
        out[name] = {"calls": reps, "kernels": len(dev) / reps,
                     "device_ms": sum(e.duration_ns() for e in dev)
                     / 1e6 / reps, "families": fams}
    return out


def _odometry_cell(name):
    """(run(frames) -> None, frames) of the two frame-to-frame cells, their
    logs on the card before the run: "rgbd" is phase 16(2)'s
    RGBDOdometry.run_fused (configs/rgbd.json, simrgbd_fullres at
    640x480, 30 frames), "s2s2d" phase 15(3)'s OdometryPipeline.run_fused
    (SlamConfig(), 2D scan-to-scan with its occupancy grid, sim2d, 30
    frames, as `cli run --dataset sim2d` pads it)."""
    from tpu_icp_slam_torch import SlamConfig
    from tpu_icp_slam_torch.slam import runner

    if name == "rgbd":
        from tpu_icp_slam_torch.slam.rgbd import RGBDOdometry

        depths, _, K = chip_smoke.k2_rgbd_inputs()[1]
        pipe = RGBDOdometry(chip_smoke._rgbd_cfg(), K, device="cuda")
        logs = (torch.as_tensor(depths, dtype=torch.float32, device="cuda"),)
        state0 = pipe.init_state(logs[0][0])
    else:
        from tpu_icp_slam_torch.slam.pipeline import OdometryPipeline

        cfg = SlamConfig()
        data = runner.load_dataset("sim2d", chip_smoke.RGBD_FRAMES)
        pts, msk = runner.pad_scans(runner.preprocess(cfg, data.scans),
                                    cfg.pipeline.scan_capacity)
        pipe = OdometryPipeline(cfg, dim=2, device="cuda")
        logs = chip_smoke._on_card(pts, msk)
        state0 = pipe.init_state(logs[0][0], logs[1][0])
    n = len(logs[0]) - 1

    def run(k=None):
        k = n if k is None else k
        pipe.run_fused(state0, *(x[1:k + 1] for x in logs))

    return run, n


def _stage_ranges():
    """Wrap the stages of a frame in torch.profiler ranges: "frame" around
    scan_to_map._step (the eager frame) or FrameGraphs.frame (the graphed
    one, where this tree has it), "icp" around the ICP (the steps loop,
    K5 or the trip replays), "insert" around the map update. Nothing of the
    package is edited: the names are replaced in its modules. A tree whose
    frames emit their own spans (obs/profile.py's icp_slam.frame and
    icp_slam.graph.insert, which _stage_split reads as "frame" and
    "insert") has only its ICP wrapped."""
    from torch.profiler import record_function

    from tpu_icp_slam_torch.mapping import voxel_map
    from tpu_icp_slam_torch.obs import profile
    from tpu_icp_slam_torch.slam import pipeline, rgbd
    from tpu_icp_slam_torch.slam import scan_to_map as s2m

    def ranged(label, fn):
        def wrapped(*args, **kwargs):
            with record_function(label):
                return fn(*args, **kwargs)
        return wrapped

    targets = [(s2m, "_step", "frame"),
               (s2m, "align_with_correspondence", "icp"),
               (s2m, "icp_fused", "icp"), (s2m, "normals_knn", "insert"),
               (voxel_map, "insert", "insert"),
               (voxel_map, "insert_hash", "insert")]
    # the frame-to-frame odometry: the eager frame, its ICP and (2D) the
    # fold into the occupancy grid
    for mod in (rgbd, pipeline):
        targets += [(mod, "_step", "frame"),
                    (mod, "align_with_correspondence", "icp")]
    targets.append((pipeline, "fold_scan", "insert"))
    for mod, name in ((s2m, "FrameGraphs"), (rgbd, "RGBDFrameGraphs"),
                      (pipeline, "OdomFrameGraphs")):
        graphs = getattr(mod, name, None)
        if graphs is not None:
            targets.append((graphs, "_icp", "icp"))
            if not hasattr(profile, "span"):
                targets += [(graphs, "frame", "frame"),
                            (graphs, "_update_map", "insert")]
    for owner, attr, label in targets:
        if hasattr(owner, attr):
            setattr(owner, attr, ranged(label, getattr(owner, attr)))


_LAUNCH_CALLS = ("cudaLaunch", "cuLaunch", "cudaGraphLaunch", "cuGraphLaunch")
STAGE_RANGES = ("frame", "icp", "insert")
# the program's own spans that stand for a stage range
PROGRAM_SPANS = {"icp_slam.frame": "frame", "icp_slam.graph.insert": "insert"}


def _stage_split(prof, n_frames):
    """Per frame, each stage's host ms, launch calls and device ms from the
    profiler's events: pre runs from a frame's start to its "icp" range,
    post from the end of that range to the "insert" range or the frame's
    end; a kernel counts to the stage whose host call launched it (the
    runtime call's correlation id)."""
    from torch.autograd import DeviceType

    events = prof.profiler.kineto_results.events()
    spans = {name: [] for name in STAGE_RANGES}
    for e in events:
        name = PROGRAM_SPANS.get(e.name(), e.name())
        if e.device_type() == DeviceType.CPU and name in spans:
            spans[name].append((e.start_ns(), e.end_ns()))
    cuts = []  # (start, end, stage)
    for f0, f1 in sorted(spans["frame"]):
        icp = [s for s in spans["icp"] if f0 <= s[0] and s[1] <= f1]
        ins = [s for s in spans["insert"] if f0 <= s[0] and s[1] <= f1]
        c = min(s[0] for s in ins) if ins else f1
        # a frame with no "icp" range (K5 inside the graphed pre) has an
        # empty icp and post stage
        a = min(s[0] for s in icp) if icp else c
        b = max(s[1] for s in icp) if icp else c
        cuts += [(f0, a, "pre"), (a, b, "icp"), (b, c, "post"),
                 (c, f1, "insert")]
    cuts.sort()
    starts = [c[0] for c in cuts]

    def stage_of(t):
        import bisect
        i = bisect.bisect_right(starts, t) - 1
        return cuts[i][2] if i >= 0 and t < cuts[i][1] else None

    out = {s: {"host_ms": 0.0, "launches": 0, "graph_launches": 0,
               "device_ms": 0.0, "kernels": 0, "families": {}}
           for s in ("pre", "icp", "post", "insert")}
    for s0, s1, stage in cuts:
        out[stage]["host_ms"] += (s1 - s0) / 1e6
    launch_at = {}
    for e in events:
        if e.device_type() == DeviceType.CPU and e.name().startswith(
                _LAUNCH_CALLS):
            launch_at[e.correlation_id()] = e.start_ns()
            stage = stage_of(e.start_ns())
            if stage:
                out[stage]["launches"] += 1
                if "Graph" in e.name():
                    out[stage]["graph_launches"] += 1
    for e in events:
        # the profiler mirrors each range on the device's timeline
        if e.device_type() != DeviceType.CUDA or e.name() in spans:
            continue
        t = launch_at.get(e.linked_correlation_id()) or launch_at.get(
            e.correlation_id())
        stage = stage_of(t) if t is not None else None
        if stage:
            ms = e.duration_ns() / 1e6
            out[stage]["device_ms"] += ms
            out[stage]["kernels"] += 1
            fam = out[stage]["families"].setdefault(
                _family(e.name()), [0, 0.0])
            fam[0] += 1
            fam[1] += ms
    return {s: {k: ({f: [c / n_frames, ms / n_frames]
                     for f, (c, ms) in v.items()} if k == "families"
                    else v / n_frames) for k, v in d.items()}
            for s, d in out.items()}


# (family, substrings of a device event's name), first match wins: what
# the trip's and the frame's device time is spent on
_FAMILIES = (
    ("KN", ("knn_select", "knn_probe", "knn_fit")),
    ("EX", ("ex_keys", "ex_refine", "ex_count", "ex_write")),
    ("K2S", ("gn_step",)), ("K2P", ("p2p_sums", "p2p_cov")),
    ("K2", ("gn_accum",)),
    ("NN (K1/K3/K4, voxel)", ("nn_", "packed_scan", "voxel")),
    ("RF", ("rigid_fit",)),
    ("cuSOLVER/cuBLAS solve", ("potrf", "potf2", "trsm", "trsv", "getrf",
                               "getrs", "cusolver", "syevj", "laswp",
                               "magma", "cholesky", "getf2")),
    ("gemm/gemv", ("gemm", "gemv", "Kernel2", "cutlass", "sm90_xmma",
                   "splitK", "dot_kernel")),
    ("reduce", ("reduce_kernel", "Reduce")),
    ("sort/top-k/scan", ("sort", "Sort", "scan", "Scan", "radix", "topk",
                         "TopK", "bitonic")),
    ("index/gather/scatter", ("index", "gather", "scatter", "Index")),
    ("cat/stack", ("CatArray", "cat_")),
    ("copy/fill", ("Memcpy", "Memset", "copy", "fill")),
    ("elementwise", ("elementwise", "Elementwise")),
)


def _family(name):
    for fam, keys in _FAMILIES:
        if any(k in name for k in keys):
            return fam
    return "other"


def frame_worker(src_dir, cell, rounds):
    """One process of --frame-profile (rounds 0, one cell) or --frame-ab
    (cell "a,b,...": those cells in turn): the package from src_dir;
    prints one JSON line, the list of the cells' results."""
    sys.path.insert(0, str(Path(src_dir).resolve()))
    import tpu_icp_slam_torch
    from tpu_icp_slam_torch.kernels import _build

    assert Path(tpu_icp_slam_torch.__file__).resolve().is_relative_to(
        Path(src_dir).resolve()), tpu_icp_slam_torch.__file__
    _build.build()
    print(json.dumps([_frame_cell_run(src_dir, c, rounds)
                      for c in cell.split(",")]))


def _frame_cell_run(src_dir, cell, rounds):
    out = {"src": str(src_dir), "cell": cell, "card": chip_smoke.card()}
    t0 = time.perf_counter()
    run, n = _frame_cell(cell)
    run()  # call 1: the warm-up (and, where the tree has them, captures)
    torch.cuda.synchronize()
    out["call1_s"] = time.perf_counter() - t0
    out["frames"] = n
    times = []
    for _ in range(max(rounds, 1)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    out["fps"] = [n / t for t in times]
    if rounds == 0:
        sites = _sync_sites(run)
        out["syncs"] = sites
        out["syncs_per_frame"] = sum(sites.values()) / n
        out["pool_mib"] = torch.cuda.memory_reserved() / 2**20
        window = min(n, SLAM3D_WINDOW) if cell == "slam3d" else n
        _stage_ranges()
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run(window)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        out["profile"] = _profile_of(prof, wall_ms)
        out["profile"]["frames"] = window
        out["stages"] = _stage_split(prof, window)
        if hasattr(run, "map_parts"):
            out["map_stages"] = _map_stages(*run.map_parts)
    return out


def _profile_of(prof, wall_ms, top=10):
    """_profile_summary's numbers from a finished profiler run."""
    from torch.autograd import DeviceType

    avgs = prof.key_averages()
    # the stage ranges appear on the device's timeline too: not its work
    dev = sorted((a for a in avgs if a.device_type == DeviceType.CUDA
                  and a.key not in STAGE_RANGES),
                 key=lambda a: -a.self_device_time_total)
    host = sorted((a for a in avgs if a.device_type == DeviceType.CPU),
                  key=lambda a: -a.self_cpu_time_total)
    device_ms = sum(a.self_device_time_total for a in dev) / 1e3
    return {
        "wall_ms": wall_ms, "device_ms": device_ms,
        "busy": device_ms / wall_ms, "idle": 1.0 - device_ms / wall_ms,
        "launches": sum(a.count for a in avgs
                        if a.key.startswith(_LAUNCH_CALLS)),
        "launch_calls": {a.key: a.count for a in avgs
                         if a.key.startswith(_LAUNCH_CALLS)},
        "top_host": [(a.key[:70], a.count, a.self_cpu_time_total / 1e3)
                     for a in host[:top]],
        "top_device": [(a.key[:70], a.count, a.self_device_time_total / 1e3)
                       for a in dev[:top]]}


def _frame_process(tree, cell, rounds):
    proc = subprocess.run(
        [sys.executable, __file__, "--frame-worker", str(tree),
         "--frame-cell", cell, "--rounds", str(rounds)],
        capture_output=True, text=True, cwd=chip_smoke.ROOT, timeout=1200)
    if proc.returncode != 0:
        raise RuntimeError(f"frame worker {cell} on {tree} failed:\n"
                           f"{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def frame_profile(root, cells=FRAME_CELLS):
    """--frame-profile: each of these cells in a process of its own:
    call 1, frames/s, host syncs by source line, then one profiler run
    with the frame's stages apart."""
    out = []
    for cell in cells:
        res, = _frame_process(Path(root) / "src", cell, 0)
        n, prof = res["frames"], res["profile"]
        w = prof["frames"]
        print(f"[frame profile] {cell} {res['card']}: call 1 "
              f"{res['call1_s']:.3f} s, {n} frames at "
              f"{res['fps'][0]:.3f} frames/s | host syncs/frame "
              f"{res['syncs_per_frame']:.3f} | profiled {w} frames: wall "
              f"{prof['wall_ms'] / w:.3f} ms, device {prof['device_ms'] / w:.3f}"
              f" ms, launch calls {prof['launches'] / w:.1f} a frame, busy "
              f"{prof['busy']:.4f}, idle {prof['idle']:.4f} | torch "
              f"reserved {res['pool_mib']:.1f} MiB")
        print(f"    syncs by site over {n} frames: {res['syncs']}")
        for stage, v in res["stages"].items():
            print(f"    stage {stage:<6} host {v['host_ms']:.3f} ms, launch "
                  f"calls {v['launches']:.1f} (graph replays "
                  f"{v['graph_launches']:.2f}), device kernels "
                  f"{v['kernels']:.1f}, device {v['device_ms']:.3f} ms a "
                  f"frame")
        _print_trip(res)
        _print_map_stages(res)
        for kind in ("top_host", "top_device"):
            for key, count, ms in prof[kind]:
                print(f"    {kind} {key:<70} {count:7d} {ms:10.3f} ms")
        out.append(res)
    return out


def _print_trip(res):
    """One later ICP trip of a graphed frame: the "icp" stage is the trip
    graph's replays (one a later trip), so its device kernels and time over
    its replays are a trip's; trips a frame are those replays + 1 (trip 0
    runs in "pre"). Eager frames (no replays in "icp") print nothing."""
    icp = res["stages"]["icp"]
    later = icp["graph_launches"]
    if later <= 0:
        return
    print(f"    trip: {later + 1:.3f} trips a frame ({later:.3f} later), "
          f"a later trip {icp['kernels'] / later:.1f} device kernels, "
          f"{icp['device_ms'] / later:.4f} ms of device time; by family "
          f"(kernels, ms a trip):")
    for fam, (count, ms) in sorted(icp["families"].items(),
                                   key=lambda kv: -kv[1][1]):
        print(f"      {fam:<24} {count / later:7.1f} {ms / later:9.4f}")


def _families(fams, per=1.0):
    return ", ".join(f"{fam} {count / per:.1f} / {ms / per:.4f}"
                     for fam, (count, ms) in sorted(fams.items(),
                                                    key=lambda kv: -kv[1][1]))


def _print_map_stages(res):
    """pre's and insert's device time a frame by op family and, in the
    scan-to-map cells, _map_stages' eager calls: extract_local,
    normals_knn and the map insert, each a call."""
    for stage in ("pre", "insert"):
        v = res["stages"][stage]
        print(f"    {stage} by family (kernels / ms a frame; "
              f"{v['graph_launches']:.3f} graph replays a frame): "
              f"{_families(v['families'])}")
    for name, v in res.get("map_stages", {}).items():
        print(f"    map stage {name:<16} {v['kernels']:.1f} kernels, "
              f"{v['device_ms']:.4f} ms of device time a call (eager, "
              f"{v['calls']} calls): {_families(v['families'])}")


def frame_ab(old_root, rounds, cells=FRAME_CELLS):
    """--frame-ab: each of these cells, OLD_ROOT's package against this
    tree's, old, new, new, old, each turn in a process of its own (the
    cells one after another); frames/s over --rounds runs after call 1,
    and the medians."""
    trees = [Path(old_root) / "src", Path(chip_smoke.ROOT) / "src"]
    results = []
    for tree in (trees[0], trees[1], trees[1], trees[0]):
        label = "old" if tree == trees[0] else "new"
        for res in _frame_process(tree, ",".join(cells), rounds):
            print(f"[frame {label}] {res['cell']} {res['card']}: call 1 "
                  f"{res['call1_s']:.3f} s, frames/s {_join(res['fps'], 3)}")
            results.append({"tree": label, **res})
    for cell in cells:
        med = {label: statistics.median(
            v for r in results if r["tree"] == label and r["cell"] == cell
            for v in r["fps"]) for label in ("old", "new")}
        print(f"[frame median] {cell}: old {med['old']:.3f}, new "
              f"{med['new']:.3f} frames/s ({med['new'] / med['old']:.3f}x)")
    return results


def _join(vals, digits):
    return ", ".join(f"{v:.{digits}f}" for v in vals)


def loop_ab(old_root, rounds):
    """--loop-ab: phase 15(2)'s Slam2D.run, phase 13's Slam3D.run and one
    verify_batch at phase 13's shape, old, new, new, old, each in a process
    of its own."""
    trees = [Path(old_root) / "src", Path(chip_smoke.ROOT) / "src"]
    results = []
    for tree in (trees[0], trees[1], trees[1], trees[0]):
        res = _loop_process(tree, "ab", rounds)
        label = "old" if tree == trees[0] else "new"
        s3 = res["slam3d"]
        print(f"[loop {label}] {res['card']} | Slam2D.run frames/s "
              f"{_join(res['slam2d_fps'], 3)} | verify ms a trip "
              f"{_join(res['verify_trip_ms'], 4)} | Slam3D backend s "
              f"{_join([r['backend_s'] for r in s3], 3)}, frames/s "
              f"{_join([r['fps'] for r in s3], 3)}, verify iters "
              f"{[r['verify_iters'] for r in s3]}, closures "
              f"{[r['closures'] for r in s3]}, ATE "
              f"{_join([r['ate'] for r in s3], 5)}, poses "
              f"{sorted({r['poses_sha'] for r in s3})}, closures "
              f"{sorted({r['closures_sha'] for r in s3})}"
              + (f", scan counts {s3[-1]['scan_counts']}"
                 if "scan_counts" in s3[-1] else ""))
        results.append({"tree": label, **res})
    shas = {(s["poses_sha"], s["closures_sha"]) for r in results
            for s in r["slam3d"]}
    print(f"[loop] poses and verified closures bit-equal across trees and "
          f"rounds: {len(shas) == 1}")
    for label in ("old", "new"):
        runs = [r for r in results if r["tree"] == label]
        med = {
            "slam2d_fps": statistics.median(
                v for r in runs for v in r["slam2d_fps"]),
            "verify_trip_ms": statistics.median(
                v for r in runs for v in r["verify_trip_ms"]),
            "backend_s": statistics.median(
                s["backend_s"] for r in runs for s in r["slam3d"]),
            "slam3d_fps": statistics.median(
                s["fps"] for r in runs for s in r["slam3d"])}
        print(f"[loop median] {label}: {json.dumps(med)}")
    return results


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--old-csrc", default=None,
                    help="compare K1, K3, K4 and K5 with the build of this "
                         "csrc/")
    ap.add_argument("--profiler-effect", action="store_true",
                    help="frames/s before and after one profiler run")
    ap.add_argument("--span-split", action="store_true",
                    help="the program's spans in a replay and an online "
                         "run, plain and under two profilers")
    ap.add_argument("--sass", action="store_true",
                    help="ptxas report and the hot loops' SASS instructions")
    ap.add_argument("--trip-ab", default=None, metavar="OLD_ROOT",
                    help="the sharded align's ms a trip, OLD_ROOT's package "
                         "against this tree's")
    ap.add_argument("--trip-worker", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--loop-profile", default=None, metavar="ROOT",
                    help="sync sites and a profile of the Slam2D run and "
                         "of one verify_batch, ROOT's package")
    ap.add_argument("--loop-ab", default=None, metavar="OLD_ROOT",
                    help="Slam2D.run, Slam3D's backend and the "
                         "verification trip, OLD_ROOT's package against "
                         "this tree's")
    ap.add_argument("--frame-profile", default=None, metavar="ROOT",
                    help="sync sites, call 1 and a profile of the frame's "
                         "stages in every cell, ROOT's package")
    ap.add_argument("--frame-ab", default=None, metavar="OLD_ROOT",
                    help="frames/s of every cell, OLD_ROOT's package "
                         "against this tree's")
    ap.add_argument("--frame-cells", default=",".join(FRAME_CELLS),
                    help="the cells of --frame-profile and --frame-ab, "
                         "comma-separated (default: all of FRAME_CELLS; "
                         "also EXTRA_FRAME_CELLS)")
    ap.add_argument("--frame-worker", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--frame-cell", help=argparse.SUPPRESS)
    ap.add_argument("--loop-worker", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--loop-mode", choices=LOOP_MODES,
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.trip_worker:
        trip_worker(args.trip_worker, args.rounds)
        return 0
    if args.loop_worker:
        loop_worker(args.loop_worker, args.loop_mode, args.rounds)
        return 0
    if args.frame_worker:
        frame_worker(args.frame_worker, args.frame_cell, args.rounds)
        return 0
    chip_smoke.phase_device()
    if args.frame_profile or args.frame_ab:
        cells = tuple(args.frame_cells.split(","))
        unknown = set(cells) - set(FRAME_CELLS) - set(EXTRA_FRAME_CELLS)
        if unknown:
            ap.error(f"unknown --frame-cells {sorted(unknown)}")
        if args.frame_profile:
            print(json.dumps({"frame_profile": frame_profile(
                args.frame_profile, cells)}))
        if args.frame_ab:
            print(json.dumps({"frame_ab": frame_ab(args.frame_ab,
                                                   args.rounds, cells)}))
        print(json.dumps({"done": True}))
        return 0
    if args.loop_profile or args.loop_ab:
        if args.loop_profile:
            print(json.dumps({"loop_profile": loop_profile(
                args.loop_profile, args.rounds)}))
        if args.loop_ab:
            print(json.dumps({"loop_ab": loop_ab(args.loop_ab,
                                                 args.rounds)}))
        print(json.dumps({"done": True}))
        return 0
    if args.trip_ab:
        print(json.dumps({"trip_ab": trip_ab(args.trip_ab, args.rounds)}))
        print(json.dumps({"done": True}))
        return 0
    if args.sass:
        print(json.dumps({"sass": sass_report()}))
        print(json.dumps({"done": True}))
        return 0
    chip_smoke.phase_build()
    pts, msk, _ = chip_smoke._scans(
        chip_smoke.FRAMES, 48, 1024, chip_smoke.FRAMES / 110.0, 0.15,
        chip_smoke.SCAN_POINTS)
    if args.old_csrc:
        print(json.dumps({"kernels_ab": kernels_ab(args.old_csrc, pts, msk)}))
        print(json.dumps({"done": True}))
        return 0
    if args.profiler_effect:
        print(json.dumps({"profiler_effect": profiler_effect(
            pts, msk, args.rounds)}))
        print(json.dumps({"done": True}))
        return 0
    if args.span_split:
        print(json.dumps({"span_split": span_split(pts, msk, args.rounds)}))
        print(json.dumps({"done": True}))
        return 0
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
