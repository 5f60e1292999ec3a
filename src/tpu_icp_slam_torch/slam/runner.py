"""Dataset-to-trajectory runner behind `cli run` / `cli eval` (port of
tpu_icp_slam/slam/runner.py).

Loads a dataset (the synthetic 2D, 3D and RGB-D logs, a CARMEN
`.clf`/`.log` file, a KITTI sequence or a TUM RGB-D directory), pads scans
to a fixed capacity, drives the pipeline the config names on `device` —
full 3D SLAM (`Slam3D`), 2D SLAM (`Slam2D`, for a 2D log with the backend
on or a scan-to-map config), scan-to-map odometry (`ScanToMapPipeline`),
scan-to-scan odometry (`OdometryPipeline`, 2D with its occupancy grid) or,
for depth images, RGB-D odometry (`RGBDOdometry`, config 3) — and writes
the artifacts: trajectory .npz with its TUM and KITTI text forms, the map
render .png, metrics .jsonl and report.json. The report's keys are the
reference's. The reference's `apply_debug` sets JAX flags and has no
counterpart here.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional

import numpy as np
import torch

from tpu_icp_slam_torch.config import (
    SlamConfig,
    config_hash,
    from_json,
    override,
)
from tpu_icp_slam_torch.core.pointcloud import PAD_COORD, voxel_downsample_np
from tpu_icp_slam_torch.datasets import carmen, kitti, synthetic, tum
from tpu_icp_slam_torch.eval import metrics as em
from tpu_icp_slam_torch.eval import trajectory_io as tio
from tpu_icp_slam_torch.icp.projective import CameraIntrinsics
from tpu_icp_slam_torch.mapping import occupancy2d, voxel_map
from tpu_icp_slam_torch.obs import MetricsLogger, Timer
from tpu_icp_slam_torch.slam import map_io
from tpu_icp_slam_torch.slam.checkpoint import load_checkpoint, save_checkpoint
from tpu_icp_slam_torch.slam.pipeline import OdometryPipeline
from tpu_icp_slam_torch.slam.rgbd import RGBDOdometry
from tpu_icp_slam_torch.slam.scan_to_map import ScanToMapPipeline
from tpu_icp_slam_torch.slam.slam2d import Slam2D
from tpu_icp_slam_torch.slam.slam3d import Slam3D


@dataclasses.dataclass
class LoadedDataset:
    scans: list  # list of (N_i, D) float arrays (sensor frame); empty for rgbd
    gt_poses: Optional[np.ndarray]  # (F, D+1, D+1) or None
    dim: int
    name: str
    kind: str = "scan"  # scan | rgbd
    depths: Optional[np.ndarray] = None  # (F, H, W) metres, for rgbd
    intrinsics: Optional[tuple] = None  # (fx, fy, cx, cy, W, H), for rgbd


def _polar_scans(log, n: int) -> list:
    return [synthetic.scan_to_points(log.ranges[i], log.angles,
                                     log.max_range) for i in range(n)]


def load_dataset(spec: str, frames: int, seed: int = 0) -> LoadedDataset:
    if spec in ("sim2d", "sim2d_loop"):
        log = synthetic.lidar2d_log(n_frames=frames, n_beams=360, seed=seed,
                                    noise=0.002, loop=spec == "sim2d_loop")
        return LoadedDataset(scans=_polar_scans(log, len(log.ranges)),
                             gt_poses=log.gt_poses, dim=2, name=spec)
    if spec in ("sim3d", "sim3d_loop"):
        # pin inter-frame motion to ~1.1 m/frame (the KITTI 10 Hz regime):
        # the generator resamples its fixed route by frame count; the loop
        # route needs the full circuit to close, so it keeps fraction 1
        frac = 1.0 if spec.endswith("loop") else min(1.0, frames / 110.0)
        scans, poses = synthetic.velodyne_log(
            n_frames=frames, seed=seed, loop=spec.endswith("loop"),
            path_fraction=frac,
        )
        return LoadedDataset(scans=scans, gt_poses=poses, dim=3, name=spec)
    if spec in ("simrgbd", "simrgbd_fullres"):
        # fullres: TUM fr1's 640x480 sensor grid (307,200 pixels a frame),
        # config 3's regime; simrgbd: the 160x120 stand-in
        K_in = (synthetic.Intrinsics.tum_default(640, 480)
                if spec == "simrgbd_fullres" else None)
        depths, poses, K = synthetic.rgbd_log(n_frames=frames, K=K_in,
                                              seed=seed)
        return LoadedDataset(
            scans=[], gt_poses=poses, dim=3, name=spec, kind="rgbd",
            depths=depths,
            intrinsics=(K.fx, K.fy, K.cx, K.cy, K.width, K.height))
    if os.path.isdir(spec) and os.path.exists(os.path.join(spec,
                                                           "depth.txt")):
        # read with fr1's intrinsics, whatever the image size
        seq = tum.load_sequence(spec, max_frames=frames)
        h, w = seq.depths.shape[1:]
        return LoadedDataset(
            scans=[], gt_poses=seq.gt_poses, dim=3,
            name=os.path.basename(spec.rstrip("/")), kind="rgbd",
            depths=seq.depths, intrinsics=(*seq.intrinsics, w, h))
    if spec.endswith((".clf", ".log")):
        log = carmen.load_clf(spec)
        n = min(frames, len(log.ranges)) if frames > 0 else len(log.ranges)
        return LoadedDataset(scans=_polar_scans(log, n), gt_poses=None,
                             dim=2, name=os.path.basename(spec))
    if os.path.isdir(spec) and os.path.exists(os.path.join(spec, "velodyne")):
        scans, poses = kitti.load_sequence(spec, max_frames=frames)
        return LoadedDataset(scans=scans, gt_poses=poses, dim=3,
                             name=os.path.basename(spec.rstrip("/")))
    raise ValueError(f"unknown dataset spec: {spec}")


def pad_scans(scans: list, capacity: int):
    """list of (N_i, D) -> (F, C, D) float32 points + (F, C) masks.

    Oversized scans are subsampled uniformly, never truncated: scan points
    arrive ordered by ring or azimuth, so truncation would delete whole
    regions of the field of view.
    """
    f = len(scans)
    d = scans[0].shape[1]
    pts = np.full((f, capacity, d), PAD_COORD, np.float32)
    msk = np.zeros((f, capacity), bool)
    for i, s in enumerate(scans):
        if len(s) > capacity:
            s = s[np.linspace(0, len(s) - 1, capacity).astype(np.int64)]
        pts[i, :len(s)] = s
        msk[i, :len(s)] = True
    return pts, msk


def preprocess(cfg: SlamConfig, scans: list) -> list:
    """The configured host-side voxel downsample (pipeline.downsample_voxel)."""
    v = cfg.pipeline.downsample_voxel
    return [voxel_downsample_np(s, v) for s in scans] if v > 0 else scans


def _make_report(poses, data, cfg, mode: str, timer, extra: dict | None = None):
    """Shared report assembly: identity, timers, and GT accuracy metrics."""
    report = {
        "frames": len(poses),
        "dataset": data.name,
        "config_hash": config_hash(cfg),
        "mode": mode,
        **(extra or {}),
        "timers": timer.summary(),
    }
    if data.gt_poses is not None:
        gt = data.gt_poses[: len(poses)]
        d = data.dim
        report["ate_rmse"] = em.ate_rmse(poses[:, :d, d], gt[:, :d, d])
        t_rpe, r_rpe = em.rpe(poses, gt)
        report["rpe_trans"] = t_rpe
        report["rpe_rot"] = r_rpe
    return report


def _write_artifacts(out_dir, poses, report, render_map=None):
    """trajectory.npz (+ TUM/KITTI text) + map render + report.json."""
    if not out_dir:
        return
    os.makedirs(out_dir, exist_ok=True)
    np.savez(os.path.join(out_dir, "trajectory.npz"), poses=poses)
    tio.write_tum(os.path.join(out_dir, "trajectory_tum.txt"), poses)
    tio.write_kitti(os.path.join(out_dir, "trajectory_kitti.txt"), poses)
    if render_map is not None:
        png = os.path.join(out_dir, "map.png")
        render_map(png)
        report["map_png"] = png
    with open(os.path.join(out_dir, "report.json"), "w") as fh:
        json.dump(report, fh, indent=2)


def _finish(metrics_log, report):
    metrics_log.log(
        "done", **{k: v for k, v in report.items() if not isinstance(v, dict)}
    )
    metrics_log.close()


def _render(vmap, poses):
    return lambda png: voxel_map.render_png(vmap, png,
                                            trajectory=poses[:, :3, 3])


def _run_slam2d(cfg, data, pts, msk, timer, metrics_log, out_dir, mode,
                ckpt_path, checkpoint_every, resume, save_map_path, device):
    """The 2D family with a map-based front end and/or loop closure and the
    pose graph (Slam2D)."""
    slam = Slam2D(cfg, device=device)
    with timer.span("slam2d"):
        poses, srep = slam.run(
            pts, msk, mode="streaming" if mode == "streaming" else "fused",
            checkpoint_path=ckpt_path, checkpoint_every=checkpoint_every,
            resume=resume)
    metrics_log.log("slam2d_run", frames=len(poses),
                    icp_iters=int(slam.frontend_iters.sum()),
                    verify_iters=slam.detector.verify_iters,
                    backend_s=slam.backend_s)
    report = _make_report(poses, data, cfg, "slam2d", timer, extra={
        "n_keyframes": srep.n_keyframes,
        "n_loop_candidates": srep.n_loop_candidates,
        "n_loop_closures": srep.n_loop_closures,
        "n_loops_rejected": srep.n_loops_rejected,
        "n_suspect_closures": srep.n_suspect_closures,
        "closures": srep.closure_table,
    })

    def render(png):
        # the grid rebuilt from the (possibly loop-corrected) trajectory
        occupancy2d.render_png(slam.rebuild_grid(poses, pts, msk), png,
                               trajectory=poses[:, :2, 2])

    if save_map_path:
        # 2D persistent map: keyframe scans, SE(2) poses, descriptors
        map_io.save_map(save_map_path,
                        [(pts[f], msk[f]) for f in slam.kf_frames],
                        np.stack(slam.kf_poses_out), detector=slam.detector,
                        closure_info=srep.closure_table)
        report["map_file"] = save_map_path
    _write_artifacts(out_dir, poses, report, render)
    _finish(metrics_log, report)
    return poses, report


def run_rgbd(cfg: SlamConfig, data: LoadedDataset,
             out_dir: Optional[str] = None, mode: str = "fused",
             device: torch.device | str = "cuda"):
    """RGB-D odometry (config 3): projective point-to-plane ICP a frame,
    always point-to-plane whatever icp.method says, as in the reference.
    Returns (poses (F, 4, 4), report). Beside the reference's artifacts,
    metrics.jsonl holds the run's ICP iterations (`icp_iters`)."""
    fx, fy, cx, cy, w, h = data.intrinsics
    K = CameraIntrinsics(fx=fx, fy=fy, cx=cx, cy=cy, width=w, height=h)
    if cfg.icp.method != "point_to_plane":
        cfg = dataclasses.replace(cfg, icp=dataclasses.replace(
            cfg.icp, method="point_to_plane"))
    timer = Timer()
    metrics_log = MetricsLogger(
        os.path.join(out_dir, "metrics.jsonl") if out_dir else None,
        static_fields={"config_hash": config_hash(cfg), "dataset": data.name},
    )
    pipe = RGBDOdometry(cfg, K, device=device)
    state = pipe.init_state(data.depths[0])
    poses = [np.eye(4, dtype=np.float32)]
    iters = []
    with timer.span("compile+run"):
        if mode == "fused":
            state, infos = pipe.run_fused(state, data.depths[1:])
            poses.extend(list(infos["pose"].cpu().numpy()))
            iters = infos["iters"].tolist()
        else:
            for i in range(1, len(data.depths)):
                state, info = pipe.step(state, data.depths[i])
                poses.append(info["pose"].cpu().numpy())
                iters.append(int(info["iters"]))
    poses = np.stack(poses)
    metrics_log.log("rgbd_run", frames=len(poses), icp_iters=int(sum(iters)))
    report = _make_report(poses, data, cfg, mode, timer)
    _write_artifacts(out_dir, poses, report)
    _finish(metrics_log, report)
    return poses, report


def run_slam(
    cfg: SlamConfig,
    data: LoadedDataset,
    out_dir: Optional[str] = None,
    mode: str = "fused",
    checkpoint_every: int = 0,
    resume: bool = False,
    save_map_path: Optional[str] = None,
    device: torch.device | str = "cuda",
):
    """Returns (poses (F, D+1, D+1) np.ndarray, report dict).

    Beside the reference's fields, metrics.jsonl holds the front end's
    total ICP iterations (`icp_iters`) of a fused odometry run and of full
    SLAM, with loop verification's batched iterations (`verify_iters`) in
    the latter's `slam3d_run` or `slam2d_run` event. Depth images (kind
    "rgbd") go to `run_rgbd`."""
    if data.kind == "rgbd":
        return run_rgbd(cfg, data, out_dir=out_dir, mode=mode, device=device)
    if data.dim not in (2, 3):
        raise ValueError(f"{data.dim}-D scans: the runner takes 2D and 3D")
    timer = Timer()
    metrics_log = MetricsLogger(
        os.path.join(out_dir, "metrics.jsonl") if out_dir else None,
        static_fields={"config_hash": config_hash(cfg), "dataset": data.name},
    )
    with timer.span("preprocess"):
        pts, msk = pad_scans(preprocess(cfg, data.scans),
                             cfg.pipeline.scan_capacity)

    ckpt_path = os.path.join(out_dir, "checkpoint.npz") if out_dir else None
    if data.dim == 2 and (cfg.backend.enabled
                          or cfg.pipeline.mode == "scan_to_map"):
        return _run_slam2d(cfg, data, pts, msk, timer, metrics_log, out_dir,
                           mode, ckpt_path, checkpoint_every, resume,
                           save_map_path, device)
    if cfg.pipeline.mode == "scan_to_map" and cfg.backend.enabled:
        # full config-4 path: scan-to-map + loop closure + pose graph;
        # checkpoint/resume carries the whole SLAM state (Slam3D.run)
        slam = Slam3D(cfg, device=device)
        with timer.span("slam3d"):
            poses, srep = slam.run(
                pts, msk,
                mode="streaming" if mode == "streaming" else "fused",
                checkpoint_path=ckpt_path,
                checkpoint_every=checkpoint_every,
                resume=resume,
            )
        metrics_log.log("slam3d_run", frames=len(poses),
                        icp_iters=int(slam.frontend_iters.sum()),
                        verify_iters=slam.detector.verify_iters,
                        backend_s=slam.backend_s)
        report = _make_report(poses, data, cfg, "slam3d", timer, extra={
            "n_keyframes": srep.n_keyframes,
            "n_loop_candidates": srep.n_loop_candidates,
            "n_loop_closures": srep.n_loop_closures,
            "n_loops_rejected": srep.n_loops_rejected,
            "n_suspect_closures": srep.n_suspect_closures,
            "closures": srep.closure_table,
        })
        render = (_render(slam.final_state.vmap, poses)
                  if slam.final_state is not None else None)
        if save_map_path:
            # persistent map (slam/map_io.py): keyframe scans, the
            # loop-corrected keyframe poses, descriptors and the voxel map,
            # for a later `cli localize`
            map_io.save_map(
                save_map_path,
                [(pts[f], msk[f]) for f in slam.kf_frames],
                np.stack(slam.kf_poses_out),
                vmap=slam.final_state.vmap if slam.final_state else None,
                detector=slam.detector,
                closure_info=srep.closure_table,
            )
            report["map_file"] = save_map_path
        _write_artifacts(out_dir, poses, report, render)
        _finish(metrics_log, report)
        return poses, report
    if cfg.pipeline.mode == "scan_to_map":
        pipe = ScanToMapPipeline(cfg, device=device)
    else:
        pipe = OdometryPipeline(cfg, dim=data.dim, device=device)
    start_idx = 1
    state = None
    if resume and ckpt_path and os.path.exists(ckpt_path):
        state, start_idx, prev_poses = load_checkpoint(ckpt_path, cfg,
                                                       device=device)
        metrics_log.log("resume", frame=start_idx)
    if state is None:
        state = pipe.init_state(pts[0], msk[0])
        prev_poses = [np.eye(data.dim + 1, dtype=np.float32)]

    poses = list(prev_poses)
    if mode == "fused" and not resume and checkpoint_every == 0:
        with timer.span("compile+run_fused"):
            state, infos = pipe.run_fused(state, pts[1:], msk[1:])
            run_poses = infos["pose"].cpu().numpy()
        poses.extend(list(run_poses))
        iters = infos["iters"].cpu().numpy()
        rmses = infos["rmse"].cpu().numpy()
        metrics_log.log(
            "fused_run",
            frames=len(poses),
            mean_icp_iters=float(iters.mean()),
            mean_rmse=float(rmses.mean()),
            icp_iters=int(iters.sum()),
        )
    else:
        with timer.span("run_streaming"):
            for i in range(start_idx, len(pts)):
                # a corrupt frame (non-finite input, a sensor glitch) must
                # not poison the run: a non-finite pose or rmse, or no
                # inlier, drops the frame and keeps the previous state
                prev_state = state
                try:
                    state, info = pipe.step(state, pts[i], msk[i])
                    pose_np = info["pose"].cpu().numpy()
                except Exception as exc:  # host-side failure: skip the frame
                    metrics_log.log("frame_error", frame=i, error=repr(exc))
                    state = prev_state
                    poses.append(poses[-1])
                    continue
                rmse = float(info["rmse"])
                n_inl = int(info["n_inliers"])
                bad = (not np.isfinite(pose_np).all()) or (
                    not np.isfinite(rmse)
                ) or n_inl == 0
                if bad:
                    metrics_log.log(
                        "frame_skipped_degenerate", frame=i, n_inliers=n_inl
                    )
                    state = prev_state
                    poses.append(poses[-1])
                    continue
                poses.append(pose_np)
                if checkpoint_every and out_dir and i % checkpoint_every == 0:
                    save_checkpoint(ckpt_path, state, i + 1, poses, cfg=cfg)
                    metrics_log.log("checkpoint", frame=i + 1)

    poses = np.stack(poses)
    report = _make_report(poses, data, cfg, mode, timer)
    render = None
    if getattr(state, "vmap", None) is not None:
        render = _render(state.vmap, poses)
    elif getattr(state, "grid", None) is not None:
        render = lambda png: occupancy2d.render_png(  # noqa: E731
            state.grid, png, trajectory=poses[:, :2, 2])
    _write_artifacts(out_dir, poses, report, render)
    _finish(metrics_log, report)
    return poses, report


def _build_cfg(args) -> SlamConfig:
    cfg = SlamConfig()
    if getattr(args, "config", None):
        with open(args.config) as fh:
            cfg = from_json(fh.read())
    if getattr(args, "override_dict", None):
        cfg = override(cfg, args.override_dict)
    return cfg


def run_from_cli(args) -> int:
    cfg = _build_cfg(args)
    data = load_dataset(args.dataset, args.frames)
    mode = "streaming" if (args.resume or args.checkpoint_every) else "fused"
    _, report = run_slam(
        cfg,
        data,
        out_dir=args.out,
        mode=mode,
        checkpoint_every=args.checkpoint_every,
        resume=args.resume,
        save_map_path=getattr(args, "save_map", None),
        device=args.device,
    )
    print(json.dumps(report, indent=2))
    return 0
