"""Full 2D SLAM: odometry + loop closure + pose-graph optimization (port of
tpu_icp_slam/slam/slam2d.py).

The front end is 2D scan-to-scan ICP (slam/pipeline.py, SE(2)) or, with
`pipeline.mode="scan_to_map"`, the 3D scan-to-map pipeline on the scans
lifted to z = 0 (planar clouds keep the pose planar; the result is projected
back to SE(2)). A host gate makes keyframes; the loop detector fingerprints
each with its 2D occupancy-count descriptor, and verifies candidates by
batched SE(2) ICP (K1's batched form on 2-D points on the card). Accepted
closures and odometry factors form a pose graph lifted to SE(3) (core.se2's
embedding), optimized in float64 on the device and projected back to SE(2);
every frame is then corrected rigidly relative to its anchor keyframe.

A run can checkpoint its whole state (front end, keyframe database,
closures, strain flags; slam/checkpoint.py, kind "odom" or "scan_to_map")
and resume from it, as Slam3D does.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time
from typing import Optional

import numpy as np
import torch

from tpu_icp_slam_torch.backend import pose_graph as pg
from tpu_icp_slam_torch.backend.loop_closure import LoopClosure, LoopDetector
from tpu_icp_slam_torch.config import SlamConfig
from tpu_icp_slam_torch.mapping import occupancy2d
from tpu_icp_slam_torch.slam.checkpoint import (
    restore_slam_session,
    save_slam_checkpoint,
)
from tpu_icp_slam_torch.slam.pipeline import OdometryPipeline, fold_scan
from tpu_icp_slam_torch.slam.scan_to_map import ScanToMapPipeline
from tpu_icp_slam_torch.slam.slam3d import SlamReport


def _to3(T2: np.ndarray) -> np.ndarray:
    T = np.eye(4)
    T[:2, :2] = T2[:2, :2]
    T[:2, 3] = T2[:2, 2]
    return T


def _to2(T3: np.ndarray) -> np.ndarray:
    # project to SE(2): yaw from the rotation's upper-left block
    yaw = np.arctan2(T3[1, 0], T3[0, 0])
    c, s = np.cos(yaw), np.sin(yaw)
    return np.array([[c, -s, T3[0, 3]], [s, c, T3[1, 3]], [0, 0, 1]])


class Slam2D:
    """2D front end + loop-closure backend on `device`. After a run,
    `frontend_iters` holds the front end's ICP iterations per frame, and
    `backend_s` the wall time of the per-keyframe backend work."""

    def __init__(self, cfg: SlamConfig, sensor_max_range: float = 12.0,
                 device: torch.device | str = "cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        self.pipe = OdometryPipeline(cfg, dim=2, device=self.device)
        self.detector = LoopDetector(cfg.backend, max_range=sensor_max_range,
                                     device=self.device)

    def run(self, pts: np.ndarray, msk: np.ndarray, mode: str = "fused",
            checkpoint_path: Optional[str] = None, checkpoint_every: int = 0,
            resume: bool = False):
        """pts (F, C, 2), msk (F, C) -> (poses (F, 3, 3) SE(2), SlamReport).

        mode="fused" runs the whole front end, then the backend over its
        poses; mode="streaming" runs the backend frame by frame and skips a
        frame whose pose is not finite. checkpoint_every > 0 or resume force
        streaming, with the same contract as Slam3D.run.
        """
        cfg = self.cfg
        p = cfg.pipeline
        if mode not in ("fused", "streaming"):
            raise ValueError(f"unknown mode: {mode}")
        if checkpoint_every or resume:
            mode = "streaming"
        lifted = p.mode == "scan_to_map"
        if lifted:
            pts3 = np.concatenate([pts, np.zeros_like(pts[..., :1])],
                                  axis=-1).astype(np.float32)
            pipe3 = ScanToMapPipeline(cfg, device=self.device)

        # resume or a fresh start of the backend and front-end state
        start = 1
        state = None
        ck = None
        poses_l: list = []
        kf_frames: list = []
        kf_poses2: list = []
        anchor_kf: list = []
        closures: list[LoopClosure] = []
        n_cands = 0
        self.closures_kept: list = []
        self.closure_scores = np.zeros(0)
        self.closure_suspect = np.zeros(0, bool)
        self.backend_s = 0.0
        if resume and checkpoint_path and os.path.exists(checkpoint_path):
            ck = restore_slam_session(checkpoint_path, cfg, self.detector)
            state = ck["fe_state"]
            start = ck["next_frame"]
            poses_l = ck["poses"]
            kf_frames = ck["kf_frames"]
            kf_poses2 = ck["kf_poses"]
            anchor_kf = ck["anchor_kf"]
            closures = ck["closures"]
            n_cands = ck["n_cands"]
        if state is None:
            if mode == "streaming":
                state = (pipe3.init_state(pts3[0], msk[0]) if lifted
                         else self.pipe.init_state(pts[0], msk[0],
                                                   with_grid=False))
            poses_l = [np.eye(3)]
            kf_frames = [0]
            kf_poses2 = [np.eye(3)]
            anchor_kf = [0]
            self.detector.add_keyframe(pts[0], msk[0], position=np.zeros(2))

        def process_frame(f, pose2):
            """Host keyframe gate and backend, frame by frame (the 2D
            pipelines carry no keyframe flag)."""
            nonlocal n_cands
            dK = np.linalg.inv(kf_poses2[-1]) @ pose2
            trans = np.linalg.norm(dK[:2, 2])
            rot = abs(np.arctan2(dK[1, 0], dK[0, 0]))
            if trans > p.keyframe_trans or rot > p.keyframe_rot:
                t0 = time.perf_counter()
                kf_idx = self.detector.add_keyframe(pts[f], msk[f],
                                                    position=pose2[:2, 2])
                kf_frames.append(f)
                kf_poses2.append(pose2)
                if cfg.backend.enabled:
                    n, lcs = self.detector.verify_keyframe_candidates(
                        kf_idx, pts[f], msk[f], pts, msk, kf_frames,
                        kf_poses2, pose2, closures)
                    n_cands += n
                    closures.extend(lcs)
                self.backend_s += time.perf_counter() - t0
            anchor_kf.append(len(kf_frames) - 1)

        # per-frame front-end strain (the ICP cap hit without converging)
        # weights the odometry factors; a resume restores it
        strain = [False] * start
        if ck is not None and ck["strain"] is not None:
            strain = list(ck["strain"])[:start]
        elif ck is not None:
            logging.getLogger(__name__).warning(
                "checkpoint has no strain record; odometry-factor weights "
                "for frames < %d resume as unstrained", start)
        iters: list = []
        if mode == "fused":
            if lifted:
                st = pipe3.init_state(pts3[0], msk[0])
                st, infos = pipe3.run_fused(st, pts3[1:], msk[1:])
                infos = {k: v.cpu().numpy() for k, v in infos.items()}
                poses = np.concatenate(
                    [np.eye(3)[None]]
                    + [[_to2(T)] for T in infos["pose"].astype(np.float64)])
            else:
                st = self.pipe.init_state(pts[0], msk[0], with_grid=False)
                st, infos = self.pipe.run_fused(st, pts[1:], msk[1:])
                infos = {k: v.cpu().numpy() for k, v in infos.items()}
                poses = np.concatenate(
                    [np.eye(3)[None], infos["pose"].astype(np.float64)])
            strain.extend(((infos["iters"] >= cfg.icp.max_iters)
                           & ~infos["converged"]).tolist())
            iters.extend(infos["iters"].tolist())
            for f in range(1, len(pts)):
                process_frame(f, poses[f])
        else:
            def save_ck(next_frame):
                save_slam_checkpoint(
                    checkpoint_path, "scan_to_map" if lifted else "odom",
                    state, next_frame, poses_l, kf_frames, kf_poses2,
                    anchor_kf, self.detector._descs,
                    self.detector._positions, closures, n_cands,
                    strain=strain, cfg=cfg)

            for f in range(start, len(pts)):
                prev_state = state
                if lifted:
                    state, info = pipe3.step(state, pts3[f], msk[f])
                    pose2 = _to2(info["pose"].cpu().numpy()
                                 .astype(np.float64))
                else:
                    state, info = self.pipe.step(state, pts[f], msk[f])
                    pose2 = info["pose"].cpu().numpy().astype(np.float64)
                iters.append(int(info["iters"]))
                if not np.isfinite(pose2).all():  # poisoned frame: skip
                    state = prev_state
                    poses_l.append(poses_l[-1])
                    anchor_kf.append(len(kf_frames) - 1)
                    strain.append(True)
                    continue
                strain.append(bool(int(info["iters"]) >= cfg.icp.max_iters
                                   and not bool(info["converged"])))
                poses_l.append(pose2)
                process_frame(f, pose2)
                if (checkpoint_every and checkpoint_path
                        and f % checkpoint_every == 0):
                    save_ck(f + 1)
            poses = np.stack(poses_l)

        self.frontend_iters = np.asarray(iters, np.int64)
        self.kf_frames = list(kf_frames)
        self.kf_poses_out = [np.asarray(q) for q in kf_poses2]
        self.closures = list(closures)
        report = SlamReport(n_frames=len(pts), n_keyframes=len(kf_frames),
                            n_loop_candidates=n_cands,
                            n_loop_closures=len(closures))
        if not (cfg.backend.enabled and closures):
            return poses, report

        # ---- SE(3)-embedded pose graph over keyframes ----
        dev = self.device
        kf3 = np.stack([_to3(T) for T in kf_poses2])
        if cfg.backend.pcm_gamma > 0 and len(closures) > 1:
            keep = pg.pairwise_consistent_closures(
                kf3, [(lc.i, lc.j, _to3(lc.T_ij)) for lc in closures],
                gamma=cfg.backend.pcm_gamma, device=dev)
            report.n_loops_rejected += int((~keep).sum())
            closures = [lc for lc, k in zip(closures, keep) if k]
            if not closures:
                return poses, report
        factors = []
        pen = cfg.backend.odom_strain_penalty
        for k in range(1, len(kf3)):
            rel = np.linalg.inv(kf3[k - 1]) @ kf3[k]
            w = 1.0
            if pen > 0:
                n_str = sum(strain[kf_frames[k - 1] + 1: kf_frames[k] + 1])
                w = 1.0 / (1.0 + pen * n_str)
            factors.append((k - 1, k, rel, w))
        for lc in closures:
            factors.append((lc.i, lc.j, _to3(lc.T_ij), 2.0))
        graph = pg.from_arrays(kf3, factors, dtype=torch.float64, device=dev)
        if cfg.backend.reject_residual > 0:
            loop_mask = np.zeros(graph.factor_capacity, bool)
            n_odo = len(kf3) - 1
            loop_mask[n_odo: n_odo + len(closures)] = True
            kept, n_rej = pg.reject_inconsistent_loops(
                graph, loop_mask, cfg.backend.reject_residual,
                iters=cfg.backend.pg_iters, damping=cfg.backend.pg_damping,
                huber_delta=cfg.backend.huber_delta)
            if n_rej:
                graph = dataclasses.replace(graph, weight=kept)
                report.n_loops_rejected += n_rej
                kept_np = kept.cpu().numpy()
                closures = [lc for k, lc in enumerate(closures)
                            if kept_np[n_odo + k] > 0]
        self.closures_kept = list(closures)
        # confidence against the odometry poses (SE(3)-lifted), as Slam3D
        scores, suspect = pg.closure_confidence(
            kf3, [(lc.i, lc.j, _to3(lc.T_ij)) for lc in closures],
            suspect_cycle=cfg.backend.suspect_cycle, device=dev)
        self.closure_scores = np.asarray(scores, np.float64)
        self.closure_suspect = np.asarray(suspect, bool)
        report.closure_table = [
            {"i": lc.i, "j": lc.j, "rmse": round(lc.rmse, 4),
             "n_inliers": lc.n_inliers,
             "cycle_score_m": (None if np.isnan(scores[k])
                               else round(float(scores[k]), 3)),
             "suspect": bool(suspect[k])}
            for k, lc in enumerate(closures)]
        report.n_suspect_closures = int(suspect.sum())
        graph_opt, chis = pg.optimize(
            graph, iters=cfg.backend.pg_iters, damping=cfg.backend.pg_damping,
            huber_delta=cfg.backend.huber_delta)
        kf_opt2 = np.stack([_to2(T) for T in
                            graph_opt.poses.cpu().numpy()[: len(kf3)]])
        self.kf_poses_out = [kf_opt2[i] for i in range(len(kf3))]
        report.chi2 = [float(c) for c in chis.cpu().numpy()]

        out = np.empty_like(poses)
        for f in range(len(poses)):
            a = anchor_kf[f]
            out[f] = kf_opt2[a] @ (np.linalg.inv(kf_poses2[a]) @ poses[f])
        return out, report

    def rebuild_grid(self, poses: np.ndarray, pts: np.ndarray,
                     msk: np.ndarray) -> occupancy2d.OccupancyGrid2D:
        """Re-raster the occupancy grid from (corrected) poses, so that the
        map artifact agrees with the optimized trajectory."""
        m = self.cfg.mapping
        grid = occupancy2d.create(m.grid_size, m.grid_resolution,
                                  device=self.device)
        poses_t = torch.as_tensor(np.asarray(poses), dtype=torch.float32,
                                  device=self.device)
        pts_t = torch.as_tensor(pts, dtype=torch.float32, device=self.device)
        msk_t = torch.as_tensor(msk, dtype=torch.bool, device=self.device)
        for f in range(len(poses_t)):
            grid = fold_scan(grid, self.cfg, poses_t[f], pts_t[f], msk_t[f])
        return grid
