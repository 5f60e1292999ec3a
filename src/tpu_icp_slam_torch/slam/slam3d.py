"""Full 3D SLAM: scan-to-map odometry + loop closure + pose-graph
optimization (port of tpu_icp_slam/slam/slam3d.py).

The scan-to-map front end (slam/scan_to_map.py) produces keyframes; each
keyframe is fingerprinted (backend/loop_closure.py), candidate loops are
verified by batched ICP, and accepted closures + odometry factors form a
pose graph optimized in float64 on the device (backend/pose_graph.py).
After optimization every frame pose is corrected rigidly relative to its
anchor keyframe. Host code only orchestrates, once per keyframe.

A run can checkpoint its whole state (front end, keyframe database,
closures, strain flags; slam/checkpoint.py) and resume from it. With
prod(cfg.dist.mesh_shape) > 1 the pose graph is solved by the distributed
Schur complement (backend/schur.py) over min(prod(mesh_shape), world size)
keyframe blocks, one a rank, as the reference takes min(n_blocks,
devices): one block in a single-process run.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import os
import time
from typing import Optional

import numpy as np
import torch

from tpu_icp_slam_torch.config import SlamConfig
from tpu_icp_slam_torch.backend import pose_graph as pg
from tpu_icp_slam_torch.backend.loop_closure import LoopClosure, LoopDetector
from tpu_icp_slam_torch.slam.checkpoint import (
    restore_slam_session,
    save_slam_checkpoint,
)
from tpu_icp_slam_torch.slam.scan_to_map import ScanToMapPipeline


@dataclasses.dataclass
class SlamReport:
    n_frames: int
    n_keyframes: int
    n_loop_candidates: int
    n_loop_closures: int
    chi2: Optional[list] = None
    n_loops_rejected: int = 0  # PCM and residual-gated rejections
    # per accepted closure: PCM cycle score and suspect flag
    closure_table: Optional[list] = None  # [{i, j, rmse, n_inliers,
    # cycle_score_m, suspect}]
    n_suspect_closures: int = 0


class Slam3D:
    """Front end + backend on `device`; `run` maps a padded log to a
    trajectory. After a run, `backend_s` is the wall time of the
    per-keyframe backend work (descriptors and loop verification),
    `frontend_poses` the front end's own poses (F, 4, 4), before the pose
    graph's correction, `frontend_iters` its ICP iterations per frame
    (F - 1,), and `pose_graph` the graph the backend optimized (None when
    no closure was kept)."""

    def __init__(self, cfg: SlamConfig, progress: bool = False,
                 device: torch.device | str = "cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        self.pipe = ScanToMapPipeline(cfg, device=self.device)
        self.detector = LoopDetector(cfg.backend, device=self.device)
        self.progress = progress  # per-chunk rate lines

    def run(self, pts: np.ndarray, msk: np.ndarray, mode: str = "fused",
            checkpoint_path: Optional[str] = None, checkpoint_every: int = 0,
            resume: bool = False, chunk_frames: int = 0):
        """pts (F, C, 3), msk (F, C) -> (poses (F, 4, 4), SlamReport).

        mode="fused" steps the whole log (or chunk_frames > 0 frames at a
        time, with the backend run between chunks and `chunk_stats`
        recording (first_frame, n_frames, wall_s) per chunk), then runs the
        backend for the keyframes found; mode="streaming" runs the backend
        as each keyframe arrives and skips a frame whose pose is not finite.
        Both produce the same factors.

        checkpoint_every > 0 or resume force streaming. checkpoint_every
        saves the whole state to checkpoint_path after every frame f with
        f % checkpoint_every == 0 (fused with chunk_frames saves after each
        chunk); resume restarts from checkpoint_path when it exists.
        """
        cfg = self.cfg
        if mode not in ("fused", "streaming"):
            raise ValueError(f"unknown mode: {mode}")
        if checkpoint_every or resume:
            mode = "streaming"
        start = 1
        closures: list[LoopClosure] = []
        n_cands = 0
        self.closures_kept: list = []
        self.pose_graph = None
        self.closure_scores = np.zeros(0)
        self.closure_suspect = np.zeros(0, bool)
        ck = None
        if resume and checkpoint_path and os.path.exists(checkpoint_path):
            ck = restore_slam_session(checkpoint_path, cfg, self.detector)
            state = ck["fe_state"]
            start = ck["next_frame"]
            poses = ck["poses"]
            kf_frames = ck["kf_frames"]
            kf_poses = ck["kf_poses"]
            anchor_kf = ck["anchor_kf"]
            closures = ck["closures"]
            n_cands = ck["n_cands"]
        else:
            state = self.pipe.init_state(pts[0], msk[0])
            poses = [np.eye(4)]
            kf_frames = [0]
            kf_poses = [np.eye(4)]
            anchor_kf = [0]  # per-frame anchoring for the post-opt correction
            self.detector.add_keyframe(pts[0], msk[0], position=np.zeros(3))
        self.backend_s = 0.0

        def on_keyframe(f, pose):
            nonlocal n_cands
            t0 = time.perf_counter()
            kf_idx = self.detector.add_keyframe(pts[f], msk[f],
                                                position=pose[:3, 3])
            kf_frames.append(f)
            kf_poses.append(pose)
            if cfg.backend.enabled:
                n, lcs = self.detector.verify_keyframe_candidates(
                    kf_idx, pts[f], msk[f], pts, msk, kf_frames, kf_poses,
                    pose, closures)
                n_cands += n
                closures.extend(lcs)
            self.backend_s += time.perf_counter() - t0

        def save_ck(next_frame):
            save_slam_checkpoint(
                checkpoint_path, "scan_to_map", state, next_frame, poses,
                kf_frames, kf_poses, anchor_kf, self.detector._descs,
                self.detector._positions, closures, n_cands,
                strain=strain, cfg=cfg)

        self.final_state = None
        self.chunk_stats: list = []  # (first_frame, n_frames, wall_s)
        # per-frame strain (hit the ICP cap without converging): feeds the
        # odometry-factor weights (BackendConfig.odom_strain_penalty), so a
        # resume restores it
        strain = [False] * start
        if ck is not None and ck["strain"] is not None:
            strain = list(ck["strain"])[:start]
        elif ck is not None:
            logging.getLogger(__name__).warning(
                "checkpoint has no strain record; odometry-factor weights "
                "for frames < %d resume as unstrained", start)
        iters: list = []
        if mode == "fused":
            chunk = chunk_frames if chunk_frames > 0 else len(pts) - start
            f0 = start
            while f0 < len(pts):
                f1 = min(f0 + chunk, len(pts))
                t0 = time.perf_counter()
                state, infos = self.pipe.run_fused(state, pts[f0:f1],
                                                   msk[f0:f1])
                infos = {k: v.cpu().numpy() for k, v in infos.items()}
                all_poses = infos["pose"].astype(np.float64)  # = readback
                kf_flags = infos["is_keyframe"]
                chunk_strain = ((infos["iters"] >= cfg.icp.max_iters)
                                & ~infos["converged"])
                if cfg.backend.strain_on_clamp:
                    chunk_strain |= infos["clamped"]
                strain.extend(chunk_strain.tolist())
                iters.extend(infos["iters"].tolist())
                self.chunk_stats.append(
                    (f0, f1 - f0, time.perf_counter() - t0))
                if self.progress:
                    dt = self.chunk_stats[-1][2]
                    print(f"[slam3d] chunk {f0}..{f1 - 1}: "
                          f"{(f1 - f0) / dt:.1f} fps, "
                          f"{int(np.sum(kf_flags))} keyframes", flush=True)
                for f in range(f0, f1):
                    pose = all_poses[f - f0]
                    poses.append(pose)
                    if bool(kf_flags[f - f0]):
                        on_keyframe(f, pose)
                    anchor_kf.append(len(kf_frames) - 1)
                if chunk_frames and checkpoint_path:
                    save_ck(f1)
                f0 = f1
        else:
            for f in range(start, len(pts)):
                # a poisoned frame keeps the previous front-end state
                prev_state = state
                state, info = self.pipe.step(state, pts[f], msk[f])
                iters.append(int(info["iters"]))
                pose = info["pose"].cpu().numpy().astype(np.float64)
                if not np.isfinite(pose).all():
                    state = prev_state
                    poses.append(poses[-1])
                    anchor_kf.append(len(kf_frames) - 1)
                    strain.append(True)  # poisoned frame = maximal strain
                    continue
                strain.append(bool(
                    int(info["iters"]) >= cfg.icp.max_iters
                    and not bool(info["converged"])
                ) or (cfg.backend.strain_on_clamp and bool(info["clamped"])))
                poses.append(pose)
                if bool(info["is_keyframe"]):
                    on_keyframe(f, pose)
                anchor_kf.append(len(kf_frames) - 1)
                if (checkpoint_every and checkpoint_path
                        and f % checkpoint_every == 0):
                    save_ck(f + 1)

        poses = np.stack(poses)
        self.frontend_poses = poses
        self.frontend_iters = np.asarray(iters, np.int64)
        self.final_state = state
        self.kf_frames = list(kf_frames)
        self.kf_poses_out = [np.asarray(p) for p in kf_poses]
        self.closures = list(closures)
        report = SlamReport(n_frames=len(pts), n_keyframes=len(kf_frames),
                            n_loop_candidates=n_cands,
                            n_loop_closures=len(closures))
        if not (cfg.backend.enabled and closures):
            return poses, report

        # ---- pose graph over keyframes: odometry chain + loop factors ----
        kf_poses = np.stack(kf_poses)
        dev = self.device
        if cfg.backend.pcm_gamma > 0 and len(closures) > 1:
            keep = pg.pairwise_consistent_closures(
                kf_poses, [(lc.i, lc.j, lc.T_ij) for lc in closures],
                gamma=cfg.backend.pcm_gamma, device=dev)
            report.n_loops_rejected += int((~keep).sum())
            closures = [lc for lc, k in zip(closures, keep) if k]
            if not closures:
                return poses, report
        factors = []
        pen = cfg.backend.odom_strain_penalty
        for k in range(1, len(kf_poses)):
            rel = np.linalg.inv(kf_poses[k - 1]) @ kf_poses[k]
            w = 1.0
            if pen > 0:
                n_str = sum(strain[kf_frames[k - 1] + 1: kf_frames[k] + 1])
                w = 1.0 / (1.0 + pen * n_str)
            factors.append((k - 1, k, rel, w))
        for lc in closures:
            factors.append((lc.i, lc.j, lc.T_ij, 2.0))
        graph = pg.from_arrays(
            kf_poses, factors,
            max_keyframes=min(max(len(kf_poses), 2),
                              cfg.backend.max_keyframes),
            max_factors=min(max(len(factors), 2), cfg.backend.max_factors),
            dtype=torch.float64, device=dev)
        if cfg.backend.reject_residual > 0:
            n_odo = len(kf_poses) - 1
            loop_mask = np.zeros(graph.factor_capacity, bool)
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
        # confidence against the ODOMETRY poses: an optimizer smears alias
        # error and would hide it
        scores, suspect = pg.closure_confidence(
            kf_poses, [(lc.i, lc.j, lc.T_ij) for lc in closures],
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
        self.pose_graph = graph
        n_blocks = math.prod(cfg.dist.mesh_shape)
        if n_blocks > 1:
            # config-5 path: keyframe blocks partitioned over the ranks,
            # Schur-reduced separator system (backend/schur.py)
            from tpu_icp_slam_torch.backend import schur
            from tpu_icp_slam_torch.dist.mesh import local_mesh, make_mesh, world

            mesh = make_mesh(min(n_blocks, world()[1]), axes=("graph",),
                             device=dev)
            if mesh.coords is None:  # a rank beyond the blocks solves alone
                mesh = local_mesh(("graph",), dev)
            graph_opt, chis = schur.optimize_distributed(
                graph, mesh, iters=cfg.backend.pg_iters,
                damping=cfg.backend.pg_damping,
                huber_delta=cfg.backend.huber_delta)
        else:
            graph_opt, chis = pg.optimize(
                graph, iters=cfg.backend.pg_iters,
                damping=cfg.backend.pg_damping,
                huber_delta=cfg.backend.huber_delta)
        kf_opt = graph_opt.poses.cpu().numpy()[: len(kf_poses)]
        self.kf_poses_out = [kf_opt[i] for i in range(len(kf_poses))]
        report.chi2 = [float(c) for c in chis.cpu().numpy()]

        # ---- rigid per-frame correction relative to the anchor keyframe ----
        out = np.empty_like(poses)
        for f in range(len(poses)):
            a = anchor_kf[f]
            out[f] = kf_opt[a] @ (np.linalg.inv(kf_poses[a]) @ poses[f])
        return out, report
