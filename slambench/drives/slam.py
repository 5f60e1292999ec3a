"""The slam drive: each lidar log through `Slam3D.run(mode="fused")`, one
at a time, the next once its poses are on the host.

Full SLAM's backend is judged stage by stage, each from the program's own
inputs to it: the loop verification is the reference's own on the
program's keyframes and front-end poses; the closure selection (PCM,
residual gate) runs on the program's verified closures, the pose graph on
its kept ones. Its numbers, beside the front end's (drives/_lidar.py):
  keyframes_differ frames that one side alone made keyframes;
  closures_differ  loop closures verified by one side only;
  closure_gap_m    largest distance between the translations of a
                   closure's relative pose T_ij verified by both;
  lock_gap_med_m   the median over the closures verified by both of the
                   distance from the program's T_ij translation to the
                   nearest of the reference's locks that passed the gates
                   (yaw hypotheses that lock onto minima a rounding apart
                   in rmse are both sound);
  verify_iters_gap |verify_iters - the reference's| over the reference's
                   (the batched verification's iterations);
  kept_differ      closures that the selection keeps on one side only,
                   both from the program's verified ones;
  pose_gap_m       largest distance between a final pose (after the pose
                   graph) and the reference's, both from the program's
                   kept closures.
"""

from __future__ import annotations

import contextlib
import json

import numpy as np

from slambench.drives import _lidar

jobs, sequence = _lidar.jobs, _lidar.sequence


class Program:
    def __init__(self, cfg: dict, device, spans: bool):
        from slambench.harness import slam_config

        self.cfg = slam_config(cfg)
        self.device = device
        self.spans = spans

    def run(self, pts, msk) -> dict:
        import torch
        from slambench.harness import _span
        from tpu_icp_slam_torch.slam.slam3d import Slam3D

        slam = Slam3D(self.cfg, device=self.device)
        infos, batches = [], []
        # the front end's infos, which Slam3D.run reads and keeps to itself
        run_fused = slam.pipe.run_fused

        def keep(*a, **kw):
            out = run_fused(*a, **kw)
            infos.append(out[1])
            return out

        slam.pipe.run_fused = keep
        if self.spans:
            # and each verification's batch and batched iterations
            slam.pipe.run_fused = _span("frontend", keep)
            slam.pipe.init_state = _span("frontend", slam.pipe.init_state)
            det = slam.detector
            verify = det.verify_batch

            def count(cands, *a, **kw):
                n0 = det.verify_iters
                out = verify(cands, *a, **kw)
                batches.append((len(cands) * det.cfg.verify_yaws,
                                det.verify_iters - n0))
                return out

            det.verify_batch = _span("verify", count)
        poses, _ = slam.run(pts, msk, mode="fused")
        # the instance's wrappers close over its own methods: drop them, so
        # that the sequence's program state goes with `slam`
        for obj, attr in ((slam.pipe, "run_fused"), (slam.pipe, "init_state"),
                          (slam.detector, "verify_batch")):
            obj.__dict__.pop(attr, None)
        if not infos:
            raise RuntimeError("Slam3D.run made no call to its front end's "
                               "run_fused: the benchmark reads each frame's "
                               "info row there")
        if self.spans and slam.detector.verify_iters and not batches:
            raise RuntimeError("verification ran without a call to "
                               "LoopDetector.verify_batch: the benchmark "
                               "reads each trip's batch there")
        rec = {"poses": poses, "frontend_poses": slam.frontend_poses,
               "closures": sorted((c.i, c.j) for c in slam.closures_kept),
               "verified": [(c.i, c.j, np.asarray(c.T_ij, np.float64))
                            for c in slam.closures],
               "kf_frames": list(slam.kf_frames),
               "icp_iters": int(slam.frontend_iters.sum()),
               "verify_iters": slam.detector.verify_iters,
               "backend_s": slam.backend_s, "verify_batches": batches}
        rows = {k: torch.cat([i[k] for i in infos]).cpu().numpy()
                for k in ("rmse", "is_keyframe", "map_inserted", "iters",
                          "converged")}
        rec.update(rows, inserts=int(rows["map_inserted"].sum()))
        return rec


def reference(cfg: dict, mix: dict, inputs: tuple, rec: dict, device,
              precision: str = "float32") -> dict:
    """The plain reference's full SLAM on one sequence, following the
    program's front-end poses, decisions and keyframes, and its backend
    stage by stage."""
    from slambench.reference import slam as reference_slam

    pts, msk = inputs
    return reference_slam.run(
        cfg, pts, msk, device, precision,
        forced=(rec["frontend_poses"], rec["is_keyframe"],
                rec["map_inserted"]),
        kf_frames=rec["kf_frames"],
        backend={"verified": rec["verified"], "kept": rec["closures"],
                 "iters": rec["iters"], "converged": rec["converged"]})


def numbers(rec: dict, ref: dict, gt=None) -> dict:
    """Frame 0 is the identity: the front end's numbers from frame 1."""
    return _lidar.compare(rec, ref, gt, ref["frontend_poses"][1:],
                          rec["frontend_poses"][1:], _backend(rec, ref))


def _backend(rec: dict, ref: dict) -> dict:
    """Full SLAM's backend numbers, stage by stage (see the module's
    docstring)."""
    mine = {(i, j): np.asarray(T, np.float64) for i, j, T in rec["verified"]}
    own = {(c.i, c.j): c for c in ref["verified"]}
    both = sorted(set(mine) & set(own))
    t_gap = [float(np.linalg.norm(mine[k][:3, 3] - own[k].T_ij[:3, 3]))
             for k in both]
    # the nearest of the reference's passing locks: yaw hypotheses that
    # lock onto different minima at rmses a rounding apart are both sound
    lock_gap = [float(np.min(np.linalg.norm(
        own[k].locks[:, :3, 3] - mine[k][None, :3, 3], axis=-1)))
        for k in both]
    return {
        "keyframes_differ": float(len(set(rec["kf_frames"])
                                      ^ set(ref["own_kf_frames"]))),
        "closures_differ": float(len(set(mine) ^ set(own))),
        "closure_gap_m": max(t_gap, default=0.0),
        "lock_gap_med_m": float(np.median(lock_gap)) if lock_gap else 0.0,
        "verify_iters_gap": abs(rec["verify_iters"] - ref["verify_iters"])
        / max(ref["verify_iters"], 1),
        "kept_differ": float(len(set(map(tuple, rec["closures"]))
                                 ^ set(ref["closures"]))),
        "pose_gap_m": float(np.max(_lidar.gaps(rec["poses"], ref["poses"])))}


def key(rec: dict) -> tuple:
    """What the reference's outputs depend on, of a record."""
    return _lidar.key(rec) + (
        np.asarray(rec["frontend_poses"]).tobytes(), tuple(rec["kf_frames"]),
        tuple(map(tuple, rec["closures"])),
        tuple((i, j, np.asarray(T).tobytes()) for i, j, T in rec["verified"]))


def summary(rec: dict) -> dict:
    """Counts of a record or a reference, for slambench/calibrate.py."""
    return {"closures": len(rec["closures"]),
            "verified": len(rec["verified"]),
            "verify_iters": rec["verify_iters"]}


# ---- faults planted in the program, never in the reference ------------------

def _no_closures(cfg: dict):
    """LoopDetector.verify_batch runs and returns no closure."""
    from tpu_icp_slam_torch.backend.loop_closure import LoopDetector

    verify = LoopDetector.verify_batch

    def none(self, cands, *a, **kw):
        return [None] * len(verify(self, cands, *a, **kw))

    return cfg, _lidar.patched(LoopDetector, "verify_batch", none)


def _no_selection(cfg: dict):
    """Every verified closure goes into the pose graph: neither the
    pairwise consistency (PCM) nor the residual gate runs."""
    cfg = json.loads(json.dumps(cfg))
    cfg["backend"].update(pcm_gamma=0.0, reject_residual=0.0)
    return cfg, contextlib.nullcontext()


def _graph_unsolved(cfg: dict):
    """Slam3D's final pose-graph solve returns the graph unchanged (the
    residual gate's solves still run)."""
    import types

    import torch
    from tpu_icp_slam_torch.backend import pose_graph
    from tpu_icp_slam_torch.slam import slam3d

    def unsolved(graph, iters=10, **kw):
        return graph, torch.zeros(iters, dtype=torch.float64)

    pg = types.SimpleNamespace(**dict(vars(pose_graph), optimize=unsolved))
    return cfg, _lidar.patched(slam3d, "pg", pg)


FAULTS = {"no_inserts": _lidar.no_inserts, "no_closures": _no_closures,
          "no_selection": _no_selection, "graph_unsolved": _graph_unsolved}
