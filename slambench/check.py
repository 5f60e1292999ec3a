"""How `correct` is decided: every sequence the window ran is judged by the
plain reference (slambench/reference) on the same scans, once the window
has closed and the program's state is freed.

The reference follows the program, one stage at a time: frame f starts
from the program's poses and keyframe and insert decisions up to f - 1
(the same prediction), against the map the reference builds itself from
the scans at those poses, and its own ICP result for f is held against
the program's. Run free, the two trajectories part by the ICP's stopping
rule alone (a step of 1 cm counts as converged, and float32 summation
order decides on which side of it a frame stops), and the parting grows
through the map, up to a lost track on the loop's turns; followed, each
frame's gap is that frame's own. Full SLAM's backend follows the same
way: the loop verification is the reference's own on the program's
keyframes and front-end poses; the closure selection (PCM, residual gate)
runs on the program's verified closures, the pose graph on its kept ones.

The numbers, each the worst over the window's sequences:
  rmse_gap_med     median over the frames of |rmse - rmse_ref| / rmse_ref,
                   the ICP's inlier RMS distance at convergence (every
                   correspondence the frame's ICP found enters it);
  rmse_gap_p90     the same, 90th percentile over the frames;
  frame_gap_med_m  median over the frames of the distance between the
                   program's pose and the reference's;
  frame_gap_p90_m  the same, 90th percentile over the frames;
  frame_gap_max_m, rmse_gap_max: the same, largest over the frames;
  decisions_differ frames whose keyframe or insert decision the reference
                   takes otherwise (each side's on its own pose);
  keyframes_differ full SLAM: frames that one side alone made keyframes;
  closures_differ  full SLAM: loop closures verified by one side only;
  closure_gap_m    full SLAM: largest distance between the translations
                   of a closure's relative pose T_ij verified by both;
  lock_gap_med_m   full SLAM: the median over the closures verified by
                   both of the distance from the program's T_ij
                   translation to the nearest of the reference's locks
                   that passed the gates (yaw hypotheses that lock onto
                   minima a rounding apart in rmse are both sound);
  verify_iters_gap full SLAM: |verify_iters - the reference's| over the
                   reference's (the batched verification's iterations);
  kept_differ      full SLAM: closures that the selection keeps on one
                   side only, both from the program's verified ones;
  pose_gap_m       full SLAM: largest distance between a final pose
                   (after the pose graph) and the reference's, both from
                   the program's kept closures;
  ate_m            the program's trajectory against the generator's
                   ground truth (RMS translation error), for the record.
slambench/limits/<cell>.json holds the numbers a cell compares and their
limits (PERF.md gives the readings each was set from); a sequence with a
non-finite pose, or a number over its limit, counts as failed.
"""

from __future__ import annotations

import math

import numpy as np


def reference(cfg: dict, mix: dict, pts, msk, rec: dict, device,
              precision: str = "float32") -> dict:
    """The plain reference's outputs on one sequence, following the
    program's poses in `rec`."""
    from slambench.reference import odometry, slam

    decisions = (rec["is_keyframe"], rec["map_inserted"])
    if mix["drive"] == "slam":
        return slam.run(cfg, pts, msk, device, precision,
                        forced=(rec["frontend_poses"], *decisions),
                        kf_frames=rec["kf_frames"],
                        backend={"verified": rec["verified"],
                                 "kept": rec["closures"],
                                 "iters": rec["iters"],
                                 "converged": rec["converged"]})
    out = odometry.run(cfg, pts, msk, device, precision,
                       forced=(rec["poses"], *decisions))
    return {"frame_poses": out["pose"], "rmse": out["rmse"],
            "is_keyframe": out["is_keyframe"],
            "map_inserted": out["map_inserted"]}


def _gaps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.linalg.norm(np.asarray(a, np.float64)[:, :3, 3]
                          - np.asarray(b, np.float64)[:, :3, 3], axis=-1)


def infos_of(ref: dict) -> dict:
    """The reference's own keyframe and insert decisions a frame."""
    return {k: np.asarray(ref[k], bool) for k in ("is_keyframe",
                                                  "map_inserted")}


def numbers(rec: dict, ref: dict, gt=None) -> dict:
    """The compared numbers of one sequence against its reference."""
    if "frontend_poses" in rec:  # full SLAM: frame 0 is the identity
        own, mine = ref["frontend_poses"][1:], rec["frontend_poses"][1:]
    else:
        own, mine = ref["frame_poses"], rec["poses"]
    gaps = _gaps(mine, own)
    rm_p = np.asarray(rec["rmse"], np.float64)
    rm_r = np.asarray(ref["rmse"], np.float64)
    rel = np.abs(rm_p - rm_r) / np.maximum(rm_r, 1e-9)
    ins = infos_of(ref)
    out = {"decisions_differ": float(
        np.sum(np.asarray(rec["is_keyframe"]) != ins["is_keyframe"])
        + np.sum(np.asarray(rec["map_inserted"]) != ins["map_inserted"])),
           "frame_gap_med_m": float(np.median(gaps)),
           "frame_gap_p90_m": float(np.quantile(gaps, 0.9)),
           "frame_gap_max_m": float(np.max(gaps)),
           "rmse_gap_med": float(np.median(rel)),
           "rmse_gap_p90": float(np.quantile(rel, 0.9)),
           "rmse_gap_max": float(np.max(rel))}
    if "closures" in rec:
        out.update(_backend(rec, ref))
    if gt is not None:
        traj = np.asarray(rec["poses"], np.float64)
        if len(traj) == len(gt) - 1:
            traj = np.concatenate([np.eye(4)[None], traj])
        rel_gt = np.einsum("ij,fjk->fik", np.linalg.inv(gt[0]), gt)
        out["ate_m"] = float(np.sqrt(np.mean(_gaps(traj, rel_gt) ** 2)))
    finite = all(np.all(np.isfinite(np.asarray(rec[k], np.float64)))
                 for k in ("poses", "rmse"))
    if not finite:
        out = {k: math.inf for k in out}
    return out


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
        "pose_gap_m": float(np.max(_gaps(rec["poses"], ref["poses"])))}


def _key(rec: dict) -> tuple:
    """What the reference's outputs depend on, of a record."""
    parts = [rec["seq"], np.asarray(rec["poses"]).tobytes()]
    if "verified" in rec:
        parts += [np.asarray(rec["frontend_poses"]).tobytes(),
                  tuple(rec["kf_frames"]), tuple(map(tuple, rec["closures"])),
                  tuple((i, j, np.asarray(T).tobytes())
                        for i, j, T in rec["verified"])]
    return tuple(parts)


def judge(cfg: dict, mix: dict, seqs: list, records: list, limits: dict,
          device, precision: str = "float32") -> dict:
    """Every record against the reference (one reference run for each
    distinct sequence and program trajectory)."""
    refs: dict = {}
    worst = {k: 0.0 for k in limits}
    failed = 0
    for rec in records:
        key = _key(rec)
        if key not in refs:
            pts, msk, _ = seqs[rec["seq"]]
            refs[key] = reference(cfg, mix, pts, msk, rec, device, precision)
        got = numbers(rec, refs[key], seqs[rec["seq"]][2])
        over = False
        for k in limits:
            worst[k] = max(worst[k], got[k])
            over |= not got[k] <= limits[k]
        failed += over
    checks = {k: {"value": worst[k], "limit": limits[k]} for k in limits}
    lines = [f"check {k}: {worst[k]!r} (limit {limits[k]!r})"
             for k in limits]
    return {"correct": failed == 0 and bool(records), "failed": failed,
            "checks": checks, "lines": lines, "refs": refs}
