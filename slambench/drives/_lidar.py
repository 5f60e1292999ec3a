"""What the lidar drives (replay, online, slam) share: Velodyne-like logs
from slambench/gen.py, fed to the program as (points (F, C, 3) float32,
mask (F, C) bool), and the front end's numbers.

The reference follows the program, one stage at a time: frame f starts
from the program's poses and keyframe and insert decisions up to f - 1
(the same prediction), against the map the reference builds itself from
the scans at those poses, and its own ICP result for f is held against
the program's. Run free, the two trajectories part by the ICP's stopping
rule alone (a step of 1 cm counts as converged, and float32 summation
order decides on which side of it a frame stops), and the parting grows
through the map, up to a lost track on the loop's turns; followed, each
frame's gap is that frame's own. Full SLAM's backend follows the same
way (drives/slam.py).

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
  ate_m            the program's trajectory against the generator's
                   ground truth (RMS translation error), for the record.
"""

from __future__ import annotations

import contextlib
import json
import math

import numpy as np

from slambench import gen


# ---- the inputs -------------------------------------------------------------

def jobs(cfg: dict, mix: dict, seed: int) -> list:
    p = cfg["pipeline"]
    return gen.jobs(mix, p["downsample_voxel"], p["scan_capacity"], seed)


def sequence(*job):
    pts, msk, gt = gen.sequence(*job)
    return (pts, msk), gt


# ---- the program ------------------------------------------------------------

class FrontEnd:
    """The scan-to-map front end (`ScanToMapPipeline`), with the
    `slambench.frontend` span around its entries when `spans`."""

    def __init__(self, cfg: dict, device, spans: bool):
        from slambench.harness import _span, slam_config
        from tpu_icp_slam_torch.slam.scan_to_map import ScanToMapPipeline

        self.cfg = slam_config(cfg)
        self.device = device
        self.spans = spans
        self.pipe = ScanToMapPipeline(self.cfg, device=device)
        if spans:
            for attr in ("init_state", "run_fused", "step"):
                setattr(self.pipe, attr,
                        _span("frontend", getattr(self.pipe, attr)))


# ---- the judgement ----------------------------------------------------------

def reference(cfg: dict, mix: dict, inputs: tuple, rec: dict, device,
              precision: str = "float32") -> dict:
    """The plain reference's front end on one sequence, following the
    program's poses and decisions in `rec`."""
    from slambench.reference import odometry

    pts, msk = inputs
    out = odometry.run(cfg, pts, msk, device, precision,
                       forced=(rec["poses"], rec["is_keyframe"],
                               rec["map_inserted"]))
    return {"frame_poses": out["pose"], "rmse": out["rmse"],
            "is_keyframe": out["is_keyframe"],
            "map_inserted": out["map_inserted"]}


def gaps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.linalg.norm(np.asarray(a, np.float64)[:, :3, 3]
                          - np.asarray(b, np.float64)[:, :3, 3], axis=-1)


def infos_of(ref: dict) -> dict:
    """The reference's own keyframe and insert decisions a frame."""
    return {k: np.asarray(ref[k], bool) for k in ("is_keyframe",
                                                  "map_inserted")}


def numbers(rec: dict, ref: dict, gt=None) -> dict:
    """The front end's compared numbers of one sequence."""
    return compare(rec, ref, gt, ref["frame_poses"], rec["poses"])


def compare(rec: dict, ref: dict, gt, own, mine,
            more: dict | None = None) -> dict:
    """The compared numbers of one sequence: the front end's poses `mine`
    against the reference's `own`, its rmse and decisions, `more` (a
    drive's further numbers), and the ATE."""
    frame_gaps = gaps(mine, own)
    rm_p = np.asarray(rec["rmse"], np.float64)
    rm_r = np.asarray(ref["rmse"], np.float64)
    rel = np.abs(rm_p - rm_r) / np.maximum(rm_r, 1e-9)
    ins = infos_of(ref)
    out = {"decisions_differ": float(
        np.sum(np.asarray(rec["is_keyframe"]) != ins["is_keyframe"])
        + np.sum(np.asarray(rec["map_inserted"]) != ins["map_inserted"])),
           "frame_gap_med_m": float(np.median(frame_gaps)),
           "frame_gap_p90_m": float(np.quantile(frame_gaps, 0.9)),
           "frame_gap_max_m": float(np.max(frame_gaps)),
           "rmse_gap_med": float(np.median(rel)),
           "rmse_gap_p90": float(np.quantile(rel, 0.9)),
           "rmse_gap_max": float(np.max(rel))}
    out.update(more or {})
    if gt is not None:
        traj = np.asarray(rec["poses"], np.float64)
        if len(traj) == len(gt) - 1:
            traj = np.concatenate([np.eye(4)[None], traj])
        rel_gt = np.einsum("ij,fjk->fik", np.linalg.inv(gt[0]), gt)
        out["ate_m"] = float(np.sqrt(np.mean(gaps(traj, rel_gt) ** 2)))
    finite = all(np.all(np.isfinite(np.asarray(rec[k], np.float64)))
                 for k in ("poses", "rmse"))
    if not finite:
        out = {k: math.inf for k in out}
    return out


def key(rec: dict) -> tuple:
    """What the front end's reference depends on, of a record."""
    return (rec["seq"], np.asarray(rec["poses"]).tobytes())


# ---- faults planted in the program ------------------------------------------

def no_inserts(cfg: dict):
    """The program's keyframe and insert gates never open: its map stays
    the first scan, and its info rows say so."""
    cfg = json.loads(json.dumps(cfg))
    cfg["pipeline"].update(keyframe_trans=1e9, keyframe_rot=1e9,
                           frontier_insert=False)
    return cfg, contextlib.nullcontext()


@contextlib.contextmanager
def patched(obj, attr, value):
    old = getattr(obj, attr)
    setattr(obj, attr, value)
    try:
        yield
    finally:
        setattr(obj, attr, old)
