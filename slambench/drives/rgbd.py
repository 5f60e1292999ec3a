"""The RGB-D drive: depth logs of a handheld Kinect v1 (drives/_depth.py),
each replayed from a fresh `RGBDOdometry.init_state` through
`RGBDOdometry.run_fused`, the next once its infos are on the host. The
program takes each (F, H, W) float32 depth stack as it comes from the
host: its upload to the card is part of a replay's cost.

The reference (slambench/reference/rgbd.py) follows the program one stage
at a time: frame f starts from the program's pose and inter-frame motion
at f - 1 (the same constant-velocity prediction), against the maps the
reference builds itself from depth f - 1, and its own ICP result for f is
held against the program's.

The numbers, each the worst over the window's sequences:
  rmse_gap_med     median over the frames of |rmse - rmse_ref| / rmse_ref,
                   the ICP's inlier RMS distance at convergence;
  rmse_gap_p90     the same, 90th percentile over the frames;
  frame_gap_med_m  median over the frames of the distance between the
                   program's pose and the reference's;
  frame_gap_p90_m  the same, 90th percentile over the frames;
  frame_gap_max_m, rmse_gap_max: the same, largest over the frames;
  ate_m            the program's trajectory against the generator's
                   ground truth (RMS translation error), for the record.
The cell's limits hold the medians alone (PERF.md §4 gives the readings).
"""

from __future__ import annotations

import contextlib
import math

import numpy as np

from slambench import gen
from slambench.drives import _depth
from slambench.drives._lidar import gaps


# ---- the inputs -------------------------------------------------------------

def jobs(cfg: dict, mix: dict, seed: int) -> list:
    worlds = mix["worlds"]
    return [(cfg["camera"], world, mix["sequence_frames"], s)
            for world, s in zip(worlds, gen.sequence_seeds(seed,
                                                           len(worlds)))]


def sequence(camera: dict, world: int, frames: int, seed: int):
    depths, gt = _depth.log(camera, world, frames, seed)
    return (depths,), gt


# ---- the program ------------------------------------------------------------

class Program:
    """`RGBDOdometry` on the configuration's camera, with the
    `slambench.rgbd` span around its entries when `spans`."""

    def __init__(self, cfg: dict, device, spans: bool):
        from slambench.harness import _span, slam_config
        from tpu_icp_slam_torch.icp.projective import CameraIntrinsics
        from tpu_icp_slam_torch.slam.rgbd import RGBDOdometry

        c = cfg["camera"]
        K = CameraIntrinsics(c["fx"], c["fy"], c["cx"], c["cy"], c["width"],
                             c["height"])
        self.odo = RGBDOdometry(slam_config(cfg), K, device=device)
        if spans:
            for attr in ("init_state", "run_fused"):
                setattr(self.odo, attr, _span("rgbd", getattr(self.odo,
                                                              attr)))

    def run(self, depths) -> dict:
        state = self.odo.init_state(depths[0])
        _, infos = self.odo.run_fused(state, depths[1:])
        out = {k: v.cpu().numpy() for k, v in infos.items()}
        return {"poses": out["pose"], "rmse": out["rmse"],
                "n_inliers": out["n_inliers"],
                "icp_iters": int(out["iters"].sum())}


# ---- the judgement ----------------------------------------------------------

def reference(cfg: dict, mix: dict, inputs: tuple, rec: dict, device,
              precision: str = "float32") -> dict:
    """The plain reference on one sequence, following the program's poses
    in `rec`."""
    from slambench.reference import rgbd

    (depths,) = inputs
    return rgbd.run(cfg, depths, device, precision, forced=rec["poses"])


def numbers(rec: dict, ref: dict, gt=None) -> dict:
    """The compared numbers of one sequence."""
    frame_gaps = gaps(rec["poses"], ref["pose"])
    rm_r = np.asarray(ref["rmse"], np.float64)
    rel = np.abs(np.asarray(rec["rmse"], np.float64) - rm_r) / np.maximum(
        rm_r, 1e-9)
    out = {"frame_gap_med_m": float(np.median(frame_gaps)),
           "frame_gap_p90_m": float(np.quantile(frame_gaps, 0.9)),
           "frame_gap_max_m": float(np.max(frame_gaps)),
           "rmse_gap_med": float(np.median(rel)),
           "rmse_gap_p90": float(np.quantile(rel, 0.9)),
           "rmse_gap_max": float(np.max(rel))}
    if gt is not None:
        traj = np.concatenate([np.eye(4)[None],
                               np.asarray(rec["poses"], np.float64)])
        rel_gt = np.einsum("ij,fjk->fik", np.linalg.inv(gt[0]), gt)
        out["ate_m"] = float(np.sqrt(np.mean(gaps(traj, rel_gt) ** 2)))
    finite = all(np.all(np.isfinite(np.asarray(rec[k], np.float64)))
                 for k in ("poses", "rmse"))
    return out if finite else {k: math.inf for k in out}


def key(rec: dict) -> tuple:
    """What the reference depends on, of a record."""
    return (rec["seq"], np.asarray(rec["poses"]).tobytes())


def summary(r: dict) -> dict:
    """ICP iterations and the fewest inliers of a frame, of a record or a
    reference."""
    iters = r["icp_iters"] if "icp_iters" in r else int(np.sum(r["iters"]))
    return {"icp_iters": iters, "inliers_min": int(np.min(r["n_inliers"]))}


# ---- faults planted in the program ------------------------------------------

@contextlib.contextmanager
def _stage(name: str, wrap):
    """slam/rgbd.py's stage `name` replaced by wrap(stage) while in force;
    the frame graphs captured before and during it dropped at each end."""
    from tpu_icp_slam_torch.slam import frame_graphs, rgbd

    old = getattr(rgbd, name)
    setattr(rgbd, name, wrap(old))
    frame_graphs.clear()
    try:
        yield
    finally:
        setattr(rgbd, name, old)
        frame_graphs.clear()


def _column_right(corr):
    def shifted(state, cfg, K):
        return corr(state, cfg, K._replace(cx=K.cx + 1.0))

    return shifted


def _maps_kept(advance):
    def stale(state, maps, res):
        return advance(state, (state.prev_vertex, state.prev_normal,
                               state.prev_valid), res)

    return stale


def pixel_off_by_one(cfg: dict):
    """The projective lookup reads the pixel one column right of the
    projection (an off-by-one in the lookup's principal point)."""
    return cfg, _stage("_corr", _column_right)


def stale_target(cfg: dict):
    """The frame's post-stage keeps the previous target maps: every frame
    is aligned to the first frame's maps."""
    return cfg, _stage("_advance", _maps_kept)


FAULTS = {"pixel_off_by_one": pixel_off_by_one,
          "stale_target": stale_target}
