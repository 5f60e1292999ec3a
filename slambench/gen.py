"""The benchmark's traffic generator: Velodyne-like 3D logs made on the host
from a seed, downsampled and padded as the port's input wants them.

Frozen copies, so that a change to the program cannot change the inputs:
`velodyne_log` with the helpers it calls (`_default_world_segments`,
`_raycast_segments`, `_street_clutter_segments`, `_round_and_resample`)
from `tpu_icp_slam_torch/datasets/synthetic.py`; `voxel_downsample_np`
from `tpu_icp_slam_torch/core/pointcloud.py` (the same points, by a packed
key); `pad_scans` from
`tpu_icp_slam_torch/slam/runner.py`; the loop route `LOOP_WAYPOINTS` from
`chip_smoke.py` (scripts/exp_loop.py's compact loop). The same seed gives
the same scans as the port's copies.

`sequences(traffic, voxel, capacity, seed)` reads a traffic mix's generator
parameters (slambench/traffic/<mix>.json) and makes its distinct
sequences.
"""

from __future__ import annotations

import numpy as np

PAD_COORD = 1.0e6  # the port's padding sentinel (core/pointcloud.py)

# The compact loop route of scripts/exp_loop.py: ~100 m, back to the start.
LOOP_WAYPOINTS = [(-36, -4), (-12, -4), (-4, -4), (-2, 2), (-4, 13),
                  (-20, 13), (-34, 12), (-38, 4), (-35, -3.6), (-28, -4)]
ROUTES = {"loop": LOOP_WAYPOINTS, "straight": None}


def _default_world_segments() -> np.ndarray:
    """Wall segments (x0, y0, x1, y1) of an office-like 2D world."""
    walls = [
        # outer rectangle 24 x 14
        (-12, -7, 12, -7), (12, -7, 12, 7), (12, 7, -12, 7), (-12, 7, -12, -7),
        # corridor walls
        (-12, -1.5, -4, -1.5), (-2, -1.5, 6, -1.5), (8, -1.5, 12, -1.5),
        (-12, 1.5, -6, 1.5), (-4, 1.5, 4, 1.5), (6, 1.5, 12, 1.5),
        # room dividers below corridor
        (-6, -7, -6, -3), (0, -7, 0, -3.5), (6, -7, 6, -3),
        # room dividers above corridor
        (-7, 7, -7, 3), (-1, 7, -1, 3.5), (5, 7, 5, 3),
        # furniture / clutter boxes
        (-10, -5, -8, -5), (-8, -5, -8, -4), (-8, -4, -10, -4), (-10, -4, -10, -5),
        (2, 4, 3, 4), (3, 4, 3, 5), (3, 5, 2, 5), (2, 5, 2, 4),
        (9, -5, 10.5, -5), (10.5, -5, 10.5, -3.5), (10.5, -3.5, 9, -3.5), (9, -3.5, 9, -5),
    ]
    # door-frame columns jutting into the corridor: they constrain motion along
    # the corridor axis, which two parallel walls alone leave unobservable
    for cx in (-8.0, -5.0, -1.0, 3.0, 7.0, 10.0):
        for cy in (-1.5, 1.5):
            s = 0.25 if cy < 0 else -0.25
            walls += [
                (cx - 0.15, cy, cx - 0.15, cy + s),
                (cx - 0.15, cy + s, cx + 0.15, cy + s),
                (cx + 0.15, cy + s, cx + 0.15, cy),
            ]
    return np.asarray(walls, dtype=np.float64)


def _raycast_segments(origin, angles_world, segs, max_range):
    """Vectorized ray/segment intersection: (B,) ranges."""
    dx = np.cos(angles_world)  # (B,)
    dy = np.sin(angles_world)
    x0, y0 = origin
    p0 = segs[:, :2]  # (S, 2)
    sd = segs[:, 2:] - segs[:, :2]  # (S, 2)
    # solve origin + t*dir = p0 + u*sd ; 0<=u<=1, t>0
    bx = p0[:, 0] - x0  # (S,)
    by = p0[:, 1] - y0
    det = dx[:, None] * (-sd[None, :, 1]) - (-sd[None, :, 0]) * dy[:, None]  # (B, S)
    det_safe = np.where(np.abs(det) < 1e-12, 1.0, det)
    t = (bx[None, :] * (-sd[None, :, 1]) - (-sd[None, :, 0]) * by[None, :]) / det_safe
    u = (dx[:, None] * by[None, :] - dy[:, None] * bx[None, :]) / det_safe
    valid = (np.abs(det) >= 1e-12) & (u >= 0.0) & (u <= 1.0) & (t > 1e-9)
    t = np.where(valid, t, np.inf)
    r = t.min(axis=1)
    return np.minimum(r, max_range)


def _street_clutter_segments(rng: np.random.Generator, n_boxes: int) -> np.ndarray:
    """Box obstacles (parked-car/bin-sized) flanking the corridor: their
    faces constrain translation along the travel axis."""
    segs = []
    for _ in range(n_boxes):
        cx = rng.uniform(-44, 44)
        side = rng.choice([-1.0, 1.0])
        cy = side * rng.uniform(2.5, 5.0)
        w = rng.uniform(1.2, 3.5)  # along x
        h = rng.uniform(0.8, 1.8)  # along y
        x0, x1 = cx - w / 2, cx + w / 2
        y0, y1 = cy - h / 2, cy + h / 2
        segs += [(x0, y0, x1, y0), (x1, y0, x1, y1), (x1, y1, x0, y1), (x0, y1, x0, y0)]
    return np.asarray(segs, dtype=np.float64)


def _round_and_resample(
    xy: np.ndarray, n_frames: int, step: float = 0.25, turn_radius: float = 3.0
) -> np.ndarray:
    """Densify a path by arc length, round corners over a fixed distance
    window, resample to n_frames at constant speed."""
    seg = np.linalg.norm(np.diff(xy, axis=0), axis=1)
    cum = np.concatenate([[0], np.cumsum(seg)])
    if cum[-1] <= 0:
        return np.repeat(xy[:1], n_frames, axis=0)
    n_dense = max(int(cum[-1] / step), 2)
    sd = np.linspace(0, cum[-1], n_dense)
    dense = np.stack([np.interp(sd, cum, xy[:, i]) for i in range(2)], axis=1)
    win = max(3, int(turn_radius / step)) | 1
    kern = np.ones(win) / win
    pad = win // 2
    dense = np.stack(
        [
            np.convolve(np.pad(dense[:, i], pad, mode="edge"), kern, mode="valid")
            for i in range(2)
        ],
        axis=1,
    )
    seg2 = np.linalg.norm(np.diff(dense, axis=0), axis=1)
    cum2 = np.concatenate([[0], np.cumsum(seg2)])
    s2 = np.linspace(0, cum2[-1], n_frames)
    return np.stack([np.interp(s2, cum2, dense[:, i]) for i in range(2)], axis=1)


def velodyne_log(
    n_frames: int = 20,
    seed: int = 0,
    n_rings: int = 16,
    n_azimuth: int = 512,
    max_range: float = 60.0,
    n_boxes: int = 48,
    path_fraction: float = 1.0,
    waypoints=None,
    route_clearance: float = 1.0,
    world_seed=None,
):
    """A vehicle driving through a 3D world of walls, ground and clutter:
    (scans: list of (N_i, 3) float64 in the sensor frame, gt poses (F, 4,
    4)). The seed places the clutter boxes and draws the range noise, as
    the port's copy does; with `world_seed`, that seed places the boxes and
    `seed` draws the noise alone. The route is `waypoints` or the built-in
    straight street, cut to `path_fraction` of its length."""
    rng = np.random.default_rng(seed)
    world = rng if world_seed is None else np.random.default_rng(world_seed)
    segs2d = _default_world_segments() * 4.0  # scale up to street scale
    boxes2d = _street_clutter_segments(world, n_boxes) if n_boxes else None
    wall_h = 6.0
    box_h = 1.6
    if waypoints is not None:
        waypoints = np.asarray(waypoints, np.float64)
    else:
        waypoints = np.array([(-40, 0), (-16, 0), (8, 0), (40, 0)])
    seg_lens = np.linalg.norm(np.diff(waypoints, axis=0), axis=1)
    cum = np.concatenate([[0], np.cumsum(seg_lens)])
    s = np.linspace(0, cum[-1] * path_fraction, n_frames)
    xy = np.stack([np.interp(s, cum, waypoints[:, i]) for i in range(2)], axis=1)
    xy = _round_and_resample(xy, n_frames)
    heading = np.arctan2(*np.flip(np.gradient(xy, axis=0), axis=1).T)

    if boxes2d is not None and route_clearance > 0.0 and len(boxes2d):
        # a vehicle does not drive through parked cars: drop boxes within
        # route_clearance of the route, densified to ~0.5 m samples
        seg = np.linalg.norm(np.diff(xy, axis=0), axis=1)
        cum = np.concatenate([[0], np.cumsum(seg)])
        sd = np.linspace(0, cum[-1], max(int(cum[-1] / 0.5), 2))
        route = np.stack(
            [np.interp(sd, cum, xy[:, i]) for i in range(2)], axis=1)
        keep = []
        rects = boxes2d.reshape(-1, 4, 4)  # (n_boxes, 4 segs, 4)
        for r in rects:
            xs = np.concatenate([r[:, 0], r[:, 2]])
            ys = np.concatenate([r[:, 1], r[:, 3]])
            x0, x1, y0, y1 = xs.min(), xs.max(), ys.min(), ys.max()
            dx = np.maximum(np.maximum(x0 - route[:, 0], route[:, 0] - x1), 0)
            dy = np.maximum(np.maximum(y0 - route[:, 1], route[:, 1] - y1), 0)
            keep.append(np.min(np.hypot(dx, dy)) >= route_clearance)
        boxes2d = rects[np.asarray(keep)].reshape(-1, 4)
        if not len(boxes2d):
            boxes2d = None

    elev = np.linspace(-0.30, 0.08, n_rings)  # radians
    azim = np.linspace(-np.pi, np.pi, n_azimuth, endpoint=False)
    sensor_h = 1.8

    scans, poses = [], []
    for f in range(n_frames):
        th = heading[f]
        c, sn = np.cos(th), np.sin(th)
        T = np.eye(4)
        T[:2, :2] = [[c, -sn], [sn, c]]
        T[0, 3], T[1, 3], T[2, 3] = xy[f, 0], xy[f, 1], sensor_h
        poses.append(T)
        # horizontal range from 2D world per azimuth, per surface class
        surfaces = [(_raycast_segments(xy[f], azim + th, segs2d, max_range), wall_h)]
        if boxes2d is not None:
            surfaces.append(
                (_raycast_segments(xy[f], azim + th, boxes2d, max_range), box_h)
            )
        pts = []
        for e in elev:
            ce, se = np.cos(e), np.sin(e)
            # nearest vertical surface whose height the beam actually meets
            r2d_hit = np.full(n_azimuth, np.inf)
            for r2d, h in surfaces:
                z = sensor_h + r2d * np.tan(e)
                ok = (z > 0.05) & (z < h) & (r2d < max_range * 0.999)
                r2d_hit = np.where(ok & (r2d < r2d_hit), r2d, r2d_hit)
            r3d = r2d_hit / max(ce, 1e-6)
            # ground hit for downward beams that reach the floor first
            with np.errstate(divide="ignore"):
                r_ground = np.where(se < -1e-6, sensor_h / -se, np.inf)
            ground_first = r_ground * ce < r2d_hit
            r_sel = np.where(
                ground_first, r_ground, np.where(np.isfinite(r3d), r3d, np.inf)
            )
            ok = np.isfinite(r_sel) & (r_sel < max_range)
            a = azim[ok]
            rr = r_sel[ok] + 0.01 * rng.standard_normal(ok.sum())
            x = rr * np.cos(e) * np.cos(a)
            y = rr * np.cos(e) * np.sin(a)
            zz = sensor_h + rr * np.sin(e)
            # sensor frame: origin at sensor, z down-shifted
            pts.append(np.stack([x, y, zz - sensor_h], axis=1))
        scans.append(np.concatenate(pts, axis=0))
    return scans, np.stack(poses)


def voxel_downsample_np(points: np.ndarray, voxel: float) -> np.ndarray:
    """Host-side voxel-grid downsample: first point per voxel, in scan
    order. The port's `np.unique(keys, axis=0)` on one packed key (21 bits
    an axis), which picks the same points an order of magnitude faster."""
    q = np.floor(points / voxel).astype(np.int64) + (1 << 20)
    if q.size and (q.min() < 0 or q.max() >= 1 << 21):
        raise ValueError("voxel_downsample_np: a coordinate beyond 2^20 "
                         "voxels")
    key = (q[:, 0] << 42) | (q[:, 1] << 21) | q[:, 2]
    _, idx = np.unique(key, return_index=True)
    return points[np.sort(idx)]


def pad_scans(scans: list, capacity: int):
    """list of (N_i, D) -> (F, C, D) float32 points + (F, C) masks.
    Oversized scans are subsampled uniformly, never truncated."""
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


def sequence_seeds(seed: int, n: int) -> list[int]:
    """n scene seeds drawn from the run's seed (any whole number)."""
    ss = np.random.SeedSequence(abs(int(seed)))
    return [int(s) for s in ss.generate_state(n, dtype=np.uint32)]


def _sequence(traffic: dict, world: int, seed: int, voxel: float,
              capacity: int):
    scans, gt = velodyne_log(
        n_frames=traffic["frames"], seed=seed, n_rings=traffic["rings"],
        n_azimuth=traffic["azimuth"], path_fraction=traffic["path_fraction"],
        waypoints=ROUTES[traffic["route"]], world_seed=world)
    if voxel > 0:
        scans = [voxel_downsample_np(x, voxel) for x in scans]
    pts, msk = pad_scans(scans, capacity)
    return pts, msk, gt


def _jobs(traffic: dict, voxel: float, capacity: int, seed: int) -> list:
    worlds = traffic["worlds"]
    return [(traffic, world, s, voxel, capacity)
            for world, s in zip(worlds, sequence_seeds(seed, len(worlds)))]


def sequences(traffic: dict, voxel: float, capacity: int, seed: int):
    """The traffic mix's distinct sequences for this seed: a list of
    (points (F, C, 3) float32, mask (F, C) bool, gt poses (F, 4, 4)), one
    for each of the mix's fixed worlds (`worlds`: the seeds that place the
    clutter), the range noise drawn from the run's seed, so that every
    seed gets the same streets and the same work."""
    return [_sequence(*job) for job in _jobs(traffic, voxel, capacity, seed)]


class Prefetch:
    """`sequences(...)`, made in worker processes, one a world (four at
    most), while the caller goes on: a run starts it before it imports
    torch and the program (the workers are forked then, and load neither).
    `result()` waits for the sequences and ends the workers; `close()`
    ends them, done or not."""

    def __init__(self, traffic: dict, voxel: float, capacity: int,
                 seed: int):
        import multiprocessing

        jobs = _jobs(traffic, voxel, capacity, seed)
        ctx = multiprocessing.get_context("fork")
        self._pool = ctx.Pool(min(len(jobs), 4))
        self._async = self._pool.starmap_async(_sequence, jobs, chunksize=1)

    def result(self) -> list:
        try:
            return self._async.get()
        finally:
            self.close()

    def close(self) -> None:
        if self._pool is not None:
            self._pool.terminate()
            self._pool.join()
            self._pool = None
