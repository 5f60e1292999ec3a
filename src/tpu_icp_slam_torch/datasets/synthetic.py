"""Synthetic scans (NumPy, host-side, deterministic).

The port's own copy of `two_scan_pair` (config 1's pair, what `cli align`
aligns), `lidar2d_log` and `scan_to_points` (the simulated 2D lidar world of
config 2), `velodyne_log` (Velodyne-like 3D logs) and `Intrinsics`,
`depth_scene` and `rgbd_log` (the synthetic depth camera of config 3) from
tpu_icp_slam/datasets/synthetic.py and the helpers they call, line for
line: the same seed gives the same clouds, scans, depth images and ground
truth in both packages.
"""

from __future__ import annotations

import dataclasses

import numpy as np


def rigid_transform(d: int, rng: np.random.Generator, rot_scale=0.3, trans_scale=0.5):
    """Random SE(d) homogeneous matrix, fp64."""
    if d == 2:
        theta = rng.uniform(-rot_scale, rot_scale)
        c, s = np.cos(theta), np.sin(theta)
        R = np.array([[c, -s], [s, c]])
    else:
        w = rng.uniform(-rot_scale, rot_scale, size=3)
        theta = np.linalg.norm(w)
        W = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
        if theta < 1e-12:
            R = np.eye(3)
        else:
            R = (
                np.eye(3)
                + np.sin(theta) / theta * W
                + (1 - np.cos(theta)) / theta**2 * (W @ W)
            )
    t = rng.uniform(-trans_scale, trans_scale, size=d)
    T = np.eye(d + 1)
    T[:d, :d] = R
    T[:d, d] = t
    return T


def surface_cloud(n: int, rng: np.random.Generator, extent: float = 10.0) -> np.ndarray:
    """3D cloud sampled from a structured scene (ground + 2 walls + blobs).

    Structured (non-degenerate in all 6 DoF) so ICP has a unique optimum.
    """
    n_ground = n // 3
    n_walls = n // 3
    n_blobs = n - n_ground - n_walls
    ground = np.stack(
        [
            rng.uniform(-extent, extent, n_ground),
            rng.uniform(-extent, extent, n_ground),
            0.02 * rng.standard_normal(n_ground),
        ],
        axis=1,
    )
    half = n_walls // 2
    wall_x = np.stack(
        [
            np.full(half, extent) + 0.02 * rng.standard_normal(half),
            rng.uniform(-extent, extent, half),
            rng.uniform(0, 3.0, half),
        ],
        axis=1,
    )
    wall_y = np.stack(
        [
            rng.uniform(-extent, extent, n_walls - half),
            np.full(n_walls - half, -extent) + 0.02 * rng.standard_normal(n_walls - half),
            rng.uniform(0, 3.0, n_walls - half),
        ],
        axis=1,
    )
    centers = rng.uniform(-extent * 0.6, extent * 0.6, size=(6, 3))
    centers[:, 2] = rng.uniform(0.5, 2.0, size=6)
    which = rng.integers(0, 6, n_blobs)
    blobs = centers[which] + 0.4 * rng.standard_normal((n_blobs, 3))
    return np.concatenate([ground, wall_x, wall_y, blobs], axis=0)


def two_scan_pair(
    n: int = 4096,
    seed: int = 0,
    noise: float = 0.0,
    rot_scale: float = 0.3,
    trans_scale: float = 0.5,
    dim: int = 3,
):
    """Config 1: (src, dst, T_gt) with dst = T_gt applied to src.

    ICP aligning src onto dst should recover T_gt to <1e-3.
    """
    rng = np.random.default_rng(seed)
    if dim == 3:
        src = surface_cloud(n, rng)
    else:
        src = _room_outline_cloud(n, rng)
    T = rigid_transform(dim, rng, rot_scale, trans_scale)
    dst = src @ T[:dim, :dim].T + T[:dim, dim]
    if noise > 0:
        dst = dst + noise * rng.standard_normal(dst.shape)
    return src, dst, T


def _room_outline_cloud(n: int, rng: np.random.Generator, extent: float = 8.0):
    """2D points on the walls of an L-shaped room (non-degenerate for SE(2))."""
    segs = np.array(
        [
            [-extent, -extent, extent, -extent],
            [extent, -extent, extent, 0.0],
            [extent, 0.0, 0.0, 0.0],
            [0.0, 0.0, 0.0, extent],
            [0.0, extent, -extent, extent],
            [-extent, extent, -extent, -extent],
        ]
    )
    lens = np.hypot(segs[:, 2] - segs[:, 0], segs[:, 3] - segs[:, 1])
    probs = lens / lens.sum()
    which = rng.choice(len(segs), size=n, p=probs)
    u = rng.uniform(0, 1, n)
    p0 = segs[which, :2]
    p1 = segs[which, 2:]
    pts = p0 + u[:, None] * (p1 - p0)
    return pts + 0.01 * rng.standard_normal(pts.shape)


# Simulated 2D lidar world (Intel-Research-Lab-style log; config 2)

@dataclasses.dataclass
class Lidar2DLog:
    ranges: np.ndarray  # (F, B) ranges, max_range where no hit
    angles: np.ndarray  # (B,) beam angles in sensor frame
    gt_poses: np.ndarray  # (F, 3, 3) SE(2) ground truth
    max_range: float


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
    # [dx, -sdx; dy, -sdy] [t; u] = p0 - origin
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


def lidar2d_log_custom(
    segs: np.ndarray,
    waypoints: np.ndarray,
    n_frames: int = 100,
    n_beams: int = 360,
    seed: int = 0,
    max_range: float = 12.0,
    noise: float = 0.005,
    dynamic_fn=None,
) -> Lidar2DLog:
    """Raycast a 2D lidar log through caller-provided wall segments.

    `dynamic_fn(frame) -> (S, 4) segments or None` adds per-frame moving
    geometry (pedestrians, vehicles) — adversarial-world hook: dynamic points
    violate the static-scene assumption every ICP variant makes, so the
    robust weighting (Huber + distance gates) has to absorb them.
    """
    rng = np.random.default_rng(seed)
    angles = np.linspace(-np.pi, np.pi, n_beams, endpoint=False)
    # resample waypoints to n_frames poses with smooth heading
    seg_lens = np.linalg.norm(np.diff(waypoints, axis=0), axis=1)
    cum = np.concatenate([[0], np.cumsum(seg_lens)])
    s = np.linspace(0, cum[-1], n_frames)
    xy = np.stack(
        [np.interp(s, cum, waypoints[:, i]) for i in range(2)], axis=1
    )
    # smooth polyline corners (robots turn over several frames; raw corners
    # give >0.5 rad/frame yaw steps no odometry can track). The 2D world uses
    # a frame-count window (legacy, validated thresholds); the 3D generator
    # uses the fixed-radius _round_and_resample.
    win = max(3, n_frames // 16) | 1
    kern = np.ones(win) / win
    pad = win // 2
    xy = np.stack(
        [
            np.convolve(np.pad(xy[:, i], pad, mode="edge"), kern, mode="valid")
            for i in range(2)
        ],
        axis=1,
    )
    heading = np.arctan2(*np.flip(np.gradient(xy, axis=0), axis=1).T)
    poses = np.zeros((n_frames, 3, 3))
    ranges = np.zeros((n_frames, n_beams))
    for f in range(n_frames):
        th = heading[f]
        c, sn = np.cos(th), np.sin(th)
        poses[f] = [[c, -sn, xy[f, 0]], [sn, c, xy[f, 1]], [0, 0, 1]]
        frame_segs = segs
        if dynamic_fn is not None:
            extra = dynamic_fn(f)
            if extra is not None and len(extra):
                frame_segs = np.concatenate([segs, np.asarray(extra, np.float64)])
        r = _raycast_segments(xy[f], angles + th, frame_segs, max_range)
        hit = r < max_range
        r = np.where(hit, r + noise * rng.standard_normal(n_beams), r)
        ranges[f] = np.clip(r, 0.05, max_range)
    return Lidar2DLog(ranges=ranges, angles=angles, gt_poses=poses, max_range=max_range)


def lidar2d_log(
    n_frames: int = 100,
    n_beams: int = 360,
    seed: int = 0,
    max_range: float = 12.0,
    noise: float = 0.005,
    loop: bool = False,
) -> Lidar2DLog:
    """Simulate a robot driving through the 2D world, raycasting each frame.

    If loop=True the trajectory returns near its start (for loop-closure tests).
    """
    segs = _default_world_segments()
    # waypoints along the corridor (y=0) and into rooms
    if loop:
        waypoints = np.array(
            [(-10, 0), (-2, 0), (4, 0), (9, 0), (9, 4), (2, 4.5), (-5, 4.5),
             (-9.5, 4), (-10, 0.5)]
        )
    else:
        waypoints = np.array([(-10, 0), (-4, 0), (2, 0), (10, 0)])
    return lidar2d_log_custom(
        segs, waypoints, n_frames=n_frames, n_beams=n_beams, seed=seed,
        max_range=max_range, noise=noise,
    )


def scan_to_points(ranges: np.ndarray, angles: np.ndarray, max_range: float):
    """Polar scan -> (N, 2) Cartesian points in sensor frame (hits only)."""
    hit = ranges < max_range * 0.999
    r = ranges[hit]
    a = angles[hit]
    return np.stack([r * np.cos(a), r * np.sin(a)], axis=1)


def _street_clutter_segments(rng: np.random.Generator, n_boxes: int) -> np.ndarray:
    """Box obstacles (parked-car/bin-sized) flanking the corridor.

    Real streets (the KITTI regime this generator stands in for) are full of
    low clutter whose faces constrain translation along the travel axis —
    without it the corridor scene is degenerate along x and any odometry
    (including the fp64 golden oracle) drifts unboundedly.
    """
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
    loop: bool = False,
    n_boxes: int = 48,
    path_fraction: float = 1.0,
    waypoints=None,
    route_clearance: float = 1.0,
):
    """Simulate a vehicle driving through a 3D world of walls + ground + clutter.

    path_fraction < 1 truncates the route so short logs keep a realistic
    (~1 m/frame, KITTI-like) inter-frame motion instead of giant hops.
    `waypoints` (K, 2) overrides the built-in route (e.g. a compact loop
    whose full circuit fits a small frame budget at ~1 m/frame).
    `route_clearance` drops clutter boxes whose footprint comes within that
    many meters of the route: a vehicle does not drive THROUGH parked cars.
    (r3 root-cause: the multisession demo's y=-4/-2 lanes pass through the
    ±2.5–5 m clutter band; every seed drove the sensor through 8–15 box
    interiors, and the point-blank box-interior scans are what made
    per-seed front-end divergence a lottery. The built-in y=0 routes never
    intersect clutter, so their scans are unchanged by the default.)
    Returns (scans: list[(N_i, 3) float64 in sensor frame], gt_poses: (F,4,4)).
    """
    rng = np.random.default_rng(seed)
    segs2d = _default_world_segments() * 4.0  # scale up to street scale
    boxes2d = _street_clutter_segments(rng, n_boxes) if n_boxes else None
    wall_h = 6.0
    box_h = 1.6
    if waypoints is not None:
        waypoints = np.asarray(waypoints, np.float64)
    elif loop:
        waypoints = np.array(
            [(-40, 0), (-8, 0), (16, 0), (36, 0), (36, 16), (8, 18), (-20, 18),
             (-38, 16), (-40, 8), (-39, 1), (-30, 0.2)]
        )
    else:
        waypoints = np.array([(-40, 0), (-16, 0), (8, 0), (40, 0)])
    seg_lens = np.linalg.norm(np.diff(waypoints, axis=0), axis=1)
    cum = np.concatenate([[0], np.cumsum(seg_lens)])
    s = np.linspace(0, cum[-1] * path_fraction, n_frames)
    xy = np.stack([np.interp(s, cum, waypoints[:, i]) for i in range(2)], axis=1)
    # corner rounding with a FIXED TURN RADIUS, independent of frame count:
    # densify the polyline by arc length, smooth over a ~3 m distance window
    # (a vehicle-plausible turn), then resample to n_frames at constant
    # speed. Frame-count-sized windows either leave 0.5 rad/frame kinks
    # (short logs) or collapse turn bulbs into cusps (long logs).
    xy = _round_and_resample(xy, n_frames)
    heading = np.arctan2(*np.flip(np.gradient(xy, axis=0), axis=1).T)

    if boxes2d is not None and route_clearance > 0.0 and len(boxes2d):
        # densify the route to ~0.5 m samples so no box hides between frames
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


# ---------------------------------------------------------------------------
# Synthetic depth camera (TUM-style RGB-D; config 3)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Intrinsics:
    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int

    @staticmethod
    def tum_default(width: int = 160, height: int = 120) -> "Intrinsics":
        # fr1 intrinsics scaled from 640x480
        s = width / 640.0
        return Intrinsics(
            fx=517.3 * s, fy=516.5 * s, cx=318.6 * s, cy=255.3 * s,
            width=width, height=height,
        )


def depth_scene(cam_T_world: np.ndarray, K: Intrinsics, seed: int = 0):
    """Render a synthetic depth image of a fixed scene (wall + floor + spheres).

    cam_T_world: (4, 4) world-to-camera. Camera looks down +z. Returns (H, W)
    depth in meters, 0 where invalid.
    """
    H, W = K.height, K.width
    us, vs = np.meshgrid(np.arange(W), np.arange(H))
    dirs_cam = np.stack(
        [(us - K.cx) / K.fx, (vs - K.cy) / K.fy, np.ones_like(us, dtype=np.float64)],
        axis=-1,
    )  # (H, W, 3), unnormalized (z=1)
    R = cam_T_world[:3, :3]
    t = cam_T_world[:3, 3]
    # camera center in world, ray dirs in world
    Cw = -R.T @ t
    dirs_w = dirs_cam @ R  # (H, W, 3) = R^T @ dirs_cam

    depth = np.full((H, W), np.inf)

    def plane(n, d0):
        # n . x = d0 ; ray Cw + s*dir -> s = (d0 - n.Cw)/(n.dir); depth = s*z_cam...
        denom = dirs_w @ n
        s = np.where(np.abs(denom) > 1e-9, (d0 - Cw @ n) / denom, np.inf)
        return np.where(s > 0.05, s, np.inf)

    # scene: floor z=0, back wall y=3, side wall x=2.5 (partial)
    cands = [
        plane(np.array([0.0, 0.0, 1.0]), 0.0),
        plane(np.array([0.0, 1.0, 0.0]), 3.0),
        plane(np.array([1.0, 0.0, 0.0]), 2.5),
    ]
    rng = np.random.default_rng(seed)
    centers = np.array([[0.4, 1.8, 0.5], [-0.6, 2.2, 0.9], [0.1, 1.2, 1.3]])
    radii = np.array([0.35, 0.45, 0.25])
    for cth, rad in zip(centers, radii):
        oc = Cw - cth
        ndirs = dirs_w / np.linalg.norm(dirs_w, axis=-1, keepdims=True)
        b = ndirs @ oc
        cc = oc @ oc - rad * rad
        disc = b * b - cc
        s = np.where(disc > 0, -b - np.sqrt(np.maximum(disc, 0)), np.inf)
        # convert unit-ray param to z=1-ray param
        s = s / np.linalg.norm(dirs_w, axis=-1)
        cands.append(np.where(s > 0.05, s, np.inf))
    for c in cands:
        depth = np.minimum(depth, c)
    # s is the parameter along the z=1 camera ray, so depth (z in camera) = s
    depth = np.where(np.isfinite(depth) & (depth < 10.0), depth, 0.0)
    _ = rng  # reserved for future noise
    return depth


def rgbd_log(n_frames: int = 10, K: Intrinsics | None = None, seed: int = 0):
    """Camera sweeping through the depth scene; returns (depths, gt_poses).

    gt_poses are camera-to-world (4, 4); depths (F, H, W) meters, 0 invalid.
    """
    K = K or Intrinsics.tum_default()
    rng = np.random.default_rng(seed)
    depths, poses = [], []
    for f in range(n_frames):
        u = f / max(n_frames - 1, 1)
        # translate sideways + slight yaw, looking at the wall (+y)
        x = -0.5 + 1.0 * u
        z = 1.0 + 0.2 * np.sin(2 * np.pi * u * 0.5)
        yaw = 0.15 * (u - 0.5)
        cy, sy = np.cos(yaw), np.sin(yaw)
        # camera axes in world: z_cam = view dir (toward +y), x_cam right, y_cam down
        zc = np.array([sy, cy, 0.0])
        xc = np.array([cy, -sy, 0.0])
        yc = np.cross(zc, xc)
        Rwc = np.stack([xc, yc, zc], axis=1)  # world-from-camera
        Twc = np.eye(4)
        Twc[:3, :3] = Rwc
        Twc[:3, 3] = [x, 0.2, z]
        Tcw = np.linalg.inv(Twc)
        depths.append(depth_scene(Tcw, K, seed=seed))
        poses.append(Twc)
    _ = rng
    return np.stack(depths), np.stack(poses), K
