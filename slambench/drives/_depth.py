"""The RGB-D drive's generator: depth logs of a handheld Kinect v1 in an
office room, made on the host with numpy alone, at the camera the
configuration states (TUM RGB-D freiburg1: 640 x 480, fr1 intrinsics,
depth in units of 1/5000 m).

A world (0-3) is a room of about 4 x 5 x 2.7 m, z up, with desk-scale
clutter: a desk with legs, a monitor-sized panel on it, boxes on the desk
and on the floor, chair-sized blocks and a cabinet, some turned about the
vertical, so that depth has occlusion edges. Each is fixed by its world
number (`_layout`), and so is its camera trajectory (`trajectory`): a
smooth handheld path at 30 Hz around a view of the desk, with hand
jitter, scaled so that its mean speeds over the sequence are fr1/desk's
published 0.41 m/s and 23 deg/s (1.4 cm and 0.78 deg a frame).

Each image is ray-cast through the intrinsics (`render`, the clean depth:
z along the optical axis, as a depth camera reports it), then made a
Kinect's (`kinect`): axial noise sigma(z) = 0.0012 + 0.0019 (z - 0.4)^2 m
(Nguyen, Izadi, Lovell, 3DIMPVT 2012), quantization to 1/5000 m, and 0
(invalid) outside 0.5-4.0 m, on a thin band at occlusion edges and on a
few percent of pixels at random. The noise and the dropout are drawn from
the sequence's seed alone; the scene, the path and the edge band are the
world's. The program receives float32 metres, as datasets/tum.py delivers
TUM's 16-bit PNGs.
"""

from __future__ import annotations

import numpy as np

FR1_SPEED_M_S = 0.41  # fr1/desk's mean translational speed (TUM's table)
FR1_SPEED_DEG_S = 23.0  # its mean angular speed
RATE_HZ = 30.0
ROOM = (np.array([-2.0, -2.5, 0.0]), np.array([2.0, 2.5, 2.7]))  # lo, hi
MIN_DEPTH_M, MAX_DEPTH_M = 0.5, 4.0  # the Kinect's valid range
DROPOUT = 0.02  # share of pixels dropped at random
EDGE_JUMP = (0.05, 0.03)  # a neighbour farther by a + b z is an edge


def sigma_m(z):
    """The Kinect v1's axial noise at depth z (m)."""
    return 0.0012 + 0.0019 * (z - 0.4) ** 2


# ---- the worlds -------------------------------------------------------------

def _layout(world: int) -> tuple:
    """(boxes, desk centre): boxes as rows (cx, cy, cz, hx, hy, hz, yaw) of
    the room's clutter, fixed by the world number."""
    rng = np.random.default_rng(1_000 + world)
    lo, hi = ROOM
    side = world % 4  # the wall the desk stands against: +y, +x, -y, -x
    ang = side * np.pi / 2
    # the desk's frame: its back to the wall, facing the room's centre
    along = np.array([np.cos(ang), np.sin(ang)])
    into = np.array([-np.sin(ang), np.cos(ang)])  # towards the wall
    wall = hi[1] if side % 2 == 0 else hi[0]
    off = rng.uniform(-0.6, 0.6)
    desk_c = into * (wall - 0.45) + along * off
    boxes = []

    def put(local_xy, z, half, yaw=0.0):
        xy = desk_c + local_xy[0] * along - local_xy[1] * into
        boxes.append((xy[0], xy[1], z, half[0], half[1], half[2],
                      ang + yaw))

    put((0.0, 0.0), 0.74, (0.7, 0.35, 0.02))  # the desk's top
    for sx in (-1, 1):
        for sy in (-1, 1):
            put((sx * 0.64, sy * 0.29), 0.36, (0.025, 0.025, 0.36))
    put((rng.uniform(-0.2, 0.2), -0.1), 1.03, (0.28, 0.02, 0.17),
        rng.uniform(-0.25, 0.25))  # the monitor
    put((0.0, -0.1), 0.82, (0.04, 0.04, 0.06))  # its stand
    for _ in range(3):  # things on the desk
        h = rng.uniform(0.04, 0.15, 3)
        put((rng.uniform(-0.55, 0.55), rng.uniform(0.0, 0.25)),
            0.76 + h[2], h, rng.uniform(-0.8, 0.8))
    for _ in range(2):  # chairs: a seat and a back
        x, y = rng.uniform(-0.9, 0.9), rng.uniform(0.7, 1.2)
        yaw = rng.uniform(-0.6, 0.6)
        put((x, y), 0.45, (0.23, 0.23, 0.04), yaw)
        put((x + 0.21 * np.sin(yaw), y + 0.21 * np.cos(yaw)), 0.72,
            (0.22, 0.03, 0.25), yaw)
        put((x, y), 0.21, (0.04, 0.04, 0.21), yaw)
    for _ in range(3):  # boxes on the floor
        h = rng.uniform(0.12, 0.3, 3)
        xy = rng.uniform(lo[:2] + 0.5, hi[:2] - 0.5)
        boxes.append((xy[0], xy[1], h[2], h[0], h[1], h[2],
                      rng.uniform(0, np.pi)))
    # a cabinet against the wall on the desk's left
    put((-1.25, 0.0), 0.6, (0.3, 0.25, 0.6))
    return np.asarray(boxes, np.float64), desk_c


def _look(eye, target, roll):
    """camera -> world rotation looking from eye at target, x right, y
    down, z forward, rolled about z."""
    f = target - eye
    f = f / np.linalg.norm(f)
    r = np.cross(f, [0.0, 0.0, 1.0])
    r = r / np.linalg.norm(r)
    d = np.cross(f, r)
    c, s = np.cos(roll), np.sin(roll)
    return np.stack([c * r + s * d, -s * r + c * d, f], axis=1)


def _angle(R):
    return np.arccos(np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0))


def _path(world: int, n: int, amp_t: float, amp_r: float):
    rng = np.random.default_rng(2_000 + world)
    _, desk_c = _layout(world)
    centre_dir = -desk_c / np.linalg.norm(desk_c)
    base = np.array([*(desk_c + 1.7 * centre_dir), 1.45])
    target0 = np.array([*desk_c, 0.9])
    t = np.arange(n) / RATE_HZ
    w = 2 * np.pi * rng.uniform(0.12, 0.35, 6)
    ph = rng.uniform(0, 2 * np.pi, 6)
    sway = np.stack([np.sin(w[k] * t + ph[k]) for k in range(6)], axis=1)
    # hand jitter: a few-Hz wobble, fixed by the world too
    jw = 2 * np.pi * rng.uniform(1.5, 3.0, 6)
    jp = rng.uniform(0, 2 * np.pi, 6)
    jit = np.stack([np.sin(jw[k] * t + jp[k]) for k in range(6)], axis=1)
    poses = np.tile(np.eye(4), (n, 1, 1))
    for f in range(n):
        eye = base + amp_t * (np.array([1.0, 1.0, 0.4]) * sway[f, :3]
                              + 0.04 * jit[f, :3])
        target = target0 + amp_r * (np.array([1.0, 1.0, 0.6]) * sway[f, 3:]
                                    + 0.05 * jit[f, 3:])
        roll = amp_r * 0.15 * (sway[f, 3] + 0.1 * jit[f, 5])
        poses[f, :3, :3] = _look(eye, target, roll)
        poses[f, :3, 3] = eye
    return poses


def frame_speeds(poses: np.ndarray) -> tuple:
    """(mean m, mean rad) a frame of a camera -> world trajectory."""
    rel = np.einsum("fji,fjk->fik", poses[:-1, :3, :3], poses[1:, :3, :3])
    trans = np.linalg.norm(np.diff(poses[:, :3, 3], axis=0), axis=1)
    return float(trans.mean()), float(np.mean([_angle(r) for r in rel]))


def trajectory(world: int, n: int) -> np.ndarray:
    """The world's (n, 4, 4) camera -> world poses at 30 Hz, its mean speeds
    fr1/desk's (its amplitudes scaled until they are, to 1e-6)."""
    want_t = FR1_SPEED_M_S / RATE_HZ
    want_r = np.deg2rad(FR1_SPEED_DEG_S) / RATE_HZ
    amp_t, amp_r = 0.5, 0.5
    for _ in range(30):
        got_t, got_r = frame_speeds(_path(world, n, amp_t, amp_r))
        if abs(got_t / want_t - 1) < 1e-6 and abs(got_r / want_r - 1) < 1e-6:
            break
        amp_t *= want_t / got_t
        amp_r *= want_r / got_r
    return _path(world, n, amp_t, amp_r)


# ---- the camera -------------------------------------------------------------

def _rays(camera: dict) -> np.ndarray:
    """(3, H, W) float32 camera-frame rays with z = 1 through each pixel's
    centre, a plane a component."""
    w, h = camera["width"], camera["height"]
    u = (np.arange(w) - camera["cx"]) / camera["fx"]
    v = (np.arange(h) - camera["cy"]) / camera["fy"]
    rays = np.ones((3, h, w), np.float32)
    rays[0] = u[None, :]
    rays[1] = v[:, None]
    return rays


def _slab(o, d, lo, hi):
    """Entry and exit ray parameters of an axis-aligned box, for rays o + s d
    with d a (3, ...) stack of component planes (NaN-free: fmin and fmax
    pass over the 0 * inf of a ray along a face)."""
    near = far = None
    with np.errstate(divide="ignore", invalid="ignore"):
        for k in range(3):
            inv = np.float32(1.0) / d[k]
            t1 = (np.float32(lo[k] - o[k])) * inv
            t2 = (np.float32(hi[k] - o[k])) * inv
            a, b = np.fmin(t1, t2), np.fmax(t1, t2)
            near = a if near is None else np.fmax(near, a)
            far = b if far is None else np.fmin(far, b)
    return near, far


def _corners(box):
    cx, cy, cz, hx, hy, hz, yaw = box
    c, s = np.cos(yaw), np.sin(yaw)
    out = []
    for sx in (-1, 1):
        for sy in (-1, 1):
            for sz in (-1, 1):
                x, y = sx * hx, sy * hy
                out.append((cx + c * x - s * y, cy + s * x + c * y,
                            cz + sz * hz))
    return np.asarray(out)


def _turned(R, d):
    """R (3, 3) applied to a (3, ...) stack of component planes."""
    R = R.astype(np.float32)
    return np.stack([R[i, 0] * d[0] + R[i, 1] * d[1] + R[i, 2] * d[2]
                     for i in range(3)])


def render(camera: dict, rays: np.ndarray, pose: np.ndarray,
           boxes: np.ndarray) -> np.ndarray:
    """The clean (H, W) depth (m, z along the optical axis) of the room and
    its boxes seen from `pose` (camera -> world), in float32."""
    R, o = pose[:3, :3], pose[:3, 3]
    h, w = rays.shape[1:]
    d = _turned(R, rays)
    depth = _slab(o, d, *ROOM)[1]  # inside the room: where a ray leaves
    inv_pose = np.linalg.inv(pose)
    for box in boxes:
        # the pixels its corners project to (all, if one is behind)
        cam = _corners(box) @ inv_pose[:3, :3].T + inv_pose[:3, 3]
        if np.all(cam[:, 2] <= 0.05):
            continue
        if np.all(cam[:, 2] > 0.05):
            u = cam[:, 0] / cam[:, 2] * camera["fx"] + camera["cx"]
            v = cam[:, 1] / cam[:, 2] * camera["fy"] + camera["cy"]
            u0, u1 = max(int(np.floor(u.min())), 0), min(int(u.max()) + 2, w)
            v0, v1 = max(int(np.floor(v.min())), 0), min(int(v.max()) + 2, h)
            if u0 >= u1 or v0 >= v1:
                continue
        else:
            u0, u1, v0, v1 = 0, w, 0, h
        cx, cy, cz, hx, hy, hz, yaw = box
        c, s = np.cos(yaw), np.sin(yaw)
        rot = np.array([[c, s, 0.0], [-s, c, 0.0], [0.0, 0.0, 1.0]])
        ob = rot @ (o - np.array([cx, cy, cz]))
        db = _turned(rot, d[:, v0:v1, u0:u1])
        half = np.array([hx, hy, hz])
        near, far = _slab(ob, db, -half, half)
        sub = depth[v0:v1, u0:u1]
        hit = (near <= far) & (near > 0.0) & (near < sub)
        sub[hit] = near[hit]
    return depth


def kinect(clean: np.ndarray, rng: np.random.Generator,
           noise: bool = True) -> np.ndarray:
    """The clean depth as the Kinect v1 reports it, in float32 metres:
    axial noise (with `noise`), quantized to 1/5000 m, 0 outside 0.5-4.0 m,
    at occlusion edges (the pixels on both sides of a jump) and, with
    `noise`, on DROPOUT of the pixels."""
    z = clean
    near = np.minimum(z[:, 1:], z[:, :-1])
    across = np.abs(z[:, 1:] - z[:, :-1]) > EDGE_JUMP[0] + EDGE_JUMP[1] * near
    near = np.minimum(z[1:], z[:-1])
    down = np.abs(z[1:] - z[:-1]) > EDGE_JUMP[0] + EDGE_JUMP[1] * near
    edge = np.zeros(z.shape, bool)
    edge[:, 1:] |= across
    edge[:, :-1] |= across
    edge[1:] |= down
    edge[:-1] |= down
    if noise:
        z = z + sigma_m(z) * rng.standard_normal(z.shape, np.float32)
    q = np.round(z * np.float32(5000.0))
    ok = (q >= MIN_DEPTH_M * 5000.0) & (q <= MAX_DEPTH_M * 5000.0) & ~edge
    if noise:
        ok &= rng.random(z.shape) >= DROPOUT
    return np.where(ok, q / np.float32(5000.0), np.float32(0.0))


def log(camera: dict, world: int, frames: int, seed: int,
        noise: bool = True) -> tuple:
    """One sequence: ((F, H, W) float32 depths, (F, 4, 4) camera -> world
    ground truth)."""
    boxes, _ = _layout(world)
    gt = trajectory(world, frames)
    rays = _rays(camera)
    rng = np.random.default_rng(seed)
    depths = np.stack([kinect(render(camera, rays, p, boxes), rng, noise)
                       for p in gt])
    return depths, gt
