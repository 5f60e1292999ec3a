"""Standard trajectory formats: TUM and KITTI text export/import.

The port's own copy of tpu_icp_slam/eval/trajectory_io.py, the same code.
External tools (evo, the KITTI devkit, TUM's scripts) read these files.

- TUM:   one line per pose: `timestamp tx ty tz qx qy qz qw` (w LAST).
- KITTI: one line per pose: the 12 row-major entries of the 3×4 [R|t].

2D poses (3×3 SE(2)) are lifted to SE(3) with z=0 / yaw-only rotation.
"""

from __future__ import annotations

import numpy as np


def _lift(poses: np.ndarray) -> np.ndarray:
    """(F, 3, 3) SE(2) or (F, 4, 4) SE(3) -> (F, 4, 4) float64."""
    poses = np.asarray(poses, np.float64)
    if poses.shape[-1] == 4:
        return poses
    out = np.tile(np.eye(4), (len(poses), 1, 1))
    out[:, :2, :2] = poses[:, :2, :2]
    out[:, :2, 3] = poses[:, :2, 2]
    return out


def _rot_to_quat(R: np.ndarray) -> np.ndarray:
    """(3, 3) -> quaternion (x, y, z, w), Shepperd's stable branch choice."""
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        w = 0.25 * s
        x = (R[2, 1] - R[1, 2]) / s
        y = (R[0, 2] - R[2, 0]) / s
        z = (R[1, 0] - R[0, 1]) / s
    else:
        i = int(np.argmax(np.diag(R)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(max(R[i, i] - R[j, j] - R[k, k] + 1.0, 1e-18)) * 2
        q = np.empty(3)
        q[i] = 0.25 * s
        q[j] = (R[j, i] + R[i, j]) / s
        q[k] = (R[k, i] + R[i, k]) / s
        w = (R[k, j] - R[j, k]) / s
        x, y, z = q
    return np.array([x, y, z, w])


def _quat_to_rot(q: np.ndarray) -> np.ndarray:
    x, y, z, w = np.asarray(q, np.float64) / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ])


def write_tum(path: str, poses: np.ndarray, timestamps=None) -> None:
    """TUM format; timestamps default to the frame index (10 Hz-agnostic —
    external tools only need monotonicity unless associating with GT)."""
    P = _lift(poses)
    ts = (np.arange(len(P), dtype=np.float64)
          if timestamps is None else np.asarray(timestamps, np.float64))
    with open(path, "w") as fh:
        fh.write("# timestamp tx ty tz qx qy qz qw\n")
        for t, T in zip(ts, P):
            q = _rot_to_quat(T[:3, :3])
            fh.write(f"{t:.6f} {T[0,3]:.9f} {T[1,3]:.9f} {T[2,3]:.9f} "
                     f"{q[0]:.9f} {q[1]:.9f} {q[2]:.9f} {q[3]:.9f}\n")


def read_tum(path: str):
    """-> (timestamps (F,), poses (F, 4, 4))."""
    ts, poses = [], []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            v = [float(x) for x in line.split()]
            T = np.eye(4)
            T[:3, :3] = _quat_to_rot(v[4:8])
            T[:3, 3] = v[1:4]
            ts.append(v[0])
            poses.append(T)
    return np.asarray(ts), np.stack(poses) if poses else np.zeros((0, 4, 4))


def write_kitti(path: str, poses: np.ndarray) -> None:
    P = _lift(poses)
    with open(path, "w") as fh:
        for T in P:
            fh.write(" ".join(f"{v:.9e}" for v in T[:3, :].reshape(-1)))
            fh.write("\n")


def read_kitti(path: str) -> np.ndarray:
    poses = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            v = np.array([float(x) for x in line.split()]).reshape(3, 4)
            T = np.eye(4)
            T[:3, :] = v
            poses.append(T)
    return np.stack(poses) if poses else np.zeros((0, 4, 4))
