"""TUM RGB-D sequences (port of tpu_icp_slam/datasets/tum.py), the fr1/xyz
directory layout: 16-bit depth PNGs scaled by 5000 under `depth/`, the
`depth.txt` index (timestamp, path) and an optional `groundtruth.txt`
(timestamp tx ty tz qx qy qz qw), matched to each depth frame by the
nearest timestamp. The PNGs are read and written by the port's own codec
(datasets/png.py) where the reference uses cv2; the writer filters every
row with Up, which cv2 reads as it reads its own files.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from tpu_icp_slam_torch.datasets import png

DEPTH_FACTOR = 5000.0
FR1_INTRINSICS = (517.3, 516.5, 318.6, 255.3)  # fx, fy, cx, cy at 640x480


@dataclasses.dataclass
class TumSequence:
    depths: np.ndarray  # (F, H, W) metres, 0 invalid
    timestamps: np.ndarray  # (F,)
    gt_poses: np.ndarray | None  # (F, 4, 4) camera-to-world, matched by time
    intrinsics: tuple  # (fx, fy, cx, cy)


def _quat_to_R(qx, qy, qz, qw):
    n = np.sqrt(qx * qx + qy * qy + qz * qz + qw * qw)
    qx, qy, qz, qw = qx / n, qy / n, qz / n, qw / n
    return np.array(
        [
            [1 - 2 * (qy**2 + qz**2), 2 * (qx * qy - qz * qw), 2 * (qx * qz + qy * qw)],
            [2 * (qx * qy + qz * qw), 1 - 2 * (qx**2 + qz**2), 2 * (qy * qz - qx * qw)],
            [2 * (qx * qz - qy * qw), 2 * (qy * qz + qx * qw), 1 - 2 * (qx**2 + qy**2)],
        ]
    )


def _rows(path: str) -> list[list[str]]:
    """The fields of each line that is neither empty nor a comment."""
    with open(path) as f:
        return [line.split() for line in map(str.strip, f)
                if line and not line.startswith("#")]


def load_sequence(root: str, max_frames: int = 0,
                  intrinsics: tuple = FR1_INTRINSICS) -> TumSequence:
    """The whole sequence (or its first max_frames frames) as float64
    metres, stacked in host memory as the reference stacks it."""
    entries = [(float(ts), os.path.join(root, rel))
               for ts, rel, *_ in _rows(os.path.join(root, "depth.txt"))]
    if max_frames > 0:
        entries = entries[:max_frames]
    depths = np.stack([png.read_gray16(p).astype(np.float64) / DEPTH_FACTOR
                       for _, p in entries])
    stamps = np.asarray([t for t, _ in entries])

    gt = None
    gt_file = os.path.join(root, "groundtruth.txt")
    if os.path.exists(gt_file):
        rows = np.asarray([[float(v) for v in r] for r in _rows(gt_file)])
        gt = []
        for t in stamps:  # nearest-timestamp association
            i = int(np.argmin(np.abs(rows[:, 0] - t)))
            tx, ty, tz, qx, qy, qz, qw = rows[i, 1:8]
            T = np.eye(4)
            T[:3, :3] = _quat_to_R(qx, qy, qz, qw)
            T[:3, 3] = (tx, ty, tz)
            gt.append(T)
        gt = np.stack(gt)
    return TumSequence(depths=depths, timestamps=stamps, gt_poses=gt,
                       intrinsics=intrinsics)


def write_sequence(root: str, depths: np.ndarray,
                   gt_poses: np.ndarray | None = None,
                   timestamps: np.ndarray | None = None) -> None:
    """Write (F, H, W) metric depths in the TUM on-disk layout."""
    os.makedirs(os.path.join(root, "depth"), exist_ok=True)
    f_count = len(depths)
    ts = (timestamps if timestamps is not None
          else np.arange(f_count) * (1.0 / 30) + 1e9)
    with open(os.path.join(root, "depth.txt"), "w") as idx:
        idx.write("# timestamp filename\n")
        for i in range(f_count):
            rel = f"depth/{ts[i]:.6f}.png"
            img = np.clip(depths[i] * DEPTH_FACTOR, 0, 65535).astype(np.uint16)
            png.write_gray16(os.path.join(root, rel), img)
            idx.write(f"{ts[i]:.6f} {rel}\n")
    if gt_poses is not None:
        with open(os.path.join(root, "groundtruth.txt"), "w") as g:
            g.write("# timestamp tx ty tz qx qy qz qw\n")
            for i in range(f_count):
                T = gt_poses[i]
                t = T[:3, 3]
                R = T[:3, :3]
                qw = np.sqrt(max(0.0, 1 + R[0, 0] + R[1, 1] + R[2, 2])) / 2
                if qw > 1e-8:
                    qx = (R[2, 1] - R[1, 2]) / (4 * qw)
                    qy = (R[0, 2] - R[2, 0]) / (4 * qw)
                    qz = (R[1, 0] - R[0, 1]) / (4 * qw)
                else:  # the near-pi case, as the reference writes it
                    qx, qy, qz = 1.0, 0.0, 0.0
                g.write(
                    f"{ts[i]:.6f} {t[0]:.6f} {t[1]:.6f} {t[2]:.6f} "
                    f"{qx:.6f} {qy:.6f} {qz:.6f} {qw:.6f}\n"
                )
