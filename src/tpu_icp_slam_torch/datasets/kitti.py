"""KITTI odometry loader (the port's own copy of
tpu_icp_slam/datasets/kitti.py, the same code).

Format-exact so real data drops in: `velodyne/*.bin` files are (N, 4)
float32 [x, y, z, reflectance] little-endian; `poses.txt` rows are the 3×4
left-camera-to-world matrices; `calib.txt` carries `Tr:` (velodyne → cam0),
needed to express GT poses in the velodyne frame:
T_w←velo = T_w←cam0 @ Tr. `write_sequence` writes a sequence in the same
format (fixtures, and synthetic logs run through the KITTI path).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np


def read_velodyne_bin(path: str) -> np.ndarray:
    """(N, 3) xyz from a KITTI .bin (reflectance dropped)."""
    raw = np.fromfile(path, dtype=np.float32)
    return raw.reshape(-1, 4)[:, :3].astype(np.float64)


def read_poses(path: str) -> np.ndarray:
    """poses.txt -> (F, 4, 4) homogeneous cam0-to-world."""
    rows = np.loadtxt(path).reshape(-1, 3, 4)
    out = np.tile(np.eye(4), (rows.shape[0], 1, 1))
    out[:, :3, :] = rows
    return out


def read_calib_tr(path: str) -> Optional[np.ndarray]:
    """calib.txt 'Tr:' line -> (4, 4) velodyne-to-cam0, or None."""
    with open(path) as fh:
        for line in fh:
            if line.startswith("Tr:") or line.startswith("Tr "):
                vals = np.array([float(v) for v in line.split()[1:]])
                T = np.eye(4)
                T[:3, :] = vals.reshape(3, 4)
                return T
    return None


def load_sequence(path: str, max_frames: int = 0):
    """Sequence dir (velodyne/ [+ poses.txt, calib.txt]) -> (scans, poses).

    scans: list of (N_i, 3) float64 velodyne-frame clouds; poses: (F, 4, 4)
    velodyne-frame GT (or None when poses.txt is absent).
    """
    velo_dir = os.path.join(path, "velodyne")
    files = sorted(
        os.path.join(velo_dir, f) for f in os.listdir(velo_dir) if f.endswith(".bin")
    )
    if max_frames > 0:
        files = files[:max_frames]
    scans = [read_velodyne_bin(f) for f in files]

    poses = None
    pose_file = os.path.join(path, "poses.txt")
    if os.path.exists(pose_file):
        poses = read_poses(pose_file)[: len(scans)]
        calib_file = os.path.join(path, "calib.txt")
        if os.path.exists(calib_file):
            Tr = read_calib_tr(calib_file)
            if Tr is not None:
                # GT is cam0-frame; re-express in the velodyne frame so the
                # trajectory compares against velodyne-frame odometry
                poses = np.einsum("fij,jk->fik", poses, Tr)
                poses = np.einsum("ij,fjk->fik", np.linalg.inv(Tr), poses)
    return scans, poses


def write_sequence(path: str, scans, poses=None, Tr=None) -> None:
    """Inverse of load_sequence, for fixtures and round-trip tests."""
    velo_dir = os.path.join(path, "velodyne")
    os.makedirs(velo_dir, exist_ok=True)
    for i, s in enumerate(scans):
        arr = np.zeros((len(s), 4), np.float32)
        arr[:, :3] = s
        arr.tofile(os.path.join(velo_dir, f"{i:06d}.bin"))
    if poses is not None:
        poses = np.asarray(poses)
        if Tr is not None:
            # store cam0-frame GT like the real dataset: T_w←cam = Tr @ T_w←velo @ Tr⁻¹
            poses = np.einsum("ij,fjk->fik", Tr, poses)
            poses = np.einsum("fij,jk->fik", poses, np.linalg.inv(Tr))
            with open(os.path.join(path, "calib.txt"), "w") as fh:
                fh.write("Tr: " + " ".join(str(v) for v in Tr[:3].ravel()) + "\n")
        np.savetxt(
            os.path.join(path, "poses.txt"),
            poses[:, :3, :].reshape(len(poses), 12),
        )
