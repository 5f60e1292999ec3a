"""CARMEN log-file (.clf / .log) reader and writer — the Intel Research Lab
format (the port's own copy of tpu_icp_slam/datasets/carmen.py, line for
line).

Format: whitespace-separated records, one per line;
`FLASER num_readings r_1 ... r_n x y theta odom_x odom_y odom_theta ts host
log_ts` for laser scans (ranges in meters, beams spread over the field of
view, typically 180 degrees), `ODOM ...` and `PARAM ...` records are carried
through / consulted for metadata. A writer is provided so synthetic logs can
be serialized in the exact on-disk format (no real datasets exist in this
repository).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class CarmenLog:
    ranges: np.ndarray  # (F, B)
    angles: np.ndarray  # (B,)
    odometry: np.ndarray  # (F, 3) x, y, theta (robot odometry at scan time)
    timestamps: np.ndarray  # (F,)
    max_range: float
    fov: float


def load_clf(path: str, max_range: float = 81.9, fov: float = np.pi) -> CarmenLog:
    scans, odoms, stamps = [], [], []
    params = {}
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            tag = parts[0]
            if tag == "PARAM" and len(parts) >= 3:
                params[parts[1]] = parts[2]
            elif tag in ("FLASER", "RLASER"):
                n = int(parts[1])
                r = np.asarray([float(x) for x in parts[2 : 2 + n]])
                rest = parts[2 + n :]
                x, y, th = (float(v) for v in rest[0:3])
                ts = float(rest[6]) if len(rest) >= 7 else len(scans) * 0.1
                scans.append(r)
                odoms.append((x, y, th))
                stamps.append(ts)
    if params.get("robot_front_laser_max"):
        max_range = float(params["robot_front_laser_max"])
    if not scans:
        raise ValueError(f"no laser records in {path}")
    n_beams = len(scans[0])
    ranges = np.stack([s for s in scans if len(s) == n_beams])
    angles = np.linspace(-fov / 2, fov / 2, n_beams, endpoint=True)
    return CarmenLog(
        ranges=ranges,
        angles=angles,
        odometry=np.asarray(odoms),
        timestamps=np.asarray(stamps),
        max_range=max_range,
        fov=fov,
    )


def write_clf(
    path: str,
    ranges: np.ndarray,
    poses_xyt: np.ndarray,
    timestamps: np.ndarray | None = None,
    max_range: float = 81.9,
) -> None:
    """Serialize scans in CARMEN FLASER format (odometry = given poses)."""
    f_count, n = ranges.shape
    ts = timestamps if timestamps is not None else np.arange(f_count) * 0.1
    with open(path, "w") as f:
        f.write("# synthetic CARMEN log written by tpu_icp_slam\n")
        f.write(f"PARAM robot_front_laser_max {max_range}\n")
        for i in range(f_count):
            rs = " ".join(f"{r:.3f}" for r in ranges[i])
            x, y, th = poses_xyt[i]
            f.write(
                f"FLASER {n} {rs} {x:.6f} {y:.6f} {th:.6f} "
                f"{x:.6f} {y:.6f} {th:.6f} {ts[i]:.6f} sim {ts[i]:.6f}\n"
            )
