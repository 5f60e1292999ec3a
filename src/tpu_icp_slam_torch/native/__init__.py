"""Host-side voxel downsampling in C, bound with ctypes.

The port's own copy of tpu_icp_slam/native's voxel pass (`voxel.c`, the
same source): first point per voxel, in scan order, in one linear pass over
an open-addressing hash table. It is host preprocessing before padding, not
a device kernel.

The library is built with the system C compiler at first use into
`build/tpu_icp_slam_torch/native/<sha256 of the source>/` at the checkout
root, never into a package directory. Without a compiler (or with
TPU_ICP_SLAM_NO_NATIVE=1) `voxel_downsample` returns None and
`core.pointcloud.voxel_downsample_np` takes its numpy path, which gives the
same points.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_SRC = Path(__file__).resolve().with_name("voxel.c")
_BUILD_ROOT = _SRC.parents[3] / "build" / "tpu_icp_slam_torch" / "native"
_CFLAGS = ("-O3", "-shared", "-fPIC")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def library_path() -> Path:
    h = hashlib.sha256(" ".join(_CFLAGS).encode())
    h.update(_SRC.read_bytes())
    return _BUILD_ROOT / h.hexdigest()[:16] / "libvoxel.so"


def _build() -> Optional[Path]:
    out = library_path()
    if out.exists():
        return out
    cc = shutil.which(os.environ.get("CC", "cc"))
    if cc is None:
        return None
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"libvoxel.{os.getpid()}.so")
    proc = subprocess.run([cc, *_CFLAGS, "-o", str(tmp), str(_SRC), "-lm"],
                          capture_output=True, timeout=120)
    if proc.returncode != 0:
        return None
    os.replace(tmp, out)
    return out


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if os.environ.get("TPU_ICP_SLAM_NO_NATIVE") == "1":
            return None
        path = _build()
        if path is None:
            return None
        lib = ctypes.CDLL(str(path))
        lib.voxel_downsample_f64.restype = ctypes.c_long
        lib.voxel_downsample_f64.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.c_long, ctypes.c_int,
            ctypes.c_double, ctypes.POINTER(ctypes.c_long),
        ]
        lib.polar_to_cartesian_f64.restype = ctypes.c_long
        lib.polar_to_cartesian_f64.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
            ctypes.c_long, ctypes.c_double, ctypes.POINTER(ctypes.c_double),
        ]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def voxel_downsample(points: np.ndarray, voxel: float) -> Optional[np.ndarray]:
    """First point per voxel, scan order. None if the library is absent."""
    lib = _load()
    if lib is None:
        return None
    pts = np.ascontiguousarray(points, dtype=np.float64)
    n, dim = pts.shape
    out = np.empty(n, dtype=np.int64)
    kept = lib.voxel_downsample_f64(
        pts.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        ctypes.c_long(n),
        ctypes.c_int(dim),
        ctypes.c_double(float(voxel)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
    )
    if kept < 0:
        return None
    return points[out[:kept]]


def polar_to_cartesian(ranges: np.ndarray, angles: np.ndarray,
                       max_range: float) -> Optional[np.ndarray]:
    """Hits (range < 0.999 max_range) of a polar scan as (K, 2) float64
    points, by the C pass. None if the library is absent."""
    lib = _load()
    if lib is None:
        return None
    r = np.ascontiguousarray(ranges, dtype=np.float64)
    a = np.ascontiguousarray(angles, dtype=np.float64)
    out = np.empty((len(r), 2), dtype=np.float64)
    k = lib.polar_to_cartesian_f64(
        r.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        a.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        ctypes.c_long(len(r)),
        ctypes.c_double(float(max_range)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
    )
    return out[:k]
