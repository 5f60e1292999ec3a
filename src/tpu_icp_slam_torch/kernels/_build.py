"""Build and load the CUDA kernels in `tpu_icp_slam_torch/csrc/`.

All `csrc/*.cu` files are compiled by nvcc for sm_90a into one shared
library with a plain C interface, loaded with ctypes (no PyTorch headers, so
the build takes seconds). The library lands in
`build/tpu_icp_slam_torch/<sha256 of sources, headers and flags>/libkernels.so`
at the checkout root and is reused while the sources and the shared headers
(`csrc/*.cuh`) are unchanged. A missing nvcc or a failed build raises
with the compiler's output: nothing runs without the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[1]
_CSRC = _PKG / "csrc"
_BUILD_ROOT = _PKG.parents[1] / "build" / "tpu_icp_slam_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _nvcc() -> str:
    cands = [shutil.which("nvcc")]
    for env in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(env):
            cands.append(os.path.join(os.environ[env], "bin", "nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError(
        "nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): the CUDA kernels "
        "of tpu_icp_slam_torch cannot be built")


def sources() -> list[Path]:
    return sorted(_CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted([*sources(), *_CSRC.glob("*.cuh")]):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return _BUILD_ROOT / h.hexdigest() / "libkernels.so"


def build(verbose: bool = False) -> Path:
    """Compile the kernels unless a library for these sources exists."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"libkernels.{os.getpid()}.so")
    cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", str(tmp), *map(str, sources())]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}")
    if verbose:
        print(proc.stderr, end="")
    os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    """The kernel library, built on first use, with argtypes declared."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            ptr, i32 = ctypes.c_void_p, ctypes.c_int
            lib.nn_bruteforce_f32.argtypes = [
                ptr, ptr, i32, i32, i32, i32, i32, ptr, ptr, ptr, ptr, ptr]
            lib.nn_bruteforce_f32.restype = i32
            lib.nn_rescore_f32.argtypes = [
                ptr, ptr, ptr, ptr, i32, i32, i32, ptr, ptr, ptr, ptr]
            lib.nn_rescore_f32.restype = i32
            lib.gn_accum_f32.argtypes = [
                ptr, ptr, ptr, ptr, i32, i32, ptr, ptr, ptr, ptr]
            lib.gn_accum_f32.restype = i32
            lib.nn_bf16_f32.argtypes = [
                ptr, ptr, i32, i32, i32, ptr, ptr, ptr, ptr, ptr]
            lib.nn_bf16_f32.restype = i32
            lib.icp_fused_max_blocks.argtypes = [i32, ptr]
            lib.icp_fused_max_blocks.restype = i32
            lib.icp_fused_f32.argtypes = [
                ptr, i32, ptr, ptr, ptr, i32, ptr, ptr, ptr, i32, i32, ptr,
                ptr, ptr]
            lib.icp_fused_f32.restype = i32
            lib.coop_probe_f32.argtypes = [ptr, ptr, ptr, ptr, i32, ptr, ptr,
                                           ptr]
            lib.coop_probe_f32.restype = i32
            _lib = lib
        return _lib


def check(err: int, name: str) -> None:
    """Raise if a kernel entry point returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def require_points(name: str, **clouds: torch.Tensor) -> None:
    """Raise unless every cloud is a non-empty contiguous (·, 3) float32
    tensor on one CUDA device: what the kernels take."""
    device = next(iter(clouds.values())).device
    for arg, t in clouds.items():
        if t.device.type != "cuda" or t.dtype != torch.float32:
            raise ValueError(f"{name}: {arg} must be float32 on CUDA, "
                             f"got {t.dtype} on {t.device}")
        if t.dim() != 2 or t.shape[1] != 3 or not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous (·, 3), got "
                             f"{tuple(t.shape)}")
        if t.device != device:
            raise ValueError(f"{name}: inputs on different devices")
        if t.shape[0] == 0:
            raise ValueError(f"{name}: {arg} is empty")


def require_batched_points(name: str, src: torch.Tensor,
                           dst: torch.Tensor) -> None:
    """Raise unless src (B, M, 3) and dst (B/G, N, 3) are non-empty
    contiguous float32 tensors on one CUDA device with B a multiple of
    dst's batch: what the batched kernels take."""
    if src.dim() != 3 or dst.dim() != 3:
        raise ValueError(f"{name}: batched src and dst must both be "
                         f"(·, ·, 3), got {tuple(src.shape)}, "
                         f"{tuple(dst.shape)}")
    if 0 in (src.shape[0], dst.shape[0]) or src.shape[0] % dst.shape[0]:
        raise ValueError(f"{name}: src batch {src.shape[0]} is not a "
                         f"multiple of dst batch {dst.shape[0]}")
    if src.shape[0] > 65535:
        raise ValueError(f"{name}: batch {src.shape[0]} > 65535")
    require_points(name, src=src[0], dst=dst[0])
    for arg, t in (("src", src), ("dst", dst)):
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
