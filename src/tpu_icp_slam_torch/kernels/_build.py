"""Build and load the CUDA kernels in `tpu_icp_slam_torch/csrc/`.

Each `csrc/*.cu` file is compiled by its own nvcc process for sm_90a, all
of them at once, and the objects are linked into one shared library with a
plain C interface, loaded with ctypes (no PyTorch headers, so the build
takes seconds). The library lands in
`build/tpu_icp_slam_torch/<sha256 of sources, headers and flags>/libkernels.so`
at the checkout root and is reused while the sources and the shared headers
(`csrc/*.cuh`) are unchanged. A missing nvcc or a failed build raises
with the compiler's output: nothing runs without the kernels.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import math
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
    """Compile the kernels unless a library for these sources exists: one
    nvcc per source, all started together, then one link. verbose prints
    ptxas's register, shared-memory and spill report."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}"
    nvcc = _nvcc()
    compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
    jobs = []
    for src in sources():
        obj = out.with_name(f"{src.stem}.{tag}.o")
        cmd = [nvcc, *compile_flags, *(["-Xptxas", "-v"] if verbose else []),
               "-c", "-o", str(obj), str(src)]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    failed, report = [], []
    for cmd, _, proc in jobs:
        _, err = proc.communicate()
        report.append(err)
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): "
                          f"{' '.join(cmd)}\n{err}")
    try:
        if failed:
            raise RuntimeError("\n".join(failed))
        tmp = out.with_name(f"libkernels.{tag}.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), *(str(o) for _, o, _ in jobs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}): "
                               f"{' '.join(cmd)}\n{proc.stderr}")
    finally:
        for _, obj, _ in jobs:
            obj.unlink(missing_ok=True)
    if verbose:
        print("".join(report), end="")
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
                ptr, ptr, i32, i32, i32, i32, i32, i32, ptr, ptr, ptr, ptr,
                ptr]
            lib.nn_bruteforce_f32.restype = i32
            lib.nn_bruteforce_blocks_per_sm.argtypes = [i32, ptr]
            lib.nn_bruteforce_blocks_per_sm.restype = i32
            lib.nn_rescore_f32.argtypes = [
                ptr, ptr, i32, i32, i32, i32, i32, ptr, ptr, ptr, ptr, ptr,
                ptr, ptr, ptr, ptr, ptr]
            lib.nn_rescore_f32.restype = i32
            lib.nn_rescore_batched_f32.argtypes = [
                ptr, ptr, i32, i32, i32, i32, i32, i32, i32, ptr, ptr, ptr,
                ptr, ptr, ptr, ptr, ptr, ptr, ptr]
            lib.nn_rescore_batched_f32.restype = i32
            lib.packed_scan_blocks_per_sm.argtypes = [ptr]
            lib.packed_scan_blocks_per_sm.restype = i32
            lib.packed_mma_argmin.argtypes = [
                ptr, ptr, i32, i32, i32, i32, i32, ptr, ptr, ptr, ptr, ptr]
            lib.packed_mma_argmin.restype = i32
            lib.gn_accum_batched_f32.argtypes = [
                ptr, ptr, ptr, ptr, i32, i32, i32, ptr, ptr, ptr, ptr, ptr]
            lib.gn_accum_batched_f32.restype = i32
            lib.nn_bf16_batched_f32.argtypes = [
                ptr, ptr, i32, i32, i32, i32, i32, i32, i32, ptr, ptr, ptr,
                ptr, ptr, ptr, ptr, ptr, ptr]
            lib.nn_bf16_batched_f32.restype = i32
            lib.icp_fused_max_blocks.argtypes = [i32, ptr]
            lib.icp_fused_max_blocks.restype = i32
            lib.icp_fused_f32.argtypes = [
                ptr, i32, ptr, ptr, ptr, ptr, i32, ptr, ptr, ptr, i32, i32,
                ptr, ptr, ptr]
            lib.icp_fused_f32.restype = i32
            lib.coop_probe_f32.argtypes = [ptr, ptr, ptr, ptr, i32, ptr, ptr,
                                           ptr]
            lib.coop_probe_f32.restype = i32
            lib.rigid_fit_f32.argtypes = [ptr, ptr, ptr, i32, i32, ptr, ptr]
            lib.rigid_fit_f32.restype = i32
            lib.gn_step_f32.argtypes = [
                ptr, ptr, ptr, ptr, ptr, ptr, i32, ptr, ptr, ptr, ptr, ptr,
                i32, ptr, ptr, ptr, ptr]
            lib.gn_step_f32.restype = i32
            lib.p2p_step_f32.argtypes = [
                ptr, ptr, ptr, ptr, ptr, i32, i32, i32, ptr, ptr, ptr, ptr,
                i32, ptr, ptr, ptr, ptr]
            lib.p2p_step_f32.restype = i32
            f32 = ctypes.c_float
            lib.projective_f32.argtypes = [
                ptr, i32, ptr, ptr, ptr, ptr, f32, f32, i32, i32, f32, ptr,
                f32, ptr, ptr, ptr, ptr, ptr]
            lib.projective_f32.restype = i32
            lib.knn_normals_f32.argtypes = [
                ptr, ptr, i32, i32, i32, ptr, ptr, ptr, ptr, ptr, ptr]
            lib.knn_normals_f32.restype = i32
            lib.local_select_scratch_words.argtypes = [i32]
            lib.local_select_scratch_words.restype = ctypes.c_longlong
            lib.local_select_f32.argtypes = [
                ptr, ptr, ptr, ptr, i32, i32, i32, ctypes.c_uint, f32, ptr,
                ptr, ptr, ptr, ptr, ptr]
            lib.local_select_f32.restype = i32
            _lib = lib
        return _lib


@functools.cache
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device `index`, read once rather
    than on every kernel call."""
    return torch.cuda.get_device_properties(index).multi_processor_count


_ALIGN = 256  # bytes; every array carved from a scratch buffer starts here


def workspace(spec: dict, dims: dict[str, int], device: torch.device):
    """One scratch buffer for the arrays of `spec` (name -> (dtype, shape),
    a shape entry either an int or a key of `dims`) and its layout, name ->
    (byte offset, dtype, shape), each array 256-byte aligned."""
    layout, total = {}, 0
    for name, (dtype, shape) in spec.items():
        shape = tuple(dims.get(d, d) for d in shape)
        layout[name] = (total, dtype, shape)
        total += -(-math.prod(shape) * dtype.itemsize // _ALIGN) * _ALIGN
    return torch.empty(total, dtype=torch.uint8, device=device), layout


def batched(spec: dict, per_target: tuple[str, ...]) -> dict:
    """`spec` with a leading axis on every array: "t" (the targets, B/G)
    for the arrays named in per_target, "b" (the batch rows) for the
    rest."""
    return {name: (dtype, ("t" if name in per_target else "b", *shape))
            for name, (dtype, shape) in spec.items()}


def views(ws: torch.Tensor, layout: dict) -> dict[str, torch.Tensor]:
    """The arrays of a `workspace` buffer as typed tensors."""
    return {name: ws[off:off + math.prod(shape) * dtype.itemsize]
            .view(dtype).view(shape)
            for name, (off, dtype, shape) in layout.items()}


def pointers(ws: torch.Tensor, layout: dict) -> dict[str, int]:
    """The device address of each array of a `workspace` buffer."""
    return {name: ws.data_ptr() + off for name, (off, _, _) in layout.items()}


def check(err: int, name: str) -> None:
    """Raise if a kernel entry point returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def require_points(name: str, dims: tuple = (3,),
                   **clouds: torch.Tensor) -> None:
    """Raise unless every cloud is a non-empty contiguous (·, D) float32
    tensor on one CUDA device, with one D of `dims` for all of them: what
    the kernels take (K1 takes D = 2 or 3, the others D = 3)."""
    first = next(iter(clouds.values()))
    device, d = first.device, first.shape[-1]
    for arg, t in clouds.items():
        if t.device.type != "cuda" or t.dtype != torch.float32:
            raise ValueError(f"{name}: {arg} must be float32 on CUDA, "
                             f"got {t.dtype} on {t.device}")
        if (t.dim() != 2 or t.shape[1] != d or d not in dims
                or not t.is_contiguous()):
            raise ValueError(
                f"{name}: {arg} must be contiguous (·, D) with D one of "
                f"{dims} for every cloud, got {tuple(t.shape)}")
        if t.device != device:
            raise ValueError(f"{name}: inputs on different devices")
        if t.shape[0] == 0:
            raise ValueError(f"{name}: {arg} is empty")


def require_batched_points(name: str, src: torch.Tensor,
                           dst: torch.Tensor, dims: tuple = (3,)) -> None:
    """Raise unless src (B, M, D) and dst (B/G, N, D) are non-empty
    contiguous float32 tensors on one CUDA device with B a multiple of
    dst's batch and D one of `dims`: what the batched kernels take."""
    if src.dim() != 3 or dst.dim() != 3:
        raise ValueError(f"{name}: batched src and dst must both be "
                         f"(·, ·, D), got {tuple(src.shape)}, "
                         f"{tuple(dst.shape)}")
    if 0 in (src.shape[0], dst.shape[0]) or src.shape[0] % dst.shape[0]:
        raise ValueError(f"{name}: src batch {src.shape[0]} is not a "
                         f"multiple of dst batch {dst.shape[0]}")
    if src.shape[0] > 65535:
        raise ValueError(f"{name}: batch {src.shape[0]} > 65535")
    require_points(name, dims, src=src[0], dst=dst[0])
    for arg, t in (("src", src), ("dst", dst)):
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
