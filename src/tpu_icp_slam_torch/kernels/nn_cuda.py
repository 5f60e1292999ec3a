"""K1: exact brute-force nearest neighbour — CUDA kernel and plain version.

`nn_bruteforce(src, dst)` launches csrc/nn_bruteforce.cu on CUDA tensors
(the port of tpu_icp_slam/kernels/nn_pallas.py::_nn_kernel, "highest" mode)
and runs `nn_bruteforce_ref` on CPU tensors. Both score the exact
difference form Σ(a-b)² and break ties toward the lowest index; see the
kernel source for how that relates to the reference's factored form.

Points are 3-D or 2-D (D = 2: the 2D lidar pipelines; the kernel takes D as
a template parameter, and its 2-D results equal the plain version's bit for
bit).

Batched form (loop-closure verification, the reference's vmap over align):
src (B, M, D) and dst (B/G, N, D); source b is searched in target b // G,
so G consecutive batch rows share one target. One launch serves the whole
batch, and each element gives what the unbatched call gives on it.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tpu_icp_slam_torch.kernels import _build


def _nn_one(src: torch.Tensor, dst: torch.Tensor, chunk: int
            ) -> tuple[torch.Tensor, torch.Tensor]:
    idx_out, d2_out = [], []
    for a in torch.split(src, chunk):
        # Σ (a_k - b_k)² summed in coordinate order, one rounding a step
        diff = a[:, None, 0] - dst[None, :, 0]
        d = diff * diff  # (chunk, N)
        for k in range(1, src.shape[-1]):
            diff = a[:, None, k] - dst[None, :, k]
            d = d + diff * diff
        d2, idx = torch.min(d, dim=1)  # first minimum on ties
        idx_out.append(idx.to(torch.int32))
        d2_out.append(d2)
    return torch.cat(idx_out), torch.cat(d2_out)


def nn_bruteforce_ref(src: torch.Tensor, dst: torch.Tensor,
                      chunk: int = 2048) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain torch: (M, D), (N, D) f32 -> (idx (M,) int32, d2 (M,) f32),
    over (chunk, N) distance tiles; batched (B, M, D), (B/G, N, D) ->
    (B, M) element by element."""
    if src.dim() == 2:
        return _nn_one(src, dst, chunk)
    group = src.shape[0] // dst.shape[0]
    out = [_nn_one(s, dst[b // group], chunk) for b, s in enumerate(src)]
    return (torch.stack([o[0] for o in out]),
            torch.stack([o[1] for o in out]))


# Grid constants of csrc/nn_bruteforce.cu (kBlockRows, kSplitAlign).
_BLOCK_ROWS = 1024
_SPLIT_ALIGN = 4
_MIN_SPLIT = 256  # fewest targets a split is cut to
_BLOCK_OVERHEAD = 64  # a block's staging, rescan and store, in targets


@functools.cache
def blocks_per_sm(index: int, dim: int = 3) -> int:
    """Blocks of K1's split kernel for dim-D points that one SM of CUDA
    device `index` holds at once, read once."""
    out = ctypes.c_int(0)
    with torch.cuda.device(index):
        _build.check(_build.load().nn_bruteforce_blocks_per_sm(
            dim, ctypes.addressof(out)), "nn_bruteforce_blocks_per_sm")
    return max(1, out.value)


@functools.lru_cache(maxsize=256)
def n_split(m: int, n: int, batch: int, sms: int, resident: int) -> int:
    """Target-axis splits of K1's grid, each a multiple of _SPLIT_ALIGN
    targets and none empty. Among the counts that give at least three
    blocks per SM (and splits of at least _MIN_SPLIT targets), the one with
    the least modelled time: the blocks the busiest SM runs (rounded up to
    whole waves of `resident` once they do not fit at once) times a block's
    targets plus _BLOCK_OVERHEAD, the fewest splits on a tie."""
    items = -(-m // _BLOCK_ROWS) * batch
    s_max = max(1, -(-n // _MIN_SPLIT))
    s_lo = min(max(1, -(-3 * sms // items)), s_max)

    def length(s: int) -> int:
        return -(-(-(-n // s)) // _SPLIT_ALIGN) * _SPLIT_ALIGN

    def cost(s: int) -> int:
        per_sm = -(-(items * s) // sms)
        if per_sm > resident:
            per_sm = resident * -(-per_sm // resident)
        return per_sm * (length(s) + _BLOCK_OVERHEAD)

    s = min(range(s_lo, s_max + 1), key=lambda s: (cost(s), s))
    return -(-n // length(s))


def nn_bruteforce(src: torch.Tensor, dst: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """(M, D), (N, D) f32 -> (idx (M,) int32, d2 (M,) f32), D = 2 or 3: the
    nearest dst point of every src point; batched (B, M, D), (B/G, N, D) ->
    (B, M). CPU tensors take the plain version."""
    if src.device.type == "cpu" and dst.device.type == "cpu":
        return nn_bruteforce_ref(src, dst)
    batched = src.dim() == 3
    if batched:
        _build.require_batched_points("nn_bruteforce", src, dst, dims=(2, 3))
        batch, group = src.shape[0], src.shape[0] // dst.shape[0]
    else:
        _build.require_points("nn_bruteforce", (2, 3), src=src, dst=dst)
        batch, group = 1, 1
    m, n, dim = src.shape[-2], dst.shape[-2], src.shape[-1]
    lib = _build.load()
    s = n_split(m, n, batch, _build.sm_count(src.device.index),
                blocks_per_sm(src.device.index, dim))
    lead = src.shape[:-2]
    part_d2 = torch.empty((batch, s, m), dtype=torch.float32,
                          device=src.device)
    part_idx = torch.empty((batch, s, m), dtype=torch.int32,
                           device=src.device)
    d2 = torch.empty((*lead, m), dtype=torch.float32, device=src.device)
    idx = torch.empty((*lead, m), dtype=torch.int32, device=src.device)
    stream = torch.cuda.current_stream(src.device).cuda_stream
    err = lib.nn_bruteforce_f32(
        src.data_ptr(), dst.data_ptr(), batch, group, m, n, dim, s,
        part_d2.data_ptr(), part_idx.data_ptr(), d2.data_ptr(),
        idx.data_ptr(), stream)
    _build.check(err, "nn_bruteforce_f32")
    nn_bruteforce.launches += 1
    nn_bruteforce.batched_launches += batched
    nn_bruteforce.launches_2d += dim == 2
    return idx, d2


nn_bruteforce.launches = 0  # every launch
nn_bruteforce.batched_launches = 0  # launches of the batched form
nn_bruteforce.launches_2d = 0  # launches on 2-D points, either form
