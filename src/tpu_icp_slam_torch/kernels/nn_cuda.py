"""K1: exact brute-force nearest neighbour — CUDA kernel and plain version.

`nn_bruteforce(src, dst)` launches csrc/nn_bruteforce.cu on CUDA tensors
(the port of tpu_icp_slam/kernels/nn_pallas.py::_nn_kernel, "highest" mode)
and runs `nn_bruteforce_ref` on CPU tensors. Both score the exact
difference form Σ(a-b)² and break ties toward the lowest index; see the
kernel source for how that relates to the reference's factored form.

Batched form (loop-closure verification, the reference's vmap over align):
src (B, M, 3) and dst (B/G, N, 3); source b is searched in target b // G,
so G consecutive batch rows share one target. One launch serves the whole
batch, and each element gives what the unbatched call gives on it.
"""

from __future__ import annotations

import torch

from tpu_icp_slam_torch.kernels import _build


def _nn_one(src: torch.Tensor, dst: torch.Tensor, chunk: int
            ) -> tuple[torch.Tensor, torch.Tensor]:
    idx_out, d2_out = [], []
    for a in torch.split(src, chunk):
        dx = a[:, None, 0] - dst[None, :, 0]
        dy = a[:, None, 1] - dst[None, :, 1]
        dz = a[:, None, 2] - dst[None, :, 2]
        d = dx * dx + dy * dy + dz * dz  # (chunk, N)
        d2, idx = torch.min(d, dim=1)  # first minimum on ties
        idx_out.append(idx.to(torch.int32))
        d2_out.append(d2)
    return torch.cat(idx_out), torch.cat(d2_out)


def nn_bruteforce_ref(src: torch.Tensor, dst: torch.Tensor,
                      chunk: int = 2048) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain torch: (M, 3), (N, 3) f32 -> (idx (M,) int32, d2 (M,) f32),
    over (chunk, N) distance tiles; batched (B, M, 3), (B/G, N, 3) ->
    (B, M) element by element."""
    if src.dim() == 2:
        return _nn_one(src, dst, chunk)
    group = src.shape[0] // dst.shape[0]
    out = [_nn_one(s, dst[b // group], chunk) for b, s in enumerate(src)]
    return (torch.stack([o[0] for o in out]),
            torch.stack([o[1] for o in out]))


def _n_split(m: int, n: int, device: torch.device, batch: int = 1) -> int:
    """Target-axis splits so that about four blocks run per SM."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    blocks_x = -(-m // 256) * batch
    return max(1, min(-(-4 * sms // blocks_x), -(-n // 256)))


def nn_bruteforce(src: torch.Tensor, dst: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """(M, 3), (N, 3) f32 -> (idx (M,) int32, d2 (M,) f32): the nearest dst
    point of every src point; batched (B, M, 3), (B/G, N, 3) -> (B, M).
    CPU tensors take the plain version."""
    if src.device.type == "cpu" and dst.device.type == "cpu":
        return nn_bruteforce_ref(src, dst)
    batched = src.dim() == 3
    if batched:
        _build.require_batched_points("nn_bruteforce", src, dst)
        batch, group = src.shape[0], src.shape[0] // dst.shape[0]
    else:
        _build.require_points("nn_bruteforce", src=src, dst=dst)
        batch, group = 1, 1
    m, n = src.shape[-2], dst.shape[-2]
    lib = _build.load()
    s = _n_split(m, n, src.device, batch)
    lead = src.shape[:-2]
    part_d2 = torch.empty((batch, s, m), dtype=torch.float32,
                          device=src.device)
    part_idx = torch.empty((batch, s, m), dtype=torch.int32,
                           device=src.device)
    d2 = torch.empty((*lead, m), dtype=torch.float32, device=src.device)
    idx = torch.empty((*lead, m), dtype=torch.int32, device=src.device)
    stream = torch.cuda.current_stream(src.device).cuda_stream
    err = lib.nn_bruteforce_f32(
        src.data_ptr(), dst.data_ptr(), batch, group, m, n, s,
        part_d2.data_ptr(), part_idx.data_ptr(), d2.data_ptr(),
        idx.data_ptr(), stream)
    _build.check(err, "nn_bruteforce_f32")
    nn_bruteforce.launches += 1
    nn_bruteforce.batched_launches += batched
    return idx, d2


nn_bruteforce.launches = 0  # every launch
nn_bruteforce.batched_launches = 0  # launches of the batched form
