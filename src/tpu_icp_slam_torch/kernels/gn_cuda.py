"""K2: point-to-plane Gauss-Newton accumulation — CUDA kernel and plain version.

`gn_accum(p, q, n, w)` launches csrc/gn_accum.cu on CUDA tensors (the port
of tpu_icp_slam/kernels/gn_pallas.py::_gn_kernel) and runs `gn_accum_ref`
on CPU tensors: H = Σ w JᵀJ, g = Σ w r J with J = [n, p×n], r = n·(p−q).

A call is one launch. Its scratch (one (27,) partial per block) and the
ticket that elects the block summing them are allocated per device and
reused: calls on one stream never overlap, and the port runs on one stream.
A CUDA graph that captured a call keeps writing through that call's
scratch pointers, so no scratch is ever freed: a larger batch gets new
buffers and the old ones are kept for the life of the process.

Batched form (the sharded align's local rows; the reference vmaps
gn_accum_pallas over them, one pallas_call with the batch on its grid):
p, q, n (B, M, 3) and w (B, M) -> H (B, 6, 6), g (B, 6) in one launch, the
batch on the grid's y axis, one partial slab and one ticket a row. Row b is
bit-equal to the unbatched call on row b. The device's scratch grows to the
largest B seen.
"""

from __future__ import annotations

import torch

from tpu_icp_slam_torch.kernels import _build

_SUMS = 27  # 21 upper-triangle entries of H + 6 of g

_scratch: dict[torch.device, tuple[torch.Tensor, torch.Tensor]] = {}
_outgrown: list = []  # scratch a captured graph may still use: never freed


def _device_scratch(device: torch.device, batch: int = 1
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """(partials (B, 2 * SMs, 27) float32, tickets (B,) int32 at 0) of a
    CUDA device for at least `batch` rows: made on the first call and
    remade larger when a call needs more rows (every call leaves its
    tickets at 0)."""
    have = _scratch.get(device)
    if have is None or have[1].shape[0] < batch:
        if have is not None:
            _outgrown.append(have)
        have = (torch.empty((batch, 2 * _build.sm_count(device.index), _SUMS),
                            dtype=torch.float32, device=device),
                torch.zeros(batch, dtype=torch.int32, device=device))
        _scratch[device] = have
    return have


def gn_accum_ref(p: torch.Tensor, q: torch.Tensor, n: torch.Tensor,
                 w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain torch: (M, 3) p/q/n + (M,) w -> (H (6, 6), g (6,)) f32;
    batched (B, M, 3) + (B, M) -> (H (B, 6, 6), g (B, 6))."""
    r = torch.sum(n * (p - q), dim=-1)
    J = torch.cat([n, torch.linalg.cross(p, n, dim=-1)], dim=-1)  # (.., M, 6)
    Jw = J * w[..., None]
    if p.dim() == 2:
        return J.T @ Jw, Jw.T @ r
    return J.mT @ Jw, (Jw.mT @ r[..., None])[..., 0]


def gn_accum(p: torch.Tensor, q: torch.Tensor, n: torch.Tensor,
             w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(M, 3) p/q/n + (M,) w f32 -> (H (6, 6), g (6,)); batched (B, M, 3) +
    (B, M) -> (H (B, 6, 6), g (B, 6)), one launch. CPU tensors take the
    plain version."""
    if all(t.device.type == "cpu" for t in (p, q, n, w)):
        return gn_accum_ref(p, q, n, w)
    if p.dim() not in (2, 3) or (p.dim() == 3 and not 0 < p.shape[0]
                                 <= 65535):
        raise ValueError(f"gn_accum: p must be (M, 3) or (B, M, 3) with "
                         f"0 < B <= 65535, got {tuple(p.shape)}")
    lead, m = tuple(p.shape[:-2]), p.shape[-2]
    for name, t, shape in (("p", p, (*lead, m, 3)), ("q", q, (*lead, m, 3)),
                           ("n", n, (*lead, m, 3)), ("w", w, (*lead, m))):
        if t.device != p.device or t.device.type != "cuda":
            raise ValueError(f"gn_accum: {name} must be on p's CUDA device, "
                             f"got {t.device}")
        if t.dtype != torch.float32 or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(f"gn_accum: {name} must be contiguous float32 "
                             f"{shape}, got {t.dtype} {tuple(t.shape)}")
    batch = lead[0] if lead else 1
    lib = _build.load()
    partial, ticket = _device_scratch(p.device, batch)
    n_blocks = max(1, min(-(-m // 256), partial.shape[1]))
    out = torch.empty((batch, 42), dtype=torch.float32, device=p.device)
    err = lib.gn_accum_batched_f32(
        p.data_ptr(), q.data_ptr(), n.data_ptr(), w.data_ptr(), m, batch,
        n_blocks, partial.data_ptr(), ticket.data_ptr(), out.data_ptr(),
        out.data_ptr() + 36 * batch * 4,
        torch.cuda.current_stream(p.device).cuda_stream)
    _build.check(err, "gn_accum_batched_f32")
    gn_accum.launches += 1
    flat = out.view(-1)
    H = flat[:36 * batch].view(*lead, 6, 6)
    g = flat[36 * batch:].view(*lead, 6)
    if lead:
        gn_accum.batched_launches += 1
    return H, g


gn_accum.launches = 0  # every launch
gn_accum.batched_launches = 0  # launches of the batched form
