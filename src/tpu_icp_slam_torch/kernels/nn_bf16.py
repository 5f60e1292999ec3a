"""K3: nearest neighbour on recentred, hi/lo-packed bf16 operands — CUDA
kernel and plain version.

`nn_bf16(src, dst)` is the port of nn_bruteforce_pallas(precision="bf16")
(tpu_icp_slam/kernels/nn_pallas.py:232-245, :279-314, :398-400): both clouds
are recentred on the bounding-box midpoint of the valid targets, packed into
16-lane bf16 rows whose dot product is ≈ d² (see csrc/packed_d2.cuh), and
the lowest score wins, ties to the lowest index. CUDA tensors launch
csrc/nn_bf16.cu; CPU tensors run `nn_bf16_ref`, which casts the same packed
operands to float32 and takes a chunked float32 product (TF32 is off
package-wide). The packing helpers also serve K5 (kernels/icp_fused.py).
"""

from __future__ import annotations

import torch

from tpu_icp_slam_torch.kernels import _build

LANES = 16
VALID_ABS = 1.0e5  # |coordinate| at or above this marks a padded target


def _split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Dekker split x = hi + lo; both halves bf16, round to nearest even."""
    hi = x.to(torch.bfloat16)
    return hi, (x - hi.to(torch.float32)).to(torch.bfloat16)


def _lanes(cols: list[torch.Tensor]) -> torch.Tensor:
    n = cols[0].shape[0]
    pad = torch.zeros((n, LANES - sum(c.shape[1] for c in cols)),
                      dtype=torch.bfloat16, device=cols[0].device)
    return torch.cat([*cols, pad], dim=1)


def _sq(x: torch.Tensor) -> torch.Tensor:
    """|x|² (N, 1) as (x·x + y·y) + z·z, each product and sum rounded to
    float32 on its own: the order the device packing (csrc/nn_shortlist.cu,
    packed_d2.cuh) writes out, so that both give the same bits."""
    sq = (x[:, 0] * x[:, 0] + x[:, 1] * x[:, 1]) + x[:, 2] * x[:, 2]
    return sq[:, None]


def pack_source(a: torch.Tensor) -> torch.Tensor:
    """(M, 3) f32 -> (M, 16) bf16 [-2a_hi, -2a_lo, -2a_hi, |a|²_hi,
    |a|²_lo, 1, 1, 0...]."""
    hi, lo = _split(a)
    sq_hi, sq_lo = _split(_sq(a))
    one = torch.ones_like(sq_hi)
    return _lanes([-2 * hi, -2 * lo, -2 * hi, sq_hi, sq_lo, one, one])


def pack_target(b: torch.Tensor) -> torch.Tensor:
    """(N, 3) f32 -> (N, 16) bf16 [b_hi, b_hi, b_lo, 1, 1, |b|²_hi,
    |b|²_lo, 0...]."""
    hi, lo = _split(b)
    sq_hi, sq_lo = _split(_sq(b))
    one = torch.ones_like(sq_hi)
    return _lanes([hi, hi, lo, one, one, sq_hi, sq_lo])


def valid_centre(dst: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Bounding-box midpoint (3,) of the rows of dst where valid (N, 1) is
    set; zero if none is."""
    lo = torch.amin(torch.where(valid, dst, 3.0e38), dim=0)
    hi = torch.amax(torch.where(valid, dst, -3.0e38), dim=0)
    return torch.where(torch.any(valid), 0.5 * (lo + hi), 0.0)


def recentre(src: torch.Tensor, dst: torch.Tensor
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Shift both clouds by the bounding-box midpoint of the valid targets
    (all |coordinates| < 1e5)."""
    c = valid_centre(dst, torch.all(torch.abs(dst) < VALID_ABS, dim=1,
                                    keepdim=True))
    return src - c, dst - c


def packed_argmin_ref(a_aug: torch.Tensor, b_aug: torch.Tensor,
                      chunk: int = 2048) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain torch: (M, 16), (N, 16) bf16 -> (idx (M,) int32, e_min (M,)
    f32), the first minimum of the float32 product a_aug · b_augᵀ."""
    b = b_aug.to(torch.float32)
    idx_out, e_out = [], []
    for a in torch.split(a_aug.to(torch.float32), chunk):
        e, idx = torch.min(a @ b.T, dim=1)
        idx_out.append(idx.to(torch.int32))
        e_out.append(e)
    return torch.cat(idx_out), torch.cat(e_out)


def nn_bf16_ref(src: torch.Tensor, dst: torch.Tensor, chunk: int = 2048
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain torch: (M, 3), (N, 3) f32 -> (idx (M,) int32, d2 (M,) f32)."""
    s, d = recentre(src, dst)
    idx, e = packed_argmin_ref(pack_source(s), pack_target(d), chunk=chunk)
    return idx, torch.clamp(e, min=0.0)


def _n_split(m: int, n: int, device: torch.device) -> int:
    """Target-axis splits so that about four blocks (256 rows each) run per
    SM."""
    blocks_x = -(-m // 256)
    return max(1, min(-(-4 * _build.sm_count(device.index) // blocks_x),
                      -(-n // 256)))


def nn_bf16(src: torch.Tensor, dst: torch.Tensor
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """(M, 3), (N, 3) f32 -> (idx (M,) int32, d2 (M,) f32): the nearest dst
    point of every src point under bf16 packed scoring. CPU tensors take the
    plain version."""
    if src.device.type == "cpu" and dst.device.type == "cpu":
        return nn_bf16_ref(src, dst)
    _build.require_points("nn_bf16", src=src, dst=dst)
    m, n = src.shape[0], dst.shape[0]
    s, d = recentre(src, dst)
    a_aug, b_aug = pack_source(s), pack_target(d)
    lib = _build.load()
    k = _n_split(m, n, src.device)
    part_d2 = torch.empty((k, m), dtype=torch.float32, device=src.device)
    part_idx = torch.empty((k, m), dtype=torch.int32, device=src.device)
    e = torch.empty(m, dtype=torch.float32, device=src.device)
    idx = torch.empty(m, dtype=torch.int32, device=src.device)
    stream = torch.cuda.current_stream(src.device).cuda_stream
    err = lib.nn_bf16_f32(
        a_aug.data_ptr(), b_aug.data_ptr(), m, n, k, part_d2.data_ptr(),
        part_idx.data_ptr(), e.data_ptr(), idx.data_ptr(), stream)
    _build.check(err, "nn_bf16_f32")
    nn_bf16.launches += 1
    return idx, torch.clamp(e, min=0.0)


nn_bf16.launches = 0
