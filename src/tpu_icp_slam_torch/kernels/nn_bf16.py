"""K3: nearest neighbour on recentred, hi/lo-packed bf16 operands — CUDA
kernel and plain version.

`nn_bf16(src, dst)` is the port of nn_bruteforce_pallas(precision="bf16")
(tpu_icp_slam/kernels/nn_pallas.py:232-245, :279-314, :398-400): both clouds
are recentred on the bounding-box midpoint of the valid targets, packed into
16-lane bf16 rows whose dot product is ≈ d² (see csrc/packed_d2.cuh), and
the lowest score wins, ties to the lowest index.

CUDA tensors launch csrc/nn_bf16.cu, four launches and no torch op on the
device: the recentring and packing (bit-equal to `recentre`, `pack_source`
and `pack_target`), the packed score on the tensor cores over `splits`
contiguous target ranges, and the fold of the splits in index order, which
also writes d2 = max(e, 0). The tensor core sums the exact bf16 products in
its own float32 order, so a pick may differ from the plain version's on a
near-tie (packed_mma.near_ties). CPU tensors run `nn_bf16_ref`, which casts
the same packed operands to float32 and takes a chunked float32 product
(TF32 is off package-wide). The packing helpers also serve K4
(kernels/nn_rescore.py) and K5 (kernels/icp_fused.py).

Batched form, the reference's vmap of the same kernel in the sharded align
(one pallas_call with the batch as a leading grid axis): src (B, M, 3) and
dst (B/G, N, 3), row b against target b // G, each target recentred on its
own valid rows. On CUDA tensors it is the same four launches whatever B is,
and row b is bit-equal to the unbatched call on (src[b], dst[b // G]); the
plain version computes each row as its unbatched call does.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tpu_icp_slam_torch.kernels import _build

LANES = 16
VALID_ABS = 1.0e5  # |coordinate| at or above this marks a padded target


def _split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Dekker split x = hi + lo; both halves bf16, round to nearest even."""
    hi = x.to(torch.bfloat16)
    return hi, (x - hi.to(torch.float32)).to(torch.bfloat16)


def hi_lo(x: torch.Tensor) -> torch.Tensor:
    """x rebuilt in float32 from its bf16 halves, hi + lo: what K5's bf16
    gather returns (icp_fused_pallas.py:452-459, _split_hi_lo at :90-93)."""
    hi, lo = _split(x)
    return hi.to(torch.float32) + lo.to(torch.float32)


def _lanes(cols: list[torch.Tensor]) -> torch.Tensor:
    lead = cols[0].shape[:-1]
    pad = torch.zeros((*lead, LANES - sum(c.shape[-1] for c in cols)),
                      dtype=torch.bfloat16, device=cols[0].device)
    return torch.cat([*cols, pad], dim=-1)


def _sq(x: torch.Tensor) -> torch.Tensor:
    """|x|² (..., N, 1) as (x·x + y·y) + z·z, each product and sum rounded
    to float32 on its own: the order the device packing
    (csrc/packed_prep.cuh) writes out, so that both give the same bits."""
    sq = (x[..., 0] * x[..., 0] + x[..., 1] * x[..., 1]) \
        + x[..., 2] * x[..., 2]
    return sq[..., None]


def pack_source(a: torch.Tensor) -> torch.Tensor:
    """(..., M, 3) f32 -> (..., M, 16) bf16 [-2a_hi, -2a_lo, -2a_hi,
    |a|²_hi, |a|²_lo, 1, 1, 0...]."""
    hi, lo = _split(a)
    sq_hi, sq_lo = _split(_sq(a))
    one = torch.ones_like(sq_hi)
    return _lanes([-2 * hi, -2 * lo, -2 * hi, sq_hi, sq_lo, one, one])


def pack_target(b: torch.Tensor) -> torch.Tensor:
    """(..., N, 3) f32 -> (..., N, 16) bf16 [b_hi, b_hi, b_lo, 1, 1,
    |b|²_hi, |b|²_lo, 0...]."""
    hi, lo = _split(b)
    sq_hi, sq_lo = _split(_sq(b))
    one = torch.ones_like(sq_hi)
    return _lanes([hi, hi, lo, one, one, sq_hi, sq_lo])


def valid_centre(dst: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Bounding-box midpoint (..., 3) of the rows of dst (..., N, 3) where
    valid (..., N, 1) is set, each target on its own; zero for a target
    with no valid row."""
    lo = torch.amin(torch.where(valid, dst, 3.0e38), dim=-2)
    hi = torch.amax(torch.where(valid, dst, -3.0e38), dim=-2)
    return torch.where(torch.any(valid, dim=-2), 0.5 * (lo + hi), 0.0)


def recentre(src: torch.Tensor, dst: torch.Tensor
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Shift both clouds by the bounding-box midpoint of the valid targets
    (all |coordinates| < 1e5). Batched, src (B, M, 3) and dst (B/G, N, 3):
    each target has its own centre, and source row b takes target b // G's,
    as the reference's vmap of its whole wrapper computes."""
    c = valid_centre(dst, torch.all(torch.abs(dst) < VALID_ABS, dim=-1,
                                    keepdim=True))
    if dst.dim() == 2:
        return src - c, dst - c
    cs = c.repeat_interleave(src.shape[0] // dst.shape[0], dim=0)
    return src - cs[:, None], dst - c[:, None]


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


def packed_argmin_batched_ref(a_aug: torch.Tensor, b_aug: torch.Tensor,
                              chunk: int = 2048
                              ) -> tuple[torch.Tensor, torch.Tensor]:
    """`packed_argmin_ref` of each row: (B, M, 16) against (B/G, N, 16)
    bf16 -> (idx (B, M) int32, e_min (B, M) f32), row b against b // G."""
    group = a_aug.shape[0] // b_aug.shape[0]
    out = [packed_argmin_ref(a, b_aug[b // group], chunk)
           for b, a in enumerate(a_aug)]
    return (torch.stack([o[0] for o in out]),
            torch.stack([o[1] for o in out]))


def nn_bf16_ref(src: torch.Tensor, dst: torch.Tensor, chunk: int = 2048
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain torch: (M, 3), (N, 3) f32 -> (idx (M,) int32, d2 (M,) f32);
    batched (B, M, 3), (B/G, N, 3) -> (B, M), row b against target b // G,
    each row what the unbatched call gives on it."""
    s, d = recentre(src, dst)
    argmin = packed_argmin_ref if src.dim() == 2 else packed_argmin_batched_ref
    idx, e = argmin(pack_source(s), pack_target(d), chunk=chunk)
    return idx, torch.clamp(e, min=0.0)


SCAN_ROWS = 128  # source rows of one work item of the scan (kScanRows)
SPLIT_ALIGN = 16  # targets; a split's length is a multiple of this
SPLIT_MIN = 256  # targets; the scan's staged tile (kScanTile)
# The scan's partials, (splits, source rows): each split's first minimum of
# the packed score and its target index.
PARTIALS = {"part_e": (torch.float32, ("k", "m")),
            "part_idx": (torch.int32, ("k", "m"))}
# K3's scratch, carved from one device buffer: name -> (dtype, shape), the
# shape in m (source rows), n (target rows) and k (splits).
_SCRATCH = {"centre": (torch.float32, (3,)),
            "a_aug": (torch.bfloat16, ("m", LANES)),
            "b_aug": (torch.bfloat16, ("n", LANES)), **PARTIALS}


def splits(m: int, n: int, sms: int, per_sm: int, batch: int = 1
           ) -> tuple[int, int]:
    """(k, length): the contiguous target splits of the scan for an (m, n)
    search of `batch` rows on a card of `sms` SMs that holds `per_sm` scan
    blocks an SM. The work items, batch x ceil(m / 128) source tiles x k
    splits, fill the sms x per_sm resident blocks without starting a
    second, partial wave: k = floor(sms x per_sm / source tiles), at least
    1 and at most one split per staged tile of 256 targets (a shorter split
    restages its 128 source rows for fewer scores and lengthens the fold).
    Split s covers [s x length, min(n, (s + 1) x length)): length is a
    multiple of 16, and no split is empty. A pick does not depend on the
    split (ties go to the lowest index over the same scores)."""
    tiles = batch * -(-m // SCAN_ROWS)
    k = max(1, min(sms * per_sm // tiles, -(-n // SPLIT_MIN)))
    length = -(-(-(-n // k)) // SPLIT_ALIGN) * SPLIT_ALIGN
    return -(-n // length), length


@functools.cache
def blocks_per_sm(index: int) -> int:
    """Blocks of the scan kernel (csrc/packed_scan.cuh, K3's and K4's) that
    one SM of CUDA device `index` holds at once, read once."""
    out = ctypes.c_int(0)
    with torch.cuda.device(index):
        _build.check(_build.load().packed_scan_blocks_per_sm(
            ctypes.addressof(out)), "packed_scan_blocks_per_sm")
    return max(1, out.value)


def scan_grid(m: int, parts: int, index: int, batch: int = 1) -> int:
    """The scan's persistent grid over batch x ceil(m / 128) x parts work
    items on CUDA device `index`: one block per item, at most as many as it
    holds at once."""
    return min(batch * -(-m // SCAN_ROWS) * parts,
               _build.sm_count(index) * blocks_per_sm(index))


def _workspace(m: int, n: int, k: int, device: torch.device,
               batch: tuple[int, int] | None = None):
    """K3's scratch buffer and its layout, name -> (byte offset, dtype,
    shape), each array 256-byte aligned. batch = (B, B/G) gives every array
    a leading axis: B/G for the centre and b_aug, B for the rest."""
    if batch is None:
        return _build.workspace(_SCRATCH, {"m": m, "n": n, "k": k}, device)
    spec = _build.batched(_SCRATCH, ("centre", "b_aug"))
    return _build.workspace(spec, {"m": m, "n": n, "k": k, "b": batch[0],
                                   "t": batch[1]}, device)


def _launch(src, dst, keep):
    if src.dim() == 3:
        _build.require_batched_points("nn_bf16", src, dst)
        batch, targets = src.shape[0], dst.shape[0]
    else:
        _build.require_points("nn_bf16", src=src, dst=dst)
        batch, targets = 1, 1
    lead = tuple(src.shape[:-2])
    m, n = src.shape[-2], dst.shape[-2]
    index = src.device.index
    k, length = splits(m, n, _build.sm_count(index), blocks_per_sm(index),
                       batch)
    ws, layout = _workspace(m, n, k, src.device,
                            (batch, targets) if lead else None)
    ptr = _build.pointers(ws, layout)
    idx = torch.empty((*lead, m), dtype=torch.int32, device=src.device)
    d2 = torch.empty((*lead, m), dtype=torch.float32, device=src.device)
    e_min = (torch.empty((*lead, m), dtype=torch.float32, device=src.device)
             if keep else None)
    err = _build.load().nn_bf16_batched_f32(
        src.data_ptr(), dst.data_ptr(), m, n, batch, batch // targets, k,
        length, scan_grid(m, k, index, batch), ptr["centre"], ptr["a_aug"],
        ptr["b_aug"], ptr["part_e"], ptr["part_idx"],
        None if e_min is None else e_min.data_ptr(), idx.data_ptr(),
        d2.data_ptr(), torch.cuda.current_stream(src.device).cuda_stream)
    _build.check(err, "nn_bf16_batched_f32")
    nn_bf16.launches += 1
    nn_bf16.batched_launches += bool(lead)
    if not keep:
        return idx, d2
    return {"idx": idx, "d2": d2, "e_min": e_min,
            **_build.views(ws, layout)}


def nn_bf16(src: torch.Tensor, dst: torch.Tensor
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """(M, 3), (N, 3) f32 -> (idx (M,) int32, d2 (M,) f32): the nearest dst
    point of every src point under bf16 packed scoring; batched (B, M, 3),
    (B/G, N, 3) -> (B, M), row b against target b // G, one call of four
    launches whatever B is. CPU tensors take the plain version."""
    if src.device.type == "cpu" and dst.device.type == "cpu":
        return nn_bf16_ref(src, dst)
    return _launch(src, dst, keep=False)


def nn_bf16_detail(src: torch.Tensor, dst: torch.Tensor
                   ) -> dict[str, torch.Tensor]:
    """CUDA only: one call of K3 that also keeps what it computed on the
    way: idx, d2, the raw packed minimum e_min (d2 = max(e_min, 0)), the
    centre, the packed operands a_aug and b_aug (as pack_source and
    pack_target name them) and the split partials part_e, part_idx; each
    with a leading batch axis (the targets' for centre and b_aug) when the
    call is batched."""
    return _launch(src, dst, keep=True)


nn_bf16.launches = 0  # every call (four kernels)
nn_bf16.batched_launches = 0  # calls of the batched form
