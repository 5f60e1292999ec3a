"""Fixed-capacity voxel-deduplicated 3D map (port of
tpu_icp_slam/mapping/voxel_map.py: the sort-based and the hash-probe
insert, the local-model extract and a top-down PNG render).

The map is a static-shape point store (capacity C) with a validity mask.
`insert` concatenates map + scan, sorts by quantized voxel key (stable, map
points first so they win their voxel), keeps the first point per voxel and
compacts back to capacity, evicting the points farthest from the sensor.
The reference's `jnp.lexsort` becomes one stable sort on a packed int64
key. `insert_hash` (mapping.insert_backend="hash") leaves map points in
their slots and finds a scan point's voxel in an open-addressing table
instead. The results of both are bitwise those of the reference.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpu_icp_slam_torch.core.pointcloud import PAD_COORD
from tpu_icp_slam_torch.datasets import png
from tpu_icp_slam_torch.kernels import select_cuda

# quantized voxel coordinates live in [-2^19, 2^19); invalid slots sort last
_QMAX = 1 << 19
_QINVALID = _QMAX + 7
_KEY_BITS = 21  # each biased key lies in [0, 2^20 + 7] < 2^21; 3 x 21 < 63


@dataclasses.dataclass(frozen=True)
class VoxelMap:
    points: torch.Tensor  # (C, 3) world frame; PAD_COORD sentinel when invalid
    normals: torch.Tensor  # (C, 3) world frame; zeros when unknown
    mask: torch.Tensor  # (C,) bool

    @property
    def capacity(self) -> int:
        return self.points.shape[0]


def create(capacity: int, *, device: torch.device | str = "cuda") -> VoxelMap:
    return VoxelMap(
        points=torch.full((capacity, 3), PAD_COORD, dtype=torch.float32,
                          device=device),
        normals=torch.zeros((capacity, 3), dtype=torch.float32, device=device),
        mask=torch.zeros(capacity, dtype=torch.bool, device=device),
    )


def _quantize(pts: torch.Tensor, msk: torch.Tensor, voxel: float):
    q = torch.floor(pts / voxel).to(torch.int32)
    q = torch.clamp(q, -_QMAX, _QMAX - 1)
    return torch.where(msk[:, None], q, torch.full_like(q, _QINVALID))


def _voxel_key(q: torch.Tensor) -> torch.Tensor:
    """Pack (q0, q1, q2) into one int64 whose order is their lexicographic
    order (q0 most significant)."""
    b = q.to(torch.int64) + _QMAX
    return (b[:, 0] << (2 * _KEY_BITS)) | (b[:, 1] << _KEY_BITS) | b[:, 2]


def insert(vm: VoxelMap, pts: torch.Tensor, msk: torch.Tensor,
           nrm: torch.Tensor, *, voxel: float,
           center: torch.Tensor | None = None) -> VoxelMap:
    """Merge a world-frame scan into the map with voxel dedup.

    Existing map points win ties inside a voxel. On overflow, with `center`
    the `cap` points nearest the sensor survive; without it the earliest
    inserted do.
    """
    cap = vm.capacity
    all_pts = torch.cat([vm.points, pts], dim=0)
    all_nrm = torch.cat([vm.normals, nrm], dim=0)
    all_msk = torch.cat([vm.mask, msk], dim=0)

    q = _quantize(all_pts, all_msk, voxel)
    _, order = torch.sort(_voxel_key(q), stable=True)
    qs = q[order]
    same_as_prev = torch.all(qs == torch.roll(qs, 1, dims=0), dim=1)
    # fill_ on the device: a Python scalar assigned into one element is
    # copied from the host, a sync that no CUDA graph can capture
    same_as_prev[0].fill_(False)
    keep = ~same_as_prev & all_msk[order]

    # keepers first, then by eviction priority (the reference's
    # lexsort((prio, ~keep)) as two stable sorts, last key first)
    if center is not None:
        diff = all_pts[order] - center[None, :]
        prio = torch.sum(diff * diff, dim=-1)  # nearest-to-sensor survives
    else:
        prio = order.to(all_pts.dtype)  # earliest-inserted survives
    rank = torch.sort(prio, stable=True).indices
    rank = rank[torch.sort((~keep[rank]).to(torch.uint8), stable=True).indices]
    chosen = order[rank[:cap]]
    new_msk = keep[rank[:cap]]
    new_pts = torch.where(new_msk[:, None], all_pts[chosen],
                          torch.full_like(all_pts[chosen], PAD_COORD))
    new_nrm = torch.where(new_msk[:, None], all_nrm[chosen],
                          torch.zeros_like(all_nrm[chosen]))
    return VoxelMap(points=new_pts, normals=new_nrm, mask=new_msk)


_U32 = 0xFFFFFFFF
_HASH_MULT = (2654435761, 0x9E3779B1, 0x85EBCA77)


def _mul_u32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2^32 for int64 a in [0, 2^32) and c < 2^32, in halves so
    that no int64 product overflows."""
    lo = (a & 0xFFFF) * c
    hi = ((a >> 16) * c) & 0xFFFF
    return (lo + (hi << 16)) & _U32


def _hash(q: torch.Tensor, tsize: int) -> torch.Tensor:
    """The reference's uint32 voxel hash of (N, 3) int32 keys, mod tsize:
    keys wrap to uint32, products wrap mod 2^32, emulated in int64."""
    u = q.to(torch.int64) & _U32
    h = (_mul_u32(u[:, 0], _HASH_MULT[0]) ^ _mul_u32(u[:, 1], _HASH_MULT[1])
         ^ _mul_u32(u[:, 2], _HASH_MULT[2]))
    return h % tsize


def insert_hash(vm: VoxelMap, pts: torch.Tensor, msk: torch.Tensor,
                nrm: torch.Tensor, *, voxel: float,
                center: torch.Tensor | None = None, table_mult: int = 2,
                probes: int = 8) -> VoxelMap:
    """Hash-probe voxel-dedup insert: map points stay in their slots.

    1. A fresh open-addressing table (table_mult x capacity slots, `probes`
       linear-probe rounds) maps the map's voxel keys to slots, built by
       scatter-min and verified by a gather.
    2. The scan dedups within itself by one small stable sort.
    3. Probing the table drops scan points whose voxel is mapped (the map
       point wins, as in `insert`).
    4. The survivors, nearest the sensor first, go to victim slots: empty
       slots first, then (with `center`) the occupied slots farthest from
       it, each only if its score is worse than the incoming point's.

    A voxel whose key overflows `probes` collisions can rarely be admitted
    twice (a wasted slot, no lost point). Ties keep the reference's order:
    victims by a stable descending sort (`lax.top_k` puts the lower index
    first), survivors by a stable ascending one.
    """
    cap = vm.capacity
    n_new = pts.shape[0]
    tsize = table_mult * cap
    dev = pts.device
    q_map = _quantize(vm.points, vm.mask, voxel)  # (C, 3)
    q_new = _quantize(pts, msk, voxel)  # (N, 3)

    # 1. build: scatter-min claims a slot; each round moves the unplaced to
    # the next probe offset
    empty = cap  # sentinel > any real index
    table = torch.full((tsize,), empty, dtype=torch.int64, device=dev)
    h_map = _hash(q_map, tsize)
    idx_map = torch.arange(cap, dtype=torch.int64, device=dev)
    placed = ~vm.mask
    for p in range(probes):
        slot = (h_map + p) % tsize
        attempt = torch.where(placed, torch.full_like(idx_map, empty),
                              idx_map)
        table.scatter_reduce_(0, slot, attempt, "amin", include_self=True)
        placed = placed | (table[slot] == idx_map)

    # 2. dedup within the scan
    _, order = torch.sort(_voxel_key(q_new), stable=True)
    qs = q_new[order]
    dup = torch.all(qs == torch.roll(qs, 1, dims=0), dim=1)
    dup[0].fill_(False)  # on the device, as in `insert`
    first_of_voxel = torch.zeros(n_new, dtype=torch.bool, device=dev)
    first_of_voxel[order] = ~dup

    # 3. membership: probe the table, verify by the exact key
    h_new = _hash(q_new, tsize)
    present = torch.zeros(n_new, dtype=torch.bool, device=dev)
    for p in range(probes):
        cand = table[(h_new + p) % tsize]  # (N,) slot or `empty`
        cand_q = q_map[torch.clamp(cand, max=cap - 1)]
        present = present | ((cand < cap) & torch.all(cand_q == q_new,
                                                      dim=1))
    need = msk & first_of_voxel & ~present

    # 4. victims and placement
    c = (center if center is not None
         else torch.zeros(3, dtype=pts.dtype, device=dev))
    inf = torch.full((cap,), float("inf"), dtype=pts.dtype, device=dev)
    if center is not None:
        # occupied slots score their distance from the sensor; empty ones
        # +inf, chosen first and always overwritable
        diff = vm.points - c[None, :]
        evict_score = torch.where(vm.mask, torch.sum(diff * diff, dim=-1),
                                  inf)
    else:
        # no eviction: only empty slots are victims
        evict_score = torch.where(vm.mask, -inf, inf)
    k_victims = min(n_new, cap)
    v_score, v_slot = torch.sort(evict_score, descending=True, stable=True)
    v_score, v_slot = v_score[:k_victims], v_slot[:k_victims]
    diff = pts - c[None, :]
    d2_new = torch.sum(diff * diff, dim=-1)
    rank_new = torch.sort(torch.where(need, d2_new, torch.full_like(
        d2_new, float("inf"))), stable=True).indices[:k_victims]
    do = need[rank_new] & (v_score > d2_new[rank_new])  # inf always wins
    tgt = torch.where(do, v_slot, torch.full_like(v_slot, cap))  # cap: drop
    src_pts = torch.where(do[:, None], pts[rank_new],
                          torch.full_like(pts[rank_new], PAD_COORD))
    src_nrm = torch.where(do[:, None], nrm[rank_new],
                          torch.zeros_like(nrm[rank_new]))
    new_points = torch.cat([vm.points, vm.points[:1]])
    new_normals = torch.cat([vm.normals, vm.normals[:1]])
    new_mask = torch.cat([vm.mask, vm.mask[:1]])
    new_points[tgt] = src_pts
    new_normals[tgt] = src_nrm
    new_mask[tgt] = new_mask[tgt] | do
    return VoxelMap(points=new_points[:cap], normals=new_normals[:cap],
                    mask=new_mask[:cap])


def extract_local(vm: VoxelMap, center: torch.Tensor, size: int,
                  radius: float = 0.0, approx: bool = False):
    """Nearest `size` map points to `center`:
    (pts (S, 3), nrm (S, 3), msk (S,), r_cover ()).

    The selection is the reference's `lax.top_k(-d2)` with its
    lower-index-first tie rule, and the kept points are put back into map
    order (the reference's rescore NN depends on that adjacency). r_cover
    is the distance to the farthest selected point, or inf while the map
    holds no more than `size` points (everything known is in the model).

    approx=True (mapping.extract_approx) selects exactly as well. The
    reference's `lax.approx_max_k` keeps ~0.95 of the nearest points on a
    TPU and is an exact top-k on every other backend; the port selects
    exactly on both devices, a stated deviation from the TPU's recall.

    CUDA tensors take EX (kernels/select_cuda.py: a radix select and one
    pass in map order, bit-equal, no fallback), CPU tensors the plain
    version `extract_local_ref`.
    """
    del approx
    if vm.points.device.type == "cpu":
        return extract_local_ref(vm, center, size, radius)
    return select_cuda.local_select(vm.points.contiguous(),
                                    vm.normals.contiguous(),
                                    vm.mask.contiguous(), center, size,
                                    radius)


def extract_local_ref(vm: VoxelMap, center: torch.Tensor, size: int,
                      radius: float = 0.0):
    """extract_local in torch ops: EX's plain version, and the CPU path.
    d² sums the squares in coordinate order, as the reference's sum does
    on the CPU (torch's CUDA sum of three may pair them otherwise)."""
    diff = vm.points - center[None, :]
    d2 = (diff[:, 0] * diff[:, 0] + diff[:, 1] * diff[:, 1]
          + diff[:, 2] * diff[:, 2])
    d2 = torch.where(vm.mask, d2, torch.full_like(d2, float("inf")))
    d2_sel, idx = torch.sort(d2, stable=True)
    d2_sel, idx = d2_sel[:size], idx[:size]
    msk = torch.isfinite(d2_sel)
    if radius > 0.0:
        msk = msk & (d2_sel <= radius * radius)
    full = torch.sum(vm.mask) > size
    zero = torch.zeros((), dtype=d2.dtype, device=d2.device)
    r_sel = torch.sqrt(torch.clamp(
        torch.max(torch.where(msk, d2_sel, zero)), min=0.0))
    r_cover = torch.where(full, r_sel, torch.full_like(r_sel, float("inf")))
    if radius > 0.0:
        r_cover = torch.clamp(r_cover, max=radius)
    big = torch.full_like(idx, torch.iinfo(torch.int32).max)
    order = torch.sort(torch.where(msk, idx, big), stable=True).indices
    idx, msk = idx[order], msk[order]
    pts = torch.where(msk[:, None], vm.points[idx],
                      torch.full_like(vm.points[idx], PAD_COORD))
    nrm = torch.where(msk[:, None], vm.normals[idx],
                      torch.zeros_like(vm.normals[idx]))
    return pts, nrm, msk, r_cover


def count(vm: VoxelMap) -> torch.Tensor:
    return torch.sum(vm.mask.to(torch.int32))


_PNG_SIZE = 1024  # pixels on the longer side of render_png's image


def render_png(vm: VoxelMap, path: str, trajectory=None) -> None:
    """Top-down render of the map as an 8-bit RGB PNG, the longer side
    1,024 pixels: each pixel's highest map point as grey (brighter is
    higher) on black, the trajectory (F, 2+) in red.

    Written with numpy and zlib alone, so it needs no plotting package. It
    is not pixel-equal to the reference's matplotlib scatter plot (no axes,
    no colour map, no legend).
    """
    pts = vm.points[vm.mask].cpu().numpy().astype(np.float64)
    traj = (np.zeros((0, 2)) if trajectory is None
            else np.asarray(trajectory, np.float64)[:, :2])
    xy = np.concatenate([pts[:, :2], traj])
    lo = xy.min(0) if len(xy) else np.zeros(2)
    hi = xy.max(0) if len(xy) else np.ones(2)
    scale = (_PNG_SIZE - 1) / max(float((hi - lo).max()), 1e-6)
    w, h = (np.round((hi - lo) * scale).astype(int) + 1).tolist()

    def pixel(p):  # (N, 2) metres -> rows (y up), cols
        c = np.clip(np.round((p[:, 0] - lo[0]) * scale).astype(int), 0, w - 1)
        r = np.clip(np.round((hi[1] - p[:, 1]) * scale).astype(int), 0, h - 1)
        return r, c

    img = np.zeros((h, w, 3), np.uint8)
    if len(pts):
        z = pts[:, 2]
        t = (z - z.min()) / max(float(z.max() - z.min()), 1e-6)
        grey = np.zeros((h, w), np.uint8)
        np.maximum.at(grey, pixel(pts), (48 + 207 * t).astype(np.uint8))
        img[:] = grey[..., None]
    if len(traj) > 1:
        n = max(int(np.abs(np.diff(traj, axis=0)).max() * scale) + 2, 2)
        s = np.linspace(0.0, 1.0, n)[:, None, None]
        line = (traj[:-1] + s * (traj[1:] - traj[:-1])).reshape(-1, 2)
        r, c = pixel(line)
        img[r, c] = (255, 0, 0)
    png.write_rgb8(path, img)
