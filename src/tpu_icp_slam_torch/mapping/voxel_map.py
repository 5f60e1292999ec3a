"""Fixed-capacity voxel-deduplicated 3D map (port of
tpu_icp_slam/mapping/voxel_map.py, sort-based insert, exact extract and a
top-down PNG render).

The map is a static-shape point store (capacity C) with a validity mask.
Insert concatenates map + scan, sorts by quantized voxel key (stable, map
points first so they win their voxel), keeps the first point per voxel and
compacts back to capacity, evicting the points farthest from the sensor.
The reference's `jnp.lexsort` becomes one stable sort on a packed int64
key; the results are bitwise those of the reference.
"""

from __future__ import annotations

import dataclasses
import struct
import zlib

import numpy as np
import torch

from tpu_icp_slam_torch.core.pointcloud import PAD_COORD

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
    same_as_prev[0] = False
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


def extract_local(vm: VoxelMap, center: torch.Tensor, size: int,
                  radius: float = 0.0):
    """Nearest `size` map points to `center`:
    (pts (S, 3), nrm (S, 3), msk (S,), r_cover ()).

    The selection is a stable ascending sort of the distances — the
    reference's `lax.top_k(-d2)` with its lower-index-first tie rule — and
    the selected points are then re-sorted into map order (the reference's
    rescore NN depends on that adjacency). r_cover is the distance to the
    farthest selected point, or inf while the map holds no more than `size`
    points (everything known is in the model).
    """
    diff = vm.points - center[None, :]
    d2 = torch.sum(diff * diff, dim=-1)
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
    _write_png(path, img)


def _write_png(path: str, rgb) -> None:
    """(H, W, 3) uint8 -> PNG file: signature, IHDR (8-bit RGB), one zlib
    IDAT of unfiltered rows, IEND."""
    h, w, _ = rgb.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           rgb.reshape(h, w * 3)], axis=1)

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    with open(path, "wb") as fh:
        fh.write(b"\x89PNG\r\n\x1a\n"
                 + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                 + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
                 + chunk(b"IEND", b""))
