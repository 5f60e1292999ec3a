"""Meshes over torch.distributed ranks and their collectives (port of
tpu_icp_slam/dist/mesh.py).

The reference scales through a `jax.sharding.Mesh` and `shard_map`: axis
"dp" batches independent alignments, axis "sp" shards the source points of
the distance matrix, and pose-graph keyframe blocks partition over a
"graph" axis. Here the same program runs on every rank (SPMD over
`torch.distributed`), and a `Mesh` lays the world's ranks out on named
axes with one process sub-group per axis line:

- a reference `lax.psum(x, axis)` is `all_reduce(x, mesh, axis)`;
- a gather over an axis is `all_gather(x, mesh, axis)`, in axis order.

In a world of one rank that has not been initialised, every axis has no
group and each collective is the identity. An initialised world always
calls the collective, one rank included, so a one-rank NCCL run exercises
NCCL's path.

Stated deviations from the reference:
- no silent CPU fallback: asking for more devices than the world has
  ranks raises (the reference warns and swaps to host-CPU devices);
- NCCL refuses two ranks on one card, so a mesh on NCCL whose ranks
  outnumber the host's cards raises; ranks that share a card must ask for
  `backend="gloo"`.
"""

from __future__ import annotations

import collections
import dataclasses
import datetime
import logging
import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist


def _two_way_factor(n: int) -> tuple[int, int]:
    """Largest divisor pair (a, b), a <= b, a*b = n — balanced 2D mesh."""
    best = (1, n)
    for a in range(1, int(np.sqrt(n)) + 1):
        if n % a == 0:
            best = (a, n // a)
    return best


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """Ranks laid out on named axes. `devices` holds the ranks in the
    mesh's shape (the reference's array of devices); `coords` this rank's
    place, None for a rank of the world outside the mesh; `groups` the
    sub-group of each axis through this rank (None in a world that has not
    been initialised); `device` the torch device this rank computes on."""

    axis_names: tuple
    devices: np.ndarray
    coords: Optional[tuple]
    groups: dict
    device: torch.device

    @property
    def shape(self) -> collections.OrderedDict:
        """Axis name -> size, as the reference's `mesh.shape`."""
        return collections.OrderedDict(zip(self.axis_names,
                                           self.devices.shape))

    def index(self, axis: str) -> int:
        """This rank's coordinate along `axis`."""
        if self.coords is None:
            raise ValueError("this rank is not in the mesh")
        return int(self.coords[self.axis_names.index(axis)])

    def group(self, axis: str):
        if self.coords is None:
            raise ValueError("this rank is not in the mesh")
        return self.groups[axis]


def world() -> tuple[int, int]:
    """(rank, world size); (0, 1) without an initialised process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", world()[0]))


def rank_device(device: str | torch.device = "cuda") -> torch.device:
    """This rank's torch device: the card of its local rank (modulo the
    host's cards, so ranks that share a card land on it), or the CPU when
    the caller asks for it."""
    device = torch.device(device)
    if device.type != "cuda":
        return device
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available (pass "
                           "device='cpu' to run on the CPU)")
    if device.index is not None:
        return device
    return torch.device("cuda", _local_rank() % torch.cuda.device_count())


def local_mesh(axes: Sequence[str], device: str | torch.device) -> Mesh:
    """A mesh of this rank alone, with no group: every collective is the
    identity (a rank beyond a smaller mesh computes on its own)."""
    axes = tuple(axes)
    return Mesh(axes, np.zeros((1,) * len(axes), np.int64), (0,) * len(axes),
                {a: None for a in axes}, rank_device(device))


def make_mesh(
    n_devices: Optional[int] = None,
    axes: Sequence[str] = ("dp", "sp"),
    shape: Optional[Sequence[int]] = None,
    *,
    backend: Optional[str] = None,
    device: str | torch.device = "cuda",
) -> Mesh:
    """A Mesh over the first n_devices ranks of the world (all by default).
    shape=None auto-factors, as the reference does. `backend` names the
    sub-groups' backend (default: the world's); `device` is where this
    rank computes ("cuda": the card of its local rank).

    Every rank of an initialised world must call this, in the same order:
    each sub-group is made by all ranks."""
    rank, n_world = world()
    n = n_world if n_devices is None else int(n_devices)
    if n > n_world:
        raise ValueError(
            f"make_mesh: {n} devices requested but the world has only "
            f"{n_world} rank(s); start more ranks (torchrun, or "
            "dist.spawn) — the port never falls back to a smaller mesh")
    if shape is None:
        if len(axes) == 1:
            shape = (n,)
        elif len(axes) == 2:
            shape = _two_way_factor(n)
        else:
            raise ValueError("pass an explicit shape for >2 mesh axes")
    shape = tuple(int(s) for s in shape)
    if int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {shape} != {n} devices")
    axes = tuple(axes)
    grid = np.arange(n).reshape(shape)
    dev = rank_device(device)
    if not dist.is_initialized():
        return local_mesh(axes, dev)
    backend = backend or dist.get_backend()
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_WORLD_SIZE", n_world))
        cards = torch.cuda.device_count()
        if local > cards:
            raise ValueError(
                f"make_mesh: {local} ranks on this host share {cards} "
                "card(s), and NCCL refuses two ranks on one card: pass "
                "backend=\"gloo\" to run ranks that share a card")
    groups = {}
    for k, axis in enumerate(axes):
        lines = np.moveaxis(grid, k, -1).reshape(-1, shape[k])
        for line in lines:  # every rank makes every group, in one order
            g = dist.new_group(ranks=[int(r) for r in line], backend=backend)
            if rank in line:
                groups[axis] = g
    coords = (tuple(int(c) for c in np.argwhere(grid == rank)[0])
              if rank < n else None)
    return Mesh(axes, grid, coords, groups, dev)


def all_reduce(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """Sum of x over the ranks of `axis` through this rank (a new tensor);
    x itself without a group."""
    group = mesh.group(axis)
    if group is None:
        return x
    y = x.clone()
    dist.all_reduce(y, group=group)
    return y


def all_gather(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """x of every rank of `axis` through this rank, concatenated along dim
    0 in axis order; x itself without a group."""
    group = mesh.group(axis)
    if group is None:
        return x
    n = dist.get_world_size(group)
    src = x.contiguous()
    if src.device.type == "cuda" and dist.get_backend(group) == "gloo":
        # Transport, not a fallback: gloo has no CUDA path for all_gather,
        # so the tensor goes through host memory and comes back to the card.
        src = src.cpu()
    out = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(out, src, group=group)
    return torch.cat(out).to(x.device)


def multihost_init(coordinator: Optional[str] = None, *,
                   world_size: Optional[int] = None,
                   rank: Optional[int] = None,
                   device: str | torch.device = "cuda",
                   timeout_s: float = 600.0) -> None:
    """Multi-rank bootstrap: `torch.distributed.init_process_group` (config
    5), NCCL on the card and gloo when the caller asks for the CPU.

    coordinator is an init method ("tcp://host:port", "file:///path") or a
    bare "host:port"; world_size and rank default from WORLD_SIZE and RANK.
    Without a coordinator, torch's launcher environment (MASTER_ADDR,
    WORLD_SIZE, RANK, as torchrun exports them) is read.

    Failure policy, as the reference's: an explicitly named coordinator
    that fails raises (a misconfigured job must not silently degrade to
    one process); with no coordinator and no launcher markers this is a
    no-op (the single-process case); it is a no-op when a process group is
    already initialised.
    """
    log = logging.getLogger(__name__)
    if dist.is_initialized():
        log.debug("torch.distributed already initialized; no-op")
        return
    markers = ("MASTER_ADDR", "WORLD_SIZE", "RANK", "TORCHELASTIC_RUN_ID")
    env_configured = any(os.environ.get(k) for k in markers)
    if coordinator is None and not env_configured:
        log.debug("no coordinator/launcher markers; staying single-process")
        return
    dev = torch.device(device)
    backend = "gloo" if dev.type == "cpu" else "nccl"
    timeout = datetime.timedelta(seconds=timeout_s)
    try:
        if backend == "nccl":
            torch.cuda.set_device(rank_device(dev))
        if coordinator is not None:
            method = coordinator if "://" in coordinator else \
                f"tcp://{coordinator}"
            dist.init_process_group(
                backend, init_method=method, timeout=timeout,
                world_size=(world_size if world_size is not None
                            else int(os.environ["WORLD_SIZE"])),
                rank=rank if rank is not None else int(os.environ["RANK"]))
        else:
            dist.init_process_group(backend, timeout=timeout)
    except Exception as exc:
        # explicit request → hard failure; silent degradation is the trap
        log.error("torch.distributed.init_process_group failed: %s", exc)
        raise
