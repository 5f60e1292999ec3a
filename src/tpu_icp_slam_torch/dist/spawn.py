"""Run a function on every rank of a fresh local world (the launcher the
tests and chip_smoke.py use; `torchrun` is the other way in).

    results = spawn(fn, 4, a, b, init_file="/tmp/x/store")

starts 4 processes (multiprocessing's "spawn" start method), initialises
each as a rank of one process group through a FileStore at `init_file`
(so parallel runs never collide on a port), calls fn(rank, a, b) there and
returns the per-rank results in rank order. fn and its arguments must
pickle: fn is a module-level function.

Nothing is swallowed: a rank that raises, dies or exits nonzero makes
`spawn` raise with that rank's traceback or exit code, and a world that
has not finished by `timeout_s` raises WorkerFailure. Every process is
killed before `spawn` returns or raises.
"""

from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import queue as _queue
import time
import traceback
from typing import Any, Callable, Optional

from tpu_icp_slam_torch.dist.failure import WorkerFailure


def _rank_main(fn, rank, world_size, init_file, backend, timeout_s,
               num_threads, args, out_q):
    os.environ["LOCAL_RANK"] = str(rank)
    os.environ["LOCAL_WORLD_SIZE"] = str(world_size)
    try:
        import torch
        import torch.distributed as dist

        if num_threads:
            torch.set_num_threads(num_threads)
        if backend == "nccl":
            from tpu_icp_slam_torch.dist.mesh import rank_device

            torch.cuda.set_device(rank_device("cuda"))
        dist.init_process_group(
            backend, init_method=f"file://{init_file}",
            world_size=world_size, rank=rank,
            timeout=datetime.timedelta(seconds=timeout_s))
        out_q.put((rank, True, fn(rank, *args)))
        dist.destroy_process_group()
    except BaseException:
        out_q.put((rank, False, traceback.format_exc()))
        raise SystemExit(1)


def spawn(fn: Callable[..., Any], world_size: int, *args,
          init_file: str, backend: str = "gloo", timeout_s: float = 300.0,
          num_threads: Optional[int] = None) -> list:
    """fn(rank, *args) on each of `world_size` new ranks; their results in
    rank order. See the module docstring."""
    if os.path.exists(init_file):
        raise ValueError(f"{init_file} exists: a FileStore needs a new file")
    ctx = mp.get_context("spawn")
    out_q = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, world_size, init_file, backend,
                               timeout_s, num_threads, args, out_q))
             for r in range(world_size)]
    deadline = time.monotonic() + timeout_s
    results: dict = {}
    try:
        for p in procs:
            p.start()
        while len(results) < world_size:
            left = deadline - time.monotonic()
            if left <= 0:
                raise WorkerFailure(
                    f"ranks {sorted(set(range(world_size)) - set(results))} "
                    f"did not finish within {timeout_s:.0f} s")
            try:
                rank, ok, value = out_q.get(timeout=min(left, 1.0))
            except _queue.Empty:
                for r, p in enumerate(procs):
                    if r not in results and p.exitcode not in (None, 0):
                        raise RuntimeError(
                            f"rank {r} died with exit code {p.exitcode}")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{value}")
            results[rank] = value
        for r, p in enumerate(procs):
            p.join(max(0.0, deadline - time.monotonic()))
            if p.exitcode != 0:
                raise RuntimeError(f"rank {r} exited with {p.exitcode}")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(10)
        out_q.close()
    return [results[r] for r in range(world_size)]
