"""Worker-failure detection for multi-rank collectives (port of
tpu_icp_slam/dist/failure.py, stdlib only).

A dead peer leaves a collective HANGING, not erroring: the surviving rank
blocks inside the communication library (gloo or NCCL) until the process
group's own timeout, which defaults to minutes. The recovery story is
detect-by-timeout + restart from checkpoint:

- `with_timeout(fn, timeout_s)` runs a blocking computation (its
  collectives and the host copy that fences it) on a watchdog thread and
  raises `WorkerFailure` when it does not complete in time.
- The caller's recovery is process-level: checkpoint state is already on
  disk (slam/checkpoint.py writes atomically), so the supervisor restarts
  the job and `--resume` continues from the last frame. The hung thread
  cannot be cancelled from Python; after WorkerFailure the process must
  exit, which is exactly the restart-from-checkpoint path.
"""

from __future__ import annotations

import threading
from typing import Any, Callable


class WorkerFailure(RuntimeError):
    """A distributed computation failed to complete within its deadline:
    the signature of a dead or partitioned peer in a collective."""


def with_timeout(fn: Callable[[], Any], timeout_s: float) -> Any:
    """Run `fn()` (blocking work, e.g. a step with collectives and its host
    fence) with a deadline. Returns fn's result, re-raises fn's exception,
    or raises WorkerFailure on deadline.

    fn runs on a daemon thread of its own. A timed-out computation leaves
    that thread blocked in the communication library (unkillable from
    Python), and a daemon thread does not hold the interpreter at exit; so
    after WorkerFailure the caller should persist what it has and exit:
    recovery is restart-from-checkpoint, not in-process retry. (The
    reference shares a thread pool, whose threads Python joins at exit,
    which would hang the exit behind the dead collective.)
    """
    out: dict = {}

    def run():
        try:
            out["value"] = fn()
        except BaseException as exc:  # re-raised in the caller
            out["error"] = exc

    t = threading.Thread(target=run, name="dist-watchdog", daemon=True)
    t.start()
    t.join(timeout_s)
    if t.is_alive():
        raise WorkerFailure(
            f"distributed computation exceeded {timeout_s:.1f}s deadline — "
            "peer process presumed dead; restart from checkpoint"
        )
    if "error" in out:
        raise out["error"]
    return out["value"]
