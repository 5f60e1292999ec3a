"""Multi-process torch.distributed bootstrap of the port (mirrors
tests/test_multiprocess.py): two local gloo processes on the CPU joined
through `dist.multihost_init` with a FileStore under tmp_path (parallel
test runners never share a port), one all-reduce across them through the
port's mesh; then a rank killed mid-run, detected by the survivor's
`with_timeout` watchdog (or by gloo's own error on the closed connection),
and a restart from the checkpoint equal to the uninterrupted run. Every
join is under a timeout; a hang fails the test."""

import os
import subprocess
import sys

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")

_WORKER = r"""
import os, sys
sys.path.insert(0, os.environ["PORT_SRC"])
import torch
torch.set_num_threads(1)
from tpu_icp_slam_torch.dist import make_mesh, multihost_init
from tpu_icp_slam_torch.dist.mesh import all_reduce
rank = int(sys.argv[1])
multihost_init("file://" + sys.argv[2], world_size=2, rank=rank,
               device="cpu", timeout_s=60)
mesh = make_mesh(axes=("x",), device="cpu")
out = all_reduce(torch.arange(4, dtype=torch.float32) * (rank + 1), mesh, "x")
print("OK", out.tolist(), flush=True)
"""

# A checkpointed multi-step distributed loop: rank 0 wraps every step in
# dist.with_timeout; rank 1 can be told to die mid-run.
_KILL_WORKER = r"""
import os, sys
sys.path.insert(0, os.environ["PORT_SRC"])
import numpy as np
import torch
torch.set_num_threads(1)
from tpu_icp_slam_torch.dist import WorkerFailure, make_mesh, multihost_init
from tpu_icp_slam_torch.dist import with_timeout
from tpu_icp_slam_torch.dist.mesh import all_reduce
rank = int(sys.argv[1])
multihost_init("file://" + sys.argv[2], world_size=2, rank=rank,
               device="cpu", timeout_s=60)
mesh = make_mesh(axes=("x",), device="cpu")
ckpt = sys.argv[3]
kill_at = int(os.environ.get("KILL_AT_STEP", "-1"))
n_steps = 8
start, acc = 0, 0.0
if os.environ.get("RESUME") == "1" and os.path.exists(ckpt):
    d = np.load(ckpt)
    start, acc = int(d["step"]) + 1, float(d["acc"])
    print("RESUMED", start, acc, flush=True)
for k in range(start, n_steps):
    if rank == 1 and k == kill_at:
        print("DYING", k, flush=True)
        os._exit(1)  # abrupt crash, no cleanup: the injected fault

    def one_step():
        local = torch.full((4,), float(k + 1))
        return float(all_reduce(local, mesh, "x").sum())  # host fence

    if rank == 0:
        try:
            total = with_timeout(one_step, timeout_s=20.0)
        except WorkerFailure:
            print("DETECTED", k, "timeout", flush=True)
            os._exit(0)  # the checkpoint is on disk; a hung thread stays
        except Exception as e:
            # gloo surfaced the closed connection itself: equally a
            # detection, not a hang
            print("DETECTED", k, "runtime-error", type(e).__name__,
                  flush=True)
            os._exit(0)
        acc += total
        tmp = ckpt + ".tmp.npz"
        np.savez(tmp, step=k, acc=acc)
        os.replace(tmp, ckpt)
        print("STEP", k, acc, flush=True)
    else:
        one_step()
if rank == 0:
    print("FINAL", acc, flush=True)
"""


def _run_pair(script, tmp_path, tag, env_extra=None, timeout=120):
    env = dict(os.environ, PORT_SRC=_SRC, **(env_extra or {}))
    for k in ("MASTER_ADDR", "WORLD_SIZE", "RANK", "TORCHELASTIC_RUN_ID"):
        env.pop(k, None)
    store = str(tmp_path / f"store_{tag}")
    ckpt = str(tmp_path / "dist_ckpt.npz")
    procs = [subprocess.Popen([sys.executable, str(script), str(r), store,
                               ckpt], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, env=env)
             for r in (0, 1)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()  # our own children, after a hang
                p.communicate()
    return procs, outs, ckpt


def test_two_process_all_reduce(tmp_path):
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    procs, outs, _ = _run_pair(script, tmp_path, "a")
    joined = "\n".join(outs)
    assert all(p.returncode == 0 for p in procs), joined
    for out in outs:
        assert "OK [0.0, 3.0, 6.0, 9.0]" in out, joined


def test_worker_kill_detect_and_resume(tmp_path):
    """Kill rank 1 mid-run: the survivor must DETECT it (WorkerFailure from
    the watchdog, or gloo's error), not hang, and a restart from the
    checkpoint must reproduce the uninterrupted result exactly."""
    script = tmp_path / "kill_worker.py"
    script.write_text(_KILL_WORKER)

    procs, outs, ckpt = _run_pair(script, tmp_path, "ref")
    joined = "\n".join(outs)
    assert procs[0].returncode == 0, joined
    final_ref = [ln for ln in outs[0].splitlines() if ln.startswith("FINAL")]
    assert final_ref, joined
    ref_acc = float(final_ref[0].split()[1])
    os.remove(ckpt)

    procs, outs, ckpt = _run_pair(script, tmp_path, "kill",
                                  env_extra={"KILL_AT_STEP": "4"})
    joined = "\n".join(outs)
    assert "DYING 4" in outs[1], joined
    assert "DETECTED 4" in outs[0], joined
    assert "FINAL" not in outs[0], joined
    assert os.path.exists(ckpt), "no checkpoint written before the fault"

    procs, outs, _ = _run_pair(script, tmp_path, "resume",
                               env_extra={"RESUME": "1"})
    joined = "\n".join(outs)
    assert procs[0].returncode == 0, joined
    assert "RESUMED 4" in outs[0], joined
    final = [ln for ln in outs[0].splitlines() if ln.startswith("FINAL")]
    assert final and float(final[0].split()[1]) == ref_acc, joined
