"""K5's capability probe on the card (csrc/coop_probe.cu).

The Hopper counterpart of the Mosaic probes P1-P6
(scripts/probe_mosaic_caps.py): a cooperative launch of K5's co-resident
grid that loops a device-decided number of times across grid syncs, gathers
by device-side indices, takes a running argmin and evaluates scalar
sqrt/div/sin/cos, each checked against a known answer. `capability_probe`
raises on the first wrong answer, naming it; it has no plain version, since
what it checks is the device.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_icp_slam_torch.kernels import _build
from tpu_icp_slam_torch.kernels.icp_fused import max_blocks


def capability_probe(device: torch.device | str = "cuda") -> dict:
    """Run the probe on `device` at K5's grid; returns the grid sizes and
    what was checked."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"capability_probe needs a CUDA device, got {dev}")
    blocks = {"highest": max_blocks(dev, False), "bf16": max_blocks(dev, True)}
    grid = blocks["highest"]
    rng = np.random.default_rng(0)
    table = np.arange(64 * 8, dtype=np.float32).reshape(64, 8)
    idx = np.array([3, 0, 63, 7, 1, 2, 5, 9], np.int32)
    e = rng.uniform(size=(16, 128)).astype(np.float32)
    e[5, [17, 90]] = -1.0  # a tie: the lower index must win
    x = np.array([30.0, 4.0], np.float32)
    args = [torch.from_numpy(a).to(dev) for a in (table, idx, e, x)]
    scratch = torch.zeros(2 * 2 * grid, dtype=torch.float32, device=dev)
    out = torch.zeros(88, dtype=torch.float32, device=dev)
    lib = _build.load()
    err = lib.coop_probe_f32(
        *(a.data_ptr() for a in args), grid, scratch.data_ptr(),
        out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, f"coop_probe_f32 (cooperative launch of {grid} blocks)")
    capability_probe.launches += 1
    got = out.cpu().numpy()
    checks = {
        "while_loop_grid_sync": (got[0:3], [120.0, 4.0, float(grid)], 0.0),
        "scalar_math": (got[3:7], [2.0, 0.25, np.sin(4.0), np.cos(4.0)],
                        1e-6),
        "dynamic_gather": (got[8:72], table[idx].ravel(), 0.0),
        "running_argmin": (got[72:88], e.argmin(axis=1), 0.0),
    }
    for name, (value, want, tol) in checks.items():
        if not np.allclose(value, np.asarray(want, np.float64), rtol=0,
                           atol=tol):
            raise RuntimeError(f"capability probe {name}: got {value}, "
                               f"want {want}")
    return {"blocks": blocks, "checked": list(checks)}


capability_probe.launches = 0
