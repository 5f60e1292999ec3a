"""The yardstick of the kernels' rooflines: one H100's published peaks and
the work of each kernel family, counted from the cell's shapes and the
counts the program returns, never from kernel names or launch counters.

Copied from chip_smoke.py (`H100_*`, `_bound`, `k1_bound`): the least
time of a piece of work is the larger of its operations over the peak its
precision allows and its bytes over the memory bandwidth, each input read
once and each output written once. A roofline share is that least time
over the family's summed device time.
"""

from __future__ import annotations

import math

# Published peaks of one H100 SXM (NVIDIA's data sheet; dense, at 700 W).
H100_FP32_FLOPS = 67e12
H100_BF16_FLOPS = 989e12
H100_BYTES_PER_S = 3.35e12
NN_FLOPS_PER_PAIR = 9.0  # 3 subtractions, a product, two fmas, a compare


def bound_s(flops: float, nbytes: float, peak_flops: float) -> float:
    """Least time in seconds of `flops` operations at `peak_flops` that
    must move `nbytes`."""
    return max(flops / peak_flops, nbytes / H100_BYTES_PER_S)


def nn_peak(precision: str) -> float:
    """The peak a configuration's NN precision allows: float32 on the CUDA
    cores at "highest", the bf16 tensor cores at "rescore" and "bf16"."""
    return H100_FP32_FLOPS if precision == "highest" else H100_BF16_FLOPS


def nn_work(calls: int, batch: int, m: int, n: int, targets: int,
            dim: int = 3) -> tuple:
    """(flops, bytes) of `calls` exact NN searches of `batch` rows of m
    points against `targets` sets of n points: each pair scored once; the
    points in, each row's index and d² out."""
    flops = NN_FLOPS_PER_PAIR * calls * batch * m * n
    nbytes = calls * ((4.0 * dim + 8.0) * batch * m + 4.0 * dim * targets * n)
    return flops, nbytes


def icp_nn(ctx) -> tuple:
    """The front end's NN: one search of the scan (capacity M) against the
    local model (N) an ICP iteration."""
    cfg = ctx.config
    m = cfg["pipeline"]["scan_capacity"]
    n = cfg["mapping"]["local_model_size"]
    flops, nbytes = nn_work(ctx.profiled_sum("icp_iters"), 1, m, n, 1)
    return flops, nbytes, nn_peak(cfg["icp"]["nn_precision"])


def knn(ctx) -> tuple:
    """KN: the k-NN of the scan against every normal_ref_stride-th point of
    it, at the first scan of a sequence and at each map insert; the points
    and mask in, the normals out."""
    p = ctx.config["pipeline"]
    m = p["scan_capacity"]
    r = math.ceil(m / max(1, p["normal_ref_stride"]))
    calls = ctx.profiled_sum("inserts") + len(ctx.profiled)
    return (NN_FLOPS_PER_PAIR * calls * m * r, calls * 25.0 * m,
            H100_FP32_FLOPS)


def verify_nn(ctx) -> tuple:
    """Verification's batched NN: B = candidates x yaws elements of the
    query scan against their candidates' scans, once a batched iteration
    (the detector's ICP runs at "highest")."""
    cfg = ctx.config
    m = cfg["pipeline"]["scan_capacity"]
    yaws = cfg["backend"]["verify_yaws"]
    flops = nbytes = 0.0
    for rec in ctx.profiled:
        for batch, calls in rec.get("verify_batches", ()):
            f, b = nn_work(calls, batch, m, m, batch // yaws)
            flops, nbytes = flops + f, nbytes + b
    return flops, nbytes, H100_FP32_FLOPS


WORK = {"icp_nn": icp_nn, "knn": knn, "verify_nn": verify_nn}


def share(ctx, family: str):
    """The family's roofline share in %, or None where the profiled
    sequences hold none of its work or none of its kernels."""
    fam = ctx.families.get(family)
    if fam is None or ctx.trace is None:
        return None
    flops, nbytes, peak = WORK[fam["work"]](ctx)
    ns = ctx.trace.family_ns(fam["patterns"], fam.get("span"))
    if flops <= 0 or ns <= 0:
        return None
    return 100.0 * bound_s(flops, nbytes, peak) / (ns * 1e-9)
