"""The readings that the limits of slambench/limits/<cell>.json are set
from, on the card (not run by the benchmark's own runs):

    python3 slambench/calibrate.py readings --workload <cell>
        --seeds 1 2 ... [--control-seeds 1 2 3] [--out FILE]

runs the cell's timed path (its drive's Program, slambench/drives) once
over each distinct sequence of each seed, then the plain reference on the
same inputs (the sound readings) and, on the control seeds, the reference
computed in TF32 in the program's place (the control, which has to come
out as not correct); one JSON line a seed. With `--faults`, on each of
the `--fault-seeds`, the program runs again with each named fault of the
drive's FAULTS planted (for the lidar drives: a program that inserts into
its map never, a verification that returns no closure, every verified
closure kept, a pose graph left unsolved), judged by the sound reference:
the readings that the numbers those faults move are held against.

    python3 slambench/calibrate.py kernels --workload <cell> --seed N

traces one profiled block as a traced run does and prints every device
operation's name with its count, time and the harness span it ran in,
and the kernel families (slambench/kernels) each falls in.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys
import time

_CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [_CHECKOUT, os.path.join(_CHECKOUT, "src")]

from slambench import harness  # noqa: E402


def _setup(cell: str, seed: int):
    w = harness.cell_of(harness.benchmark(), cell)
    cfg, mix = harness.config(w["config"]), harness.traffic(w["traffic"])
    drv = harness.drive(mix["drive"])
    return cfg, mix, drv, [drv.sequence(*job)
                           for job in drv.jobs(cfg, mix, seed)]


def _summaries(drv, row: dict, side: str, recs: list) -> None:
    """The drive's counts of each record or reference, where it has any."""
    summary = getattr(drv, "summary", None)
    if summary is None:
        return
    counts = [summary(r) for r in recs]
    for k in counts[0]:
        row[f"{side}_{k}"] = [c[k] for c in counts]


def _readings(drv, cfg: dict, mix: dict, seqs: list, recs: list,
              precision: str = "float32", device: str = "cuda"):
    """The worst of each number over the seed's sequences, and the
    references."""
    got, refs = [], []
    for rec, (inputs, gt) in zip(recs, seqs):
        refs.append(drv.reference(cfg, mix, inputs, rec, device, precision))
        got.append(drv.numbers(rec, refs[-1], gt))
    return {k: max(g[k] for g in got) for k in got[0]}, refs


def readings(args) -> None:
    import torch

    harness.require_card(1)
    prog = None
    out = open(args.out, "a") if args.out else None
    for seed in args.seeds:
        cfg, mix, drv, seqs = _setup(args.workload, seed)
        unknown = set(args.faults) - set(drv.FAULTS)
        if unknown:
            raise SystemExit(f"calibrate: no fault {sorted(unknown)} in "
                             f"drive {mix['drive']} ({sorted(drv.FAULTS)})")
        if prog is None:
            prog = drv.Program(cfg, "cuda", spans=False)
            prog.run(*seqs[0][0])
        t0 = time.perf_counter()
        recs = []
        for k, (inputs, _) in enumerate(seqs):
            rec = prog.run(*inputs)
            rec["seq"] = k
            recs.append(rec)
        torch.cuda.synchronize()
        row = {"cell": args.workload, "seed": seed,
               "program_s": time.perf_counter() - t0}
        for precision in ("float32", "tf32"):
            if precision == "tf32" and seed not in args.control_seeds:
                continue
            t0 = time.perf_counter()
            name = "sound" if precision == "float32" else "control"
            row[name], refs = _readings(drv, cfg, mix, seqs, recs,
                                        precision)
            row[f"{name}_s"] = time.perf_counter() - t0
            _summaries(drv, row, name, refs)
        _summaries(drv, row, "program", recs)
        row["icp_iters"] = [r["icp_iters"] for r in recs]
        if seed in args.fault_seeds:
            for name in args.faults:
                row[f"fault_{name}"] = _fault_reading(name, cfg, mix, drv,
                                                      seqs)
        text = json.dumps(row)
        print(text, flush=True)
        if out:
            out.write(text + "\n")
            out.flush()


def _fault_reading(name: str, cfg: dict, mix: dict, drv, seqs: list,
                   device: str = "cuda") -> dict:
    """The numbers of the program with the fault planted, against the
    sound reference (each the worst over the seed's sequences)."""
    import torch

    prog_cfg, patch = drv.FAULTS[name](cfg)
    with patch:
        prog = drv.Program(prog_cfg, device, spans=False)
        recs = [dict(prog.run(*inputs), seq=k)
                for k, (inputs, _) in enumerate(seqs)]
    del prog
    if device == "cuda":
        torch.cuda.synchronize()
    return _readings(drv, cfg, mix, seqs, recs, device=device)[0]


def kernels(args) -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from slambench import trace

    harness.require_card(1)
    cfg, mix, drv, seqs = _setup(args.workload, args.seed)
    prog = drv.Program(cfg, "cuda", spans=True)
    prog.run(*seqs[0][0])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("slambench.block"):
            for i in range(mix["profile_sequences"]):
                prog.run(*seqs[i % len(seqs)][0])
            torch.cuda.synchronize()
    tr = trace.reduce(prof)
    fams = harness.families()
    by = collections.defaultdict(lambda: [0, 0])
    for name, _, d, span in tr.ops:
        by[(name, span)][0] += 1
        by[(name, span)][1] += d
    for (name, span), (n, ns) in sorted(by.items(), key=lambda x: -x[1][1]):
        hit = [f for f, v in fams.items()
               if any(p in name for p in v["patterns"])
               and v.get("span") in (None, span)]
        print(json.dumps({"name": name, "span": span, "count": n,
                          "ms": ns / 1e6, "families": hit}))
    print(json.dumps({"launches": tr.launches, "syncs": tr.syncs,
                      "busy_s": tr.busy_ns() / 1e9}))


def main() -> None:
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("readings")
    r.add_argument("--workload", required=True)
    r.add_argument("--seeds", type=int, nargs="+", required=True)
    r.add_argument("--control-seeds", type=int, nargs="*", default=[])
    r.add_argument("--faults", nargs="*", default=[],
                   help="names in the cell's drive's FAULTS")
    r.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    r.add_argument("--out")
    k = sub.add_parser("kernels")
    k.add_argument("--workload", required=True)
    k.add_argument("--seed", type=int, required=True)
    args = ap.parse_args()
    {"readings": readings, "kernels": kernels}[args.cmd](args)


if __name__ == "__main__":
    main()
