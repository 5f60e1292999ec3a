"""The readings that the limits of slambench/limits/<cell>.json are set
from, on the card (not run by the benchmark's own runs):

    python3 slambench/calibrate.py readings --workload <cell>
        --seeds 1 2 ... [--control-seeds 1 2 3] [--out FILE]

runs the cell's timed path (slambench/harness.Program) once over each
distinct sequence of each seed, then the plain reference on the same
scans (the sound readings) and, on the control seeds, the reference
computed in TF32 in the program's place (the control, which has to come
out as not correct); one JSON line a seed. With `--faults`, on each of
the `--fault-seeds`, the program runs again with each fault planted
(slambench/faults.py: a program that inserts into its map never, a verification that
returns no closure, a pose graph left unsolved), judged by the sound
reference: the readings that the numbers those faults move are held
against.

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

from slambench import check, gen, harness  # noqa: E402
from slambench.faults import FAULTS  # noqa: E402


def _setup(cell: str, seed: int):
    w = harness.cell_of(harness.benchmark(), cell)
    cfg, mix = harness.config(w["config"]), harness.traffic(w["traffic"])
    p = cfg["pipeline"]
    return cfg, mix, gen.sequences(mix, p["downsample_voxel"],
                                   p["scan_capacity"], seed)


def readings(args) -> None:
    import torch

    harness.require_card(1)
    prog = None
    out = open(args.out, "a") if args.out else None
    for seed in args.seeds:
        cfg, mix, seqs = _setup(args.workload, seed)
        if prog is None:
            prog = harness.Program(cfg, mix["drive"], "cuda", spans=False)
            prog.run(seqs[0][0], seqs[0][1])
        t0 = time.perf_counter()
        recs = []
        for k, (pts, msk, _) in enumerate(seqs):
            rec = prog.run(pts, msk)
            rec["seq"] = k
            recs.append(rec)
        torch.cuda.synchronize()
        row = {"cell": args.workload, "seed": seed,
               "program_s": time.perf_counter() - t0}
        for precision in ("float32", "tf32"):
            if precision == "tf32" and seed not in args.control_seeds:
                continue
            t0 = time.perf_counter()
            got, refs = [], []
            for rec, (pts, msk, gt) in zip(recs, seqs):
                refs.append(check.reference(cfg, mix, pts, msk, rec, "cuda",
                                            precision))
                got.append(check.numbers(rec, refs[-1], gt))
            name = "sound" if precision == "float32" else "control"
            row[name] = {k: max(g[k] for g in got) for k in got[0]}
            row[f"{name}_s"] = time.perf_counter() - t0
            if mix["drive"] == "slam":
                row[f"{name}_closures"] = [len(r["closures"]) for r in refs]
                row[f"{name}_verify_iters"] = [r["verify_iters"]
                                               for r in refs]
        if mix["drive"] == "slam":
            row["program_closures"] = [len(r["closures"]) for r in recs]
            row["program_verified"] = [len(r["verified"]) for r in recs]
            row["program_verify_iters"] = [r["verify_iters"] for r in recs]
        row["icp_iters"] = [r["icp_iters"] for r in recs]
        if seed in args.fault_seeds:
            for name in args.faults:
                row[f"fault_{name}"] = _fault_reading(name, cfg, mix, seqs)
        text = json.dumps(row)
        print(text, flush=True)
        if out:
            out.write(text + "\n")
            out.flush()


def _fault_reading(name: str, cfg: dict, mix: dict, seqs: list,
                   device: str = "cuda") -> dict:
    """The numbers of the program with the fault planted, against the
    sound reference (each the worst over the seed's sequences)."""
    import torch

    prog_cfg, patch = FAULTS[name](cfg)
    got = []
    with patch:
        prog = harness.Program(prog_cfg, mix["drive"], device, spans=False)
        recs = [dict(prog.run(pts, msk), seq=k)
                for k, (pts, msk, _) in enumerate(seqs)]
    del prog
    if device == "cuda":
        torch.cuda.synchronize()
    for rec, (pts, msk, gt) in zip(recs, seqs):
        ref = check.reference(cfg, mix, pts, msk, rec, device)
        got.append(check.numbers(rec, ref, gt))
    return {k: max(g[k] for g in got) for k in got[0]}


def kernels(args) -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from slambench import trace

    harness.require_card(1)
    cfg, mix, seqs = _setup(args.workload, args.seed)
    prog = harness.Program(cfg, mix["drive"], "cuda", spans=True)
    prog.run(seqs[0][0], seqs[0][1])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("slambench.block"):
            for i in range(mix["profile_sequences"]):
                pts, msk, _ = seqs[i % len(seqs)]
                prog.run(pts, msk)
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
    r.add_argument("--faults", nargs="*", default=[], choices=sorted(FAULTS))
    r.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    r.add_argument("--out")
    k = sub.add_parser("kernels")
    k.add_argument("--workload", required=True)
    k.add_argument("--seed", type=int, required=True)
    args = ap.parse_args()
    {"readings": readings, "kernels": kernels}[args.cmd](args)


if __name__ == "__main__":
    main()
