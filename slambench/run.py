"""Run one cell of the benchmark of tpu_icp_slam_torch on this machine's
CUDA card and print its result as the last line of standard output:

    python3 slambench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

from the root of a checkout (see slambench/harness.py). It has no CPU
mode: without a CUDA device it exits with an error and prints no result.
The cell's inputs are made in worker processes while torch and the program
load.
"""

import time

T_START = time.perf_counter()  # set-up is timed from here

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

_CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [_CHECKOUT, os.path.join(_CHECKOUT, "src")]

from slambench import gen, registry  # noqa: E402


def prefetch(argv):
    """The inputs of the cell and seed that `argv` names, under way in
    worker processes (its drive's `sequence` over its `jobs`); None where
    it names none (the harness then says why)."""
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--workload")
    ap.add_argument("--seed", type=int)
    try:
        args = ap.parse_known_args(argv)[0]
        w = registry.cell_of(registry.benchmark(), args.workload)
    except SystemExit:
        return None
    if args.seed is None:
        return None
    cfg, mix = registry.config(w["config"]), registry.traffic(w["traffic"])
    drive = registry.drive(mix["drive"])
    return gen.Prefetch(drive.sequence, drive.jobs(cfg, mix, args.seed))


if __name__ == "__main__":
    inputs = prefetch(sys.argv[1:])
    from slambench import harness

    sys.exit(harness.main(t_start=T_START, prefetch=inputs))
