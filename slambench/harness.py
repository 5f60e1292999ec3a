"""The benchmark of tpu_icp_slam_torch, driven by data.

A cell `<config>.<mix>` of BENCHMARK.json names a configuration
(slambench/configs/<config>.json: the port's SlamConfig groups and the
deployment's source), a traffic mix (slambench/traffic/<mix>.json: the
generator's parameters and, under `drive`, the drive that makes its inputs,
feeds them to the program and judges its outputs:
slambench/drives/<drive>.py), and the metrics it reports; each metric is
read by slambench/metrics/<name>.py, each kernel family's patterns are the
union of slambench/kernels/<family>*.json, and the limits that decide
`correct` are slambench/limits/<cell>.json. Nothing here names a cell, a
drive or a kind of input, so a later cell, metric or drive is a matter of
new files.

A run: set-up (the inputs made on the host from the seed, in worker
processes while torch and the program load; the drive's program built;
one untimed sequence that builds the kernels and captures the graphs),
then a window of whole sequences, closed loop, one at a time, until
`seconds` have passed; with `trace`, the first sequences of the window run
under torch.profiler. Once the window has closed, every sequence it ran is
judged against the plain reference (slambench/check.py), and the result is
one JSON line.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import sys
import time

import torch

from slambench import gen
from slambench.registry import (  # noqa: F401
    CHECKOUT,
    ROOT,
    benchmark,
    cell_of,
    config,
    drive,
    families,
    limits,
    metrics_of,
    reader,
    traffic,
)

GROUPS = ("icp", "mapping", "pipeline", "backend", "dist", "bench", "debug")
FORBIDDEN = ("jax", "jaxlib", "flax", "tpu_icp_slam")


# ---- what the drives use ----------------------------------------------------

def slam_config(cfg: dict):
    """The port's SlamConfig of a configuration file."""
    from tpu_icp_slam_torch.config.config import from_json

    return from_json(json.dumps({k: cfg[k] for k in GROUPS if k in cfg}))


def _span(name: str, fn):
    """fn wrapped in a record_function range named slambench.<name>."""
    @functools.wraps(fn)
    def wrapped(*a, **kw):
        with torch.profiler.record_function(f"slambench.{name}"):
            return fn(*a, **kw)

    return wrapped


# ---- the run ---------------------------------------------------------------

@dataclasses.dataclass
class Context:
    """What the metric readers read."""
    cell: str
    config: dict
    traffic: dict
    families: dict
    setup_s: float
    window_s: float
    records: list  # every sequence of the window
    profiled: list  # the sequences run under the profiler
    trace: object = None  # slambench.trace.Trace of the profiled block
    block_ns: tuple = (0, 0)  # the profiled block on the profiler's clock

    @property
    def plain(self) -> list:
        """The window's sequences that ran without the profiler."""
        return self.records[len(self.profiled):]

    def profiled_sum(self, key: str) -> int:
        return sum(r[key] for r in self.profiled)

    def profiled_frames(self) -> int:
        return sum(r["frames"] for r in self.profiled)


def require_card(chips: int) -> None:
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        raise SystemExit(f"slambench: needs {chips} CUDA device(s), found "
                         f"{n}; there is no CPU mode")


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def _card_line() -> str:
    import subprocess

    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "nvidia-smi: not read"


def run(cell: str, seed: int, seconds: float, trace: bool, t_start: float,
        device: str = "cuda", bench: dict | None = None,
        config_override=None, traffic_override=None, program_cls=None,
        prefetch: gen.Prefetch | None = None, root=ROOT):
    """One run of a cell: (result dict, check lines). `prefetch`, the cell's
    sequences for this seed under way (gen.Prefetch over its drive's
    `sequence` and `jobs`). `root`, the slambench/ directory whose files
    the cell's pieces are read from. `config_override` and
    `traffic_override` (dict -> dict) and `program_cls` (in place of the
    drive's Program) serve the tests, which run the whole path on the CPU
    at a small size."""
    from slambench import check
    from slambench import trace as trace_mod

    bench = bench or benchmark()
    w = cell_of(bench, cell)
    cfg, mix = config(w["config"], root), traffic(w["traffic"], root)
    if config_override:
        cfg = config_override(cfg)
    if traffic_override:
        mix = traffic_override(mix)
    drv = drive(mix["drive"], root)
    stages = [("start", t_start), ("imports", time.perf_counter())]
    seqs = prefetch.result() if prefetch is not None else [
        drv.sequence(*job) for job in drv.jobs(cfg, mix, seed)]
    stages.append(("inputs", time.perf_counter()))
    prog = (program_cls or drv.Program)(cfg, device, spans=trace)
    cuda = torch.device(device).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    prog.run(*seqs[0][0])  # warm-up: builds and captures
    sync()
    stages.append(("warm-up", time.perf_counter()))
    print("set-up: " + ", ".join(
        f"{b[0]} {b[1] - a[1]:.3f} s" for a, b in zip(stages, stages[1:])),
        file=sys.stderr)
    records, profiled = [], []
    n_prof = mix["profile_sequences"] if trace else 0

    def one(i):
        inputs, _ = seqs[i % len(seqs)]
        rec = prog.run(*inputs)
        rec.update(seq=i % len(seqs), frames=len(inputs[0]))
        records.append(rec)

    t_win = time.perf_counter()
    setup_s = t_win - t_start
    tr, block = None, (0, 0)
    if n_prof:
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                         else [])
        with profile(activities=acts) as prof:
            with record_function("slambench.block"):
                for i in range(n_prof):
                    one(i)
                sync()
        tr = trace_mod.reduce(prof)
        block = tr.span_ns("slambench.block")
        profiled = list(records)
    while time.perf_counter() - t_win < seconds or len(records) <= n_prof:
        one(len(records))
    sync()
    window_s = time.perf_counter() - t_win

    dev_info = {"platform": "gpu" if cuda else device,
                "kind": torch.cuda.get_device_name(0) if cuda else device,
                "count": 1,
                "memory_peak_bytes": (torch.cuda.max_memory_allocated()
                                      if cuda else 0)}
    ctx = Context(cell=cell, config=cfg, traffic=mix,
                  families=families(root), setup_s=setup_s,
                  window_s=window_s, records=records, profiled=profiled,
                  trace=tr, block_ns=block)
    metrics = {}
    for m in metrics_of(bench, cell, trace):
        v = reader(m["name"], root).read(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    result = {"attempted": len(records), "metrics": metrics,
              "device": dev_info}
    if tr is not None:
        busy = tr.busy_ns() / 1e9
        dev_info.update(busy_s=busy, window_s=(block[1] - block[0]) / 1e9)
        result["breakdown"] = {"device_ops": tr.top_ops(),
                               "idle_gaps": tr.idle_gaps(*block)}
    # the program's state goes before the reference runs
    del prog
    if cuda:
        from tpu_icp_slam_torch.slam import frame_graphs

        frame_graphs.clear()
        import gc

        gc.collect()
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    verdict = check.judge(drv, cfg, mix, seqs, records, limits(cell, root),
                          device)
    print(f"reference: {time.perf_counter() - t_ref:.3f} s for "
          f"{len(verdict['refs'])} sequence(s)", file=sys.stderr)
    result.update(correct=verdict["correct"], failed=verdict["failed"])
    if cuda:
        result["card"] = _card_line()
    result["checks"] = verdict["checks"]
    return result, verdict["lines"]


def main(argv=None, t_start: float | None = None,
         prefetch: gen.Prefetch | None = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    import argparse

    ap = argparse.ArgumentParser(prog="slambench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    try:
        args = ap.parse_args(argv)
        bench = benchmark()
        w = cell_of(bench, args.workload)
        require_card(w["chips"])
        result, lines = run(args.workload, args.seed, args.seconds,
                            bool(args.trace), t_start, bench=bench,
                            prefetch=prefetch)
    finally:
        if prefetch is not None:
            prefetch.close()
    bad = forbidden_modules()
    if bad:
        print(f"slambench: the process loaded {bad}: the benchmark runs "
              "the port alone", file=sys.stderr)
        return 3
    order = ["correct", "attempted", "failed", "metrics", "device",
             "breakdown", "card", "checks"]
    line = json.dumps({k: result[k] for k in order if k in result})
    for text in lines:
        print(text, file=sys.stderr)
    sys.stderr.flush()
    print(line, flush=True)
    return 0
