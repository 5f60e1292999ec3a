"""The benchmark of tpu_icp_slam_torch, driven by data.

A cell `<config>.<mix>` of BENCHMARK.json names a configuration
(slambench/configs/<config>.json: the port's SlamConfig groups and the
deployment's source), a traffic mix (slambench/traffic/<mix>.json: the
generator's parameters and how the program is driven), and the metrics it
reports; each metric is read by slambench/metrics/<name>.py, each kernel
family's patterns are the union of slambench/kernels/<family>*.json, and
the limits that decide `correct` are slambench/limits/<cell>.json. Nothing
here names a cell, so a later cell or metric is a matter of new files.

A run: set-up (the scans made on the host from the seed, in worker
processes while torch and the program load; the program built; one
untimed sequence that builds the kernels and captures the graphs), then a
window of whole sequences, closed loop, one at a time, until `seconds`
have passed; with `trace`, the first sequences of the window run under
torch.profiler. Once the window has closed, every
sequence it ran is judged against the plain reference
(slambench/reference), and the result is one JSON line.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import sys
import time

import numpy as np
import torch

from slambench import gen
from slambench.registry import (  # noqa: F401
    CHECKOUT,
    ROOT,
    benchmark,
    cell_of,
    config,
    families,
    limits,
    metrics_of,
    reader,
    traffic,
)

GROUPS = ("icp", "mapping", "pipeline", "backend", "dist", "bench", "debug")
FORBIDDEN = ("jax", "jaxlib", "flax", "tpu_icp_slam")


# ---- the program, driven ---------------------------------------------------

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


class Program:
    """The system under test, tpu_icp_slam_torch, driven as the traffic mix
    says: "replay" (`ScanToMapPipeline.run_fused` over each log), "online"
    (`ScanToMapPipeline.step`, one scan at a time, the next handed in once
    the last pose is on the host) or "slam" (`Slam3D.run`). Each drive of
    a sequence returns its record: the outputs the check judges and the
    counts the readers take."""

    def __init__(self, cfg: dict, drive: str, device, spans: bool):
        from tpu_icp_slam_torch.slam.scan_to_map import ScanToMapPipeline

        self.cfg = slam_config(cfg)
        self.drive = drive
        self.device = device
        self.spans = spans
        if drive not in ("replay", "online", "slam"):
            raise ValueError(f"unknown drive {drive!r}")
        self.pipe = ScanToMapPipeline(self.cfg, device=device)
        if spans:
            for attr in ("init_state", "run_fused", "step"):
                setattr(self.pipe, attr,
                        _span("frontend", getattr(self.pipe, attr)))

    def run(self, pts, msk) -> dict:
        return getattr(self, f"_{self.drive}")(pts, msk)

    def _replay(self, pts, msk) -> dict:
        state = self.pipe.init_state(pts[0], msk[0])
        _, infos = self.pipe.run_fused(state, pts[1:], msk[1:])
        out = {k: v.cpu().numpy() for k, v in infos.items()}
        return {"poses": out["pose"], "rmse": out["rmse"],
                "is_keyframe": out["is_keyframe"],
                "map_inserted": out["map_inserted"],
                "icp_iters": int(out["iters"].sum()),
                "inserts": int(out["map_inserted"].sum())}

    def _online(self, pts, msk) -> dict:
        state = self.pipe.init_state(pts[0], msk[0])
        poses, infos, frame_s = [], [], []
        for f in range(1, len(pts)):
            t0 = time.perf_counter()
            state, info = self.pipe.step(state, pts[f], msk[f])
            poses.append(info["pose"].cpu().numpy())
            frame_s.append(time.perf_counter() - t0)
            infos.append(info)
        rows = {k: torch.stack([torch.as_tensor(i[k]) for i in infos]
                               ).cpu().numpy()
                for k in ("rmse", "iters", "is_keyframe", "map_inserted")}
        return {"poses": np.stack(poses), "rmse": rows["rmse"],
                "is_keyframe": rows["is_keyframe"],
                "map_inserted": rows["map_inserted"],
                "icp_iters": int(rows["iters"].sum()),
                "inserts": int(rows["map_inserted"].sum()),
                "frame_s": frame_s}

    def _slam(self, pts, msk) -> dict:
        from tpu_icp_slam_torch.slam.slam3d import Slam3D

        slam = Slam3D(self.cfg, device=self.device)
        infos, batches = [], []
        # the front end's infos, which Slam3D.run reads and keeps to itself
        run_fused = slam.pipe.run_fused

        def keep(*a, **kw):
            out = run_fused(*a, **kw)
            infos.append(out[1])
            return out

        slam.pipe.run_fused = keep
        if self.spans:
            # and each verification's batch and batched iterations
            slam.pipe.run_fused = _span("frontend", keep)
            slam.pipe.init_state = _span("frontend", slam.pipe.init_state)
            det = slam.detector
            verify = det.verify_batch

            def count(cands, *a, **kw):
                n0 = det.verify_iters
                out = verify(cands, *a, **kw)
                batches.append((len(cands) * det.cfg.verify_yaws,
                                det.verify_iters - n0))
                return out

            det.verify_batch = _span("verify", count)
        poses, _ = slam.run(pts, msk, mode="fused")
        # the instance's wrappers close over its own methods: drop them, so
        # that the sequence's program state goes with `slam`
        for obj, attr in ((slam.pipe, "run_fused"), (slam.pipe, "init_state"),
                          (slam.detector, "verify_batch")):
            obj.__dict__.pop(attr, None)
        if not infos:
            raise RuntimeError("Slam3D.run made no call to its front end's "
                               "run_fused: the benchmark reads each frame's "
                               "info row there")
        if self.spans and slam.detector.verify_iters and not batches:
            raise RuntimeError("verification ran without a call to "
                               "LoopDetector.verify_batch: the benchmark "
                               "reads each trip's batch there")
        rec = {"poses": poses, "frontend_poses": slam.frontend_poses,
               "closures": sorted((c.i, c.j) for c in slam.closures_kept),
               "verified": [(c.i, c.j, np.asarray(c.T_ij, np.float64))
                            for c in slam.closures],
               "kf_frames": list(slam.kf_frames),
               "icp_iters": int(slam.frontend_iters.sum()),
               "verify_iters": slam.detector.verify_iters,
               "backend_s": slam.backend_s, "verify_batches": batches}
        rows = {k: torch.cat([i[k] for i in infos]).cpu().numpy()
                for k in ("rmse", "is_keyframe", "map_inserted", "iters",
                          "converged")}
        rec.update(rows, inserts=int(rows["map_inserted"].sum()))
        return rec


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
        config_override=None, traffic_override=None, program_cls=Program,
        scans: gen.Prefetch | None = None):
    """One run of a cell: (result dict, check lines). `scans`, the cell's
    sequences for this seed under way (gen.Prefetch). `config_override`
    and `traffic_override` (dict -> dict) and `program_cls` serve the
    tests, which run the whole path on the CPU at a small size."""
    from slambench import check
    from slambench import trace as trace_mod

    bench = bench or benchmark()
    w = cell_of(bench, cell)
    cfg, mix = config(w["config"]), traffic(w["traffic"])
    if config_override:
        cfg = config_override(cfg)
    if traffic_override:
        mix = traffic_override(mix)
    stages = [("start", t_start), ("imports", time.perf_counter())]
    seqs = scans.result() if scans is not None else gen.sequences(
        mix, cfg["pipeline"]["downsample_voxel"],
        cfg["pipeline"]["scan_capacity"], seed)
    stages.append(("scans", time.perf_counter()))
    prog = program_cls(cfg, mix["drive"], device, spans=trace)
    cuda = torch.device(device).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    prog.run(seqs[0][0], seqs[0][1])  # warm-up: builds and captures
    sync()
    stages.append(("warm-up", time.perf_counter()))
    print("set-up: " + ", ".join(
        f"{b[0]} {b[1] - a[1]:.3f} s" for a, b in zip(stages, stages[1:])),
        file=sys.stderr)
    records, profiled = [], []
    n_prof = mix["profile_sequences"] if trace else 0

    def one(i):
        pts, msk, _ = seqs[i % len(seqs)]
        rec = prog.run(pts, msk)
        rec.update(seq=i % len(seqs), frames=len(pts))
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
    ctx = Context(cell=cell, config=cfg, traffic=mix, families=families(),
                  setup_s=setup_s, window_s=window_s, records=records,
                  profiled=profiled, trace=tr, block_ns=block)
    metrics = {}
    for m in metrics_of(bench, cell, trace):
        v = reader(m["name"]).read(ctx)
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
    verdict = check.judge(cfg, mix, seqs, records, limits(cell), device)
    print(f"reference: {time.perf_counter() - t_ref:.3f} s for "
          f"{len(verdict['refs'])} sequence(s)", file=sys.stderr)
    result.update(correct=verdict["correct"], failed=verdict["failed"])
    if cuda:
        result["card"] = _card_line()
    result["checks"] = verdict["checks"]
    return result, verdict["lines"]


def main(argv=None, t_start: float | None = None,
         scans: gen.Prefetch | None = None) -> int:
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
                            scans=scans)
    finally:
        if scans is not None:
            scans.close()
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
