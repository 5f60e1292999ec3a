"""The harness finds configurations, traffic mixes, drives, metric readers,
kernel families and limits by name, files added later included (a cell of
a new kind of input runs whole from new files alone), and BENCHMARK.json
keeps to the benchmark's contract."""

import json
import re
import shutil
import time
from pathlib import Path

import pytest

from slambench import harness

BENCH = harness.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
DRIVE_MEMBERS = ("jobs", "sequence", "Program", "reference", "numbers",
                 "key", "FAULTS")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves(cell):
    w = harness.cell_of(BENCH, cell)
    assert cell == f"{w['config']}.{w['traffic']}"
    cfg, mix = harness.config(w["config"]), harness.traffic(w["traffic"])
    assert set(harness.GROUPS) <= set(cfg)
    harness.slam_config(cfg)  # the port takes the groups as they are
    drive = harness.drive(mix["drive"])
    for member in DRIVE_MEMBERS:
        assert hasattr(drive, member), member
    assert callable(drive.Program.run) and drive.FAULTS
    assert len(drive.jobs(cfg, mix, 2**31 + 3)) >= 1
    assert mix["profile_sequences"] >= 1
    assert harness.limits(cell)
    for trace in (False, True):
        for m in harness.metrics_of(BENCH, cell, trace):
            assert callable(harness.reader(m["name"]).read)


TOY_DRIVE = '''"""A toy drive: a stack of (F, 6, 8) float32 "depth" images a
sequence; the program reads each image's mean depth as its pose's z."""

import contextlib

import numpy as np


def jobs(cfg, mix, seed):
    return [(mix["frames"], cfg["depth_m"], seed, k)
            for k in range(mix["sequences"])]


def sequence(frames, depth_m, seed, k):
    rng = np.random.default_rng([abs(seed), k])
    depth = (depth_m * (0.5 + rng.random((frames, 6, 8)))).astype(np.float32)
    return (depth,), None


class Program:
    def __init__(self, cfg, device, spans):
        self.device = device
        self.bias = cfg.get("bias_m", 0.0)

    def run(self, depth):
        import torch

        z = torch.as_tensor(depth, device=self.device).mean(dim=(1, 2))
        poses = np.tile(np.eye(4), (len(depth), 1, 1))
        poses[:, 2, 3] = z.cpu().numpy() + self.bias
        return {"poses": poses, "icp_iters": len(depth)}


def reference(cfg, mix, inputs, rec, device, precision):
    (depth,) = inputs
    return {"z": depth.astype(np.float64).mean(axis=(1, 2))}


def numbers(rec, ref, gt):
    return {"z_gap_m": float(np.max(np.abs(rec["poses"][:, 2, 3]
                                           - ref["z"])))}


def key(rec):
    return (rec["seq"], rec["poses"].tobytes())


def _biased(cfg):
    return dict(cfg, bias_m=0.01), contextlib.nullcontext()


FAULTS = {"biased": _biased}
'''
TOY_BENCH = {
    "workloads": [{"name": "toy-depth.toy", "config": "toy-depth",
                   "traffic": "toy", "chips": 1, "why": "a toy"}],
    "end_to_end": [
        {"name": "frames_per_s", "unit": "frames/s", "better": "higher",
         "bound": 0.1, "source": "host_clock"},
        {"name": "setup_s", "unit": "s", "better": "lower", "bound": 0.25,
         "source": "host_clock"}],
    "per_layer": [
        {"name": "icp_iters_per_frame", "unit": "iters/frame",
         "better": "lower", "source": "program_counter", "layer": "toy",
         "moves": "frames_per_s"}]}


def test_files_added_later_are_found(tmp_path):
    root = tmp_path / "slambench"
    shutil.copytree(harness.ROOT, root, ignore=shutil.ignore_patterns(
        "tests", "__pycache__"))
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}
    (root / "kernels" / "icp_nn_k9.json").write_text(json.dumps(
        {"family": "icp_nn", "work": "icp_nn", "span": "slambench.frontend",
         "patterns": ["k9_scan_kernel", "nn_split_kernel"]}))
    (root / "kernels" / "fresh.json").write_text(json.dumps(
        {"family": "fresh", "work": "knn", "patterns": ["fresh_kernel"]}))
    (root / "metrics" / "fresh_metric.py").write_text(
        "def read(ctx):\n    return 42.0\n")
    (root / "configs" / "fresh-config.json").write_text(json.dumps(
        {"source": "s", "icp": {}}))
    (root / "traffic" / "fresh.json").write_text(json.dumps(
        {"drive": "replay", "worlds": [7]}))
    (root / "limits" / "fresh-config.fresh.json").write_text(json.dumps(
        {"rmse_gap_med": 1.0}))
    # a new kind of input: its drive, configuration, mix and limits
    (root / "drives" / "toy.py").write_text(TOY_DRIVE)
    (root / "configs" / "toy-depth.json").write_text(json.dumps(
        {"source": "s", "depth_m": 2.0}))
    (root / "traffic" / "toy.json").write_text(json.dumps(
        {"drive": "toy", "frames": 5, "sequences": 2,
         "profile_sequences": 1}))
    (root / "limits" / "toy-depth.toy.json").write_text(json.dumps(
        {"z_gap_m": 1e-5}))
    fams = harness.families(root)
    assert fams["icp_nn"]["patterns"][-1] == "k9_scan_kernel"
    assert fams["icp_nn"]["patterns"].count("nn_split_kernel") == 1
    assert fams["fresh"] == {"patterns": ["fresh_kernel"], "work": "knn",
                             "span": None}
    assert harness.reader("fresh_metric", root).read(None) == 42.0
    assert harness.config("fresh-config", root)["source"] == "s"
    assert harness.traffic("fresh", root)["worlds"] == [7]
    assert harness.limits("fresh-config.fresh", root) == {"rmse_gap_med": 1.0}
    with pytest.raises(FileNotFoundError):
        harness.reader("no_such_metric", root)
    with pytest.raises(FileNotFoundError):
        harness.drive("no_such_drive", root)
    toy = harness.drive("toy", root)
    assert harness.drive("toy", root) is toy
    assert all(hasattr(toy, m) for m in DRIVE_MEMBERS)
    # the toy cell runs whole from the copy, its inputs one depth stack
    for trace in (False, True):
        res, lines = harness.run("toy-depth.toy", 2**31 + 11, 0.1, trace,
                                 time.perf_counter(), device="cpu",
                                 bench=TOY_BENCH, root=root)
        assert res["correct"] and res["failed"] == 0, lines
        assert res["attempted"] >= 2
        assert set(res["metrics"]) == ({"icp_iters_per_frame"} if trace
                                       else {"frames_per_s", "setup_s"})
        assert res["metrics"].get("icp_iters_per_frame", {"value": 1.0}
                                  )["value"] == 1.0
        assert 0.0 <= res["checks"]["z_gap_m"]["value"] <= 1e-5

    # and its own planted fault is judged not correct
    class Faulted(toy.Program):
        def __init__(self, cfg, *a, **kw):
            cfg, _ = toy.FAULTS["biased"](cfg)
            super().__init__(cfg, *a, **kw)

    res, lines = harness.run("toy-depth.toy", 2**31 + 11, 0.1, False,
                             time.perf_counter(), device="cpu",
                             bench=TOY_BENCH, root=root, program_cls=Faulted)
    assert not res["correct"] and res["failed"] == res["attempted"], lines
    assert res["checks"]["z_gap_m"]["value"] == pytest.approx(0.01, abs=1e-5)
    # all of it from new files: none that the copy already had was edited
    assert all(p.read_bytes() == b for p, b in before.items())


def test_the_harness_names_no_drive_and_no_kind_of_input():
    for name in ("harness.py", "check.py", "run.py", "calibrate.py"):
        text = (harness.ROOT / name).read_text()
        for word in ("ScanToMapPipeline", "Slam3D", '"replay"', '"online"',
                     '"slam"', "downsample_voxel", "scan_capacity"):
            assert word not in text, (name, word)


def test_metrics_of_a_cell():
    names = {c: [m["name"] for m in harness.metrics_of(BENCH, c, False)]
             for c in CELLS}
    assert names["kitti-odom.online"] == ["frames_per_s", "frame_ms_p95",
                                          "setup_s"]
    assert names["kitti-odom.replay"] == ["frames_per_s", "setup_s"]
    assert names["kitti-slam.loop"] == ["frames_per_s.slam", "setup_s"]
    traced = [m["name"] for m in harness.metrics_of(BENCH, "kitti-slam.loop",
                                                    True)]
    assert "verify_nn_roofline" in traced and "frame_ms_p50" not in traced
    noloop = [m["name"] for m in harness.metrics_of(BENCH,
                                                    "kitti-slam.noloop", True)]
    assert "verify_iters_per_seq" in noloop
    assert "verify_nn_roofline" not in noloop


def test_benchmark_contract():
    b = BENCH
    assert list(b) == ["command", "paths", "run_seconds", "configs",
                       "workloads", "end_to_end", "per_layer"]
    assert b["command"] == ["python3", "slambench/run.py"]
    assert b["paths"] == ["slambench"]
    assert 1 <= b["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (b["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert CELLS == ["kitti-odom.replay", "kitti-slam.loop",
                     "kitti-odom.online", "kitti-slam.noloop"]
    metric_names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(set(metric_names)) == len(metric_names)
    assert [m["name"] for m in b["end_to_end"]] == [
        "frames_per_s", "frames_per_s.slam", "frame_ms_p95", "setup_s"]
    used = set()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("slambench/")
        assert Path(harness.CHECKOUT / c["file"]).exists()
        cfg = json.loads((harness.CHECKOUT / c["file"]).read_text())
        assert cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"]
        assert 1 <= len(c["source"]) <= 200 and len(c["why"]) <= 200
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and NAME.match(w["name"])
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
        used.add(w["config"])
    assert used == {c["name"] for c in b["configs"]}
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert m["moves"] in e2e
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"])
        for cell in m.get("workloads", CELLS):
            assert m["moves"] in [x["name"] for x in harness.metrics_of(
                b, cell, False)]
    for cell in CELLS:
        e = [m["name"] for m in harness.metrics_of(b, cell, False)]
        assert "setup_s" in e and len(e) >= 2
        assert harness.metrics_of(b, cell, True)
