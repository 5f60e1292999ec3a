"""The harness finds configurations, traffic mixes, metric readers, kernel
families and limits by name, files added later included, and
BENCHMARK.json keeps to the benchmark's contract."""

import json
import re
import shutil
from pathlib import Path

import pytest

from slambench import harness

BENCH = harness.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves(cell):
    w = harness.cell_of(BENCH, cell)
    assert cell == f"{w['config']}.{w['traffic']}"
    cfg, mix = harness.config(w["config"]), harness.traffic(w["traffic"])
    assert set(harness.GROUPS) <= set(cfg)
    harness.slam_config(cfg)  # the port takes the groups as they are
    assert mix["drive"] in ("replay", "online", "slam")
    assert len(mix["worlds"]) >= 1 and mix["profile_sequences"] >= 1
    assert harness.limits(cell)
    for trace in (False, True):
        for m in harness.metrics_of(BENCH, cell, trace):
            assert callable(harness.reader(m["name"]).read)


def test_files_added_later_are_found(tmp_path):
    root = tmp_path / "slambench"
    shutil.copytree(harness.ROOT, root, ignore=shutil.ignore_patterns(
        "tests", "__pycache__"))
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
