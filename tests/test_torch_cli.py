"""The port's command line (tpu_icp_slam_torch.cli) on the CPU
(`--device cpu`): run --save-map then localize (mirrors
tests/test_cli_localize.py), align, eval against the reference's eval, the
checkpoint/resume flags, the refused bench verb and the default device.

Tolerances: localize within 3.0 m of ground truth (the reference's bound);
align recovers the transform to 1e-3 (config 1's criterion); eval's golden
ATE bit for bit the reference's (the same numpy oracle on the same scans)
and its run's ATE within 1e-4 m of the reference's.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from tpu_icp_slam import cli as jcli
from tpu_icp_slam_torch import cli

ROOT = Path(__file__).resolve().parents[1]
# test_cli_localize.py's `run --save-map` overrides
MAP_OVERRIDES = [
    "pipeline.mode=scan_to_map", "pipeline.scan_capacity=512",
    "pipeline.downsample_voxel=0.5", "pipeline.keyframe_trans=1.0",
    "mapping.map_capacity=4096", "mapping.local_model_size=1024",
    "mapping.map_voxel=0.5",
    "icp.method=point_to_point", "icp.max_iters=8",
    "icp.max_corr_dist=2.0", "icp.nn_backend=xla",
    "backend.enabled=true", "backend.min_loop_separation=4",
]
# a short scan-to-scan run (SlamConfig()'s pipeline) at a small capacity
ODOM_OVERRIDES = ["pipeline.scan_capacity=512",
                  "pipeline.downsample_voxel=0.6", "icp.max_iters=10",
                  "icp.max_corr_dist=2.0"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Test files run in parallel worker processes: one torch thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_run_save_map_then_localize(tmp_path, capsys):
    """Mirrors test_cli_localize.py::test_run_save_map_then_localize."""
    out = tmp_path / "run_out"
    map_file = tmp_path / "map.npz"
    rc = cli.main(["run", "--dataset", "sim3d", "--frames", "14",
                   "--out", str(out), "--save-map", str(map_file),
                   "--device", "cpu", *MAP_OVERRIDES])
    rep = json.loads(capsys.readouterr().out)
    assert rc == 0 and map_file.exists()
    assert rep["mode"] == "slam3d" and rep["map_file"] == str(map_file)
    for name in ("trajectory.npz", "trajectory_tum.txt",
                 "trajectory_kitti.txt", "report.json", "metrics.jsonl",
                 "map.png"):
        assert (out / name).exists(), name
    rc = cli.main(["localize", "--map", str(map_file), "--dataset", "sim3d",
                   "--frame", "6", "--frames", "14", "--device", "cpu",
                   "pipeline.downsample_voxel=0.5"])
    rep = json.loads(capsys.readouterr().out)
    assert rc == 0 and rep["localized"], rep
    assert rep["error_vs_gt_m"] < 3.0, rep


def test_align_recovers_transform(capsys):
    rc = cli.main(["align", "--n", "512", "--device", "cpu", "--repeat",
                   "2"])
    rep = json.loads(capsys.readouterr().out)
    assert rc == 0 and rep["recovered_under_1e-3"], rep
    assert rep["n_points"] == 512 and rep["converged"]
    assert rep["batched_repeat"] == 2 and rep["batched_solves_per_s"] > 0


def test_module_entry_point_runs():
    """`python -m tpu_icp_slam_torch.cli` is the console script's main."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "tpu_icp_slam_torch.cli", "align", "--n",
         "512", "--device", "cpu"], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout)["recovered_under_1e-3"]


def test_eval_matches_reference(capsys):
    args = ["eval", "--dataset", "sim3d", "--frames", "6", *ODOM_OVERRIDES]
    assert jcli.main(args + ["icp.nn_backend=xla"]) == 0
    want = json.loads(capsys.readouterr().out)
    assert cli.main(args + ["--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out)
    assert set(got) == set(want) >= {"tpu_ate", "golden_ate",
                                     "tpu_vs_golden_ate"}
    assert got["golden_ate"] == want["golden_ate"]
    assert abs(got["tpu_ate"] - want["tpu_ate"]) <= 1e-4
    assert abs(got["tpu_vs_golden_ate"] - want["tpu_vs_golden_ate"]) <= 1e-4
    assert (got["frames"], got["mode"]) == (want["frames"], want["mode"])


def test_run_checkpoint_then_resume(tmp_path, capsys):
    """--checkpoint-every streams and writes out/checkpoint.npz; --resume
    continues from it to the same trajectory."""
    base = ["run", "--dataset", "sim3d", "--frames", "6", "--device", "cpu",
            *ODOM_OVERRIDES]
    assert cli.main(base + ["--out", str(tmp_path / "a")]) == 0
    full = json.loads(capsys.readouterr().out)
    assert cli.main(base + ["--out", str(tmp_path / "b"),
                            "--checkpoint-every", "2"]) == 0
    ck = json.loads(capsys.readouterr().out)
    assert ck["mode"] == "streaming"
    assert (tmp_path / "b" / "checkpoint.npz").exists()
    assert cli.main(base + ["--out", str(tmp_path / "b"), "--resume"]) == 0
    res = json.loads(capsys.readouterr().out)
    assert abs(res["ate_rmse"] - full["ate_rmse"]) <= 1e-5
    assert "resume" in (tmp_path / "b" / "metrics.jsonl").read_text()


def test_bench_is_refused_and_names_its_roadmap_item():
    with pytest.raises(NotImplementedError, match="queue 1, item 8"):
        cli.main(["bench"])


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="checks the default device where there is no card")
@pytest.mark.parametrize("verb", [
    ["align", "--n", "64"],
    ["run", "--dataset", "sim3d", "--frames", "2"],
    ["eval", "--dataset", "sim3d", "--frames", "2"],
    ["localize", "--map", "none.npz"],
])
def test_default_device_raises_without_a_card(verb):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(verb)
