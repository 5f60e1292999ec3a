"""Nothing a cell runs loads JAX or the JAX package (top-level module names
compared whole: tpu_icp_slam_torch is not tpu_icp_slam), and the plain
reference loads nothing of the program."""

import os
import subprocess
import sys

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

CELL_RUN = r"""
import sys, time, json
sys.path[:0] = [{checkout!r}, {checkout!r} + "/src", {tests!r}]
import torch
torch.set_num_threads(2)
from conftest import small_config, small_traffic
from slambench import harness
for cell in ("kitti-odom.online", "kitti-slam.loop"):
    res, _ = harness.run(cell, 5, 0.1, True, time.perf_counter(),
                         device="cpu", config_override=small_config,
                         traffic_override=small_traffic)
    assert res["correct"], res
for m in harness.benchmark()["per_layer"] + harness.benchmark()["end_to_end"]:
    harness.reader(m["name"])
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
print(json.dumps(harness.forbidden_modules()))
"""


def _run(code):
    env = dict(os.environ, PYTHONPATH="")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=CHECKOUT, env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout.strip().splitlines()


def test_a_cells_run_loads_no_jax():
    tests = os.path.join(CHECKOUT, "slambench", "tests")
    lines = _run(CELL_RUN.format(checkout=CHECKOUT, tests=tests))
    loaded = set(eval(lines[-2]))
    assert "tpu_icp_slam_torch" in loaded and "slambench" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "tpu_icp_slam"}
    assert eval(lines[-1]) == []
    assert not loaded & {"chip_smoke", "chip_ab", "bench"}


def test_the_reference_loads_nothing_of_the_program():
    code = (f"import sys; sys.path[:0] = [{CHECKOUT!r}]\n"
            "import slambench.reference.odometry, slambench.reference.slam\n"
            "import slambench.check, slambench.gen, slambench.roofline\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    loaded = set(eval(_run(code)[-1]))
    assert not loaded & {"tpu_icp_slam_torch", "tpu_icp_slam", "jax"}


def test_drives_load_neither_torch_nor_the_program():
    """A drive's jobs and sequences run in workers forked before torch
    loads: importing a drive module loads neither torch nor the port."""
    code = (f"import sys; sys.path[:0] = [{CHECKOUT!r}]\n"
            "from slambench import registry\n"
            "names = sorted(p.stem for p in (registry.ROOT / 'drives')"
            ".glob('*.py') if not p.stem.startswith('_'))\n"
            "mods = [registry.drive(n) for n in names]\n"
            "print(names)\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    lines = _run(code)
    assert {"replay", "online", "slam"} <= set(eval(lines[-2]))
    loaded = set(eval(lines[-1]))
    assert "slambench" in loaded and "numpy" in loaded
    assert not loaded & {"torch", "tpu_icp_slam_torch", "tpu_icp_slam",
                         "jax"}


def test_forbidden_names_are_compared_whole(monkeypatch):
    from slambench import harness

    monkeypatch.setitem(sys.modules, "tpu_icp_slam_torch_extra", sys)
    assert "tpu_icp_slam" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.fake", sys)
    assert harness.forbidden_modules() == ["jaxlib"]


def test_no_card_no_result():
    """run.py without a CUDA device exits non-zero and prints no result."""
    out = subprocess.run(
        [sys.executable, "slambench/run.py", "--workload",
         "kitti-odom.replay", "--seed", "1", "--seconds", "1", "--trace",
         "0"], capture_output=True, text=True, cwd=CHECKOUT, timeout=300,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr
