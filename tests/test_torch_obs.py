"""The port's obs/bench.py and obs/profile.py against the reference's:
`measurement_stamp` on a clean and a dirty scratch git tree, the profiler
helpers on the CPU, and `cli bench --device cpu --config-id 1..5` at small
--frames, whose JSON keys are the reference's plus `impl` and
`device_name`. The reference's keys come from its own `bench_from_cli`
with its timing replaced by a constant, so no JAX program is timed."""

import argparse
import contextlib
import io
import json
import os
import subprocess

import pytest
import torch

from tpu_icp_slam.obs import bench as jbench
from tpu_icp_slam_torch import cli
from tpu_icp_slam_torch.obs import bench, profile, timers

FRAMES = {1: 3, 2: 4, 3: 3, 4: 2, 5: 3}


def _git(root, *args):
    subprocess.run(["git", "-C", str(root), "-c", "user.name=t",
                    "-c", "user.email=t@t", *args], check=True,
                   capture_output=True)


def test_measurement_stamp_clean_and_dirty(tmp_path, monkeypatch):
    monkeypatch.delenv("ALLOW_DIRTY_BENCH", raising=False)
    _git(tmp_path, "init", "-q")
    (tmp_path / "a.txt").write_text("a\n")
    _git(tmp_path, "add", "a.txt")
    _git(tmp_path, "commit", "-q", "-m", "a")
    sha = subprocess.run(["git", "-C", str(tmp_path), "rev-parse", "--short",
                          "HEAD"], capture_output=True, text=True,
                         check=True).stdout.strip()
    assert bench.measurement_stamp(root=str(tmp_path)) == {
        "git_sha": sha, "git_dirty": False}
    (tmp_path / "b.txt").write_text("b\n")  # untracked: dirty
    with pytest.raises(RuntimeError, match="dirty tree"):
        bench.measurement_stamp(root=str(tmp_path))
    assert bench.measurement_stamp(allow_dirty=True, root=str(tmp_path)) == {
        "git_sha": sha, "git_dirty": True}
    monkeypatch.setenv("ALLOW_DIRTY_BENCH", "1")
    assert bench.measurement_stamp(root=str(tmp_path))["git_dirty"] is True
    # not a repository: the reference's "unknown" row
    assert bench.measurement_stamp(root=str(tmp_path / "none"))[
        "git_sha"] == "unknown"


def test_measurement_stamp_resolves_this_repository(monkeypatch):
    """The port's file sits at the reference's depth: both name the same
    checkout."""
    monkeypatch.setenv("ALLOW_DIRTY_BENCH", "1")
    assert bench.measurement_stamp()["git_sha"] == \
        jbench.measurement_stamp()["git_sha"]


def test_profile_trace_annotate_scope(tmp_path):
    """The reference's annotate/scope are the port's one span: a range
    icp_slam.<name> in the trace file, nested as opened."""
    with timers.trace(str(tmp_path)):
        with profile.span("stage_a"):
            with profile.span("inner"):
                (torch.ones(8, 8) @ torch.ones(8, 8)).sum()
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    got = {e["name"]: (e["ts"], e["ts"] + e["dur"]) for e in events
           if e.get("name", "").startswith(profile.PREFIX)}
    assert set(got) == {"icp_slam.stage_a", "icp_slam.inner"}
    (a0, a1), (b0, b1) = got["icp_slam.stage_a"], got["icp_slam.inner"]
    assert a0 <= b0 <= b1 <= a1


def test_span_records_only_under_a_profiler():
    """With no profiler a span records nothing; under one, every program
    span is a function-scope event, not a user annotation (which the
    profiler would mirror onto the device's timeline)."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    with profile.span("before"):
        torch.ones(4).sum()
    with torch_profile(activities=[ProfilerActivity.CPU]) as prof:
        with profile.span("inside"):
            torch.ones(4).sum()
    with profile.span("after"):
        torch.ones(4).sum()
    ours = [e for e in prof.profiler.kineto_results.events()
            if e.name().startswith(profile.PREFIX)]
    assert [e.name() for e in ours] == ["icp_slam.inside"]
    assert not any(e.is_user_annotation() for e in ours)


def test_profiler_started_inside_an_open_span():
    """A span opened before a profiler started records nothing and closes
    cleanly inside it (torch's record would refuse to close, an internal
    assert); one opened under the profiler and closed after it stopped is
    kept."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    outer = profile.span("opened_before")
    outer.__enter__()
    with torch_profile(activities=[ProfilerActivity.CPU]) as prof:
        torch.ones(4).sum()
        outer.__exit__(None, None, None)
        inner = profile.span("closed_after")
        inner.__enter__()
    inner.__exit__(None, None, None)
    names = [e.name() for e in prof.profiler.kineto_results.events()
             if e.name().startswith(profile.PREFIX)]
    assert names == ["icp_slam.closed_after"]


def test_profile_does_not_swallow_errors(tmp_path):
    """Stated deviation: the reference's helpers catch every exception and
    yield again; the port's let the block's error through."""
    with pytest.raises(ValueError, match="inside"):
        with timers.trace(str(tmp_path)):
            with profile.span("a"):
                raise ValueError("inside")


def _reference_keys(cid, monkeypatch):
    monkeypatch.setattr(jbench, "_steady", lambda fn, repeats=3: 1.0)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        jbench.bench_from_cli(argparse.Namespace(
            config_id=cid, frames=FRAMES[cid], json=True))
    return json.loads(buf.getvalue())


@pytest.mark.parametrize("cid", [1, 2, 3, 4, 5])
def test_cli_bench_on_cpu_has_the_reference_keys(cid, monkeypatch, capsys):
    assert cli.main(["bench", "--device", "cpu", "--config-id", str(cid),
                     "--frames", str(FRAMES[cid]), "--json"]) == 0
    got = json.loads(capsys.readouterr().out)
    want = _reference_keys(cid, monkeypatch)
    assert set(got) == set(want) | {"impl", "device_name"}, (got, want)
    assert got["platform"] == "cpu" and got["devices"] == 1
    assert got["impl"] == "torch" and got["device_name"] == "cpu"
    if cid == 5:
        # one rank: one row of each kind, no communication model (the
        # reference emits it from two devices up)
        assert [r["devices"] for r in got["rows"]] == [1]
        assert got["rows"][0].keys() == want["rows"][0].keys()
        assert got["schur_rows"][0].keys() == want["schur_rows"][0].keys()
        assert got["comm_model"] == []
        assert got["rows"][0]["efficiency"] == 1.0
    else:
        assert got["metric"] == want["metric"] and got["value"] > 0
        assert got["unit"] == want["unit"]


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="checks the default device where there is no card")
def test_cli_bench_default_device_refuses_without_a_card():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["bench"])
    assert not os.environ.get("RANK")  # nothing started a world
