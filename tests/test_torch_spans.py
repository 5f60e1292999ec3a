"""The program's spans (obs/profile.py) in the scan-to-map frame loop, on
the CPU: `FrameGraphs` run eagerly over a short log under a CPU profiler
gives one icp_slam.frame a frame; each frame's graph.* and read.* spans
nest inside it; their counts follow the frames' info rows (ICP trips,
condition reads, inserts); step() is the span step around its frame; and
every program span is a function-scope event, never a user annotation.
"""

import collections

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from test_torch_frame_graph import GRAPH_CASES, _problem, _t
from tpu_icp_slam_torch.obs.profile import PREFIX
from tpu_icp_slam_torch.slam import scan_to_map as s2m

CPU = torch.device("cpu")


def _spans(prof) -> list:
    """(start_ns, end_ns, name without the prefix) of the program's spans,
    in start order; every one a function-scope event."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith(PREFIX):
            assert not e.is_user_annotation(), e.name()
            out.append((e.start_ns(), e.end_ns(), e.name()[len(PREFIX):]))
    return sorted(out)


def _by_frame(spans) -> list:
    """Each frame span's children's names, counted; every span other than
    a frame lies inside exactly one frame."""
    frames = [(s, e) for s, e, n in spans if n == "frame"]
    kids = [collections.Counter() for _ in frames]
    for s, e, n in spans:
        if n == "frame":
            continue
        inside = [k for k, (f0, f1) in enumerate(frames)
                  if f0 <= s and e <= f1]
        assert len(inside) == 1, (n, s, e)
        kids[inside[0]][n] += 1
    return kids


@pytest.mark.parametrize("case", ["steps", "hysteresis", "fused"])
def test_frame_spans_follow_the_info_rows(case):
    cfg, pts, msk, state0 = _problem(case, GRAPH_CASES)
    graphs = s2m.FrameGraphs(cfg, pts.shape[1], CPU)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _, infos = graphs.run(state0, _t(pts[1:]), _t(msk[1:], bool))
    kids = _by_frame(_spans(prof))
    n = len(pts) - 1
    assert len(kids) == n
    iters = infos["iters"].tolist()
    inserted = infos["map_inserted"].tolist()
    max_iters = cfg.icp.max_iters
    assert sum(inserted) >= 1
    for k, c in enumerate(kids):
        assert c["graph.pre"] == 1 and c["read.insert"] == 1
        assert c["graph.insert"] == int(inserted[k])
        hyst = case == "hysteresis"
        assert c["graph.need"] == c["read.need"] == int(hyst)
        if case == "fused":
            # K5 runs the whole ICP and post inside pre: nothing to read
            assert c["graph.trip"] == c["read.trip"] == c["graph.post"] == 0
            continue
        # trip 0 runs in pre, one replay a later trip; the condition is
        # read after every trip but one that reaches max_iters
        assert c["graph.trip"] == iters[k] - 1
        assert c["read.trip"] == iters[k] - (iters[k] >= max_iters)
        assert c["graph.post"] == 1
    if case != "fused":
        assert sum(c["graph.trip"] for c in kids) == sum(iters) - n


def test_step_span_holds_its_frame():
    """step() is one span step around one frame span; the state load, the
    snapshot and the info's unrow are step's own time."""
    cfg, pts, msk, state0 = _problem("steps", GRAPH_CASES)
    graphs = s2m.FrameGraphs(cfg, pts.shape[1], CPU)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        state = state0
        for f in (1, 2):
            state, _ = graphs.step(state, _t(pts[f]), _t(msk[f], bool))
    spans = _spans(prof)
    steps = [(s, e) for s, e, n in spans if n == "step"]
    frames = [(s, e) for s, e, n in spans if n == "frame"]
    assert len(steps) == len(frames) == 2
    for (s0, s1), (f0, f1) in zip(steps, frames):
        assert s0 < f0 and f1 < s1
