"""The window's arithmetic: rates over all the work and all the time,
percentiles over every frame, the device readers over the profiled block,
and a run whose window holds a stall."""

import statistics
import time

import numpy as np
import pytest

from slambench import harness, trace
from slambench.harness import Context


def _ctx(records, window_s, profiled=(), tr=None, block=(0, 0)):
    return Context(cell="c", config=harness.config("kitti-odom"),
                   traffic={}, families=harness.families(), setup_s=12.5,
                   window_s=window_s, records=list(profiled) + list(records),
                   profiled=list(profiled), trace=tr, block_ns=block)


def read(name, ctx):
    return harness.reader(name).read(ctx)


def test_rate_is_all_frames_over_the_whole_window():
    recs = [{"frames": 30, "icp_iters": 90, "inserts": 10}] * 7
    ctx = _ctx(recs, window_s=0.5)
    assert read("frames_per_s", ctx) == 7 * 30 / 0.5
    assert read("setup_s", ctx) == 12.5
    assert read("icp_iters_per_frame", ctx) == 3.0
    assert read("inserts_per_frame", ctx) == pytest.approx(1 / 3)


def test_percentiles_over_every_frame_with_a_stall():
    times = [i / 1000 for i in range(1, 101)]  # 1..100 ms
    recs = [{"frames": 51, "frame_s": times[:50]},
            {"frames": 51, "frame_s": times[50:]}]
    ctx = _ctx(recs, window_s=10.0)
    assert read("frame_ms_p95", ctx) == pytest.approx(95.05)
    assert read("frame_ms_p50", ctx) == pytest.approx(50.5)
    # one frame stalls for a second: the tail moves by one rank, the rate
    # pays the whole stall
    stalled = [{"frames": 51, "frame_s": times[:50] + [1.0]},
               {"frames": 51, "frame_s": times[50:]}]
    ctx2 = _ctx(stalled, window_s=11.0)
    assert read("frame_ms_p95", ctx2) == pytest.approx(
        1e3 * statistics.quantiles(times + [1.0], n=100,
                                   method="inclusive")[94])
    assert read("frames_per_s", ctx2) == 102 / 11.0
    # readers of another mix read nothing
    assert read("frame_ms_p95", _ctx([{"frames": 3}], 1.0)) is None
    assert read("backend_s_per_seq", _ctx([{"frames": 3}], 1.0)) is None


def test_device_readers_over_the_profiled_block():
    us = 1000  # ns
    ops = [("k1", 0, 400 * us, None), ("k2", 300 * us, 200 * us, None),
           ("k3", 1000 * us, 500 * us, None)]  # union [0, 500), [1000, 1500)
    tr = trace.Trace(ops=ops, launches=12, syncs=6,
                     host=[(450 * us, 1200 * us, "cudaStreamSynchronize"),
                           (700 * us, 800 * us, "aten::copy_")], spans=[])
    prof = [{"frames": 3, "icp_iters": 1, "inserts": 0}] * 2
    ctx = _ctx([{"frames": 3, "icp_iters": 1, "inserts": 0}], 1.0,
               profiled=prof, tr=tr, block=(0, 2000 * us))
    assert tr.busy_ns() == 1000 * us and tr.device_ns() == 1100 * us
    assert read("device_idle_share", ctx) == pytest.approx(50.0)
    assert read("device_ms_per_frame", ctx) == pytest.approx(1.1 / 6)
    assert read("launch_calls_per_frame", ctx) == 2.0
    assert read("host_syncs_per_frame", ctx) == 1.0
    # the gap [500, 1000) us is charged to the innermost host event at its
    # middle (the copy inside the sync), the trailing one to nothing traced
    gaps = dict(tr.idle_gaps(0, 2000 * us))
    assert gaps == {"aten::copy_": pytest.approx(500e-6),
                    "host, no traced op": pytest.approx(500e-6)}
    assert tr.top_ops() == [["k3", 5e-4], ["k1", 4e-4], ["k2", 2e-4]]
    assert trace.merged(ops) == [[0, 500 * us], [1000 * us, 1500 * us]]


class _StallingProgram:
    """A program of 5-frame sequences that takes 10 ms a sequence, 300 ms
    in its third."""

    def __init__(self, cfg, drive, device, spans):
        self.n = 0

    def run(self, pts, msk):
        self.n += 1
        time.sleep(0.3 if self.n == 3 else 0.01)
        f = len(pts)
        return {"poses": np.tile(np.eye(4), (f - 1, 1, 1)),
                "rmse": np.ones(f - 1), "icp_iters": 2 * (f - 1),
                "inserts": 1}


def test_a_window_with_a_stall(monkeypatch):
    from slambench import check

    monkeypatch.setattr(check, "judge", lambda *a, **k: {
        "correct": True, "failed": 0, "checks": {}, "lines": [],
        "refs": {}})

    def tiny(mix):
        return dict(mix, frames=5, rings=4, azimuth=32, worlds=[0])

    t0 = time.perf_counter()
    res, _ = harness.run("kitti-odom.replay", 3, 0.5, False, t0,
                         device="cpu", traffic_override=tiny,
                         program_cls=_StallingProgram)
    n = res["attempted"]
    rate = res["metrics"]["frames_per_s"]["value"]
    window = 5 * n / rate
    # whole sequences until 0.5 s have passed, the stall inside
    assert window >= 0.5 and window < 0.5 + 0.2
    assert 0.3 + 0.01 * (n - 1) <= window
    assert res["correct"] and res["failed"] == 0
    assert res["device"]["platform"] == "cpu"
