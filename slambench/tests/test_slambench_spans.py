"""The readers of the program's own spans (icp_slam.*) on a synthetic
trace: the frame's idle split into graph launches and host, which with the
busy time fills the frame spans; step's own time outside its frame;
the idle inside the frame's host reads and inside verification's trip
replays; verification's idle and the pose graph's solve a sequence;
nothing read without a trace or from a program that has no spans."""

import pytest

from slambench import harness, trace
from slambench.harness import Context

US = 1000  # ns
SPANS = [  # (start, end, name) in us
    (0, 1000, "step"),
    (100, 900, "frame"),
    (100, 200, "graph.pre"),
    (250, 400, "read.trip"),
    (400, 500, "graph.trip"),
    (600, 700, "graph.insert"),
    (1000, 2000, "frame"),
    (1000, 1100, "graph.pre"),
    (1500, 1600, "graph.post"),
    (2000, 2500, "verify.batch"),
    (2100, 2200, "graph.verify_trip"),
    (2500, 3000, "backend.graph"),
]
OPS = [(150, 350), (450, 650), (1050, 1200), (2150, 2300)]  # busy, us
NEW = ("launch_idle_ms_per_frame", "host_idle_ms_per_frame",
       "read_idle_ms_per_frame", "step_self_ms_per_frame",
       "verify_idle_s_per_seq", "verify_launch_idle_s_per_seq",
       "graph_solve_s_per_seq")


def _ctx(spans=SPANS, traced=True):
    host = [(s * US, e * US, f"icp_slam.{n}") for s, e, n in spans]
    host.append((120 * US, 150 * US, "aten::copy_"))
    tr = trace.Trace(ops=[("k", s * US, (e - s) * US, None)
                          for s, e in OPS],
                     launches=0, syncs=0, host=host, spans=[])
    prof = [{"frames": 2}]
    return Context(cell="c", config=harness.config("kitti-odom"),
                   traffic={}, families=harness.families(), setup_s=1.0,
                   window_s=1.0, records=prof + [{"frames": 2}],
                   profiled=prof if traced else [],
                   trace=tr if traced else None, block_ns=(0, 3000 * US))


def read(name, ctx):
    return harness.reader(name).read(ctx)


def test_launch_and_host_idle_fill_the_frames_with_the_busy_time():
    ctx = _ctx()
    launch = read("launch_idle_ms_per_frame", ctx)
    host = read("host_idle_ms_per_frame", ctx)
    # graph replays in frames: 500 us, 200 of them busy
    assert launch == pytest.approx(0.300 / 2)
    # frames 1,800 us, busy 550: the idle outside the replays (the read
    # and the Python between them) is the host's
    assert host == pytest.approx(0.950 / 2)
    busy_in_frames = 550e-3
    assert 2 * (launch + host) + busy_in_frames == pytest.approx(1.8)
    # with the idle outside the frames, the whole block's idle
    idle = read("device_idle_share", ctx) / 100 * 3.0  # ms of the block
    # outside the frames: [0, 100), [900, 1000), [2000, 3000) less 150 busy
    outside = (100 + 100 + 1000 - 150) * 1e-3
    assert 2 * (launch + host) + outside == pytest.approx(idle)
    assert read("launch_idle_ms_per_frame.slam", ctx) == launch
    assert read("host_idle_ms_per_frame.slam", ctx) == host


def test_read_idle_is_the_part_of_host_idle_inside_the_reads():
    ctx = _ctx()
    # read.trip [250, 400) with [150, 350) busy: 50 us idle, two frames
    reads = read("read_idle_ms_per_frame", ctx)
    assert reads == pytest.approx(0.050 / 2)
    assert reads < read("host_idle_ms_per_frame", ctx)
    assert read("read_idle_ms_per_frame.slam", ctx) == reads


def test_step_self_time_leaves_out_its_frame():
    # step [0, 1000) less its frame [100, 900), over two frames
    assert read("step_self_ms_per_frame", _ctx()) == pytest.approx(0.100)


def test_verification_idle_and_graph_solve_a_sequence():
    ctx = _ctx()
    # verify.batch [2000, 2500) with [2150, 2300) busy
    assert read("verify_idle_s_per_seq", ctx) == pytest.approx(350e-6)
    assert read("graph_solve_s_per_seq", ctx) == pytest.approx(500e-6)
    # its trip replay [2100, 2200) with [2150, 2300) busy
    assert read("verify_launch_idle_s_per_seq", ctx) == pytest.approx(50e-6)


@pytest.mark.parametrize("name", NEW)
def test_nothing_read_without_a_trace_or_spans(name):
    assert read(name, _ctx(traced=False)) is None
    # a program that emits no span of its own (an older tree)
    assert read(name, _ctx(spans=[])) is None
