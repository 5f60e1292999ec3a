"""The RGB-D cell, tum-rgbd.depth-replay, on the CPU at a small size (an
80 x 60 camera, the fr1 intrinsics scaled by 1/8; six-frame logs of two
worlds): whole through the harness and `correct`; each fault of its drive
judged not correct; and its three readers (rgbd_trip_roofline,
depth_maps_ms_per_frame, upload_ms_per_frame) on synthetic traces, the
roofline's work counted by hand at the cell's 640 x 480."""

import contextlib
import json
import time

import pytest

from slambench import harness, trace
from slambench.harness import Context

CELL = "tum-rgbd.depth-replay"
SEED = 2**31 + 29
RGBD = harness.config("tum-rgbd")
DRIVE = harness.drive("rgbd")


def small_camera(cfg: dict) -> dict:
    cfg = json.loads(json.dumps(cfg))
    c = cfg["camera"]
    c.update(fx=c["fx"] / 8, fy=c["fy"] / 8, cx=(c["cx"] + 0.5) / 8 - 0.5,
             cy=(c["cy"] + 0.5) / 8 - 0.5, width=80, height=60)
    return cfg


def short_logs(mix: dict) -> dict:
    return dict(mix, sequence_frames=6, worlds=mix["worlds"][:2],
                profile_sequences=1)


def _run(trace_on: bool, program_cls=None):
    return harness.run(CELL, SEED, 0.1, trace_on, time.perf_counter(),
                       device="cpu", config_override=small_camera,
                       traffic_override=short_logs, program_cls=program_cls)


@pytest.mark.parametrize("trace_on", [False, True])
def test_the_cell_runs_whole_and_is_correct(trace_on):
    res, lines = _run(trace_on)
    assert res["correct"] and res["failed"] == 0, lines
    assert res["attempted"] >= 1
    assert set(res["checks"]) == set(harness.limits(CELL))
    names = {m["name"] for m in harness.metrics_of(harness.benchmark(), CELL,
                                                   trace_on)}
    if not trace_on:
        assert set(res["metrics"]) == names == {"frames_per_s", "setup_s"}
    else:
        # the CPU run has no device operations and no upload: what reads
        # there is the counters and the frame loop's counts
        assert res["metrics"]["icp_iters_per_frame"]["value"] >= 1.0
        assert {"rgbd_trip_roofline", "depth_maps_ms_per_frame",
                "upload_ms_per_frame"} <= names


@pytest.mark.parametrize("fault", sorted(DRIVE.FAULTS))
def test_each_fault_is_not_correct(fault):
    with contextlib.ExitStack() as patches:
        class Faulted(DRIVE.Program):
            def __init__(self, cfg, *a, **kw):
                cfg, patch = DRIVE.FAULTS[fault](cfg)
                patches.enter_context(patch)
                super().__init__(cfg, *a, **kw)

        res, lines = _run(False, Faulted)
    assert not res["correct"], lines
    assert res["failed"] == res["attempted"]


def test_a_fault_leaves_the_next_program_sound():
    """A fault's patch ends with its program: a sound program built after
    it is correct again (no frame graph or stage of the fault survives)."""
    cfg = small_camera(RGBD)
    _, patch = DRIVE.FAULTS["pixel_off_by_one"](cfg)
    with patch:
        pass
    res, lines = _run(False)
    assert res["correct"], lines


# ---- the readers ------------------------------------------------------------

US = 1000  # ns


def _ctx(ops, host=(), profiled=None, cfg=RGBD, traced=True):
    profiled = profiled if profiled is not None else [
        {"frames": 120, "icp_iters": 600}, {"frames": 120, "icp_iters": 700}]
    tr = trace.Trace(ops=list(ops), launches=0, syncs=0, host=list(host),
                     spans=[])
    return Context(cell=CELL, config=cfg, traffic={},
                   families=harness.families(), setup_s=1.0, window_s=1.0,
                   records=profiled + [{"frames": 120, "icp_iters": 1}],
                   profiled=profiled if traced else [],
                   trace=tr if traced else None, block_ns=(0, 10**9))


def read(name, ctx):
    return harness.reader(name).read(ctx)


OPS = [("projective_kernel", 0, 2_000 * US, "slambench.rgbd"),
       ("gn_step_kernel", 0, 8_000 * US, "slambench.rgbd"),
       ("gn_step_kernel", 0, 5_000 * US, "slambench.frontend"),
       ("vectorized_elementwise_kernel<4>", 0, 3_000 * US, "slambench.rgbd"),
       ("Memcpy DtoD (Device -> Device)", 0, 500 * US, "slambench.rgbd"),
       ("Memcpy HtoD (Pageable -> Device)", 0, 40_000 * US,
        "slambench.rgbd"),
       ("Memcpy DtoH (Device -> Pageable)", 0, 100 * US, "slambench.rgbd"),
       ("reduce_kernel", 0, 700 * US, None)]


def test_rgbd_trip_work_by_hand_at_640_by_480():
    w = harness.reader("rgbd_trip_roofline")
    assert w.FLOPS_PER_ROW == 110
    flops, nbytes = w.work(_ctx(OPS))
    # 1,300 iterations of 307,200 rows at 110 operations; 2 x 119 frames
    # that run the ICP, each reading 12 B a source row and 25 B a pixel
    assert flops == 110 * 307_200 * 1_300 == 43_929_600_000
    assert nbytes == 238 * 37 * 307_200 == 2_705_203_200
    # bytes bound it: 2.7052e9 / 3.35e12 = 807.52 us, over the family's
    # 10 ms in the drive's span (K2S in the lidar front end apart)
    assert read("rgbd_trip_roofline", _ctx(OPS)) == pytest.approx(
        100 * 2_705_203_200 / 3.35e12 / 10e-3, rel=1e-9)
    assert read("rgbd_trip_roofline", _ctx(OPS)) == pytest.approx(
        8.0752334, rel=1e-7)


def test_rgbd_trip_work_follows_the_stride():
    cfg = json.loads(json.dumps(RGBD))
    cfg["pipeline"]["rgbd_src_stride"] = 2
    flops, nbytes = harness.reader("rgbd_trip_roofline").work(
        _ctx(OPS, cfg=cfg, profiled=[{"frames": 2, "icp_iters": 3}]))
    assert flops == 110 * 76_800 * 3
    assert nbytes == 12 * 76_800 + 25 * 307_200


def test_depth_maps_are_the_rest_of_the_drives_device_work():
    # the element-wise kernel and the copy on the card, 3.5 ms over 240
    # frames; not PJ or K2S, not a copy between host and card, not an
    # operation outside the drive's calls
    assert read("depth_maps_ms_per_frame", _ctx(OPS)) == pytest.approx(
        3.5 / 240)


def test_depth_maps_leave_out_what_runs_once_a_trip():
    # 5 ICP iterations: the product launched 5 times goes with the trips,
    # the roll launched 4 times (twice a frame) stays
    recs = [{"frames": 2, "icp_iters": 5}]
    ops = [("sm80_xmma_gemm_f32f32", 0, 10 * US, "slambench.rgbd")] * 5 + [
        ("roll_cuda_kernel<float>", 0, 3 * US, "slambench.rgbd")] * 4
    assert read("depth_maps_ms_per_frame", _ctx(ops, profiled=recs)) == \
        pytest.approx(0.012 / 2)


def test_upload_is_the_host_time_in_its_spans():
    host = [(0, 1_000 * US, "icp_slam.upload"),
            (500 * US, 700 * US, "aten::copy_"),
            (2_000 * US, 4_400 * US, "icp_slam.upload"),
            (5_000 * US, 6_000 * US, "icp_slam.frame")]
    assert read("upload_ms_per_frame", _ctx(OPS, host)) == pytest.approx(
        3.4 / 240)


@pytest.mark.parametrize("name", ["rgbd_trip_roofline",
                                  "depth_maps_ms_per_frame",
                                  "upload_ms_per_frame"])
def test_nothing_read_without_a_trace_or_its_work(name):
    assert read(name, _ctx(OPS, traced=False)) is None
    # a program without the upload span, or a block with none of the
    # drive's kernels, reads nothing
    other = [op for op in OPS if op[3] != "slambench.rgbd"]
    assert read(name, _ctx(other)) is None
