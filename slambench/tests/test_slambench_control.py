"""`correct` comes out false where it should: the control (the plain
reference computed in TF32, the nearest precision below the configurations'
float32, in the program's place) and faults planted in the timed path,
each through the rest of a run on the CPU, judged by the cell's own limits
(slambench/limits).

The control runs at 8,192-point scans of the cells' real street geometry
(48 x 1,024 rays, 0.15 m voxels; a 65,536-point map, an 8,192-point local
model), five frames: at the tests' smaller logs (10 x 192 rays over 8 m)
the coordinates are too small for TF32's rounding of |x|² to show. On the
card the control is read at the cells' own size (slambench/calibrate.py
readings; PERF.md). The faults: a frame step that returns its state
unchanged; the Gauss-Newton sums over every second point, doubled (half
of the batch left out, the mean taken over the rest); every frame's pose
altered by 2 cm where `_post` produces it (the comparisons are medians
over the frames: a single frame altered by less than a cell's per-frame
spread passes the medians, and is held by the 90th percentiles where it
touches a tenth of the frames or more, see PERF.md); the pose altered by
2 cm on the frames that insert into the map alone. The cells run on one
chip, so there is no exchange between chips to leave out. And the faults
of slambench/faults.py, planted in the program alone: a map never
inserted into (its info rows saying so), a loop verification that
returns no closure, every verified closure kept (no PCM, no residual
gate), Slam3D's pose graph left unsolved.
"""

import contextlib

import json

import pytest
import torch

from conftest import small_config, small_traffic
from slambench import check, gen, harness
from slambench.faults import FAULTS


def _real_geometry(cfg):
    cfg = json.loads(json.dumps(cfg))
    cfg["mapping"].update(map_capacity=65536, local_model_size=8192)
    cfg["pipeline"].update(scan_capacity=8192)
    return cfg


def _limits(cell):
    return harness.limits(cell)


def test_control_is_not_correct():
    cell = "kitti-odom.replay"
    cfg = _real_geometry(harness.config("kitti-odom"))
    mix = dict(harness.traffic("replay"), frames=5, worlds=[0],
               path_fraction=5 / 110)
    seqs = gen.sequences(mix, 0.15, 8192, 2**31 + 5)
    prog = harness.Program(cfg, "replay", "cpu", spans=False)
    rec = dict(prog.run(seqs[0][0], seqs[0][1]), seq=0)
    sound = check.judge(cfg, mix, seqs, [rec], _limits(cell), "cpu")
    control = check.judge(cfg, mix, seqs, [rec], _limits(cell), "cpu",
                          precision="tf32")
    assert sound["correct"], sound["lines"]
    assert not control["correct"], control["lines"]


def _run(cell, **kw):
    import time

    return harness.run(cell, 2**31 + 17, 0.1, False, time.perf_counter(),
                       device="cpu", config_override=small_config,
                       traffic_override=small_traffic, **kw)[0]


@pytest.fixture
def odom():
    import tpu_icp_slam_torch.slam.scan_to_map as s2m

    return s2m


def _state_unchanged(monkeypatch, s2m):
    step = s2m._step

    def stale(state, points, mask, *, cfg):
        _, info = step(state, points, mask, cfg=cfg)
        return state, info

    monkeypatch.setattr(s2m, "_step", stale)


def _half_the_points(monkeypatch, s2m):
    from tpu_icp_slam_torch.icp import point_to_plane

    accum = point_to_plane.gn_accum

    def half(p, q, n, w):
        keep = torch.zeros_like(w)
        keep[..., ::2] = 2.0  # the mean over the rest, as if all
        return accum(p, q, n, w * keep)

    monkeypatch.setattr(point_to_plane, "gn_accum", half)


def _pose_altered(monkeypatch, s2m):
    post = s2m._post

    def altered(state, points, mask, pre, res, cfg):
        out = post(state, points, mask, pre, res, cfg)
        pose = out.pose.clone()
        pose[0, 3] += 0.02  # every frame's pose 2 cm off as post makes it
        return s2m._Post(pose=pose, T_rel=out.T_rel, clamped=out.clamped,
                         is_kf=out.is_kf, is_map_insert=out.is_map_insert)

    monkeypatch.setattr(s2m, "_post", altered)


def _insert_pose_altered(monkeypatch, s2m):
    post = s2m._post

    def altered(state, points, mask, pre, res, cfg):
        out = post(state, points, mask, pre, res, cfg)
        pose = out.pose.clone()
        # 2 cm off on the frames that insert into the map alone
        pose[0, 3] += 0.02 * out.is_map_insert.to(pose.dtype)
        return s2m._Post(pose=pose, T_rel=out.T_rel, clamped=out.clamped,
                         is_kf=out.is_kf, is_map_insert=out.is_map_insert)

    monkeypatch.setattr(s2m, "_post", altered)


@pytest.mark.parametrize("cell", ["kitti-odom.replay", "kitti-slam.loop"])
def test_sound_run_is_correct(cell):
    assert _run(cell)["correct"]


@pytest.mark.parametrize("fault", [_state_unchanged, _half_the_points,
                                   _pose_altered, _insert_pose_altered])
@pytest.mark.parametrize("cell", ["kitti-odom.replay", "kitti-slam.loop"])
def test_fault_is_not_correct(cell, fault, monkeypatch, odom):
    fault(monkeypatch, odom)
    res = _run(cell)
    assert not res["correct"], res["checks"]
    assert res["failed"] >= 1


def _loop_with_closures(cfg):
    """The small loop's gates, with the configuration's two candidates a
    keyframe."""
    cfg = small_config(cfg)
    if cfg["backend"]["enabled"]:
        cfg["backend"]["candidate_topk"] = 2
    return cfg


def _longer(mix):
    """The small loop over 24 frames: four closures verified, one kept."""
    mix = small_traffic(mix)
    return dict(mix, frames=24) if mix["route"] == "loop" else mix


@pytest.mark.parametrize("cell, fault", [
    ("kitti-odom.replay", "no_inserts"), ("kitti-slam.loop", "no_inserts"),
    ("kitti-slam.loop", "no_closures"), ("kitti-slam.loop", "no_selection"),
    ("kitti-slam.loop", "graph_unsolved")])
def test_planted_fault_is_not_correct(cell, fault):
    import time

    with contextlib.ExitStack() as patches:
        class Faulted(harness.Program):
            def __init__(self, cfg, *a, **kw):
                cfg, patch = FAULTS[fault](cfg)
                patches.enter_context(patch)
                super().__init__(cfg, *a, **kw)

        res = harness.run(cell, 2**31 + 17, 0.1, False, time.perf_counter(),
                          device="cpu", config_override=_loop_with_closures,
                          traffic_override=_longer, program_cls=Faulted)[0]
    assert not res["correct"], res["checks"]


def test_sound_run_of_the_longer_loop_is_correct():
    import time

    res = harness.run("kitti-slam.loop", 2**31 + 17, 0.1, False,
                      time.perf_counter(), device="cpu",
                      config_override=_loop_with_closures,
                      traffic_override=_longer)[0]
    assert res["correct"], res["checks"]
