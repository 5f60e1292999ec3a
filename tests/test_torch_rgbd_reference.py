"""The benchmark's plain RGB-D reference (slambench/reference/rgbd.py)
against the port's eager `RGBDOdometry` on the CPU, stage by stage and
over a followed sequence, and the RGB-D drive's generator
(slambench/drives/_depth.py). The size: an 80 x 60 image, the fr1
intrinsics scaled by 1/8, six frames of the generator's logs.

Tolerances, and why:
- backprojection and the lookup (the pixel read, q, n, gate, d2): bit for
  bit, the same float32 operations (true division by the focal lengths,
  round half to even);
- the depth normals within 2 float32 ulps of 1 (2.4e-7): the reference
  writes the cross product out, the port calls torch.linalg.cross; their
  validity equal;
- a followed sequence (each frame from the port's pose and motion at the
  frame before): poses within 1e-5 m and 1e-5 rad a frame, the same ICP
  iterations, the inlier RMS distance within 1e-5 of itself: the normal
  equations summed in another order (the reference's product of the whole
  Jacobian, the port's K2 plain version); the gaps seen are ~1e-7;
- the TF32 control (the reference's products on TF32-rounded operands)
  leaves at least one of those tolerances.
The generator: the same seed gives the same log and another seed other
noise on the same scene and path; its noise follows the stated Kinect
model; depth is quantized to 1/5000 m and 0 outside 0.5-4.0 m; holes
fall where stated; the path's mean speeds are fr1/desk's. The reference
recovers the path's motion from noise-free depth. On a card the port's
run_fused records the span upload beside its frame spans.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from slambench import registry  # noqa: E402
from slambench.drives import _depth, rgbd  # noqa: E402
from slambench.reference import rgbd as ref  # noqa: E402
from slambench.reference.nn import Arith  # noqa: E402
from slambench.reference.odometry import namespace  # noqa: E402
from tpu_icp_slam_torch.icp import projective as proj  # noqa: E402
from tpu_icp_slam_torch.mapping.normals import normals_from_depth  # noqa: E402
from tpu_icp_slam_torch.obs.profile import PREFIX  # noqa: E402
from tpu_icp_slam_torch.slam.rgbd import RGBDOdometry  # noqa: E402

SCALE = 8  # 640 x 480 -> 80 x 60
FRAMES = 6
SEED = 2**31 + 23
NORMAL_GAP = 2.4e-7
POSE_GAPS = (1e-5, 1e-5)  # m, rad a frame
RMSE_GAP = 1e-5  # relative
MOTION_GAPS = (2e-3, np.deg2rad(0.1))  # noise-free depth: m, rad a frame


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Test files run in parallel worker processes: one torch thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _config(scale=SCALE) -> dict:
    """slambench's tum-rgbd configuration, its camera scaled by 1/scale
    (pixel centres kept)."""
    cfg = json.loads(json.dumps(registry.config("tum-rgbd")))
    c = cfg["camera"]
    c.update(fx=c["fx"] / scale, fy=c["fy"] / scale,
             cx=(c["cx"] + 0.5) / scale - 0.5,
             cy=(c["cy"] + 0.5) / scale - 0.5,
             width=c["width"] // scale, height=c["height"] // scale)
    return cfg


def _port(cfg: dict, device="cpu") -> RGBDOdometry:
    """The port's odometry as the benchmark's RGB-D drive builds it."""
    return rgbd.Program(cfg, device, spans=False).odo


@pytest.fixture(scope="module")
def case():
    cfg = _config()
    depths, gt = _depth.log(cfg["camera"], 2, FRAMES, SEED)
    return cfg, depths, gt


def _rot_gaps(a, b) -> np.ndarray:
    R = np.einsum("fji,fjk->fik", a[:, :3, :3], b[:, :3, :3])
    return np.arccos(np.clip((np.trace(R, axis1=1, axis2=2) - 1) / 2,
                             -1, 1))


def _pose_gaps(a, b) -> tuple:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a[:, :3, 3] - b[:, :3, 3], axis=1), _rot_gaps(a, b)


# ---- stage by stage ---------------------------------------------------------

def test_backprojection_is_the_ports(case):
    cfg, depths, _ = case
    odo = _port(cfg)
    cam = namespace(cfg["camera"])
    for d in torch.as_tensor(depths):
        v, ok = ref.backproject(d, cam)
        pv, pok = proj.backproject_depth(d, odo.K)
        assert torch.equal(v, pv) and torch.equal(ok, pok)
        assert 0.8 < ok.float().mean() < 1.0


def test_normals_within_two_ulps_of_the_ports(case):
    cfg, depths, _ = case
    cam = namespace(cfg["camera"])
    for d in torch.as_tensor(depths):
        v, ok = ref.backproject(d, cam)
        n, nok = ref.normals(v, ok)
        pn, pnok = normals_from_depth(v, ok)
        assert torch.equal(nok, pnok)
        assert torch.max(torch.abs(n - pn)) <= NORMAL_GAP
        assert not nok[0].any() and not nok[:, -1].any()
        unit = torch.linalg.vector_norm(n[nok], dim=-1)
        assert torch.allclose(unit, torch.ones_like(unit), atol=1e-6)
        assert torch.all(torch.sum(n[nok] * v[nok], dim=-1) <= 0)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_lookup_reads_the_ports_pixels(case, seed):
    """The source of frame 1 moved by a small random motion, looked up in
    frame 0's maps: every pixel the reference reads is the one the port
    reads (q and n equal), and the gate and d2 are the port's."""
    cfg, depths, _ = case
    odo = _port(cfg)
    cam = namespace(cfg["camera"])
    d0, d1 = torch.as_tensor(depths[:2])
    target = ref.maps(d0, cam)
    v1, _, ok1 = ref.maps(d1, cam)
    pts, mask = ref.source(v1, ok1, 1)
    rng = np.random.default_rng(seed)
    xi = torch.as_tensor(rng.normal(0, [0.01] * 3 + [0.01] * 3),
                         dtype=torch.float32)
    from slambench.reference import lie

    cur = ref.moved(Arith(), pts, lie.exp(xi))
    idx, q, n, gate, d2 = ref.lookup(cam, target, cur, 0.3 * 0.3)
    pq, pn, pgate, pd2 = proj.projective_correspondence(
        odo.K, *target, max_corr_dist=0.3)(cur)
    assert torch.equal(q, pq) and torch.equal(n, pn)
    assert torch.equal(gate.float(), pgate) and torch.equal(d2, pd2)
    assert torch.equal(q, target[0].reshape(-1, 3)[idx])
    assert gate[mask].float().mean() > 0.5


# ---- over a sequence --------------------------------------------------------

@pytest.fixture(scope="module")
def followed(case):
    """The port's eager run over the log, and the reference following it."""
    cfg, depths, _ = case
    odo = _port(cfg)
    state = odo.init_state(depths[0])
    _, infos = odo.run_fused(state, depths[1:])
    rec = {k: v.numpy() for k, v in infos.items()}
    return rec, ref.run(cfg, depths, "cpu", forced=rec["pose"])


def _within(rec, out) -> bool:
    trans, rot = _pose_gaps(rec["pose"], out["pose"])
    rel = np.abs(rec["rmse"] - out["rmse"]) / out["rmse"]
    return (trans.max() <= POSE_GAPS[0] and rot.max() <= POSE_GAPS[1]
            and rel.max() <= RMSE_GAP
            and np.array_equal(rec["iters"], out["iters"]))


def test_followed_sequence_agrees_with_the_port(followed):
    rec, out = followed
    assert out["pose"].shape == (FRAMES - 1, 4, 4)
    trans, rot = _pose_gaps(rec["pose"], out["pose"])
    assert trans.max() <= POSE_GAPS[0], trans
    assert rot.max() <= POSE_GAPS[1], rot
    np.testing.assert_array_equal(rec["iters"], out["iters"])
    assert _within(rec, out)


def test_tf32_control_leaves_a_tolerance(case, followed):
    cfg, depths, _ = case
    rec, _ = followed
    control = ref.run(cfg, depths, "cpu", precision="tf32",
                      forced=rec["pose"])
    assert not _within(rec, control)


def test_followed_frames_start_from_the_given_poses(case, followed):
    """Each frame composes its own ICP result onto the given pose of the
    frame before."""
    cfg, depths, _ = case
    rec, out = followed
    prev = np.concatenate([np.eye(4)[None], rec["pose"][:-1].astype(
        np.float64)])
    np.testing.assert_allclose(out["pose"], prev @ out["T"], atol=1e-12)


@pytest.mark.parametrize("world", [0, 1, 2, 3])
def test_reference_recovers_the_generators_motion(world):
    """Noise-free depth: each frame's ICP motion within 2 mm and 0.1 deg of
    the path's (the pixel grid and the 1/5000 m quantization bound it at
    this size)."""
    cfg = _config()
    depths, gt = _depth.log(cfg["camera"], world, FRAMES, 5, noise=False)
    out = ref.run(cfg, depths, "cpu")
    motion = np.linalg.inv(gt[:-1]) @ gt[1:]
    trans, rot = _pose_gaps(out["T"], motion)
    assert trans.max() <= MOTION_GAPS[0], trans
    assert rot.max() <= MOTION_GAPS[1], rot


def test_reference_refuses_options_it_does_not_implement():
    cfg = _config()
    cfg["icp"]["huber_delta"] = 0.1
    with pytest.raises(ValueError, match="huber_delta"):
        ref.run(cfg, np.zeros((2, 60, 80), np.float32), "cpu")


# ---- the generator ----------------------------------------------------------

def test_generator_is_deterministic(case):
    cfg, depths, gt = case
    again, gt2 = _depth.log(cfg["camera"], 2, FRAMES, SEED)
    assert again.dtype == np.float32 and again.shape == (FRAMES, 60, 80)
    np.testing.assert_array_equal(again, depths)
    np.testing.assert_array_equal(gt2, gt)
    other, gt3 = _depth.log(cfg["camera"], 2, FRAMES, SEED + 1)
    np.testing.assert_array_equal(gt3, gt)  # the world's path
    assert not np.array_equal(other, depths)  # the seed's noise
    np.testing.assert_array_equal(
        _depth.log(cfg["camera"], 2, FRAMES, SEED, noise=False)[0],
        _depth.log(cfg["camera"], 2, FRAMES, SEED + 1, noise=False)[0])


def test_noise_quantization_and_holes_follow_the_model():
    cam = registry.config("tum-rgbd")["camera"]
    boxes, _ = _depth._layout(1)
    pose = _depth.trajectory(1, 2)[0]
    clean = _depth.render(cam, _depth._rays(cam), pose, boxes)
    rng = np.random.default_rng(7)
    noisy = _depth.kinect(clean, rng).astype(np.float64)
    bare = _depth.kinect(clean, rng, noise=False).astype(np.float64)
    valid = noisy > 0
    units = noisy[valid] * 5000.0
    np.testing.assert_allclose(units, np.round(units), atol=2e-3)
    assert noisy[valid].min() >= 0.5 and noisy[valid].max() <= 4.0
    # the residual against the clean depth, in units of sigma(z): the
    # quantization (0.2 mm / sqrt(12)) adds under 4% to a sigma of 1.2 mm
    # or more
    both = valid & (bare > 0)
    z = clean[both].astype(np.float64)
    res = (noisy[both] - z) / _depth.sigma_m(z)
    assert abs(res.mean()) < 0.02 and 0.97 < res.std() < 1.05
    # holes: the edge band and the out-of-range pixels in both, and the
    # random dropout (2% of the rest, give or take the noise's own range
    # crossings)
    assert not np.any(valid & (bare == 0) & (clean > 0.6) & (clean < 3.9))
    dropped = np.mean(~valid[bare > 0])
    assert 0.015 < dropped < 0.03
    assert 0.002 < np.mean(bare == 0) < 0.2  # the edge band, 1 px a side


def test_path_runs_at_fr1_desk_speeds():
    frames = registry.traffic("depth-replay")["sequence_frames"]
    assert frames == registry.config("tum-rgbd")["sequence_frames"] == 120
    for world in range(4):
        poses = _depth.trajectory(world, frames)
        trans, rot = _depth.frame_speeds(poses)
        assert trans * 30 == pytest.approx(0.41, rel=1e-5)
        assert np.rad2deg(rot) * 30 == pytest.approx(23.0, rel=1e-5)
        R = poses[:, :3, :3]
        np.testing.assert_allclose(np.einsum("fji,fjk->fik", R, R),
                                   np.broadcast_to(np.eye(3), R.shape),
                                   atol=1e-12)
        lo, hi = _depth.ROOM
        assert np.all((poses[:, :3, 3] > lo) & (poses[:, :3, 3] < hi))


# ---- the upload span --------------------------------------------------------

def _span_names(prof) -> list:
    return [e.name()[len(PREFIX):] for e in
            prof.profiler.kineto_results.events()
            if e.name().startswith(PREFIX)]


def test_no_upload_span_on_the_cpu(case):
    """A CPU device takes the host's depth where it lies: nothing is
    copied, and the span upload is not recorded."""
    cfg, depths, _ = case
    odo = _port(cfg)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        taken = odo._depth(depths[1])
        odo.run_fused(odo.init_state(depths[0]), depths[1:3])
    assert taken.data_ptr() == depths[1].ctypes.data
    assert "upload" not in _span_names(prof)


@pytest.mark.cuda
def test_upload_span_on_the_card(case):
    """run_fused on a card, from host numpy depths: the span upload around
    each copy of a depth input to the card (init_state's frame, then the
    log's stack at once), beside the frame spans and the three graph
    stages; none for depths already on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the depth upload and the frame "
                    "graphs run on the card)")
    cfg, depths, _ = case
    dev = torch.device("cuda")
    odo = _port(cfg, dev)
    state = odo.init_state(depths[0])
    odo.run_fused(state, depths[1:])  # captures the graphs
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        state = odo.init_state(depths[0])
        _, infos = odo.run_fused(state, depths[1:])
        torch.cuda.synchronize()
    names = _span_names(prof)
    assert names.count("upload") == 2
    assert names.count("frame") == FRAMES - 1
    assert names.count("graph.pre") == names.count("graph.post") == FRAMES - 1
    assert names.count("graph.trip") == int(infos["iters"].sum()) - (
        FRAMES - 1) >= 1
    on_card = torch.as_tensor(depths, device=dev)
    with profile(activities=acts) as prof:
        odo.run_fused(odo.init_state(on_card[0]), on_card[1:])
        torch.cuda.synchronize()
    names = _span_names(prof)
    assert "upload" not in names and names.count("frame") == FRAMES - 1
