"""K2P's plain version and the point-to-point loops that run it, against
the JAX reference on the CPU.

K2P (kernels/p2p_step.py, csrc/p2p_step.cu) is the point-to-point ICP
iteration after the correspondence, in place on the carried state. On CPU
tensors it is its plain version, `icp.loop.trip_ref` (the torch step
around `umeyama_masked` and the rigid fit, and the freeze); the card's
kernel is held to that plain version by tests/test_torch_cuda.py and
chip_smoke.py phase 25.

- The unbatched loop (`align_with_correspondence`, the exact NN on both
  sides) in SE(2) and SE(3) against the reference's on numpy-seeded
  scenes (walls in 2D, planes in 3D; the source the target moved by a
  small motion, with noise; padded rows), under
  configs/lidar2d_scan_to_map.json's ICP (Huber 0.3, step_scale 1.4,
  tol_update), the verification configurations of
  backend/loop_closure.py (coarse and fine), and with AA(1) and a trust
  region that binds, each on and off.
- The batched loop (`align_batched`, B = 8: two targets, four initial
  yaws each) against the reference's `jax.vmap` of `align` under the
  verification configurations and under the preset with AA and the trust
  region on.
- Tolerances: iterations, inliers and convergence equal; T and rmse within
  1e-5, RF's bound (tests/test_torch_rigid.py: float32 SVDs by two LAPACK
  drivers and sums in another order; measured here at most 1.5e-6 in T
  and 2.8e-7 in rmse).
- The wrapper: CPU tensors take the plain version and never reach the
  kernel library; tensors elsewhere go to the kernel (and, off CUDA,
  raise); every point-to-point iteration of the unbatched and batched
  loops is one K2P call, and no point-to-plane iteration is.
"""

import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_icp_slam.config import ICPConfig as JICPConfig
from tpu_icp_slam.core import pointcloud as jpc
from tpu_icp_slam.icp import loop as jloop
from tpu_icp_slam_torch.config import ICPConfig
from tpu_icp_slam_torch.core import pointcloud as tpc
from tpu_icp_slam_torch.icp import loop as tloop
from tpu_icp_slam_torch.kernels import _build, p2p_step

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-5
CAP = 448  # rows of a cloud, the last ones padding


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the suite runs test files in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _preset_icp(name):
    icp = json.loads((ROOT / "configs" / name).read_text())["icp"]
    return dataclasses.replace(ICPConfig(), **icp)


PRESET = dataclasses.replace(_preset_icp("lidar2d_scan_to_map.json"),
                             nn_backend="xla")
# backend/loop_closure.py's LoopDetector.icp_coarse and icp_fine
COARSE = ICPConfig(method="point_to_point", max_iters=50, max_corr_dist=6.0,
                   nn_backend="xla", huber_delta=1.5, max_step_trans=3.0,
                   max_step_rot=0.5, min_inliers=30, tol=1e-5)
FINE = dataclasses.replace(COARSE, max_corr_dist=1.5, huber_delta=0.5,
                           max_iters=30)
TRUST = dict(max_total_trans=0.04, max_total_rot=0.02)
CASES = {
    "preset": PRESET,
    "coarse": COARSE,
    "fine": FINE,
    "anderson": dataclasses.replace(PRESET, anderson=True),
    "trust": dataclasses.replace(PRESET, **TRUST),
    "anderson_trust": dataclasses.replace(PRESET, anderson=True, **TRUST),
}


def _rotation(d, yaw, tilt=0.0):
    R = np.eye(d)
    R[:2, :2] = [[np.cos(yaw), -np.sin(yaw)], [np.sin(yaw), np.cos(yaw)]]
    if d == 3:
        R = R @ [[1, 0, 0], [0, np.cos(tilt), -np.sin(tilt)],
                 [0, np.sin(tilt), np.cos(tilt)]]
    return R


def _scene(d, n, rng):
    """n points on the walls of a 10 m room (2D) or on its walls and floor
    (3D)."""
    axis = rng.integers(0, d, n)
    p = rng.uniform(-5.0, 5.0, (n, d))
    p[np.arange(n), axis] = rng.choice([-5.0, 5.0], n)
    if d == 3:
        p[:, 2] = np.where(axis == 2, -1.5, p[:, 2] * 0.3)
    return p


def _problem(d, seed=0):
    """(src (400, D), dst (420, D), init (D+1, D+1)) float32: dst a scene,
    src its points moved by the inverse of a small motion, with noise."""
    rng = np.random.default_rng(seed + 10 * d)
    dst = _scene(d, 420, rng)
    R = _rotation(d, 0.06, 0.02)
    t = np.array([0.12, -0.08, 0.03][:d])
    src = (dst[:400] - t) @ R + 0.01 * rng.standard_normal((400, d))
    init = np.eye(d + 1)
    init[:d, d] = 0.02
    f32 = np.float32
    return src.astype(f32), dst.astype(f32), init.astype(f32)


def _assert_close(got, want, what):
    for k in ("iters", "n_inliers", "converged"):
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]),
                                      err_msg=f"{what}: {k}")
    for k in ("T", "rmse"):
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]),
                                   rtol=0, atol=TOL, err_msg=f"{what}: {k}")


def _fields(r):
    return {k: np.asarray(torch.as_tensor(getattr(r, k)) if isinstance(
        getattr(r, k), (torch.Tensor, int)) else getattr(r, k))
        for k in ("T", "rmse", "iters", "n_inliers", "converged")}


def _jcorr(dst, max_d2):
    """The exact NN (difference-form d², first minimum) into dst, and the
    gate: the reference's factored-score NN picks a near-tie of the exact
    one on some rows of these scenes, which is the NN's affair, not K2P's."""
    b = jnp.asarray(dst)

    def corr(cur):
        d2 = jnp.sum((cur[:, None, :] - b[None]) ** 2, axis=-1)
        q = b[jnp.argmin(d2, axis=1)]
        diff = cur - q
        dd = jnp.sum(diff * diff, axis=-1)
        return q, None, (dd <= max_d2).astype(jnp.float32), dd

    return corr


def _tcorr(dst, max_d2):
    b = torch.from_numpy(np.array(dst))

    def corr(cur):
        d2 = torch.sum((cur[:, None, :] - b[None]) ** 2, dim=-1)
        q = b[torch.argmin(d2, dim=1)]
        diff = cur - q
        dd = torch.sum(diff * diff, dim=-1)
        return q, None, (dd <= max_d2).to(torch.float32), dd

    return corr


@pytest.mark.parametrize("d", [2, 3])
@pytest.mark.parametrize("case", list(CASES))
def test_align_matches_reference(case, d):
    """The unbatched point-to-point loop (every trip through K2P's
    wrapper, its plain version here) against the reference's
    align_with_correspondence, the same exact NN on both sides."""
    cfg = CASES[case]
    src, dst, init = _problem(d)
    dpts = np.asarray(jpc.make(dst, CAP).points)
    want = jloop.align_with_correspondence(
        jpc.make(src, CAP), _jcorr(dpts, cfg.max_corr_dist ** 2),
        jnp.asarray(init), JICPConfig(**dataclasses.asdict(cfg)))
    calls = p2p_step.p2p_step.launches
    got = tloop.align_with_correspondence(
        tpc.make(src, CAP, device="cpu"),
        _tcorr(dpts, cfg.max_corr_dist ** 2), torch.from_numpy(init), cfg)
    assert p2p_step.p2p_step.launches == calls  # the plain version
    _assert_close(_fields(got), {k: np.asarray(getattr(want, k)) for k in
                                 ("T", "rmse", "iters", "n_inliers",
                                  "converged")}, f"{case} D={d}")
    assert int(got.iters) > 1
    # the trust region binds: the total correction is cut to its radius
    xi = tloop.lie(d).log(got.T @ torch.linalg.inv(torch.from_numpy(init)))
    total = float(torch.linalg.vector_norm(xi[:d]))
    if "trust" in case:
        assert total <= TRUST["max_total_trans"] + 1e-5, total
    else:
        assert total > TRUST["max_total_trans"], total


def _batched_problem(d):
    """One source of 300 points in a box against two moved, noisy copies,
    four initial yaws each (B = 8, G = 4): rows stop at different trips.
    A box, not a room: align_batched runs the port's NN, which resolves the
    room scenes' near-ties of the reference's factored score exactly, and
    rows then part by the NN, not by K2P."""
    rng = np.random.default_rng(40 + d)
    src = rng.uniform(-5.0, 5.0, (300, d))
    targets = []
    for _ in range(2):
        yaw, tilt = rng.uniform(-0.15, 0.15, 2)
        moved = (src @ _rotation(d, yaw, tilt).T + rng.uniform(-0.4, 0.4, d)
                 + rng.normal(size=src.shape) * 0.02)
        targets.append(np.asarray(jpc.make(moved.astype(np.float32),
                                           320).points))
    yaws = np.tile(np.asarray([0.0, 0.1, -0.2, 0.3]), 2)
    inits = np.tile(np.eye(d + 1, dtype=np.float32), (8, 1, 1))
    inits[:, :2, :2] = np.stack([_rotation(2, y) for y in yaws])
    return (src.astype(np.float32), np.stack(targets),
            inits.astype(np.float32))


BATCHED = {"coarse": COARSE, "fine": FINE,
           "anderson_trust": dataclasses.replace(
               COARSE, anderson=True, max_total_trans=0.3,
               max_total_rot=0.1)}


@pytest.mark.parametrize("d", [2, 3])
@pytest.mark.parametrize("case", list(BATCHED))
def test_align_batched_matches_vmapped_reference(case, d):
    """align_batched (its in-place batched step, K2P's plain version here)
    against the reference's jax.vmap of align, row by row."""
    cfg = BATCHED[case]
    src, targets, inits = _batched_problem(d)
    group = inits.shape[0] // targets.shape[0]
    srcp = jpc.make(src, 320)
    mask = jnp.ones(targets.shape[1], bool)
    jcfg = JICPConfig(**dataclasses.asdict(cfg))
    ref = jax.vmap(lambda t, p: jloop.align(
        srcp, jpc.PointCloud(points=p, mask=mask), t, cfg=jcfg))(
        jnp.asarray(inits), jnp.asarray(np.repeat(targets, group, 0)))
    got = tloop.align_batched(
        tpc.make(src, 320, device="cpu"), torch.from_numpy(targets),
        torch.ones(targets.shape[:2], dtype=torch.bool),
        torch.from_numpy(inits), cfg)
    want = {k: np.asarray(getattr(ref, k)) for k in
            ("T", "rmse", "iters", "n_inliers", "converged")}
    _assert_close(_fields(got), want, f"{case} D={d}")
    assert len(set(want["iters"].tolist())) > 1, want["iters"]


def _state_problem(d, batch=None):
    """A trip's inputs on the CPU: (cfg, mask_f, cur, q, gate, d2, state,
    T0, T0_inv), unbatched or with a leading batch axis."""
    cfg = dataclasses.replace(PRESET, anderson=True, **TRUST)
    src, dst, init = _problem(d, seed=3)
    lead = () if batch is None else (batch,)
    cur = torch.from_numpy(src).expand(*lead, -1, -1).contiguous()
    q = torch.from_numpy(dst[:400]).expand(*lead, -1, -1).contiguous()
    diff = cur - q
    d2 = torch.sum(diff * diff, dim=-1)
    gate = (d2 <= cfg.max_corr_dist ** 2).float()
    mask_f = torch.ones(400)
    mask_f[-7:] = 0.0
    T0 = torch.from_numpy(init).expand(*lead, -1, -1).contiguous()
    T0_inv, _ = tloop._anchor(cfg, T0, prior=False)
    state = tuple(t.clone() for t in tloop._init_state(T0))
    return cfg, mask_f, cur, q, gate, d2, state, T0, T0_inv


@pytest.mark.parametrize("batch", [None, 4])
@pytest.mark.parametrize("d", [2, 3])
def test_cpu_tensors_take_the_plain_version(monkeypatch, d, batch):
    """p2p_step on CPU tensors is trip_ref bit for bit, trips 0 and 1 and
    on a frozen state, and never loads the kernel library."""
    def refuse():
        raise AssertionError("the kernel library was loaded")

    monkeypatch.setattr(_build, "load", refuse)
    cfg, mask_f, cur, q, gate, d2, state, T0, T0_inv = _state_problem(
        d, batch)
    want = tuple(t.clone() for t in state)
    calls = p2p_step.p2p_step.launches
    for it in (0, 1):
        p2p_step.p2p_step(cfg, mask_f, cur, q, gate, d2, state, it, T0,
                          T0_inv)
        tloop.trip_ref(cfg, mask_f, cur, q, None, gate, d2, want, it, T0,
                       T0_inv, None)
        for a, b in zip(state, want):
            assert torch.equal(a, b), it
    assert p2p_step.p2p_step.launches == calls
    assert bool((state[6] == 2).all())
    state[3].fill_(True)  # converged: frozen
    before = tuple(t.clone() for t in state)
    p2p_step.p2p_step(cfg, mask_f, cur, q, gate, d2, state, 2, T0, T0_inv)
    for a, b in zip(state, before):
        assert torch.equal(a, b)


def test_tensors_off_the_cpu_go_to_the_kernel():
    """A wrapper takes its plain version only for CPU tensors: others go to
    the kernel's checks (which refuse anything but CUDA), and a
    point-to-plane configuration is refused."""
    cfg, mask_f, cur, q, gate, d2, state, T0, T0_inv = _state_problem(3)
    meta = [t.to("meta") for t in (mask_f, cur, q, gate, d2)]
    with pytest.raises(ValueError, match="CUDA"):
        p2p_step.p2p_step(cfg, *meta, tuple(t.to("meta") for t in state), 0,
                          T0.to("meta"), T0_inv.to("meta"))
    with pytest.raises(ValueError, match="point-to-point"):
        p2p_step.p2p_step(dataclasses.replace(cfg, method="point_to_plane"),
                          *meta, tuple(t.to("meta") for t in state), 0,
                          T0.to("meta"), T0_inv.to("meta"))


def test_routes():
    """K2P takes every Umeyama method at D = 2 and 3, K2S none of them."""
    from tpu_icp_slam_torch.kernels import gn_step

    for method in ("point_to_point", "projective"):
        cfg = dataclasses.replace(PRESET, method=method)
        assert p2p_step.routes(cfg, 2) and p2p_step.routes(cfg, 3)
        assert not gn_step.routes(cfg, 3)
    plane = dataclasses.replace(PRESET, method="point_to_plane")
    assert not p2p_step.routes(plane, 3) and not p2p_step.routes(plane, 2)


@pytest.mark.parametrize("method", ["point_to_point", "point_to_plane"])
def test_loops_call_k2p_once_a_trip(monkeypatch, method):
    """Every point-to-point trip of the unbatched loop (eager and unrolled)
    and of align_batched is one call of K2P's wrapper; a point-to-plane
    trip never is."""
    calls = []
    real = p2p_step.p2p_step

    def counted(*a, **k):
        calls.append(a[2].shape)
        return real(*a, **k)

    monkeypatch.setattr(p2p_step, "p2p_step", counted)
    src, dst, init = _problem(3)
    cfg = dataclasses.replace(COARSE, method=method, max_iters=4, tol=0.0)
    nrm = np.tile(np.float32([0.0, 0.0, 1.0]), (dst.shape[0], 1))
    dcloud = tpc.make(dst, CAP, nrm, device="cpu")
    for unroll in (0, 5):
        calls.clear()
        r = tloop.align(tpc.make(src, CAP, device="cpu"), dcloud,
                        torch.from_numpy(init),
                        cfg=dataclasses.replace(cfg, unroll_iters=unroll))
        trips = unroll or int(r.iters)
        assert len(calls) == (trips if method == "point_to_point" else 0)
    if method == "point_to_point":
        calls.clear()
        targets = torch.from_numpy(dst[None].repeat(2, 0))
        tloop.align_batched(tpc.make(src, CAP, device="cpu"), targets,
                            torch.ones(2, 420, dtype=torch.bool),
                            torch.from_numpy(init).expand(4, -1, -1), cfg)
        assert calls == [(4, CAP, 3)] * cfg.max_iters
