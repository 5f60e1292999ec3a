"""K2S's plain version and the in-place ICP trip that runs it, against the
JAX reference on the CPU; and the occupancy grid's fold with a spare cell
an off-grid entry.

- The ICP on a fixed correspondence (numpy-seeded planes, M = 600 rows in
  a 640-row cloud, pair i to target i, the distance gate) through the
  reference's `align_with_correspondence` (gn_backend "xla") and the
  port's at max_iters 1 and 3, the port at "xla" (the plain assembly, the
  body's path) and at "auto" (the in-place K2S trip, its CPU branch), over
  the presets' option sets: chip_smoke.slice_config()'s (prior, trust
  region, step_scale 1.4, Huber, tol_update), configs/rgbd.json's,
  configs/kitti_full_res.json's, Anderson, a min_inliers hold, a non-PD H
  (points on a line along their common normal, no damping: a zero step)
  and a loop that converges after its second trip; plus the reference at
  "pallas" (K2 in interpret mode) against the port at "auto". Tolerances:
  iterations, inliers and convergence equal; T within 1e-6 and rmse within
  2e-5 relative (measured at most 3.1e-7 and 8.7e-6, after three trips;
  2e-7 absolute), tighter than ROADMAP §3's front-end gaps (2.96e-5 m),
  which include the NN.
- The in-place trip bit for bit the body's: `_drive` over `_step` (K2S's
  route, the plain trip at "xla" and point-to-point) against the loops
  over `_body` that the unbatched loop ran before it (a copy kept here),
  eager and unrolled; `gn_step` on a converged state (and, in the
  unrolled form, at max_iters) leaves the state as it was.
- `occupancy2d.update` bit-equal to its one-spare-cell form (a copy kept
  here) on scans with off-grid, masked and padded beams, and within the
  existing 1e-5 of the reference's `update`.
"""

import dataclasses
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _occupancy_one_spare as fold_ref
import chip_smoke
from tpu_icp_slam.config import ICPConfig as JICPConfig
from tpu_icp_slam.core import pointcloud as jpc
from tpu_icp_slam.icp import loop as jloop
from tpu_icp_slam.mapping import occupancy2d as jocc
from tpu_icp_slam_torch.config import ICPConfig
from tpu_icp_slam_torch.core import pointcloud as tpc
from tpu_icp_slam_torch.core import se3
from tpu_icp_slam_torch.icp import loop as tloop
from tpu_icp_slam_torch.kernels import gn_step as k2s
from tpu_icp_slam_torch.mapping import occupancy2d as occ

ROOT = Path(__file__).resolve().parents[1]
M, CAP = 600, 640
T_TOL, RMSE_RTOL = 1e-6, 2e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread a worker: the suite runs files in parallel."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _preset_icp(name):
    icp = json.loads((ROOT / "configs" / name).read_text())["icp"]
    return dataclasses.replace(ICPConfig(), **icp)


SLICE = chip_smoke.slice_config().icp
CASES = {
    "slice": SLICE,
    "rgbd": _preset_icp("rgbd.json"),
    "kitti_full_res": _preset_icp("kitti_full_res.json"),
    "anderson": dataclasses.replace(SLICE, anderson=True),
    "min_inliers_hold": dataclasses.replace(SLICE, min_inliers=5000),
    "non_pd": dataclasses.replace(SLICE, damping=0.0, prior_trans_weight=0.0,
                                  prior_rot_weight=0.0, huber_delta=0.0),
    "converges": dataclasses.replace(SLICE, tol=10.0, tol_update=0.0),
}


def _problem(case, seed=0):
    """(src (M, 3), q (M, 3), n (M, 3), init T (4, 4)) float32: targets on
    three planes (a line along z for "non_pd"), the source the targets moved
    by a small motion, with noise."""
    rng = np.random.default_rng(seed)
    if case == "non_pd":
        q = np.zeros((M, 3))
        q[:, 2] = rng.uniform(1.0, 8.0, M)
        n = np.tile([0.0, 0.0, 1.0], (M, 1))
    else:
        q = rng.uniform(-4.0, 4.0, (M, 3))
        n = np.zeros((M, 3))
        axis = np.arange(M) % 3
        q[np.arange(M), axis] = rng.choice([-3.0, 3.0], M)
        n[np.arange(M), axis] = 1.0
    xi = np.array([0.08, -0.05, 0.03, 0.01, -0.02, 0.015])
    T = se3.exp(torch.as_tensor(xi, dtype=torch.float64)).numpy()
    src = (q - T[:3, 3]) @ T[:3, :3]  # T⁻¹ q
    src = src + 0.003 * rng.standard_normal((M, 3))
    if case == "non_pd":
        src = q.copy()
        src[:, 2] -= 0.05
    init = np.eye(4)
    init[:3, 3] = [0.01, -0.01, 0.005]
    f32 = np.float32
    return src.astype(f32), q.astype(f32), n.astype(f32), init.astype(f32)


def _padded(a):
    out = np.zeros((CAP, 3), np.float32)
    out[:M] = a
    return out


def _jcorr(q, n, max_d2):
    qj, nj = jnp.asarray(_padded(q)), jnp.asarray(_padded(n))

    def corr(cur):
        diff = cur - qj
        d2 = jnp.sum(diff * diff, axis=-1)
        return qj, nj, (d2 <= max_d2).astype(jnp.float32), d2

    return corr


def _tcorr(q, n, max_d2):
    qt, nt = torch.from_numpy(_padded(q)), torch.from_numpy(_padded(n))

    def corr(cur):
        diff = cur - qt
        d2 = torch.sum(diff * diff, dim=-1)
        return qt, nt, (d2 <= max_d2).to(torch.float32), d2

    return corr


_REF = {}


def _reference(case, iters, backend="xla"):
    key = (case, iters, backend)
    if key not in _REF:
        cfg = dataclasses.replace(CASES[case], max_iters=iters,
                                  gn_backend=backend)
        src, q, n, init = _problem(case)
        jcfg = JICPConfig(**dataclasses.asdict(cfg))
        r = jloop.align_with_correspondence(
            jpc.make(src, CAP), _jcorr(q, n, cfg.max_corr_dist ** 2),
            jnp.asarray(init), jcfg)
        _REF[key] = {k: np.asarray(getattr(r, k)) for k in
                     ("T", "rmse", "iters", "n_inliers", "converged")}
    return _REF[key]


def _port(case, iters, backend):
    cfg = dataclasses.replace(CASES[case], max_iters=iters,
                              gn_backend=backend)
    src, q, n, init = _problem(case)
    r = tloop.align_with_correspondence(
        tpc.make(src, CAP, device="cpu"),
        _tcorr(q, n, cfg.max_corr_dist ** 2), torch.from_numpy(init), cfg)
    return {k: np.asarray(torch.as_tensor(getattr(r, k))) for k in
            ("T", "rmse", "iters", "n_inliers", "converged")}


def _assert_close(got, want):
    assert int(got["iters"]) == int(want["iters"])
    assert int(got["n_inliers"]) == int(want["n_inliers"])
    assert bool(got["converged"]) == bool(want["converged"])
    np.testing.assert_allclose(got["T"], want["T"], rtol=0, atol=T_TOL)
    np.testing.assert_allclose(got["rmse"], want["rmse"], rtol=RMSE_RTOL,
                               atol=1e-9)


@pytest.mark.parametrize("backend", ["xla", "auto"])
@pytest.mark.parametrize("iters", [1, 3])
@pytest.mark.parametrize("case", list(CASES))
def test_align_matches_reference(case, iters, backend):
    _assert_close(_port(case, iters, backend), _reference(case, iters))


def test_align_matches_reference_pallas_k2():
    """The reference's K2 in interpret mode against the port's K2S route."""
    _assert_close(_port("slice", 3, "auto"),
                  _reference("slice", 3, backend="pallas"))


def test_case_outcomes():
    """The cases do what their names say, on the reference too."""
    hold = _reference("min_inliers_hold", 3)
    src, _, _, init = _problem("min_inliers_hold")
    np.testing.assert_array_equal(hold["T"], init)  # the pose held
    non_pd = _reference("non_pd", 3)
    np.testing.assert_allclose(non_pd["T"], _problem("non_pd")[3], atol=0)
    conv = _reference("converges", 3)
    assert bool(conv["converged"]) and int(conv["iters"]) == 2
    got = _port("non_pd", 3, "auto")
    np.testing.assert_array_equal(got["T"], _problem("non_pd")[3])


def _body_loop(cfg, body, T0):
    """The unbatched loops over `body` (icp/loop.py's eager host loop and
    unrolled form before they ran the in-place step), verbatim."""
    state = tloop._init_state(T0)
    if cfg.unroll_iters > 0:
        T, prev_rmse, n_inl, converged, f_prev, g_prev, iters = state
        for _ in range(cfg.unroll_iters):
            stop = converged | (iters >= cfg.max_iters)
            T, prev_rmse, n_inl, converged, f_prev, g_prev = tloop.freeze(
                stop, body(T, prev_rmse, iters, f_prev, g_prev),
                (T, prev_rmse, n_inl, converged, f_prev, g_prev))
            iters = iters + (~stop).to(torch.int32)
        return tloop.ICPResult(T=T, rmse=prev_rmse, iters=iters,
                               n_inliers=n_inl, converged=converged)
    T, prev_rmse, n_inl, converged, f_prev, g_prev, _ = state
    it = 0
    while it < cfg.max_iters and not (it > 0 and bool(converged)):
        T, prev_rmse, n_inl, converged, f_prev, g_prev = body(
            T, prev_rmse, it, f_prev, g_prev)
        it += 1
    return tloop.ICPResult(T=T, rmse=prev_rmse, iters=it, n_inliers=n_inl,
                           converged=converged)


ROUTES = {"auto": {}, "xla": {"gn_backend": "xla"},
          "point_to_point": {"method": "point_to_point"}}


def _driven(case, route, iters, unroll, with_step):
    cfg = dataclasses.replace(CASES[case], max_iters=iters,
                              unroll_iters=unroll, **ROUTES[route])
    assert k2s.routes(cfg, 3) == (route == "auto")
    src, q, n, init = _problem(case)
    cloud = tpc.make(src, CAP, device="cpu")
    corr = _tcorr(q, n, cfg.max_corr_dist ** 2)
    T0 = torch.from_numpy(init)
    use_prior = cfg.method == "point_to_plane" and (
        cfg.prior_trans_weight > 0.0 or cfg.prior_rot_weight > 0.0)
    T0_inv, prior_scale = tloop._anchor(cfg, T0, use_prior)
    if with_step:
        return tloop._drive(
            cfg, tloop._step(cfg, cloud, corr, T0, T0_inv, prior_scale), T0)
    return _body_loop(
        cfg, tloop._body(cfg, cloud, corr, T0, T0_inv, prior_scale), T0)


@pytest.mark.parametrize("unroll", [0, 4])
@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("case", list(CASES))
def test_inplace_trip_bit_equal_to_body(case, route, unroll):
    """_drive over the in-place step (K2S's route on the CPU, or the plain
    trip) against the body's loop, the form the loop had before the step
    existed."""
    a = _driven(case, route, 3, unroll, with_step=True)
    b = _driven(case, route, 3, unroll, with_step=False)
    for k in ("T", "rmse", "n_inliers", "converged"):
        assert torch.equal(getattr(a, k), getattr(b, k)), k
    assert int(torch.as_tensor(a.iters)) == int(torch.as_tensor(b.iters))


@pytest.mark.parametrize("unrolled", [False, True])
def test_frozen_state_unchanged(unrolled):
    cfg = dataclasses.replace(SLICE, max_iters=3)
    src, q, n, init = _problem("slice")
    cloud = tpc.make(src, CAP, device="cpu")
    corr = _tcorr(q, n, cfg.max_corr_dist ** 2)
    T0 = torch.from_numpy(init)
    T0_inv, prior_scale = tloop._anchor(cfg, T0, True)
    step = tloop._step(cfg, cloud, corr, T0, T0_inv, prior_scale)
    state = tuple(t.clone() for t in tloop._init_state(T0))
    step(state, 0)
    assert int(state[6]) == 1 and not bool(state[3])
    if unrolled:
        state[6].fill_(cfg.max_iters)  # at max_iters: frozen
    else:
        state[3].fill_(True)  # converged: frozen
    before = tuple(t.clone() for t in state)
    step(state, None if unrolled else 1, unrolled=unrolled)
    for a, b in zip(state, before):
        assert torch.equal(a, b)


def test_gn_step_ref_is_the_body_tail():
    """gn_step_ref on the body's own correspondence gives the body's
    result."""
    cfg = dataclasses.replace(SLICE, max_iters=3, anderson=True)
    src, q, n, init = _problem("slice")
    cloud = tpc.make(src, CAP, device="cpu")
    corr = _tcorr(q, n, cfg.max_corr_dist ** 2)
    T0 = torch.from_numpy(init)
    T0_inv, prior_scale = tloop._anchor(cfg, T0, True)
    state = tloop._init_state(T0)
    T, prev, _, _, f, g, _ = state
    want = tloop._body(cfg, cloud, corr, T0, T0_inv, prior_scale)(
        T, prev, 0, f, g)
    cur = tloop._moved(cloud.points, T)
    got = tloop.gn_step_ref(cfg, cloud.mask.float(), cur, *corr(cur), T,
                            prev, 0, f, g, T0, T0_inv, prior_scale)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert k2s.routes(cfg, 3)
    assert not k2s.routes(dataclasses.replace(cfg, gn_backend="xla"), 3)
    assert not k2s.routes(dataclasses.replace(cfg, degen_eps=1e-3), 3)
    assert not k2s.routes(dataclasses.replace(cfg, method="point_to_point"),
                          3)
    assert not k2s.routes(cfg, 2)


# ---- the occupancy grid's fold ----------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_occupancy_fold_bit_equal_to_one_spare_form(seed):
    grid = occ.create(200, 0.1, device="cpu")  # 20 m: ranges past 10 m drop
    jgrid = jocc.create(200, 0.1)
    new = old = grid
    for k in range(3):
        pose, pts, mask = fold_ref.fold_scans(seed * 10 + k)
        assert (~mask[:360]).any()  # masked beams inside the grid
        args = (torch.from_numpy(pose), torch.from_numpy(pts),
                torch.from_numpy(mask))
        new = occ.update(new, *args)
        old = fold_ref.update_one_spare(old, *args)
        jgrid = jocc.update(jgrid, jnp.asarray(pose), jnp.asarray(pts),
                            jnp.asarray(mask))
        assert chip_smoke.bits_equal(new.logodds, old.logodds)
    lo = new.logodds.numpy()
    assert (lo > 0).any() and (lo < 0).any()
    np.testing.assert_allclose(lo, np.asarray(jgrid.logodds), atol=1e-5)
