"""K5 (the whole-loop fused ICP) and the fused scan-to-map slice of the torch
port against the JAX reference.

On the CPU `icp_fused` runs its plain torch version; the reference's
icp_fused_pallas runs in interpret mode, as tests/test_icp_fused.py runs it,
on the same float32 inputs (that file's `_problem` cases). The CUDA kernel
itself is held against the plain version in test_torch_cuda.py.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_icp_fused import _CFG, _problem
from test_torch_slice import _rot_gap
from tpu_icp_slam.core.pointcloud import voxel_downsample_np
from tpu_icp_slam.datasets import synthetic
from tpu_icp_slam.eval import metrics as em
from tpu_icp_slam.kernels.icp_fused_pallas import icp_fused_pallas
from tpu_icp_slam.slam.runner import pad_scans
from tpu_icp_slam.slam.scan_to_map import ScanToMapPipeline as JaxPipeline
from tpu_icp_slam_torch.kernels import icp_fused as k5
from tpu_icp_slam_torch.slam.scan_to_map import ScanToMapPipeline

from test_scan_to_map import _s2m_cfg

# Bounds on the largest gap over the cases below (CPU, port's plain version
# vs interpret mode; `python tests/test_torch_fused.py` prints them), as
# (metres, radians, rmse in m). One align: at "highest" both pick the same
# neighbours and differ by float32 summation order (observed 4.2e-7 m,
# 2.2e-8 rad, rmse 6.0e-8; bounds at about 10x). At "bf16" both rebuild q
# and n from their bf16 hi/lo halves and differ by summation order too
# (observed 3.6e-7 m, 4.9e-8 rad, rmse 6.0e-8 over 1 and 3 torch threads;
# bounds at 2x). Iteration and inlier counts agree exactly.
ALIGN_GAP = {"highest": (5e-6, 3e-7, 1e-6), "bf16": (7.2e-7, 9.7e-8, 1.19e-7)}
# Per-frame poses of the fused slice: at "highest" observed 4.0e-5 m and
# 1.1e-5 rad (iteration counts +-1 at the tol threshold). At "bf16" the
# float32 sum order of the packed scores flips near-tie selections and the
# frames converge along different paths: observed 1.6e-3 m, 8.8e-4 rad, and
# map sizes up to 0.36% apart (voxel-boundary points of slightly different
# poses), so map_points is held to 3.5% there and equal at "highest".
SLICE_GAP = {"highest": (4e-4, 1e-4, 0.0), "bf16": (1.6e-2, 9e-3, 0.035)}


def _plane_problem():
    """Ground plane only: x, y and yaw are unobserved; z is 0.3 m off."""
    rng = np.random.default_rng(11)
    n = 640
    xy = rng.uniform(-10, 10, (n, 2))
    dst = np.concatenate([xy, np.zeros((n, 1))], 1).astype(np.float32)
    src = dst + np.array([0, 0, 0.3], np.float32)
    nrm = np.tile(np.array([0, 0, 1.0], np.float32), (n, 1))
    ones = np.ones(n, bool)
    kw = dict(max_iters=10, tol=1e-8, tol_update=0.0, max_corr_dist=5.0,
              huber_delta=0.0, damping=1e-6, step_scale=1.0,
              max_step_trans=1.0, max_step_rot=0.3, min_inliers=10,
              prior_trans_weight=0.05, prior_rot_weight=0.05)
    return (src, ones, dst, nrm, ones, None, 1e9), kw


# name: (_problem kwargs, r_gate, init from T_true, overrides of _CFG)
CASES = {
    "highest": (dict(seed=0), 1e6, False, {}),
    "coverage_gate_one_iteration": (dict(seed=1), 9.0, False,
                                    dict(max_iters=1)),
    "coverage_gate": (dict(seed=1), 9.0, False, {}),
    "init_T": (dict(seed=2, offset_scale=0.6), 1e6, True, {}),
    "min_inlier_guard": (dict(seed=3), 1e-3, False, {}),
    "non_tile_multiple": (dict(seed=5, m=333, n=517), 1e6, False, {}),
    "motion_prior": (dict(seed=2), 1e6, False,
                     dict(prior_trans_weight=0.02, prior_rot_weight=0.02)),
    "trust_region_binding": (dict(seed=3, offset_scale=0.5), 1e6, False,
                             dict(max_total_trans=0.25, max_total_rot=0.1,
                                  max_iters=8)),
    "trust_region_not_binding": (dict(seed=4, offset_scale=0.1), 1e6, False,
                                 dict(max_total_trans=50.0,
                                      max_total_rot=3.0)),
}


def _case(name):
    if name == "motion_prior_plane_only":
        return _plane_problem()
    prob, r_gate, with_init, over = CASES[name]
    src, smask, dst, nrm, dmask, T_true = _problem(**prob)
    arrays = tuple(np.array(a) for a in (src, smask, dst, nrm, dmask))
    init = np.array(T_true, np.float32) if with_init else None
    return (*arrays, init, r_gate), {**_CFG, **over}


def _both(args, kw, precision):
    src, smask, dst, nrm, dmask, init, r_gate = args
    ref = icp_fused_pallas(
        jnp.asarray(src), jnp.asarray(smask), jnp.asarray(dst),
        jnp.asarray(nrm), jnp.asarray(dmask),
        init_T=None if init is None else jnp.asarray(init), r_gate=r_gate,
        precision=precision, tile_m=256, tile_n=256, **kw)
    port = k5.icp_fused(
        torch.from_numpy(src), torch.from_numpy(smask),
        torch.from_numpy(dst), torch.from_numpy(nrm),
        torch.from_numpy(dmask),
        init_T=None if init is None else torch.from_numpy(init),
        r_gate=r_gate, precision=precision, **kw)
    ref = [np.asarray(v) for v in ref]
    port = [v.numpy() for v in port]
    return ref, port


def _assert_align_agrees(ref, port, precision):
    (Tr, rr, ir, nr, cr), (Tp, rp, ip, np_, cp) = ref, port
    assert Tp.dtype == np.float32 and ip.dtype == np.int32
    assert np_.dtype == np.int32 and cp.dtype == np.bool_
    t_gap = float(np.linalg.norm(Tr[:3, 3] - Tp[:3, 3]))
    r_gap = float(_rot_gap(Tr[None], Tp[None])[0])
    bound = ALIGN_GAP[precision]
    assert t_gap <= bound[0] and r_gap <= bound[1], (t_gap, r_gap)
    assert abs(float(rr) - float(rp)) <= bound[2], (float(rr), float(rp))
    assert (int(ir), int(nr), bool(cr)) == (int(ip), int(np_), bool(cp))


@pytest.mark.parametrize("name", [*CASES, "motion_prior_plane_only"])
def test_fused_plain_matches_reference_highest(name):
    args, kw = _case(name)
    ref, port = _both(args, kw, "highest")
    _assert_align_agrees(ref, port, "highest")
    if name == "min_inlier_guard":
        np.testing.assert_allclose(port[0], np.eye(4), atol=1e-5)
        assert int(port[3]) == 0
    if name == "coverage_gate_one_iteration":
        # same transform, so the gate must zero the same points
        assert abs(int(ref[3]) - int(port[3])) <= 1
    if name == "motion_prior_plane_only":
        T = port[0].astype(np.float64)
        assert abs(T[2, 3] + 0.3) < 0.02 and np.abs(T[:2, 3]).max() < 1e-3


@pytest.mark.parametrize("name", ["highest", "non_tile_multiple",
                                  "trust_region_binding"])
def test_fused_plain_matches_reference_bf16(name):
    args, kw = _case(name)
    ref, port = _both(args, kw, "bf16")
    _assert_align_agrees(ref, port, "bf16")


def test_fused_solves_the_problem():
    """Not just agreement: the port's align recovers the true transform."""
    src, smask, dst, nrm, dmask, T_true = _problem(seed=0)
    T, *_ = k5.icp_fused(*(torch.from_numpy(np.array(a)) for a in
                           (src, smask, dst, nrm, dmask)), r_gate=1e6,
                         precision="highest", **_CFG)
    d = np.linalg.inv(np.asarray(T_true)) @ T.numpy().astype(np.float64)
    assert np.linalg.norm(d[:3, 3]) < 0.02


def _slice_log():
    scans, gt = synthetic.velodyne_log(n_frames=10, n_rings=12, n_azimuth=200,
                                       path_fraction=0.15)
    scans = [voxel_downsample_np(s, 0.5) for s in scans]
    pts, msk = pad_scans(scans, 1024)
    return pts, msk, gt


def _fused_cfg(precision):
    cfg = _s2m_cfg()
    return dataclasses.replace(
        cfg,
        icp=dataclasses.replace(cfg.icp, loop_backend="fused",
                                nn_precision=precision),
        pipeline=dataclasses.replace(cfg.pipeline, scan_capacity=1024),
        mapping=dataclasses.replace(cfg.mapping, local_model_size=2048))


@pytest.mark.parametrize("precision,n_frames", [("highest", 9),
                                                ("bf16", 4)])
def test_fused_slice_matches_reference(precision, n_frames):
    """The port's fused scan-to-map slice against JaxPipeline on the log and
    configuration of test_scan_to_map_fused_loop_backend_matches_steps."""
    pts, msk, gt = _slice_log()
    pts, msk = pts[: n_frames + 1], msk[: n_frames + 1]
    cfg = _fused_cfg(precision)
    jp = JaxPipeline(cfg)
    _, ji = jp.run_fused(jp.init_state(pts[0], msk[0]), pts[1:], msk[1:])
    tp = ScanToMapPipeline(cfg, device="cpu")
    before = k5.icp_fused.launches
    _, ti = tp.run_fused(tp.init_state(pts[0], msk[0]), pts[1:], msk[1:])
    assert k5.icp_fused.launches == before  # CPU: the plain version
    ji = {k: np.asarray(v) for k, v in ji.items()}
    ti = {k: v.numpy() for k, v in ti.items()}
    pos_gap = np.linalg.norm(ji["pose"][:, :3, 3] - ti["pose"][:, :3, 3],
                             axis=1)
    rot_gap = _rot_gap(ji["pose"], ti["pose"])
    bound = SLICE_GAP[precision]
    assert pos_gap.max() <= bound[0], pos_gap
    assert rot_gap.max() <= bound[1], rot_gap
    for k in ("is_keyframe", "map_inserted"):
        np.testing.assert_array_equal(ti[k], ji[k], err_msg=k)
    map_gap = np.abs(ti["map_points"] - ji["map_points"]) / ji["map_points"]
    assert map_gap.max() <= bound[2], (ti["map_points"], ji["map_points"])
    if precision == "highest":
        assert np.abs(ti["iters"] - ji["iters"]).max() <= 1
    assert ti["iters"].dtype.kind == "i" and ti["iters"].min() >= 1
    poses = np.concatenate([np.eye(4)[None], ti["pose"]])
    gt_rel = np.einsum("ij,fjk->fik", np.linalg.inv(gt[0]), gt)
    ate = em.ate_rmse(poses[:, :3, 3], gt_rel[: len(poses), :3, 3])
    assert ate < 0.15, ate


def test_fused_state_carried_from_reference_continues():
    """Four frames of the reference's fused pipeline (the seed frame and
    three steps), its state carried into the port through numpy, then both
    step two more frames on the fused path."""
    from tpu_icp_slam_torch.interop import state_from_numpy

    pts, msk, _ = _slice_log()
    cfg = _fused_cfg("highest")
    jp = JaxPipeline(cfg)
    js, _ = jp.run_fused(jp.init_state(pts[0], msk[0]), pts[1:4], msk[1:4])
    d = {f.name: np.asarray(getattr(js, f.name))
         for f in dataclasses.fields(js) if f.name != "vmap"}
    d["vmap"] = {k: np.asarray(getattr(js.vmap, k))
                 for k in ("points", "normals", "mask")}
    ts = state_from_numpy(d, device="cpu")
    tp = ScanToMapPipeline(cfg, device="cpu")
    for f in (4, 5):
        js, jinfo = jp.step(js, pts[f], msk[f])
        ts, tinfo = tp.step(ts, pts[f], msk[f])
        gap = np.abs(tinfo["pose"].numpy() - np.asarray(jinfo["pose"]))
        assert gap.max() <= SLICE_GAP["highest"][0], gap.max()
        assert bool(tinfo["map_inserted"]) == bool(jinfo["map_inserted"])
        assert int(tinfo["map_points"]) == int(jinfo["map_points"])


def align_gaps(precision, names):
    """(metres, radians, rmse) gap of the port's plain version from the
    reference's interpret mode on each named case."""
    out = {}
    for name in names:
        (Tr, rr, *_), (Tp, rp, *_) = _both(*_case(name), precision)
        out[name] = (float(np.linalg.norm(Tr[:3, 3] - Tp[:3, 3])),
                     float(_rot_gap(Tr[None], Tp[None])[0]),
                     abs(float(rr) - float(rp)))
    return out


if __name__ == "__main__":
    # The measurement behind ALIGN_GAP: python tests/test_torch_fused.py
    import jax

    jax.config.update("jax_platforms", "cpu")
    for prec, names in (("highest", [*CASES, "motion_prior_plane_only"]),
                        ("bf16", ["highest", "non_tile_multiple",
                                  "trust_region_binding"])):
        gaps = align_gaps(prec, names)
        for name, g in gaps.items():
            print(f"{prec} {name}: {g[0]:.3e} m, {g[1]:.3e} rad, rmse "
                  f"{g[2]:.3e}")
        print(f"{prec} largest: " + ", ".join(
            f"{max(g[i] for g in gaps.values()):.3e}" for i in range(3)))
