"""The torch port's scan-to-map slice as a whole, against the JAX reference,
and the properties of the port's packaging (no jax, no CPU fallback in the
GPU smoke script, the same flagship configuration as bench.py)."""

import dataclasses
import importlib.util
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from test_scan_to_map import _s2m_cfg
from tpu_icp_slam.core.pointcloud import voxel_downsample_np
from tpu_icp_slam.datasets import synthetic
from tpu_icp_slam.eval import metrics as em
from tpu_icp_slam.slam.runner import pad_scans
from tpu_icp_slam.slam.scan_to_map import ScanToMapPipeline as JaxPipeline
from tpu_icp_slam_torch.interop import state_from_numpy, state_to_numpy
from tpu_icp_slam_torch.slam.scan_to_map import ScanToMapPipeline

ROOT = Path(__file__).resolve().parents[1]
# Per-frame pose agreement of the whole slice on the CPU, bounds at 10x the
# observed gaps (f32 summation-order differences plus the NN's
# difference-form vs factored-form scoring): position 2.96e-5 m and rotation
# 6.1e-6 rad on the main log; 1.54e-4 m and 1.9e-5 rad with extract
# hysteresis (its carried model is reused across frames, so gaps compound).
GAPS = {"main": (3e-4, 6e-5), "hysteresis": (1.5e-3, 2e-4)}


def _load_module(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _log(n_frames=10, n_rings=16, n_azimuth=320, path_fraction=0.12,
         voxel=0.4, capacity=2048):
    scans, gt = synthetic.velodyne_log(
        n_frames=n_frames, n_rings=n_rings, n_azimuth=n_azimuth,
        path_fraction=path_fraction)
    scans = [voxel_downsample_np(s, voxel) for s in scans]
    pts, msk = pad_scans(scans, capacity)
    return pts, msk, gt


def _rot_gap(Ta, Tb):
    """Geodesic angle between rotations, atan2 form (exact at small angles,
    where arccos of the trace rounds to 0)."""
    M = np.einsum("fji,fjk->fik", Ta[:, :3, :3].astype(np.float64),
                  Tb[:, :3, :3].astype(np.float64))
    A = M - np.swapaxes(M, 1, 2)
    sin = np.linalg.norm(np.stack([A[:, 2, 1], A[:, 0, 2], A[:, 1, 0]], 1),
                         axis=1) / 2.0
    cos = (np.trace(M, axis1=1, axis2=2) - 1.0) / 2.0
    return np.arctan2(sin, cos)


def _run_both(cfg, pts, msk):
    jp = JaxPipeline(cfg)
    _, ji = jp.run_fused(jp.init_state(pts[0], msk[0]), pts[1:], msk[1:])
    tp = ScanToMapPipeline(cfg, device="cpu")
    _, ti = tp.run_fused(tp.init_state(pts[0], msk[0]), pts[1:], msk[1:])
    return ({k: np.asarray(v) for k, v in ji.items()},
            {k: v.numpy() for k, v in ti.items()})


def _assert_slice_agrees(ji, ti, gt, gaps):
    pos_gap = np.linalg.norm(ji["pose"][:, :3, 3] - ti["pose"][:, :3, 3],
                             axis=1)
    assert pos_gap.max() <= gaps[0], pos_gap
    rot_gap = _rot_gap(ji["pose"], ti["pose"])
    assert rot_gap.max() <= gaps[1], rot_gap
    for k in ("is_keyframe", "map_inserted", "map_points"):
        np.testing.assert_array_equal(ti[k], ji[k], err_msg=k)
    poses = np.concatenate([np.eye(4)[None], ti["pose"]])
    gt_rel = np.einsum("ij,fjk->fik", np.linalg.inv(gt[0]), gt)
    ate = em.ate_rmse(poses[:, :3, 3], gt_rel[: len(poses), :3, 3])
    assert ate < 0.15, f"port scan-to-map ATE {ate}"


def test_slice_matches_reference():
    pts, msk, gt = _log()
    ji, ti = _run_both(_s2m_cfg(), pts, msk)
    _assert_slice_agrees(ji, ti, gt, GAPS["main"])
    assert ti["is_keyframe"].sum() >= 1
    assert np.isfinite(ti["pose"]).all()
    assert ti["iters"].dtype.kind == "i" and ti["iters"].min() >= 1


def test_slice_with_extract_hysteresis_matches_reference():
    pts, msk, gt = _log(n_frames=8, n_rings=12, n_azimuth=240,
                        path_fraction=0.1, capacity=1536)
    cfg = _s2m_cfg()
    cfg = dataclasses.replace(cfg, mapping=dataclasses.replace(
        cfg.mapping, extract_hysteresis=3.0, local_model_size=2048))
    ji, ti = _run_both(cfg, pts, msk)
    _assert_slice_agrees(ji, ti, gt, GAPS["hysteresis"])


def test_carried_state_continues_like_reference():
    """Five frames (the seed frame and four steps) in JAX, the state carried
    into the port through numpy, then both step the next two frames."""
    pts, msk, _ = _log()
    cfg = _s2m_cfg()
    jp = JaxPipeline(cfg)
    js, _ = jp.run_fused(jp.init_state(pts[0], msk[0]), pts[1:5], msk[1:5])
    d = {f.name: np.asarray(getattr(js, f.name))
         for f in dataclasses.fields(js) if f.name != "vmap"}
    d["vmap"] = {k: np.asarray(getattr(js.vmap, k))
                 for k in ("points", "normals", "mask")}
    ts = state_from_numpy(d, device="cpu")
    back = state_to_numpy(ts)
    for k, v in d.items():
        if k == "vmap":
            for kk in v:
                np.testing.assert_array_equal(back[k][kk], v[kk])
        else:
            np.testing.assert_array_equal(back[k], v.astype(back[k].dtype))
    tp = ScanToMapPipeline(cfg, device="cpu")
    for f in (5, 6):  # frame 6 inserts into the map
        js, jinfo = jp.step(js, pts[f], msk[f])
        ts, tinfo = tp.step(ts, pts[f], msk[f])
        np.testing.assert_allclose(tinfo["pose"].numpy(),
                                   np.asarray(jinfo["pose"]), atol=1e-4)
        assert bool(tinfo["map_inserted"]) == bool(jinfo["map_inserted"])
        np.testing.assert_array_equal(ts.vmap.mask.numpy(),
                                      np.asarray(js.vmap.mask))
        if not bool(jinfo["map_inserted"]):
            np.testing.assert_array_equal(ts.vmap.points.numpy(),
                                          np.asarray(js.vmap.points))
        else:
            np.testing.assert_allclose(ts.vmap.points.numpy(),
                                       np.asarray(js.vmap.points), atol=1e-4)
    assert bool(jinfo["map_inserted"])


def test_streaming_steps_equal_run_fused():
    pts, msk, _ = _log(n_frames=4, n_rings=8, n_azimuth=128,
                       path_fraction=0.2, voxel=0.6, capacity=512)
    cfg = _s2m_cfg()
    cfg = dataclasses.replace(
        cfg, pipeline=dataclasses.replace(cfg.pipeline, scan_capacity=512))
    tp = ScanToMapPipeline(cfg, device="cpu")
    _, infos = tp.run_fused(tp.init_state(pts[0], msk[0]), pts[1:], msk[1:])
    st = tp.init_state(pts[0], msk[0])
    for i in range(1, len(pts)):
        st, info = tp.step(st, pts[i], msk[i])
        assert torch.equal(info["pose"], infos["pose"][i - 1])


@pytest.mark.parametrize("section,field,value", [
    ("mapping", "insert_backend", "hash"),
    ("mapping", "extract_approx", True),
])
def test_unported_pipeline_options_raise(section, field, value):
    cfg = _s2m_cfg()
    cfg = dataclasses.replace(cfg, **{section: dataclasses.replace(
        getattr(cfg, section), **{field: value})})
    with pytest.raises(NotImplementedError):
        ScanToMapPipeline(cfg, device="cpu")


def _port_modules():
    return sorted(
        ".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
        .removesuffix(".__init__")
        for p in (ROOT / "src" / "tpu_icp_slam_torch").rglob("*.py"))


def test_port_imports_without_jax():
    code = (
        "import importlib, sys\n"
        "sys.modules['jax'] = None\n"
        f"for m in {_port_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "import chip_smoke\n"
        "chip_smoke.slice_config()\n"
        "print('imported', len(sys.modules))\n"
    )
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT)]))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "imported" in proc.stdout


def test_port_sources_never_import_jax():
    files = list((ROOT / "src" / "tpu_icp_slam_torch").rglob("*.py"))
    files += [ROOT / "chip_smoke.py", ROOT / "chip_ab.py"]
    jax_import = re.compile(r"^\s*(import|from)\s+jax\b", re.M)
    ref_import = re.compile(r"^\s*(import|from)\s+tpu_icp_slam\b(?!_)", re.M)
    assert len(files) > 10
    for f in files:
        assert not jax_import.search(f.read_text()), f
    # the smoke script reaches the shared numpy modules through the port
    assert not ref_import.search((ROOT / "chip_smoke.py").read_text())


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_refuses_to_run_without_cuda(where, tmp_path):
    script = ROOT / "chip_smoke.py"
    if where == "alone":
        script = tmp_path / "chip_smoke.py"
        script.write_text((ROOT / "chip_smoke.py").read_text())
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, str(script)], cwd=script.parent,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_ab_refuses_to_run_without_cuda():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, str(ROOT / "chip_ab.py")],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"done"' not in proc.stdout


@pytest.mark.parametrize("change", ["none", "trans", "rot", "rmse", "iters",
                                    "inliers", "converged"])
def test_chip_smoke_k5_checks_reject_each_mismatch(change):
    """Phase 8's comparison of K5 with its plain version fails on a gap
    just past each bound, and on any difference in the counts."""
    from tpu_icp_slam_torch.core import se3

    smoke = _load_module("chip_smoke_for_k5_test", ROOT / "chip_smoke.py")
    ref = (torch.eye(4), torch.tensor(0.15), torch.tensor(4, dtype=torch.int32),
           torch.tensor(16199, dtype=torch.int32), torch.tensor(True))
    for prec, b in smoke.K5_BOUNDS.items():
        xi = torch.zeros(6, dtype=torch.float64)
        rmse, iters, inl, conv = ref[1], ref[2], ref[3], ref[4]
        if change == "trans":
            xi[0] = 2 * b["trans_m"]
        elif change == "rot":
            xi[5] = 2 * b["rot_rad"]
        elif change == "rmse":
            rmse = rmse + 2 * b["rmse_m"]
        elif change == "iters":
            iters = iters + 1
        elif change == "inliers":
            inl = inl - 1
        elif change == "converged":
            conv = ~conv
        out = (se3.exp(xi).float(), rmse, iters, inl, conv)
        bad = smoke._k5_mismatches(out, ref, prec)
        expected = [] if change == "none" else [
            {"trans": "trans_m", "rot": "rot_rad", "rmse": "rmse_m"}.get(
                change, change)]
        assert bad == expected, (prec, bad)


def test_chip_smoke_config_is_the_bench_flagship(monkeypatch):
    for var in ("BENCH_NN", "BENCH_LOOP", "BENCH_NOVS"):
        monkeypatch.delenv(var, raising=False)
    bench = _load_module("bench_for_port_test", ROOT / "bench.py")
    smoke = _load_module("chip_smoke_for_port_test", ROOT / "chip_smoke.py")
    assert smoke.slice_config() == bench._kitti_cfg()
