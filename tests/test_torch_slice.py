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
from tpu_icp_slam.config import to_json as jto_json
from tpu_icp_slam.core.pointcloud import voxel_downsample_np
from tpu_icp_slam.datasets import synthetic
from tpu_icp_slam.eval import metrics as em
from tpu_icp_slam.slam.runner import pad_scans
from tpu_icp_slam.slam.scan_to_map import ScanToMapPipeline as JaxPipeline
from tpu_icp_slam_torch.config import from_json as tfrom_json
from tpu_icp_slam_torch.config import to_json as tto_json
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
    tp = ScanToMapPipeline(tfrom_json(jto_json(cfg)), device="cpu")
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
    """The mapping options that earlier slices refused now run: the slice
    with each one on matches the reference's on the main log, within the
    main bounds (tests/test_torch_mapping_options.py holds the functions
    themselves entry for entry)."""
    cfg = _s2m_cfg()
    cfg = dataclasses.replace(cfg, **{section: dataclasses.replace(
        getattr(cfg, section), **{field: value})})
    pts, msk, gt = _log()
    ji, ti = _run_both(cfg, pts, msk)
    _assert_slice_agrees(ji, ti, gt, GAPS["main"])
    assert ti["map_inserted"].sum() >= 1


def _port_modules():
    return sorted(
        ".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
        .removesuffix(".__init__")
        for p in (ROOT / "src" / "tpu_icp_slam_torch").rglob("*.py"))


def test_port_imports_without_jax():
    """The port, chip_smoke.py and chip_ab.py import and run with jax, the
    reference package and cv2 blocked (the card's machine has none of
    them), lazy imports included: the native voxel downsample, a preset
    through from_json, velodyne_log, ATE, a 3-frame scan-to-map run, `cli
    align`, a 3-frame `cli run`, a 3-frame 2D `cli run` (sim2d, its
    occupancy grid and map.png), a 3-frame RGB-D `cli run` (simrgbd with
    configs/rgbd.json) and a TUM directory written and read back, on the
    CPU."""
    code = (
        "import importlib, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['tpu_icp_slam'] = None\n"
        "sys.modules['cv2'] = None\n"
        f"for m in {_port_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "import dataclasses\n"
        "import numpy as np\n"
        "import chip_ab, chip_smoke\n"
        "from tpu_icp_slam_torch import from_json, metrics, synthetic\n"
        "from tpu_icp_slam_torch.core.pointcloud import voxel_downsample_np\n"
        "from tpu_icp_slam_torch.native import available\n"
        "from tpu_icp_slam_torch.slam.runner import pad_scans\n"
        "from tpu_icp_slam_torch.slam.scan_to_map import ScanToMapPipeline\n"
        "chip_smoke.slice_config()\n"
        "cfg = from_json(open('configs/kitti_full_res.json').read())\n"
        "assert cfg.icp.nn_precision == 'highest', cfg.icp\n"
        "scans, gt = synthetic.velodyne_log(\n"
        "    n_frames=4, n_rings=8, n_azimuth=128, path_fraction=0.04)\n"
        "scans = [voxel_downsample_np(s, 0.5) for s in scans]\n"
        "assert available()\n"
        "pts, msk = pad_scans(scans, 768)\n"
        "cfg = chip_smoke.slice_config()\n"
        "cfg = dataclasses.replace(\n"
        "    cfg, pipeline=dataclasses.replace(cfg.pipeline,\n"
        "                                      scan_capacity=768),\n"
        "    mapping=dataclasses.replace(cfg.mapping, map_capacity=8192,\n"
        "                                local_model_size=1024))\n"
        "pipe = ScanToMapPipeline(cfg, device='cpu')\n"
        "_, infos = pipe.run_fused(pipe.init_state(pts[0], msk[0]),\n"
        "                          pts[1:], msk[1:])\n"
        "poses = np.concatenate([np.eye(4)[None],\n"
        "                        infos['pose'].numpy().astype(np.float64)])\n"
        "gt_rel = np.einsum('ij,fjk->fik', np.linalg.inv(gt[0]), gt)\n"
        "ate = metrics.ate_rmse(poses[:, :3, 3], gt_rel[:, :3, 3])\n"
        "assert np.isfinite(ate) and ate < 0.5, ate\n"
        "import contextlib, io, json, tempfile\n"
        "from tpu_icp_slam_torch import cli\n"
        "buf = io.StringIO()\n"
        "with contextlib.redirect_stdout(buf):\n"
        "    cli.main(['align', '--n', '256', '--device', 'cpu'])\n"
        "assert 'rot_err_rad' in json.loads(buf.getvalue())\n"
        "out = tempfile.mkdtemp()\n"
        "with contextlib.redirect_stdout(io.StringIO()):\n"
        "    assert cli.main(['run', '--dataset', 'sim3d', '--frames', '3',\n"
        "                     '--device', 'cpu', '--out', out,\n"
        "                     'pipeline.scan_capacity=1024',\n"
        "                     'icp.max_iters=10']) == 0\n"
        "assert json.load(open(out + '/report.json'))['frames'] == 3\n"
        "with contextlib.redirect_stdout(io.StringIO()):\n"
        "    assert cli.main(['run', '--dataset', 'sim2d', '--frames', '3',\n"
        "                     '--device', 'cpu', '--out', out + '/2d',\n"
        "                     'pipeline.scan_capacity=512']) == 0\n"
        "assert np.load(out + '/2d/trajectory.npz')['poses'].shape == (\n"
        "    3, 3, 3)\n"
        "assert open(out + '/2d/map.png', 'rb').read(4) == b'\\x89PNG'\n"
        "with contextlib.redirect_stdout(io.StringIO()):\n"
        "    assert cli.main(['run', '--dataset', 'simrgbd', '--frames', '3',\n"
        "                     '--device', 'cpu', '--out', out + '/rgbd',\n"
        "                     '--config', 'configs/rgbd.json']) == 0\n"
        "rep = json.load(open(out + '/rgbd/report.json'))\n"
        "assert rep['frames'] == 3 and np.isfinite(rep['ate_rmse']), rep\n"
        "from tpu_icp_slam_torch.datasets import tum\n"
        "d, p, _ = synthetic.rgbd_log(n_frames=2)\n"
        "tum.write_sequence(out + '/tum', d, gt_poses=p)\n"
        "seq = tum.load_sequence(out + '/tum')\n"
        "img = np.clip(d * 5000.0, 0, 65535).astype(np.uint16)\n"
        "assert np.array_equal(seq.depths, img / 5000.0)\n"
        "assert not [k for k, v in sys.modules.items() if v is not None\n"
        "            and k.split('.')[0] in ('jax', 'tpu_icp_slam', 'cv2')]\n"
        "print('imported', len(sys.modules), 'ate', ate)\n"
    )
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT)]))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "imported" in proc.stdout


def test_port_sources_never_import_jax():
    """Neither jax, the reference package nor cv2 is imported by any port
    file, chip_smoke.py or chip_ab.py, at top level or inside a
    function."""
    files = list((ROOT / "src" / "tpu_icp_slam_torch").rglob("*.py"))
    files += [ROOT / "chip_smoke.py", ROOT / "chip_ab.py"]
    jax_import = re.compile(r"^\s*(import|from)\s+(jax|cv2)\b", re.M)
    ref_import = re.compile(r"^\s*(import|from)\s+tpu_icp_slam\b(?!_)", re.M)
    ref_name = re.compile(
        r"import_module\(\s*['\"](jax|cv2|tpu_icp_slam)\b(?!_)")
    assert len(files) > 10
    for f in files:
        text = f.read_text()
        assert not jax_import.search(text), f
        assert not ref_import.search(text), f
        assert not ref_name.search(text), f


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
    # the two packages' config classes differ; their JSON form is the same
    assert tto_json(smoke.slice_config()) == jto_json(bench._kitti_cfg())
    assert tfrom_json(jto_json(bench._kitti_cfg())) == smoke.slice_config()
