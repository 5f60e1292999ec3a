"""The port's persistent maps (slam/map_io.py) against the reference's, on
tests/test_map_io.py's fixtures: save, load and localize in one package;
closure metadata and descriptor geometry round trips; and a map saved by
either package localizes in the other to the pose the saving package finds.

Tolerances: what a map stores (scans, poses, descriptors, the voxel map)
crosses bit for bit; a localized pose within 1 m of ground truth (the
reference's own bound); the two packages' localized poses within 1e-3 m and
the same matched keyframe (test_torch_backend.py's relocalize tolerance:
float32 ICP in another summation order). Verification runs 4 yaw
hypotheses a candidate (the reference's lean basket) to keep the CPU's
brute-force NN short.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_icp_slam.config import BackendConfig as JBackendConfig
from tpu_icp_slam.core.pointcloud import voxel_downsample_np
from tpu_icp_slam.datasets import synthetic
from tpu_icp_slam.mapping import voxel_map as jvm
from tpu_icp_slam.slam import map_io as jmap_io
from tpu_icp_slam_torch.backend.loop_closure import LoopDetector
from tpu_icp_slam_torch.config import BackendConfig
from tpu_icp_slam_torch.mapping import voxel_map
from tpu_icp_slam_torch.slam import map_io

CAP = 1024


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Test files run in parallel worker processes: one torch thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pad(s, cap=CAP):
    pts = np.full((cap, 3), 1.0e6, np.float32)
    msk = np.zeros(cap, bool)
    pts[: len(s)] = s[:cap]
    msk[: min(len(s), cap)] = True
    return pts, msk


def _cfgs(**kw):
    kw = dict(dict(verify_max_rmse=0.6, verify_max_dev=0.0, verify_yaws=4),
              **kw)
    return BackendConfig(**kw), JBackendConfig(**kw)


@pytest.fixture(scope="module")
def session():
    """test_map_io.py::test_save_load_localize's mapping session (keyframes
    at ground truth every second frame) in both packages, its scans at 8
    rings x 192 azimuths (12 x 256 there) to keep the CPU's NN short."""
    scans, gt = synthetic.velodyne_log(n_frames=16, n_rings=8,
                                       n_azimuth=192, path_fraction=0.4)
    cfg, jcfg = _cfgs()
    det, jdet = LoopDetector(cfg, device="cpu"), jmap_io.LoopDetector(jcfg)
    vm, jv = voxel_map.create(16384, device="cpu"), jvm.create(16384)
    kf_scans, kf_poses = [], []
    for i in range(0, 16, 2):
        pts, msk = _pad(voxel_downsample_np(scans[i], 0.5))
        det.add_keyframe(pts, msk, position=gt[i][:3, 3])
        jdet.add_keyframe(pts, msk, position=gt[i][:3, 3])
        kf_scans.append((pts, msk))
        kf_poses.append(gt[i])
        world = pts @ gt[i][:3, :3].T + gt[i][:3, 3]
        world = np.where(msk[:, None], world, 1.0e6).astype(np.float32)
        vm = voxel_map.insert(vm, torch.from_numpy(world),
                              torch.from_numpy(msk),
                              torch.zeros((CAP, 3)), voxel=0.4)
        jv = jvm.insert(jv, jnp.asarray(world), jnp.asarray(msk),
                        jnp.zeros((CAP, 3), jnp.float32), voxel=0.4)
    query = _pad(voxel_downsample_np(scans[5], 0.5))  # not a keyframe
    return dict(scans=scans, gt=gt, det=det, jdet=jdet, vm=vm, jv=jv,
                kf_scans=kf_scans, kf_poses=np.stack(kf_poses), query=query)


def test_save_load_localize(tmp_path, session):
    """Mirrors test_map_io.py::test_save_load_localize."""
    s = session
    path = str(tmp_path / "site.npz")
    map_io.save_map(path, s["kf_scans"], s["kf_poses"], vmap=s["vm"],
                    detector=s["det"])
    saved = map_io.load_map(path, _cfgs()[0], device="cpu")
    assert saved.vmap is not None
    for k in ("points", "normals", "mask"):
        assert torch.equal(getattr(saved.vmap, k), getattr(s["vm"], k)), k
    assert int(voxel_map.count(saved.vmap)) == int(voxel_map.count(s["vm"]))
    for a, b in zip(saved.detector._descs, s["det"]._descs):
        np.testing.assert_array_equal(a, b)
    out = map_io.localize_in_map(saved, *s["query"])
    assert out is not None, "localization failed in the loaded map"
    pose, match_idx, rmse = out
    assert np.linalg.norm(pose[:3, 3] - s["gt"][5][:3, 3]) < 1.0
    assert 0 <= match_idx < len(s["kf_scans"]) and rmse <= 0.6


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_map_crosses_packages_and_localizes_alike(tmp_path, session, writer):
    """A map saved by one package loads in the other with the same arrays,
    and localizes the query to the pose the saving package finds."""
    s = session
    path = str(tmp_path / f"{writer}.npz")
    if writer == "port":
        map_io.save_map(path, s["kf_scans"], s["kf_poses"], vmap=s["vm"],
                        detector=s["det"])
    else:
        jmap_io.save_map(path, s["kf_scans"], s["kf_poses"], vmap=s["jv"],
                         detector=s["jdet"])
    cfg, jcfg = _cfgs()
    mine = map_io.load_map(path, cfg, device="cpu")
    ref = jmap_io.load_map(path, jcfg)
    np.testing.assert_array_equal(mine.kf_poses, ref.kf_poses)
    for (p, m), (jp, jm) in zip(mine.kf_scans, ref.kf_scans):
        np.testing.assert_array_equal(p, jp)
        np.testing.assert_array_equal(m, jm)
    for k in ("points", "normals", "mask"):
        np.testing.assert_array_equal(getattr(mine.vmap, k).numpy(),
                                      np.asarray(getattr(ref.vmap, k)))
    for a, b in zip(mine.detector._descs, ref.detector._descs):
        np.testing.assert_array_equal(a, b)
    got = map_io.localize_in_map(mine, *s["query"])
    want = jmap_io.localize_in_map(ref, *s["query"])
    assert got is not None and want is not None
    assert got[1] == want[1]
    assert np.linalg.norm(got[0][:3, 3] - np.asarray(want[0])[:3, 3]) < 1e-3
    assert abs(got[2] - float(want[2])) < 1e-3


def test_closure_metadata_roundtrip(tmp_path, session):
    """Mirrors test_map_io.py::test_closure_metadata_roundtrip; the
    reference reads the port's metadata the same."""
    s = session
    info = [
        {"i": 0, "j": 2, "cycle_score_m": 0.04, "suspect": False},
        {"i": 1, "j": 2, "cycle_score_m": 9.3, "suspect": True},
        {"i": 0, "j": 1, "cycle_score_m": None, "suspect": False},
    ]
    path = str(tmp_path / "meta.npz")
    map_io.save_map(path, s["kf_scans"][:3], s["kf_poses"][:3],
                    detector=s["det"], closure_info=info)
    saved = map_io.load_map(path, _cfgs()[0], device="cpu")
    assert saved.closure_info == info
    assert saved.n_suspect_closures == 1
    assert saved.vmap is None
    assert jmap_io.load_map(path, _cfgs()[1]).closure_info == info


def test_descriptor_geometry_persists(tmp_path, session):
    """Mirrors test_map_io.py::test_descriptor_geometry_persists: a map built
    with other descriptor geometry localizes with the STORED geometry."""
    s = session
    cfg, _ = _cfgs(descriptor_rings=16, descriptor_sectors=48)
    det = LoopDetector(cfg, max_range=25.0, device="cpu")
    for (pts, msk), pose in zip(s["kf_scans"][:4], s["kf_poses"][:4]):
        det.add_keyframe(pts, msk, position=pose[:3, 3])
    path = str(tmp_path / "geo.npz")
    map_io.save_map(path, s["kf_scans"][:4], s["kf_poses"][:4], detector=det)
    wrong = _cfgs()[0]  # 20 rings x 60 sectors
    saved = map_io.load_map(path, wrong, max_range=60.0, device="cpu")
    assert saved.detector.cfg.descriptor_rings == 16
    assert saved.detector.cfg.descriptor_sectors == 48
    assert saved.detector.max_range == 25.0
    assert saved.detector._descs[0].shape == (16, 48)
    # keyframe 1's own scan: binned like the stored descriptors, it ranks
    # its keyframe first and verifies there
    out = map_io.localize_in_map(saved, *s["kf_scans"][1], topk=1)
    assert out is not None and out[1] == 1
    assert np.linalg.norm(out[0][:3, 3] - s["gt"][2][:3, 3]) < 1.0


def test_map_without_descriptors_rebuilds_them(tmp_path, session):
    """A map saved without a detector: load_map fingerprints its keyframes
    again, to the descriptors a live detector holds."""
    s = session
    path = str(tmp_path / "bare.npz")
    map_io.save_map(path, s["kf_scans"], s["kf_poses"])
    saved = map_io.load_map(path, _cfgs()[0], device="cpu")
    assert len(saved.detector._descs) == len(s["kf_scans"])
    for a, b in zip(saved.detector._descs, s["det"]._descs):
        np.testing.assert_array_equal(a, b)
