"""The CUDA kernels of the torch port against their plain versions, on the card.

Every test here is marked `cuda` and skips without a CUDA device. The file
imports no jax, so it also runs where JAX is not installed:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from tpu_icp_slam_torch import ICPConfig, MappingConfig, PipelineConfig
from tpu_icp_slam_torch import SlamConfig
from tpu_icp_slam_torch.kernels import (
    coop_probe,
    gn_cuda,
    icp_fused,
    nn_bf16,
    nn_cuda,
    nn_rescore,
)
from tpu_icp_slam_torch.kernels.nn import nearest_neighbor

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernel vs plain version on the card)")
    return torch.device("cuda")


def _clouds(m, n, seed, scale):
    rng = np.random.default_rng(seed)
    src = rng.uniform(-scale, scale, (m, 3)).astype(np.float32)
    dst = rng.uniform(-scale, scale, (n, 3)).astype(np.float32)
    return src, dst


def _gn_case(m, seed):
    rng = np.random.default_rng(seed)
    p = rng.uniform(-20, 20, (m, 3)).astype(np.float32)
    q = (p + 0.1 * rng.standard_normal((m, 3))).astype(np.float32)
    n = rng.standard_normal((m, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    w = rng.uniform(0, 1, m).astype(np.float32)
    w[m // 2:] = 0.0
    return p, q, n, w


@pytest.mark.parametrize("m,n", [(16384, 16384), (300, 5000), (4097, 77),
                                 (1, 1)])
def test_nn_kernel_matches_plain(cuda_device, m, n):
    """Index agreement >= 99.9% (the two differ only by FMA rounding on
    near-ties), d2 to f32 rounding, sentinel rows never picked."""
    src, dst = _clouds(m, n, seed=m, scale=40.0)
    n_pad = n // 8
    if n_pad:
        dst[-n_pad:] = 1.0e6
    s, d = (torch.from_numpy(a).to(cuda_device) for a in (src, dst))
    idx, d2 = nn_cuda.nn_bruteforce(s, d)
    ridx, rd2 = nn_cuda.nn_bruteforce_ref(s, d)
    assert idx.dtype == torch.int32 and idx.shape == (m,)
    assert float((idx == ridx).float().mean()) >= 0.999
    torch.testing.assert_close(d2, rd2, rtol=1e-6, atol=1e-5)
    assert int(idx.max()) < n - n_pad


def test_nn_kernel_ties_go_to_lowest_index(cuda_device):
    dst = torch.zeros(5000, 3, device=cuda_device)
    dst[:, 0] = 5.0
    dst[[17, 1200, 2500, 4999], 0] = 1.0  # equidistant winners in 3 splits
    idx, d2 = nn_cuda.nn_bruteforce(torch.zeros(64, 3, device=cuda_device),
                                    dst)
    assert torch.all(idx == 17) and torch.all(d2 == 1.0)


def test_gn_kernel_matches_plain_and_is_reproducible(cuda_device):
    p, q, n, w = (torch.from_numpy(a).to(cuda_device)
                  for a in _gn_case(16384, seed=11))
    H, g = gn_cuda.gn_accum(p, q, n, w)
    H_ref, g_ref = gn_cuda.gn_accum_ref(p, q, n, w)
    # rtol 1e-4 per entry plus 1e-4 of the largest entry: the summation
    # order differs from the plain matmul, and off-diagonal sums cancel
    torch.testing.assert_close(H, H_ref, rtol=1e-4,
                               atol=1e-4 * float(H_ref.abs().max()))
    torch.testing.assert_close(g, g_ref, rtol=1e-4,
                               atol=1e-4 * float(g_ref.abs().max()))
    assert torch.equal(H, H.T)
    H2, g2 = gn_cuda.gn_accum(p, q, n, w)
    assert torch.equal(H, H2) and torch.equal(g, g2)


def test_wrappers_count_launches(cuda_device):
    a = torch.rand(100, 3, device=cuda_device)
    before = (nn_cuda.nn_bruteforce.launches, gn_cuda.gn_accum.launches)
    nn_cuda.nn_bruteforce(a, a)
    gn_cuda.gn_accum(a, a, a, torch.ones(100, device=cuda_device))
    nn_cuda.nn_bruteforce_ref(a, a)
    assert (nn_cuda.nn_bruteforce.launches, gn_cuda.gn_accum.launches) == (
        before[0] + 1, before[1] + 1)


def test_wrappers_raise_instead_of_falling_back(cuda_device):
    a = torch.zeros(8, 3, device=cuda_device)
    with pytest.raises(ValueError):
        nn_cuda.nn_bruteforce(a.double(), a)
    with pytest.raises(ValueError):
        nn_cuda.nn_bruteforce(a, a.cpu())
    with pytest.raises(ValueError):
        nn_cuda.nn_bruteforce(a[:, :2].contiguous(), a)
    with pytest.raises(ValueError):
        gn_cuda.gn_accum(a, a, a, torch.ones(7, device=cuda_device))
    with pytest.raises(ValueError):
        gn_cuda.gn_accum(a, a.t().contiguous().t(), a,
                         torch.ones(8, device=cuda_device))
    with pytest.raises(ValueError):
        nn_bf16.nn_bf16(a, a.cpu())
    with pytest.raises(ValueError):
        nn_bf16.nn_bf16(a.t().contiguous().t(), a)
    with pytest.raises(NotImplementedError):  # no batched K4
        nearest_neighbor(a[None], a[None], backend="pallas",
                         precision="rescore")
    with pytest.raises(ValueError):
        nn_rescore.nn_rescore(a, a.cpu())
    with pytest.raises(ValueError):
        nn_rescore.nn_rescore(a.double(), a)
    with pytest.raises(ValueError):
        nn_rescore.nn_rescore(a.t().contiguous().t(), a)
    ones = torch.ones(8, dtype=torch.bool, device=cuda_device)
    with pytest.raises(ValueError):
        icp_fused.icp_fused(a, ones, a.cpu(), a, ones)
    with pytest.raises(ValueError):
        icp_fused.icp_fused(a, ones.cpu(), a, a, ones)
    with pytest.raises(ValueError):
        icp_fused.icp_fused(a, ones, a, a.t().contiguous().t(), ones)


@pytest.mark.parametrize("m,n", [(16384, 16384), (300, 5000), (1, 1)])
def test_nn_bf16_kernel_matches_plain(cuda_device, m, n):
    """K3 and its plain version sum the same exact bf16 products in float32
    in different orders: scores within 2·13·2⁻²⁴·Σ|a_k·b_k|, indices equal
    but for near-ties, sentinel rows never picked."""
    src, dst = _clouds(m, n, seed=m, scale=40.0)
    n_pad = n // 8
    if n_pad:
        dst[-n_pad:] = 1.0e6
    s, d = (torch.from_numpy(a).to(cuda_device) for a in (src, dst))
    idx, d2 = nn_bf16.nn_bf16(s, d)
    ridx, rd2 = nn_bf16.nn_bf16_ref(s, d)
    assert idx.dtype == torch.int32 and idx.shape == (m,)
    assert float((idx == ridx).float().mean()) >= 0.999
    sc, dc = nn_bf16.recentre(s, d)
    mag = torch.sum(torch.abs(nn_bf16.pack_source(sc).float()
                              * nn_bf16.pack_target(dc).float()[ridx.long()]),
                    dim=1)
    assert torch.all(torch.abs(d2 - rd2) <= 2 * 13 * 2.0 ** -24 * mag)
    assert int(idx.max()) < n - n_pad


@pytest.mark.parametrize("m,n", [(16384, 16384), (300, 5000), (1000, 100)])
def test_nn_rescore_kernel_matches_plain(cuda_device, m, n):
    """K4 against its plain version: the same packed operands and the same
    float32 rescore, so indices agree but for packed-score near-ties inside
    one slot (>= 99.9%) and the picked d² is equal wherever they do;
    (1000, 100) is a single slot (S = 1), sentinel rows never picked."""
    src, dst = _clouds(m, n, seed=m + 1, scale=40.0)
    n_pad = n // 8
    dst[-n_pad:] = 1.0e6
    s, d = (torch.from_numpy(a).to(cuda_device) for a in (src, dst))
    idx, d2 = nn_rescore.nn_rescore(s, d)
    ridx, rd2 = nn_rescore.nn_rescore_ref(s, d)
    assert idx.dtype == torch.int32 and idx.shape == (m,)
    same = idx == ridx
    assert float(same.float().mean()) >= 0.999
    assert torch.equal(d2[same], rd2[same])
    assert int(idx.max()) < n - n_pad
    if (m, n) == (1000, 100):
        assert nn_rescore.slots(n)[1] == 1


def test_nn_rescore_kernel_ties_go_to_the_lowest_slot(cuda_device):
    """An exact duplicate at indices 3 and 8 (slots 3 and 0 of 8): the
    kernel takes the lower slot, 8, as the reference does."""
    rng = np.random.default_rng(5)
    dst = rng.uniform(-20, 20, (1024, 3)).astype(np.float32)
    dst[8] = dst[3] = [0.5, 0.25, -0.125]
    src = (dst[3] + rng.uniform(-0.01, 0.01, (40, 3))).astype(np.float32)
    idx, _ = nn_rescore.nn_rescore(torch.from_numpy(src).to(cuda_device),
                                   torch.from_numpy(dst).to(cuda_device))
    assert torch.all(idx == 8)


def test_batched_nn_kernel_matches_plain(cuda_device):
    """K1's batched form: B = 16 sources over 2 targets (G = 8) against the
    plain version element by element; B = 1 is the unbatched call bit for
    bit."""
    rng = np.random.default_rng(3)
    src = rng.uniform(-40, 40, (16, 4096, 3)).astype(np.float32)
    dst = rng.uniform(-40, 40, (2, 5000, 3)).astype(np.float32)
    dst[:, -100:] = 1.0e6
    s, d = (torch.from_numpy(a).to(cuda_device) for a in (src, dst))
    idx, d2 = nn_cuda.nn_bruteforce(s, d)
    ridx, rd2 = nn_cuda.nn_bruteforce_ref(s, d)
    assert idx.shape == (16, 4096) and idx.dtype == torch.int32
    assert float((idx == ridx).float().mean()) >= 0.999
    torch.testing.assert_close(d2, rd2, rtol=1e-6, atol=1e-5)
    for b in (0, 9):  # each element is its own unbatched search
        one = nn_cuda.nn_bruteforce(s[b].contiguous(), d[b // 8].contiguous())
        assert torch.equal(one[0], idx[b]) and torch.equal(one[1], d2[b])
    one = nn_cuda.nn_bruteforce(s[:1], d[:1])
    ref = nn_cuda.nn_bruteforce(s[0].contiguous(), d[0].contiguous())
    assert torch.equal(one[0][0], ref[0]) and torch.equal(one[1][0], ref[1])


def test_batched_wrappers_raise_and_count(cuda_device):
    a = torch.zeros(4, 8, 3, device=cuda_device)
    with pytest.raises(ValueError):  # 4 sources over 3 targets
        nn_cuda.nn_bruteforce(a, a[:3])
    with pytest.raises(ValueError):
        nn_cuda.nn_bruteforce(a, a[:2].cpu())
    with pytest.raises(ValueError):
        nn_cuda.nn_bruteforce(a.transpose(0, 1), a[:1])
    with pytest.raises(NotImplementedError):
        nearest_neighbor(a, a[:2], backend="pallas", precision="bf16")
    before = (nn_cuda.nn_bruteforce.launches,
              nn_cuda.nn_bruteforce.batched_launches,
              nn_rescore.nn_rescore.launches)
    nn_cuda.nn_bruteforce(a, a[:2])
    nn_cuda.nn_bruteforce(a[0], a[0])
    nn_rescore.nn_rescore(a[0], a[0])
    nn_rescore.nn_rescore_ref(a[0], a[0])
    nn_cuda.nn_bruteforce_ref(a, a[:2])
    assert (nn_cuda.nn_bruteforce.launches,
            nn_cuda.nn_bruteforce.batched_launches,
            nn_rescore.nn_rescore.launches) == (
        before[0] + 2, before[1] + 1, before[2] + 1)


def test_slam3d_on_cuda_matches_cpu(cuda_device):
    """Full SLAM at nn_precision="rescore" on the card (K4 and K2 in the
    front end, batched K1 in verification) against the port on the CPU
    (their plain versions): the same keyframes and closures, poses within
    3 cm; one K4 launch per front-end ICP iteration, one K1 launch per
    batched verification iteration. K4 and its plain version add the 13
    packed products in different orders (a float32 ulp of the packed score
    is ~6e-5 m² at these extents), so near-tied points of one slot can swap;
    each swap moves a 768-point scan's pose by a few mm, and the map carries
    it on (observed 9.7e-3 m on an H100)."""
    from tpu_icp_slam_torch import BackendConfig, synthetic
    from tpu_icp_slam_torch.core.pointcloud import voxel_downsample_np
    from tpu_icp_slam_torch.slam.runner import pad_scans
    from tpu_icp_slam_torch.slam.slam3d import Slam3D

    cfg = SlamConfig(
        icp=ICPConfig(method="point_to_plane", max_iters=15,
                      max_corr_dist=1.5, damping=1e-3, max_step_trans=1.0,
                      max_step_rot=0.3, min_inliers=50, huber_delta=0.3,
                      nn_precision="rescore"),
        mapping=MappingConfig(map_capacity=8192, local_model_size=2048,
                              map_voxel=0.3),
        pipeline=PipelineConfig(mode="scan_to_map", scan_capacity=768,
                                keyframe_trans=1.6, keyframe_rot=0.2),
        backend=BackendConfig(enabled=True, min_loop_separation=2,
                              candidate_topk=1, verify_yaws=4,
                              verify_max_rmse=0.6, gating_radius=10.0),
    )
    scans, _ = synthetic.velodyne_log(n_frames=8, n_rings=10, n_azimuth=192,
                                      path_fraction=0.1)
    scans = [voxel_downsample_np(s, 0.5) for s in scans]
    pts, msk = pad_scans(scans + scans[::-1][1:], 768)
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        slam = Slam3D(cfg, device=dev)
        k0 = (nn_rescore.nn_rescore.launches, nn_cuda.nn_bruteforce.launches)
        poses, rep = slam.run(pts, msk, mode="fused")
        out[dev.type] = (poses, rep, slam, (
            nn_rescore.nn_rescore.launches - k0[0],
            nn_cuda.nn_bruteforce.launches - k0[1]))
    (gp, g_rep, gslam, gl), (cp, crep, _, cl) = out["cuda"], out["cpu"]
    assert crep.n_loop_closures >= 1
    assert (g_rep.n_keyframes, g_rep.n_loop_closures) == (
        crep.n_keyframes, crep.n_loop_closures)
    np.testing.assert_allclose(gp[:, :3, 3], cp[:, :3, 3], atol=3e-2)
    assert gl == (int(gslam.frontend_iters.sum()),
                  gslam.detector.verify_iters) and cl == (0, 0)


def _align_problem(device, seed=0, m=4096, n=6144):
    """Two walls and a floor (tests/test_icp_fused.py's _problem, larger),
    the scan a noisy subset moved by a known transform."""
    rng = np.random.default_rng(seed)
    k = n // 3
    dst = np.concatenate([
        np.c_[rng.uniform(-8, 8, k), rng.uniform(-8, 8, k), np.zeros(k)],
        np.c_[np.full(k, 8.0), rng.uniform(-8, 8, k), rng.uniform(0, 4, k)],
        np.c_[rng.uniform(-8, 8, n - 2 * k), np.full(n - 2 * k, -8.0),
              rng.uniform(0, 4, n - 2 * k)]]).astype(np.float32)
    nrm = np.zeros_like(dst)
    nrm[:k, 2] = 1.0
    nrm[k:2 * k, 0] = -1.0
    nrm[2 * k:, 1] = 1.0
    ang = 0.05
    R = np.array([[np.cos(ang), -np.sin(ang), 0], [np.sin(ang), np.cos(ang), 0],
                  [0, 0, 1]], np.float32)
    t = np.array([0.3, -0.2, 0.1], np.float32)
    src = (dst[rng.permutation(n)[:m]] - t) @ R  # = R^T (x - t)
    src += rng.normal(size=src.shape).astype(np.float32) * 0.005
    smask = np.ones(m, bool)
    smask[-m // 8:] = False
    dst[-32:] = 1.0e6  # padded model rows
    dmask = np.ones(n, bool)
    dmask[-32:] = False
    args = tuple(torch.from_numpy(a).to(device)
                 for a in (src, smask, dst, nrm, dmask))
    kw = dict(max_iters=18, tol=1e-5, tol_update=0.01, max_corr_dist=1.0,
              huber_delta=0.3, damping=1e-3, step_scale=1.4,
              max_step_trans=1.0, max_step_rot=0.3, min_inliers=100,
              prior_trans_weight=0.004, prior_rot_weight=0.04,
              max_total_trans=1.5, max_total_rot=0.5)
    return args, kw


@pytest.mark.parametrize("precision", ["highest", "bf16"])
def test_icp_fused_kernel_matches_plain(cuda_device, precision):
    """K5 against its plain version on the card: the same pose up to float32
    summation order (5e-4 m / rad), one launch per align, bit-reproducible
    across launches."""
    args, kw = _align_problem(cuda_device)
    r_gate = torch.tensor(30.0, device=cuda_device)
    before = icp_fused.icp_fused.launches
    T, rmse, it, inl, conv = icp_fused.icp_fused(
        *args, r_gate=r_gate, precision=precision, **kw)
    T2, rmse2, *_ = icp_fused.icp_fused(*args, r_gate=r_gate,
                                        precision=precision, **kw)
    assert icp_fused.icp_fused.launches == before + 2
    Tr, rmse_r, it_r, inl_r, conv_r = icp_fused.icp_fused_ref(
        *args, r_gate=r_gate, precision=precision, **kw)
    assert torch.equal(T, T2) and torch.equal(rmse, rmse2)
    assert it.dtype == torch.int32 and conv.dtype == torch.bool
    assert float(torch.max(torch.abs(T - Tr))) < 5e-4
    assert abs(float(rmse) - float(rmse_r)) < 1e-4
    assert abs(int(inl) - int(inl_r)) <= 0.01 * int(inl_r)
    assert abs(int(it) - int(it_r)) <= 1


def test_capability_probe(cuda_device):
    got = coop_probe.capability_probe(cuda_device)
    assert got["blocks"]["highest"] >= 1 and got["blocks"]["bf16"] >= 1


def test_fused_pipeline_on_cuda_matches_cpu(cuda_device):
    """loop_backend="fused" on the card (K5) against the port on the CPU
    (its plain version): one K5 launch per frame and no K1, K2 or K3."""
    from tpu_icp_slam_torch import synthetic
    from tpu_icp_slam_torch.core.pointcloud import voxel_downsample_np
    from tpu_icp_slam_torch.slam.runner import pad_scans
    from tpu_icp_slam_torch.slam.scan_to_map import ScanToMapPipeline

    cfg = SlamConfig(
        icp=ICPConfig(method="point_to_plane", max_iters=15,
                      max_corr_dist=1.5, damping=1e-3, max_step_trans=1.0,
                      max_step_rot=0.3, min_inliers=50, huber_delta=0.3,
                      loop_backend="fused"),
        mapping=MappingConfig(map_capacity=32768, local_model_size=4096,
                              map_voxel=0.3),
        pipeline=PipelineConfig(mode="scan_to_map", scan_capacity=2048,
                                keyframe_trans=2.0, keyframe_rot=0.2),
    )
    scans, _ = synthetic.velodyne_log(n_frames=8, n_rings=16, n_azimuth=320,
                                      path_fraction=0.1)
    pts, msk = pad_scans([voxel_downsample_np(s, 0.4) for s in scans], 2048)
    out = {}
    kernels = (nn_cuda.nn_bruteforce, gn_cuda.gn_accum, nn_bf16.nn_bf16,
               icp_fused.icp_fused)
    for dev in (cuda_device, torch.device("cpu")):
        pipe = ScanToMapPipeline(cfg, device=dev)
        k0 = [k.launches for k in kernels]
        _, infos = pipe.run_fused(pipe.init_state(pts[0], msk[0]), pts[1:],
                                  msk[1:])
        out[dev.type] = ({k: v.cpu().numpy() for k, v in infos.items()},
                         [k.launches - b for k, b in zip(kernels, k0)])
    (gpu, gpu_launches), (cpu, cpu_launches) = out["cuda"], out["cpu"]
    assert gpu_launches == [0, 0, 0, len(pts) - 1]
    assert cpu_launches == [0, 0, 0, 0]
    assert gpu["iters"].dtype.kind == "i"
    np.testing.assert_allclose(gpu["pose"], cpu["pose"], atol=5e-3)
    for k in ("is_keyframe", "map_inserted"):
        np.testing.assert_array_equal(gpu[k], cpu[k])


def test_pipeline_on_cuda_matches_cpu(cuda_device):
    """The scan-to-map slice on the card (kernels K1/K2) against the same
    port on the CPU (their plain versions); K1 and K2 run once per ICP
    iteration."""
    from tpu_icp_slam_torch import synthetic
    from tpu_icp_slam_torch.core.pointcloud import voxel_downsample_np
    from tpu_icp_slam_torch.slam.runner import pad_scans
    from tpu_icp_slam_torch.slam.scan_to_map import ScanToMapPipeline

    cfg = SlamConfig(
        icp=ICPConfig(method="point_to_plane", max_iters=15,
                      max_corr_dist=1.5, damping=1e-3, max_step_trans=1.0,
                      max_step_rot=0.3, min_inliers=50, huber_delta=0.3),
        mapping=MappingConfig(map_capacity=32768, local_model_size=4096,
                              map_voxel=0.3),
        pipeline=PipelineConfig(mode="scan_to_map", scan_capacity=2048,
                                keyframe_trans=2.0, keyframe_rot=0.2),
    )
    scans, _ = synthetic.velodyne_log(n_frames=8, n_rings=16, n_azimuth=320,
                                      path_fraction=0.1)
    pts, msk = pad_scans([voxel_downsample_np(s, 0.4) for s in scans], 2048)
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        pipe = ScanToMapPipeline(cfg, device=dev)
        k0 = (nn_cuda.nn_bruteforce.launches, gn_cuda.gn_accum.launches)
        _, infos = pipe.run_fused(pipe.init_state(pts[0], msk[0]), pts[1:],
                                  msk[1:])
        launches = (nn_cuda.nn_bruteforce.launches - k0[0],
                    gn_cuda.gn_accum.launches - k0[1])
        out[dev.type] = ({k: v.cpu().numpy() for k, v in infos.items()},
                         launches)
    (gpu, gpu_launches), (cpu, cpu_launches) = out["cuda"], out["cpu"]
    n_iters = int(gpu["iters"].sum())
    assert gpu_launches == (n_iters, n_iters) and cpu_launches == (0, 0)
    np.testing.assert_allclose(gpu["pose"], cpu["pose"], atol=5e-3)
    for k in ("is_keyframe", "map_inserted"):
        np.testing.assert_array_equal(gpu[k], cpu[k])
    cfg_xla = dataclasses.replace(
        cfg, icp=dataclasses.replace(cfg.icp, nn_backend="xla",
                                     gn_backend="xla"))
    k0 = (nn_cuda.nn_bruteforce.launches, gn_cuda.gn_accum.launches)
    pipe = ScanToMapPipeline(cfg_xla, device=cuda_device)
    pipe.run_fused(pipe.init_state(pts[0], msk[0]), pts[1:3], msk[1:3])
    assert (nn_cuda.nn_bruteforce.launches, gn_cuda.gn_accum.launches) == k0
