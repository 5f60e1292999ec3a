"""Config 2's building blocks in the torch port against the JAX reference on
the same numpy inputs (the reference on the CPU as its own tests run it:
Pallas in interpret mode, NN on "xla"):

- K1's plain version at D = 2 against the reference's interpret-mode
  `nn_bruteforce_pallas(precision="highest")` and `nn_bruteforce_xla`,
  unbatched and batched: idx equal away from near-ties, d2 within 1e-4 m²
  (the reference scores the factored form, the port the difference form);
- `occupancy2d.update` on tests/test_occupancy2d.py's cases and a random
  scan: log-odds within 1e-5 (float32 sums into one cell in the scatter's
  order);
- `OdometryPipeline(dim=2)` fused and streaming against the reference's on
  `sim2d` at tests/test_pipeline_2d.py::_cfg2d, 12 frames: poses within
  2e-5 m and 2e-5 rad (measured 1.8e-6 m, 9.4e-6 rad), iterations equal;
  the grids equal within 1e-4 but for a few cells (at most 0.05%), each
  one sample step apart: a free-space sample on a cell face lands on
  either side once the poses differ by 1e-6 m.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_icp_slam.config import SlamConfig, override, to_json
from tpu_icp_slam.core import pointcloud as jpc
from tpu_icp_slam.kernels.nn_pallas import nn_bruteforce_pallas
from tpu_icp_slam.kernels.nn_xla import nn_bruteforce_xla
from tpu_icp_slam.mapping import occupancy2d as jocc
from tpu_icp_slam.slam import runner as jrunner
from tpu_icp_slam.slam.pipeline import OdometryPipeline as JOdometry
from tpu_icp_slam_torch.config import from_json
from tpu_icp_slam_torch.datasets import synthetic
from tpu_icp_slam_torch.kernels import nn_cuda
from tpu_icp_slam_torch.kernels.nn import nearest_neighbor
from tpu_icp_slam_torch.mapping import occupancy2d as occ
from tpu_icp_slam_torch.slam import runner
from tpu_icp_slam_torch.slam.pipeline import OdometryPipeline

NEAR_TIE = 1e-3  # m²: the reference's factored score may rank two targets
# closer than this either way


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread a worker: the suite runs files in parallel."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def _clouds2(m, n, seed, scale=10.0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-scale, scale, (m, 2)).astype(np.float32),
            rng.uniform(-scale, scale, (n, 2)).astype(np.float32))


def _check_nn(src, dst, idx, d2, ref_idx, ref_d2):
    D = ((src[:, None].astype(np.float64) - dst[None].astype(np.float64))
         ** 2).sum(-1)
    part = np.partition(D, 1, axis=1)
    clear = (part[:, 1] - part[:, 0]) > NEAR_TIE
    assert clear.mean() > 0.5  # the comparison is not vacuous
    np.testing.assert_array_equal(idx[clear], ref_idx[clear])
    np.testing.assert_allclose(d2, ref_d2, atol=1e-4)
    assert np.all(D[np.arange(len(src)), idx] - part[:, 0] <= NEAR_TIE)


# ---- K1 at D = 2 ----------------------------------------------------------


@pytest.mark.parametrize("m,n", [(300, 500), (1024, 96)])
def test_k1_plain_2d_matches_reference(m, n):
    src, dst = _clouds2(m, n, seed=m + n)
    dst[-7:] = jpc.PAD_COORD  # sentinel rows never win
    ri, rd = nn_bruteforce_pallas(jnp.asarray(src), jnp.asarray(dst),
                                  tile_m=128, tile_n=256, interpret=True,
                                  precision="highest")
    xi, xd = nn_bruteforce_xla(jnp.asarray(src), jnp.asarray(dst))
    idx, d2 = nn_cuda.nn_bruteforce(_t(src), _t(dst))
    assert idx.dtype == torch.int32 and idx.shape == (m,)
    for ref_i, ref_d in ((ri, rd), (xi, xd)):
        _check_nn(src, dst, idx.numpy(), d2.numpy(), np.asarray(ref_i),
                  np.asarray(ref_d))
    assert np.all(idx.numpy() < n - 7)
    # the plain version's 2-D score is dx*dx + dy*dy rounded once a step
    diff = src[:, None] - dst[None]
    want = diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1]
    np.testing.assert_array_equal(d2.numpy(), want.min(1))
    np.testing.assert_array_equal(idx.numpy(), want.argmin(1))


def test_k1_plain_2d_batched_matches_reference():
    """B = 4 sources over 2 targets (G = 2): each element is the reference's
    search of its own pair, and B = 1 the unbatched call bit for bit."""
    rng = np.random.default_rng(11)
    src = rng.uniform(-8, 8, (4, 256, 2)).astype(np.float32)
    dst = rng.uniform(-8, 8, (2, 300, 2)).astype(np.float32)
    idx, d2 = nn_cuda.nn_bruteforce(_t(src), _t(dst))
    assert idx.shape == (4, 256)
    for b in range(4):
        ri, rd = nn_bruteforce_pallas(jnp.asarray(src[b]),
                                      jnp.asarray(dst[b // 2]), tile_m=128,
                                      tile_n=256, interpret=True,
                                      precision="highest")
        _check_nn(src[b], dst[b // 2], idx[b].numpy(), d2[b].numpy(),
                  np.asarray(ri), np.asarray(rd))
    one = nn_cuda.nn_bruteforce(_t(src[:1]), _t(dst[:1]))
    ref = nn_cuda.nn_bruteforce(_t(src[0]), _t(dst[0]))
    assert torch.equal(one[0][0], ref[0]) and torch.equal(one[1][0], ref[1])


@pytest.mark.parametrize("precision", ["bf16", "rescore"])
def test_packed_modes_take_2d_points_with_a_zero_z(precision):
    """K3 and K4 take 3-D operands: a 2-D search runs them on a zero z, as
    the reference's kernel pads its lanes with zeros."""
    src, dst = _clouds2(200, 300, seed=4)
    pad = [np.concatenate([a, np.zeros((len(a), 1), np.float32)], 1)
           for a in (src, dst)]
    got = nearest_neighbor(_t(src), _t(dst), backend="pallas",
                           precision=precision)
    want = nearest_neighbor(_t(pad[0]), _t(pad[1]), backend="pallas",
                            precision=precision)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# ---- occupancy grid -----------------------------------------------------------


def _grids_close(tg, jg, atol=1e-5):
    np.testing.assert_allclose(tg.logodds.numpy(), np.asarray(jg.logodds),
                               atol=atol)
    np.testing.assert_array_equal(tg.origin.numpy(), np.asarray(jg.origin))
    assert float(tg.resolution) == float(jg.resolution)


def test_occupancy_hit_and_free_cells():
    grid = occ.create(64, 0.1, device="cpu")
    pts = torch.tensor([[2.0, 0.0]])
    g = occ.update(grid, torch.eye(3), pts, torch.tensor([True]),
                   ray_samples=64)
    lo = g.logodds.numpy()
    hit = occ.world_to_cell(g, pts).numpy()[0]
    assert lo[hit[0], hit[1]] > 0
    mid = occ.world_to_cell(g, torch.tensor([[1.0, 0.0]])).numpy()[0]
    assert lo[mid[0], mid[1]] < 0
    far = occ.world_to_cell(g, torch.tensor([[-2.0, -2.0]])).numpy()[0]
    assert lo[far[0], far[1]] == 0
    jg = jocc.update(jocc.create(64, 0.1), jnp.eye(3, dtype=jnp.float32),
                     jnp.asarray([[2.0, 0.0]], jnp.float32),
                     jnp.asarray([True]), ray_samples=64)
    _grids_close(g, jg)


def test_occupancy_masked_beams_and_out_of_bounds():
    g = occ.update(occ.create(32, 0.1, device="cpu"), torch.eye(3),
                   torch.tensor([[1.0, 1.0]]), torch.tensor([False]))
    assert torch.all(g.logodds == 0)
    g = occ.update(occ.create(16, 0.1, device="cpu"), torch.eye(3),
                   torch.tensor([[50.0, 50.0]]), torch.tensor([True]))
    lo = g.logodds.numpy()
    assert np.isfinite(lo).all() and lo.max() <= 0
    jg = jocc.update(jocc.create(16, 0.1), jnp.eye(3, dtype=jnp.float32),
                     jnp.asarray([[50.0, 50.0]], jnp.float32),
                     jnp.asarray([True]))
    _grids_close(g, jg)


def test_occupancy_pose_transforms_scan_and_clip():
    c, s = np.cos(np.pi / 2), np.sin(np.pi / 2)
    pose = torch.tensor([[c, -s, 1.0], [s, c, 0.0], [0, 0, 1]],
                        dtype=torch.float32)
    g = occ.update(occ.create(64, 0.1, device="cpu"), pose,
                   torch.tensor([[2.0, 0.0]]), torch.tensor([True]))
    cell = occ.world_to_cell(g, torch.tensor([[1.0, 2.0]])).numpy()[0]
    assert g.logodds[cell[0], cell[1]] > 0
    g = occ.create(16, 0.1, device="cpu")
    for _ in range(30):
        g = occ.update(g, torch.eye(3), torch.tensor([[0.5, 0.0]]),
                       torch.tensor([True]), clip=5.0)
    assert g.logodds.max() <= 5.0 and g.logodds.min() >= -5.0


def test_occupancy_random_scan_matches_reference():
    """A 360-beam scan of the 2D world from a turned, moved pose, half the
    beams masked, folded three times into a 256² grid at 0.1 m."""
    log = synthetic.lidar2d_log(n_frames=3, n_beams=360, seed=2)
    pts = synthetic.scan_to_points(log.ranges[1], log.angles, log.max_range)
    pts = np.asarray(pts, np.float32)
    rng = np.random.default_rng(0)
    mask = rng.uniform(size=len(pts)) < 0.5
    pose = log.gt_poses[1].astype(np.float32)
    tg, jg = occ.create(256, 0.1, device="cpu"), jocc.create(256, 0.1)
    for _ in range(3):
        tg = occ.update(tg, _t(pose), _t(pts), _t(mask), ray_samples=64)
        jg = jocc.update(jg, jnp.asarray(pose), jnp.asarray(pts),
                         jnp.asarray(mask), ray_samples=64)
    _grids_close(tg, jg)
    assert (tg.logodds > 0).sum() > 50 and (tg.logodds < 0).sum() > 1000
    np.testing.assert_allclose(occ.to_probability(tg).numpy(),
                               np.asarray(jocc.to_probability(jg)),
                               atol=1e-6)


def test_occupancy_render_png(tmp_path):
    g = occ.update(occ.create(64, 0.1, device="cpu"), torch.eye(3),
                   torch.tensor([[2.0, 0.0], [0.0, -2.5]]),
                   torch.tensor([True, True]))
    path = tmp_path / "grid.png"
    occ.render_png(g, str(path), trajectory=np.array([[0.0, 0.0],
                                                      [1.0, 0.5]]))
    raw = path.read_bytes()
    assert raw[:8] == b"\x89PNG\r\n\x1a\n"
    assert int.from_bytes(raw[16:20], "big") == 64  # width, one pixel a cell


# ---- the 2D scan-to-scan pipeline ------------------------------------------


def _cfg2d():
    """tests/test_pipeline_2d.py::_cfg2d."""
    return override(SlamConfig(), {
        "icp.max_corr_dist": 0.5, "icp.max_iters": 30,
        "icp.nn_backend": "xla", "pipeline.scan_capacity": 512,
        "mapping.grid_size": 256, "mapping.grid_resolution": 0.1,
        "mapping.ray_samples": 64})


@pytest.fixture(scope="module")
def sim2d():
    """12 frames of sim2d. Longer logs of this corridor drift apart by up to
    1.3e-3 m (14 frames): one NN decision at a near-tie or at the gate,
    factored float32 score against difference form, is then carried by the
    scan-to-scan chain."""
    data = runner.load_dataset("sim2d", 12)
    ref = jrunner.load_dataset("sim2d", 12)
    for a, b in zip(data.scans, ref.scans):
        np.testing.assert_array_equal(a, b)  # the generator, bit for bit
    np.testing.assert_array_equal(data.gt_poses, ref.gt_poses)
    pts, msk = runner.pad_scans(data.scans, 512)
    return data, pts, msk


@pytest.mark.parametrize("mode", ["fused", "streaming"])
def test_odometry_2d_matches_reference(sim2d, mode):
    _, pts, msk = sim2d
    cfg = _cfg2d()
    jp = JOdometry(cfg, dim=2)
    tp = OdometryPipeline(from_json(to_json(cfg)), dim=2, device="cpu")
    js, ts = jp.init_state(pts[0], msk[0]), tp.init_state(pts[0], msk[0])
    _grids_close(ts.grid, js.grid)
    if mode == "fused":
        js, ji = jp.run_fused(js, pts[1:], msk[1:])
        ts, ti = tp.run_fused(ts, pts[1:], msk[1:])
        jposes, tposes = np.asarray(ji["pose"]), ti["pose"].numpy()
        np.testing.assert_array_equal(ti["iters"].numpy(),
                                      np.asarray(ji["iters"]))
    else:
        jposes, tposes = [], []
        for i in range(1, len(pts)):
            js, jinfo = jp.step(js, pts[i], msk[i])
            ts, tinfo = tp.step(ts, pts[i], msk[i])
            assert int(tinfo["iters"]) == int(jinfo["iters"])
            jposes.append(np.asarray(jinfo["pose"]))
            tposes.append(tinfo["pose"].numpy())
        jposes, tposes = np.stack(jposes), np.stack(tposes)
    assert tposes.shape == (len(pts) - 1, 3, 3)
    np.testing.assert_allclose(tposes[:, :2, 2], jposes[:, :2, 2], atol=2e-5)
    np.testing.assert_allclose(tposes[:, :2, :2], jposes[:, :2, :2],
                               atol=2e-5)
    assert int(ts.frame) == int(js.frame) == len(pts) - 1
    diff = np.abs(ts.grid.logodds.numpy() - np.asarray(js.grid.logodds))
    assert (diff > 1e-4).mean() <= 5e-4, (diff > 1e-4).sum()
    assert diff.max() <= 0.9 + 0.4 + 1e-4  # one hit or free step


def test_run_slam_2d_fused_equals_streaming_and_writes_map(sim2d, tmp_path):
    data, _, _ = sim2d
    cfg = from_json(to_json(_cfg2d()))
    pf, rep = runner.run_slam(cfg, data, out_dir=str(tmp_path), mode="fused",
                              device="cpu")
    ps, _ = runner.run_slam(cfg, data, mode="streaming", device="cpu")
    assert pf.shape == (12, 3, 3) and rep["mode"] == "fused"
    np.testing.assert_array_equal(pf, ps)
    assert (tmp_path / "map.png").read_bytes()[:4] == b"\x89PNG"
    ref, jrep = jrunner.run_slam(_cfg2d(), jrunner.load_dataset("sim2d", 12),
                                 mode="fused")
    np.testing.assert_allclose(pf[:, :2, 2], ref[:, :2, 2], atol=2e-5)
    assert abs(rep["ate_rmse"] - jrep["ate_rmse"]) < 2e-5
