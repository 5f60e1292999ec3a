"""The batched forms of K2, K3 and K4 and the batched 6×6 solve of the torch
port, against the JAX reference's `jax.vmap` of the same functions.

The reference's sharded align vmaps its per-row ICP
(tpu_icp_slam/dist/sharded_icp.py:150), and under vmap each Pallas kernel
becomes one pallas_call with the batch as a leading grid axis. Here the
port's batched plain versions (CPU tensors) are held against that vmap, run
in interpret mode on the CPU as the reference's own tests run it:

  - gn_accum_ref (B, M, 3) against jax.vmap(gn_accum_pallas): every entry
    of H and g within 1e-5 of the sum of its terms' absolute values;
  - nn_bf16_ref and nn_rescore_ref (B, M, 3) against (B/G, N, 3) against
    jax.vmap of nn_bruteforce_pallas(precision=...): each row under the
    contracts of test_torch_nn_bf16.py (picks equal except near-ties,
    scores within 2.1e-6·Σ|a b| of the reference's, held to 10x) and
    test_torch_rescore.py (picks equal, d² within D2_RTOL), one target all
    sentinel rows;
  - solve_increment (B, k, k) against jax.vmap(solve_increment), and each
    row bit-equal to the unbatched call;
  - the port's ShardedAligner at nn_backend="pallas", nn_precision "bf16"
    and "rescore", on a one-rank CPU mesh, against the reference's, with
    test_torch_dist.py's float32 point-to-plane bounds.

The CUDA kernels themselves are held bit-equal to per-row calls in
test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_dist import _tcfg
from test_torch_nn_bf16 import REF_REL, _check_against_reference
from test_torch_rescore import D2_RTOL
from tpu_icp_slam.config import ICPConfig as JaxICPConfig
from tpu_icp_slam.core import pointcloud as jpc
from tpu_icp_slam.datasets import synthetic
from tpu_icp_slam.dist import ShardedAligner as JaxShardedAligner
from tpu_icp_slam.dist import make_mesh as jax_make_mesh
from tpu_icp_slam.icp.point_to_plane import solve_increment as jax_solve
from tpu_icp_slam.kernels.gn_pallas import gn_accum_pallas
from tpu_icp_slam.kernels.nn_pallas import nn_bruteforce_pallas
from tpu_icp_slam.mapping.normals import normals_knn
from tpu_icp_slam_torch.dist import ShardedAligner, make_mesh
from tpu_icp_slam_torch.icp.point_to_plane import solve_increment
from tpu_icp_slam_torch.kernels import gn_cuda, nn_bf16, nn_cuda, nn_rescore
from tpu_icp_slam_torch.kernels.nn import nearest_neighbor

GN_REL = 1e-5  # of the sum of a sum's terms' absolute values


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs test files in parallel worker processes: one torch
    thread each keeps them from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _gn_rows(b, m, seed):
    rng = np.random.default_rng(seed)
    p = rng.uniform(-20, 20, (b, m, 3)).astype(np.float32)
    q = (p + 0.1 * rng.standard_normal((b, m, 3))).astype(np.float32)
    n = rng.standard_normal((b, m, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    w = rng.uniform(0, 1, (b, m)).astype(np.float32)
    w[:, m // 2:] = 0.0  # gated rows add nothing
    return p, q, n, w


def _gn_magnitudes(p, q, n, w):
    """Σ|terms| of every entry of H (B, 6, 6) and g (B, 6), in float64."""
    p, q, n, w = (x.astype(np.float64) for x in (p, q, n, w))
    J = np.concatenate([n, np.cross(p, n)], -1)
    r = np.sum(n * (p - q), -1)
    aw = np.abs(w)[..., None] * np.abs(J)
    return (np.einsum("bma,bmc->bac", aw, np.abs(J)),
            np.einsum("bma,bm->ba", aw, np.abs(r)))


@pytest.mark.parametrize("b,m", [(1, 300), (3, 300), (4, 517)])
def test_gn_accum_ref_batched_matches_vmapped_pallas(b, m):
    p, q, n, w = _gn_rows(b, m, seed=b * m)
    H_ref, g_ref = jax.vmap(
        lambda *a: gn_accum_pallas(*a, interpret=True))(
        *(jnp.asarray(x) for x in (p, q, n, w)))
    H, g = gn_cuda.gn_accum_ref(*(torch.from_numpy(x) for x in (p, q, n, w)))
    assert H.shape == (b, 6, 6) and g.shape == (b, 6)
    assert H.dtype == g.dtype == torch.float32
    mag_H, mag_g = _gn_magnitudes(p, q, n, w)
    assert np.all(np.abs(H.numpy() - np.asarray(H_ref)) <= GN_REL * mag_H)
    assert np.all(np.abs(g.numpy() - np.asarray(g_ref)) <= GN_REL * mag_g)


@pytest.mark.parametrize("b", [1, 3, 4])
def test_gn_accum_batched_rows_are_unbatched_calls(b):
    """On CPU tensors the batched call is the plain version, counts no
    launch, and each row's H and g are its unbatched call's within float32
    summation order (the batched product sums in its own order)."""
    p, q, n, w = (torch.from_numpy(x) for x in _gn_rows(b, 257, seed=b))
    before = (gn_cuda.gn_accum.launches, gn_cuda.gn_accum.batched_launches)
    H, g = gn_cuda.gn_accum(p, q, n, w)
    assert (gn_cuda.gn_accum.launches,
            gn_cuda.gn_accum.batched_launches) == before
    mag_H, mag_g = _gn_magnitudes(*(x.numpy() for x in (p, q, n, w)))
    for i in range(b):
        H1, g1 = gn_cuda.gn_accum(p[i], q[i], n[i], w[i])
        assert np.all(np.abs((H[i] - H1).numpy()) <= GN_REL * mag_H[i])
        assert np.all(np.abs((g[i] - g1).numpy()) <= GN_REL * mag_g[i])


def _nn_batch(seed, m=200, n=300, groups=2, targets=2, sentinel=1):
    """src (B, m, 3) over dst (B/G, n, 3), target `sentinel` all at the
    1e6 sentinel (a target with no valid row); a second target partly
    padded, as a padded cloud is."""
    rng = np.random.default_rng(seed)
    src = rng.uniform(-10, 10, (groups * targets, m, 3)).astype(np.float32)
    dst = rng.uniform(-10, 10, (targets, n, 3)).astype(np.float32)
    dst[0, -n // 8:] = 1.0e6
    dst[sentinel] = 1.0e6
    return src, dst


def _vmapped_reference(src, dst, precision):
    """jax.vmap of the reference's kernel over the rows, row b against
    target b // G (the target repeated, as the sharded align passes it)."""
    group = src.shape[0] // dst.shape[0]
    fn = jax.vmap(lambda a, b: nn_bruteforce_pallas(
        a, b, interpret=True, precision=precision))
    idx, d2 = fn(jnp.asarray(src), jnp.asarray(np.repeat(dst, group, 0)))
    return np.asarray(idx), np.asarray(d2)


@pytest.mark.parametrize("seed", [0, 1])
def test_nn_bf16_ref_batched_matches_vmapped_pallas(seed):
    src, dst = _nn_batch(seed)
    ri, rd = _vmapped_reference(src, dst, "bf16")
    idx, d2 = nn_bf16.nn_bf16(torch.from_numpy(src), torch.from_numpy(dst))
    assert idx.shape == d2.shape == src.shape[:2]
    assert idx.dtype == torch.int32 and d2.dtype == torch.float32
    idx, d2 = idx.numpy(), d2.numpy()
    for b in range(4):
        if b // 2 == 1:
            # no valid target: centre 0, every score the same sentinel
            # score, the first index wins on both sides
            assert np.all(idx[b] == 0) and np.all(ri[b] == 0)
            np.testing.assert_allclose(d2[b], rd[b], rtol=REF_REL)
            continue
        _check_against_reference(src[b], dst[b // 2], idx[b], d2[b], ri[b],
                                 rd[b])
        assert np.all(idx[b] < dst.shape[1] - dst.shape[1] // 8)


@pytest.mark.parametrize("seed", [0, 1])
def test_nn_rescore_ref_batched_matches_vmapped_pallas(seed):
    src, dst = _nn_batch(seed, sentinel=0 if seed else 1)
    ri, rd = _vmapped_reference(src, dst, "rescore")
    idx, d2 = nn_rescore.nn_rescore(torch.from_numpy(src),
                                    torch.from_numpy(dst))
    assert idx.shape == d2.shape == src.shape[:2]
    np.testing.assert_array_equal(idx.numpy(), ri)
    np.testing.assert_allclose(d2.numpy(), rd, rtol=D2_RTOL, atol=0.0)


def test_batched_packing_centres_each_target_on_its_own_rows():
    """recentre/pack_source/pack_target on a batch: each target's centre
    is its own valid rows' bounding-box midpoint (0 for the all-sentinel
    target), row b takes target b // G's, and every packed row is bit-equal
    to the unbatched packing of (src[b], dst[b // G])."""
    src, dst = (torch.from_numpy(a) for a in _nn_batch(3, targets=3,
                                                       sentinel=2))
    s, d = nn_bf16.recentre(src, dst)
    a, t = nn_bf16.pack_source(s), nn_bf16.pack_target(d)
    assert a.shape == (6, 200, 16) and t.shape == (3, 300, 16)
    assert torch.equal(d[2], dst[2])  # nothing valid: shifted by 0
    for b in range(6):
        s1, d1 = nn_bf16.recentre(src[b], dst[b // 2])
        assert torch.equal(s[b], s1) and torch.equal(d[b // 2], d1)
        assert torch.equal(a[b], nn_bf16.pack_source(s1))
        assert torch.equal(t[b // 2], nn_bf16.pack_target(d1))


@pytest.mark.parametrize("precision", ["bf16", "rescore"])
def test_batched_nn_dispatch_on_cpu_launches_nothing(precision):
    """nearest_neighbor at "pallas" with a batch on CPU tensors is the
    batched plain version in one call: no kernel counter moves, and 2-D
    points get a zero z column as in the unbatched call."""
    rng = np.random.default_rng(4)
    src = torch.as_tensor(rng.uniform(-5, 5, (4, 120, 2)), dtype=torch.float32)
    dst = torch.as_tensor(rng.uniform(-5, 5, (2, 150, 2)), dtype=torch.float32)
    counters = (nn_bf16.nn_bf16, nn_rescore.nn_rescore,
                nn_cuda.nn_bruteforce)
    before = [f.launches for f in counters]
    idx, d2 = nearest_neighbor(src, dst, backend="pallas",
                               precision=precision)
    assert [f.launches for f in counters] == before
    for b in range(4):
        one = nearest_neighbor(src[b], dst[b // 2], backend="pallas",
                               precision=precision)
        assert torch.equal(idx[b], one[0]) and torch.equal(d2[b], one[1])


def _systems(b, k, dtype, seed):
    """b damped-solve systems, row 1 not positive definite (the zero-step
    guard), the others spread over six decades."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((b, k, k)) * 10.0 ** rng.integers(-2, 4,
                                                              (b, 1, 1))
    H = A @ np.swapaxes(A, 1, 2)
    H[1] = -H[1] - 10.0 * np.eye(k)  # negative definite, prior or not
    g = 100.0 * rng.standard_normal((b, k))
    pw = rng.uniform(0, 1, (b, k))
    xp = rng.standard_normal((b, k))
    return tuple(x.astype(dtype) for x in (H, g, pw, xp))


SOLVE_KW = {"plain": {}, "clamps": dict(max_step_trans=0.5, max_step_rot=0.1),
            "prior": dict(max_step_trans=0.5, max_step_rot=0.1, prior=True)}


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("k", [6, 3])
@pytest.mark.parametrize("kind", list(SOLVE_KW))
def test_solve_increment_batched_rows_bit_equal(dtype, k, kind):
    """Each row of the batched damped Cholesky solve is the unbatched
    call's on the CPU, bit for bit (trace, damping, guard, clamps, prior
    all per row)."""
    H, g, pw, xp = (torch.from_numpy(x) for x in _systems(5, k, dtype, k))
    kw = dict(SOLVE_KW[kind])
    prior = kw.pop("prior", False)
    pk = dict(prior_w=pw, xi_prior=xp) if prior else {}
    xi = solve_increment(H, g, 1e-3, **kw, **pk)
    assert xi.shape == (5, k) and xi.dtype == H.dtype
    assert torch.equal(xi[1], torch.zeros(k, dtype=H.dtype))  # guard
    for b in range(5):
        pk1 = dict(prior_w=pw[b], xi_prior=xp[b]) if prior else {}
        one = solve_increment(H[b], g[b], 1e-3, **kw, **pk1)
        assert torch.equal(xi[b], one), (b, xi[b], one)


@pytest.mark.parametrize("kind", list(SOLVE_KW))
def test_solve_increment_batched_matches_vmapped_reference(kind):
    """Against jax.vmap(solve_increment) in float64: the same steps, the
    same zero step on the row that is not positive definite."""
    H, g, pw, xp = _systems(4, 6, np.float64, seed=9)
    H[2] += 1e3 * np.eye(6)  # one well-conditioned row
    kw = dict(SOLVE_KW[kind])
    prior = kw.pop("prior", False)
    got = solve_increment(torch.from_numpy(H), torch.from_numpy(g), 1e-3,
                          **kw, **(dict(prior_w=torch.from_numpy(pw),
                                        xi_prior=torch.from_numpy(xp))
                                   if prior else {}))

    def one(h, gg, p, x):
        return jax_solve(h, gg, 1e-3, **kw, **(dict(prior_w=p, xi_prior=x)
                                               if prior else {}))

    want = jax.vmap(one)(*(jnp.asarray(a) for a in (H, g, pw, xp)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-9,
                               atol=1e-12)
    assert np.all(got.numpy()[1] == 0.0)


def _plane_rows(b):
    """b plane-rich problems (tests/test_dist.py's scene, float32,
    different sizes padded to 512), the reference's k-NN normals of each
    target given to both sides."""
    S, M, D, N = [], [], [], []
    for i in range(b):
        rng = np.random.default_rng(20 + i)
        src3 = synthetic.surface_cloud(500 - 10 * i, rng)
        T_gt = synthetic.rigid_transform(3, rng, rot_scale=0.05,
                                         trans_scale=0.1)
        dst3 = src3 @ T_gt[:3, :3].T + T_gt[:3, 3]
        cl_d = jpc.make(dst3, capacity=512, dtype=jnp.float32)
        N.append(np.asarray(normals_knn(cl_d.points, cl_d.mask, k=12),
                            np.float32))
        cl_s = jpc.make(src3, capacity=512, dtype=jnp.float32)
        S.append(np.asarray(cl_s.points))
        M.append(np.asarray(cl_s.mask))
        D.append(np.asarray(cl_d.points))
    return tuple(np.stack(x) for x in (S, M, D, N))


@pytest.mark.parametrize("precision", ["bf16", "rescore"])
def test_sharded_align_batched_nn_matches_reference(precision):
    """The port's ShardedAligner (B = 3 rows, one rank on the CPU: batched
    K3/K4 and K2 plain versions, one batched solve a trip) against the
    reference's on a one-device mesh, at test_torch_dist.py's float32
    point-to-plane bounds: T rtol 1e-4 / atol 1e-5, rmse 10x, iterations
    and convergence equal."""
    cfg = JaxICPConfig(method="point_to_plane", max_iters=10,
                       nn_backend="pallas", gn_backend="pallas",
                       damping=1e-6, nn_precision=precision)
    arrays = _plane_rows(3)
    ref = JaxShardedAligner(mesh=jax_make_mesh(1, axes=("dp", "sp")),
                            cfg=cfg)(*(jnp.asarray(a) for a in arrays))
    got = ShardedAligner(make_mesh(1, device="cpu"), _tcfg(cfg))(*arrays)
    np.testing.assert_array_equal(got.iters.numpy(), np.asarray(ref.iters))
    np.testing.assert_array_equal(got.converged.numpy(),
                                  np.asarray(ref.converged))
    np.testing.assert_allclose(got.T.numpy(), np.asarray(ref.T), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(got.rmse.numpy(), np.asarray(ref.rmse),
                               rtol=1e-3, atol=1e-4)
    assert got.T.shape == (3, 4, 4)
