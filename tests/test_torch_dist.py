"""The port's distributed layer (tpu_icp_slam_torch.dist) against the JAX
reference's (tpu_icp_slam.dist).

The port runs as spawned gloo ranks on the CPU (`dist.spawn.spawn`, a
FileStore under tmp_path, one torch thread a rank) while the reference runs
in this process on conftest's 8 virtual CPU devices. Both are computed once
per module. Tolerances: float64 point-to-point rtol 1e-8 / atol 1e-9 (the
reference's own sharded-vs-single bound, tests/test_dist.py:94-107);
float32 point-to-plane through the plain K1/K2 versions (the reference's
interpret-mode kernels) rtol 1e-4 / atol 1e-5; iterations equal.
"""

import concurrent.futures
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as tdist

import _torch_dist_workers as workers
from tpu_icp_slam.config import ICPConfig as JaxICPConfig
from tpu_icp_slam.core import pointcloud as jpc
from tpu_icp_slam.datasets import synthetic
from tpu_icp_slam.dist import ShardedAligner as JaxShardedAligner
from tpu_icp_slam.dist import make_mesh as jax_make_mesh
from tpu_icp_slam.dist import mesh as jax_mesh
from tpu_icp_slam.mapping.normals import normals_knn
from tpu_icp_slam_torch import from_json
from tpu_icp_slam_torch.dist import ShardedAligner, make_mesh, multihost_init
from tpu_icp_slam_torch.dist import mesh as tmesh
from tpu_icp_slam_torch.dist.spawn import spawn
from tpu_icp_slam_torch.kernels.nn import nearest_neighbor


def _tcfg(cfg):
    """The port's copy of a reference ICPConfig, through JSON."""
    from tpu_icp_slam.config import SlamConfig, to_json

    return from_json(to_json(SlamConfig(icp=cfg))).icp


def _pairs(batch, n, dim=3, dtype=np.float64):
    """Synthetic correspondence problems padded to capacity n, as
    tests/test_dist.py::_pair_batch makes them."""
    src_b, dst_b, msk_b = [], [], []
    for i in range(batch):
        src, dst, _ = synthetic.two_scan_pair(n=n - 7, seed=10 + i, dim=dim)
        cs = jpc.make(src, capacity=n, dtype=jnp.float64)
        cd = jpc.make(dst, capacity=n, dtype=jnp.float64)
        src_b.append(np.asarray(cs.points, dtype))
        dst_b.append(np.asarray(cd.points, dtype))
        msk_b.append(np.asarray(cs.mask))
    return np.stack(src_b), np.stack(msk_b), np.stack(dst_b)


def _plane_problem():
    """tests/test_dist.py's plane-rich scene, float32, with the reference's
    k-NN normals of the target (given to both sides)."""
    rng = np.random.default_rng(7)
    src3 = synthetic.surface_cloud(505, rng)
    T_gt = synthetic.rigid_transform(3, rng, rot_scale=0.05, trans_scale=0.1)
    dst3 = src3 @ T_gt[:3, :3].T + T_gt[:3, 3]
    cl_d = jpc.make(dst3, capacity=512, dtype=jnp.float32)
    nrm = np.asarray(normals_knn(cl_d.points, cl_d.mask, k=12), np.float32)
    cl_s = jpc.make(src3, capacity=512, dtype=jnp.float32)
    return (np.asarray(cl_s.points)[None], np.asarray(cl_s.mask)[None],
            np.asarray(cl_d.points)[None], nrm[None], T_gt)


P2P = JaxICPConfig(method="point_to_point", max_iters=15, nn_backend="xla")
PLANE = JaxICPConfig(method="point_to_plane", max_iters=10,
                     nn_backend="pallas", gn_backend="pallas", damping=1e-6)
CASES = {
    # name: (reference config, (src, msk, dst, nrm), rtol, atol)
    "p2p_f64": (P2P, (*_pairs(2, 512), None), 1e-8, 1e-9),
    "p2p_f64_padded_batch": (P2P, (*_pairs(3, 256), None), 1e-8, 1e-9),
    "se2_f64": (dataclasses.replace(P2P, max_iters=20),
                (*_pairs(2, 256, dim=2), None), 1e-8, 1e-9),
    "plane_f32": (PLANE, _plane_problem()[:4], 1e-4, 1e-5),
}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """(port results of every rank, reference results) per case."""
    names = list(CASES)
    cases = [(_tcfg(CASES[k][0]), *CASES[k][1]) for k in names]
    store = str(tmp_path_factory.mktemp("dist") / "store")
    pool = concurrent.futures.ThreadPoolExecutor(1)
    ranks = pool.submit(spawn, workers.dist_suite, 4, cases, (2, 2),
                        init_file=store, num_threads=1)
    mesh = jax_make_mesh(4, axes=("dp", "sp"))
    ref = {}
    for k in names:
        cfg, (src, msk, dst, nrm), _, _ = CASES[k]
        args = (jnp.asarray(src), jnp.asarray(msk), jnp.asarray(dst))
        if nrm is not None:
            args += (jnp.asarray(nrm),)
        r = JaxShardedAligner(mesh=mesh, cfg=cfg)(*args)
        ref[k] = {f: np.asarray(getattr(r, f)) for f in
                  ("T", "iters", "rmse", "n_inliers", "converged")}
    ranks = ranks.result()  # the ranks ran while the reference computed
    pool.shutdown()
    return ranks, {k: [rk["align"][i] for rk in ranks]
                   for i, k in enumerate(names)}, ref


def test_mesh_factoring_matches_reference(results):
    for n in range(1, 17):
        assert tmesh._two_way_factor(n) == jax_mesh._two_way_factor(n)
    ranks, _, _ = results
    want = jax_make_mesh(4, axes=("dp", "sp")).devices.shape
    for r, rk in enumerate(ranks):
        assert rk["auto_shape"] == want == (2, 2)
        assert rk["coords"] == (r // 2, r % 2)
        assert rk["hosts_shape"] == (4,)
    m = make_mesh(1, axes=("dp", "sp"), device="cpu")
    assert m.devices.shape == (1, 1) and dict(m.shape) == {"dp": 1, "sp": 1}
    assert m.groups == {"dp": None, "sp": None}  # no world: identities


def test_make_mesh_refusals(monkeypatch):
    """No silent fallback: more devices than ranks raises (the reference
    would swap to host-CPU devices); so do a shape that does not hold the
    devices and >2 axes without a shape; NCCL with two ranks on one card
    raises and names backend="gloo"."""
    with pytest.raises(ValueError, match="world has only 1 rank"):
        make_mesh(2, axes=("dp",), device="cpu")
    with pytest.raises(ValueError, match="mesh shape"):
        make_mesh(1, axes=("dp", "sp"), shape=(1, 2), device="cpu")
    with pytest.raises(ValueError, match="explicit shape"):
        make_mesh(1, axes=("a", "b", "c"), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh(1)  # the default device is the card
    monkeypatch.setattr(tdist, "is_initialized", lambda: True)
    monkeypatch.setattr(tdist, "get_rank", lambda group=None: 0)
    monkeypatch.setattr(tdist, "get_world_size", lambda group=None: 2)
    monkeypatch.setattr(tdist, "get_backend", lambda group=None: "nccl")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    with pytest.raises(ValueError, match='backend="gloo"'):
        make_mesh(2, axes=("dp",), device="cpu")


def test_multihost_init_noop_and_explicit_failure(monkeypatch):
    """The reference's policy: no coordinator and no launcher markers is a
    no-op; an initialised group is a no-op; an explicitly named coordinator
    that cannot be reached raises."""
    for k in ("MASTER_ADDR", "WORLD_SIZE", "RANK", "TORCHELASTIC_RUN_ID"):
        monkeypatch.delenv(k, raising=False)
    multihost_init(device="cpu")
    assert not tdist.is_initialized()
    with pytest.raises(Exception, match="timed out|connect"):
        multihost_init("127.0.0.1:1", world_size=2, rank=1, device="cpu",
                       timeout_s=1.0)
    assert not tdist.is_initialized()

    def refuse(*a, **k):
        raise AssertionError("init_process_group called twice")

    monkeypatch.setattr(tdist, "is_initialized", lambda: True)
    monkeypatch.setattr(tdist, "init_process_group", refuse)
    multihost_init("127.0.0.1:1", world_size=2, rank=1, device="cpu")


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_align_matches_reference(results, case):
    """The 2x2 world's ShardedAligner against the reference's on
    make_mesh(4, ("dp", "sp")): every rank returns the whole batch, equal on
    every rank, within the case's tolerance of the reference."""
    _, port, ref = results
    _, _, rtol, atol = CASES[case]
    for rk in port[case][1:]:
        for f in rk:
            np.testing.assert_array_equal(rk[f], port[case][0][f])
    got, want = port[case][0], ref[case]
    np.testing.assert_array_equal(got["iters"], want["iters"])
    np.testing.assert_array_equal(got["converged"], want["converged"])
    np.testing.assert_allclose(got["T"], want["T"], rtol=rtol, atol=atol)
    np.testing.assert_allclose(got["rmse"], want["rmse"], rtol=rtol * 10,
                               atol=atol * 10)
    assert got["T"].shape[0] == CASES[case][1][0].shape[0]


def test_sharded_plane_recovers_transform(results):
    """tests/test_dist.py's recovery bound on the plane scene."""
    _, port, _ = results
    err = np.abs(port["plane_f32"][0]["T"][0] - _plane_problem()[4]).max()
    assert err < 5e-3, err


def test_one_rank_aligner_equals_two_by_two(results):
    """A world that has not been initialised runs the same loop with every
    collective the identity."""
    _, port, _ = results
    cfg, (src, msk, dst, _), rtol, atol = CASES["p2p_f64"]
    res = ShardedAligner(make_mesh(1, device="cpu"), _tcfg(cfg))(
        src, msk, dst)
    np.testing.assert_allclose(res.T.numpy(), port["p2p_f64"][0]["T"],
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("precision", ["bf16", "rescore"])
def test_batched_nn_at_bf16_and_rescore_is_per_row(precision):
    """Batched K3/K4 (nn_backend="pallas"): each row equals its own
    unbatched call against target b // G, as the reference's vmap of the
    same kernel; here the plain versions on the CPU."""
    rng = np.random.default_rng(3)
    src = torch.as_tensor(rng.uniform(-5, 5, (4, 300, 3)), dtype=torch.float32)
    dst = torch.as_tensor(rng.uniform(-5, 5, (2, 280, 3)), dtype=torch.float32)
    idx, d2 = nearest_neighbor(src, dst, backend="pallas", precision=precision)
    assert idx.shape == d2.shape == (4, 300)
    for b in range(4):
        i1, d1 = nearest_neighbor(src[b], dst[b // 2], backend="pallas",
                                  precision=precision)
        assert torch.equal(idx[b], i1) and torch.equal(d2[b], d1)


def test_spawn_reports_a_failing_rank(tmp_path):
    """A rank that raises fails the whole world with its traceback; nothing
    is swallowed."""
    with pytest.raises(RuntimeError, match="rank 1 failed"):
        spawn(workers.fail_on_rank, 2, 1, init_file=str(tmp_path / "s"),
              timeout_s=60)
