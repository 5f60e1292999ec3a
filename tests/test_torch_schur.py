"""The port's distributed Schur pose-graph solve (backend/schur.py) and
Slam3D's Schur branch against the JAX reference's.

The port runs as spawned gloo ranks on the CPU (4 for the graphs, 2 for
Slam3D); the reference runs in this process on conftest's virtual CPU
devices. Tolerances: `make_plan` arrays equal; poses rtol 1e-7 / atol
1e-8 and chi2 rtol 1e-6, float64 on both sides, against the reference's
4-block mesh and against the port's dense solve (the reference's own
Schur-vs-dense bound, tests/test_schur.py:49-54); Slam3D with
dist.mesh_shape=(2,) over 2 ranks: keyframes and kept closures equal,
poses within tests/test_torch_slam3d.py's POSE_GAPS, chi2 rtol 1e-3 (the
front ends differ by float32 rounding, as in that file).
"""

import concurrent.futures
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist_workers as workers
from test_pose_graph import _chain_with_loop
from test_torch_slam3d import POSE_GAPS, _out_and_back, _slam_cfg
from tpu_icp_slam.backend import pose_graph as jpg
from tpu_icp_slam.backend import schur as jschur
from tpu_icp_slam.config import DistConfig, to_json
from tpu_icp_slam.dist import make_mesh as jax_make_mesh
from tpu_icp_slam.slam.slam3d import Slam3D as JaxSlam3D
from tpu_icp_slam_torch.backend import pose_graph as pg
from tpu_icp_slam_torch.backend import schur
from tpu_icp_slam_torch.dist import make_mesh
from tpu_icp_slam_torch.dist.spawn import spawn


def _graphs():
    """name: (poses, factors, max_keyframes, max_factors, iters), the
    graphs of tests/test_schur.py."""
    init, _, factors = _chain_with_loop(n=16, drift=0.03)
    init8, _, factors8 = _chain_with_loop(n=8, drift=0.02)
    return {"chain16": (init, factors, 0, 0, 6),
            "padded8": (init8, factors8, 12, 16, 3)}


GRAPHS = _graphs()


def _jax_graph(poses, factors, kk, ff):
    return jpg.from_arrays(poses, factors, max_keyframes=kk, max_factors=ff,
                           dtype=jnp.float64)


def _port_graph(poses, factors, kk, ff):
    return pg.from_arrays(poses, factors, max_keyframes=kk, max_factors=ff,
                          dtype=torch.float64, device="cpu")


def _mesh2_cfg():
    return dataclasses.replace(_slam_cfg(), dist=DistConfig(mesh_shape=(2,)))


def _port_runs(d):
    """The port's 4-rank solves and its 2-rank Slam3D run, every rank's."""
    graphs = list(GRAPHS.values())
    solves = spawn(workers.schur, 4, graphs, 4, init_file=str(d / "g"),
                   num_threads=1)
    pts, msk = _out_and_back()
    slams = spawn(workers.slam3d, 2, to_json(_mesh2_cfg()), pts, msk,
                  init_file=str(d / "s"), num_threads=1)
    return {k: [s[i] for s in solves] for i, k in enumerate(GRAPHS)}, slams


def _reference_runs():
    """The reference's 4-block solves and its Slam3D run with
    mesh_shape=(2,)."""
    mesh = jax_make_mesh(4, axes=("graph",))
    solves = {}
    for name, (poses, factors, kk, ff, iters) in GRAPHS.items():
        g, chis = jschur.optimize_distributed(
            _jax_graph(poses, factors, kk, ff), mesh, iters=iters,
            damping=1e-9)
        solves[name] = (np.asarray(g.poses), np.asarray(chis))
    pts, msk = _out_and_back()
    slam = JaxSlam3D(_mesh2_cfg())
    poses, rep = slam.run(pts, msk, mode="fused")
    return solves, (poses, rep, list(slam.kf_frames))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(port, reference): the port's ranks run while the reference computes
    in this process."""
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        port = pool.submit(_port_runs, tmp_path_factory.mktemp("schur"))
        ref = _reference_runs()
        return port.result(), ref


@pytest.mark.parametrize("blocks", [1, 2, 3, 4])
@pytest.mark.parametrize("name", list(GRAPHS))
def test_make_plan_equals_reference(name, blocks):
    poses, factors, kk, ff, _ = GRAPHS[name]
    jg, tg = _jax_graph(poses, factors, kk, ff), \
        _port_graph(poses, factors, kk, ff)
    want = jschur.make_plan(jg.fi, jg.fj, jg.weight, jg.pose_mask, blocks)
    got = schur.make_plan(tg.fi, tg.fj, tg.weight, tg.pose_mask, blocks)
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        np.testing.assert_array_equal(a, b, err_msg=f.name)
        assert np.asarray(a).dtype == np.asarray(b).dtype, f.name


@pytest.mark.parametrize("name", list(GRAPHS))
def test_schur_matches_reference_4_blocks(runs, name):
    (solves, _), (ref, _) = runs
    for got in solves[name][1:]:  # replicated on every rank
        np.testing.assert_array_equal(got[0], solves[name][0][0])
    n = len(GRAPHS[name][0])
    np.testing.assert_allclose(solves[name][0][0][:n], ref[name][0][:n],
                               rtol=1e-7, atol=1e-8)
    np.testing.assert_allclose(solves[name][0][1], ref[name][1], rtol=1e-6)


@pytest.mark.parametrize("name", list(GRAPHS))
def test_schur_matches_dense(runs, name):
    poses, factors, kk, ff, iters = GRAPHS[name]
    (solves, _), _ = runs
    dense, chis = pg.optimize(_port_graph(poses, factors, kk, ff),
                              iters=iters, damping=1e-9)
    n = len(poses)
    np.testing.assert_allclose(solves[name][0][0][:n],
                               dense.poses.numpy()[:n], rtol=1e-7, atol=1e-8)
    np.testing.assert_allclose(solves[name][0][1], chis.numpy(), rtol=1e-6)


@pytest.mark.parametrize("name", list(GRAPHS))
def test_schur_one_block_without_a_world(name):
    """A world that has not been initialised: one block, the collectives
    the identity; the dense solve's result."""
    poses, factors, kk, ff, iters = GRAPHS[name]
    g = _port_graph(poses, factors, kk, ff)
    got, chis = schur.optimize_distributed(
        g, make_mesh(1, axes=("graph",), device="cpu"), iters=iters,
        damping=1e-9)
    dense, dchis = pg.optimize(g, iters=iters, damping=1e-9)
    np.testing.assert_allclose(got.poses.numpy(), dense.poses.numpy(),
                               rtol=1e-7, atol=1e-8)
    np.testing.assert_allclose(chis.numpy(), dchis.numpy(), rtol=1e-6)


def test_slam3d_mesh2_matches_reference(runs):
    """Slam3D with dist.mesh_shape=(2,) over 2 ranks against the reference's
    Schur branch over 2 of its devices: both ranks return the same run."""
    (_, slams), (_, (ref_poses, ref_rep, ref_kf)) = runs
    assert ref_rep.n_loop_closures >= 1
    got = slams[0]
    np.testing.assert_array_equal(slams[1]["poses"], got["poses"])
    assert got["kf_frames"] == ref_kf
    assert got["closures"] == [(c["i"], c["j"])
                               for c in ref_rep.closure_table]
    np.testing.assert_allclose(got["chi2"], ref_rep.chi2, rtol=1e-3,
                               atol=1e-9)
    gap = np.linalg.norm(got["poses"][:, :3, 3] - ref_poses[:, :3, 3], axis=1)
    assert gap.max() <= POSE_GAPS[0], gap
