"""The port's communication accounting (tpu_icp_slam_torch.dist.comm)
against the reference's (tpu_icp_slam.dist.comm): the payload and wire-byte
functions and the separator count equal exactly; the scaling models
recomputed by hand with the port's H100 constants."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_pose_graph import _chain_with_loop
from tpu_icp_slam.backend import pose_graph as jpg
from tpu_icp_slam.dist import comm as jcomm
from tpu_icp_slam_torch.backend import pose_graph as pg
from tpu_icp_slam_torch.dist import comm


@pytest.mark.parametrize("n", [1, 2, 3, 4, 8, 100])
def test_ring_allreduce_wire_bytes_equal(n):
    for payload in (0.0, 100.0, 180.0, 1e6):
        assert comm.ring_allreduce_wire_bytes(payload, n) == \
            jcomm.ring_allreduce_wire_bytes(payload, n)


@pytest.mark.parametrize("method", ["point_to_point", "point_to_plane"])
@pytest.mark.parametrize("d", [2, 3])
@pytest.mark.parametrize("dtype_bytes", [4, 8])
def test_sharded_icp_payloads_equal(method, d, dtype_bytes):
    assert comm.sharded_icp_psum_payload(method, d, dtype_bytes) == \
        jcomm.sharded_icp_psum_payload(method, d, dtype_bytes)


def test_payloads_are_what_the_port_reduces():
    """The port packs [H, g, stats] (45 floats) or [moments, stats] (19
    floats) into its one all-reduce an iteration (dist/sharded_icp.py)."""
    assert comm.sharded_icp_psum_payload("point_to_plane")[
        "floats_per_iteration"] == 36 + 6 + 3
    assert comm.sharded_icp_psum_payload("point_to_point")[
        "floats_per_iteration"] == 1 + 3 + 3 + 9 + 3


@pytest.mark.parametrize("ns", [0, 1, 16, 40])
def test_schur_payload_equal(ns):
    for d in (2, 3):
        assert comm.schur_psum_payload(ns, d) == jcomm.schur_psum_payload(
            ns, d)


@pytest.mark.parametrize("blocks", [1, 2, 4])
def test_schur_separator_count_equal(blocks):
    init, _, factors = _chain_with_loop(n=16, drift=0.03)
    g = pg.from_arrays(init, factors, dtype=torch.float64, device="cpu")
    jg = jpg.from_arrays(init, factors, dtype=jnp.float64)
    assert comm.schur_separator_count(g, blocks) == \
        jcomm.schur_separator_count(jg, blocks)


def test_sharded_icp_model_by_hand():
    m = n = 16384
    iters, dev = 3.4, 4
    row = comm.sharded_icp_scaling_model(m_points=m, n_points=n, iters=iters,
                                         n_devices=dev)
    flops = 2.0 * m * n * 16 * 1 * iters
    payload = 180 * iters
    wire = 2.0 * 3 / 4 * payload
    compute_s = flops / (dev * 989e12 * 0.10)
    comm_s = wire / 450e9
    assert row["compute_flops_per_step"] == flops
    assert row["psum_payload_bytes_per_step"] == payload
    assert row["wire_bytes_per_device_per_step"] == wire
    assert row["compute_s_at_peak"] == pytest.approx(compute_s, rel=1e-12)
    assert row["comm_s"] == pytest.approx(comm_s, rel=1e-12)
    assert row["efficiency_bound"] == round(
        compute_s / (compute_s + comm_s), 4)
    # the keys are the reference's: bench rung 5 prints either
    assert row.keys() == jcomm.sharded_icp_scaling_model(
        m_points=m, n_points=n, iters=iters, n_devices=dev).keys()
    # the KITTI regime stays compute-dominated on NVLink
    assert row["efficiency_bound"] > 0.999
    assert row["compute_s_at_peak"] > 100 * row["comm_s"]


def test_schur_model_by_hand():
    ns, ni, nf, iters, dev = 12, 13, 64, 2, 4
    row = comm.schur_scaling_model(n_separator=ns, n_interior_max=ni,
                                   n_factors=nf, iters=iters, n_devices=dev)
    chol = (ni * 6) ** 3 / 3.0
    linz = 400.0 * nf / dev
    flops = (chol + linz) * dev * iters
    payload = ((ns * 6) ** 2 + ns * 6) * 8  # float64, as the port solves
    wire = 2.0 * 3 / 4 * payload * iters
    compute_s = flops / (dev * 67e12 * 0.04)
    comm_s = wire / 50e9
    assert row["psum_payload_bytes_per_iteration"] == payload
    assert row["wire_bytes_per_device_per_step"] == wire
    assert row["compute_s_at_peak"] == pytest.approx(compute_s, rel=1e-12)
    assert row["comm_s"] == pytest.approx(comm_s, rel=1e-12)
    assert row["efficiency_bound"] == round(
        compute_s / (compute_s + comm_s), 4)
    assert row.keys() == jcomm.schur_scaling_model(
        n_separator=ns, n_interior_max=ni, n_factors=nf, iters=iters,
        n_devices=dev).keys()


def test_no_tpu_constant_in_the_port():
    names = [k for k in vars(comm) if k.isupper()]
    assert not [k for k in names if "V5" in k or "ICI" in k or "DCN" in k]
    assert comm.H100_BF16_FLOPS == 989e12 and comm.H100_FP32_FLOPS == 67e12
    assert np.isclose(comm.NVLINK_BYTES_PER_S, 450e9)
    assert np.isclose(comm.IB_NDR_BYTES_PER_S, 50e9)
