"""The work and bound arithmetic of the kernels' rooflines, against values
worked out by hand at the cells' shapes (16,384-point scans and models)."""

import types

import pytest

from slambench import harness, roofline, trace

M = 16384


def test_bound_of_an_exact_nn_at_16384_squared():
    flops, nbytes = roofline.nn_work(1, 1, M, M, 1)
    assert flops == 9 * 16384 * 16384 == 2_415_919_104
    assert nbytes == 20 * 16384 + 12 * 16384 == 524_288
    # operations bound it: 2.4159e9 / 67e12 = 36.058 us (chip_smoke's K1
    # row: 0.0361 ms)
    assert roofline.bound_s(flops, nbytes, roofline.H100_FP32_FLOPS) == \
        pytest.approx(3.6058494e-5, rel=1e-7)
    # at the bf16 peak the same work takes 2.4428 us
    assert roofline.bound_s(flops, nbytes, roofline.H100_BF16_FLOPS) == \
        pytest.approx(2.4427898e-6, rel=1e-7)


def test_bound_of_batched_verification():
    # B = 16 (2 candidates x 8 yaws) against 2 targets: chip_smoke's
    # batched K1 row, 0.5769 ms
    flops, nbytes = roofline.nn_work(1, 16, M, M, 2)
    assert flops == 9 * 16 * 16384 ** 2
    assert nbytes == 20 * 16 * 16384 + 12 * 2 * 16384
    assert roofline.bound_s(flops, nbytes, 67e12) == pytest.approx(
        5.7693591e-4, rel=1e-7)


def test_bytes_bound_a_small_search():
    flops, nbytes = roofline.nn_work(1, 1, 1000, 10, 1)
    assert roofline.bound_s(flops, nbytes, 67e12) == nbytes / 3.35e12


def _ctx(cfg, profiled, ns_by_name, families=None):
    ops = [(name, 0, ns, span) for (name, span), ns in ns_by_name.items()]
    tr = trace.Trace(ops=ops, launches=0, syncs=0, host=[], spans=[])
    return types.SimpleNamespace(
        config=cfg, profiled=profiled, trace=tr,
        families=families or harness.families(),
        profiled_sum=lambda k: sum(r[k] for r in profiled))


ODOM = harness.config("kitti-odom")
SLAM = harness.config("kitti-slam")


def test_icp_nn_share():
    # 10 ICP iterations of K1 taking 0.1 ms each: 10 x 36.058 us / 1 ms
    ctx = _ctx(ODOM, [{"icp_iters": 6}, {"icp_iters": 4}],
               {("nn_split_kernel<3>", "slambench.frontend"): 900_000,
                ("nn_fold_kernel", "slambench.frontend"): 100_000,
                ("nn_split_kernel<3>", "slambench.verify"): 5_000_000})
    assert roofline.share(ctx, "icp_nn") == pytest.approx(
        100 * 10 * 3.6058494e-5 / 1e-3, rel=1e-6)


def test_rescore_counts_at_the_bf16_peak():
    ctx = _ctx(SLAM, [{"icp_iters": 1}],
               {("packed_scan_kernel", "slambench.frontend"): 100_000})
    assert roofline.share(ctx, "icp_nn") == pytest.approx(
        100 * 2.4427898e-6 / 1e-4, rel=1e-6)


def test_knn_share_counts_the_first_scan_and_each_insert():
    # stride 4: 16,384 x 4,096 pairs a call; 2 sequences, 3 inserts
    ctx = _ctx(ODOM, [{"inserts": 1}, {"inserts": 2}],
               {("knn_select_kernel<8, 2>", "slambench.frontend"): 500_000})
    per_call = 9 * 16384 * 4096 / 67e12
    assert roofline.share(ctx, "knn") == pytest.approx(
        100 * 5 * per_call / 5e-4, rel=1e-6)


def test_verify_share_sums_each_batch():
    recs = [{"verify_batches": [(16, 10), (8, 5)]}]
    ctx = _ctx(SLAM, recs,
               {("nn_split_kernel<3>", "slambench.verify"): 20_000_000,
                ("nn_split_kernel<3>", "slambench.frontend"): 9_000_000})
    work = 9 * 16384 ** 2 * (16 * 10 + 8 * 5) / 67e12
    assert roofline.share(ctx, "verify_nn") == pytest.approx(
        100 * work / 0.02, rel=1e-6)


def test_no_kernels_or_no_work_reads_nothing():
    ctx = _ctx(ODOM, [{"icp_iters": 5}], {("other_kernel", None): 1000})
    assert roofline.share(ctx, "icp_nn") is None
    ctx = _ctx(ODOM, [{"icp_iters": 0}],
               {("nn_split_kernel<3>", "slambench.frontend"): 1000})
    assert roofline.share(ctx, "icp_nn") is None
    ctx = _ctx(SLAM, [{"verify_batches": []}],
               {("nn_split_kernel<3>", "slambench.verify"): 1000})
    assert roofline.share(ctx, "verify_nn") is None
    ctx.trace = None
    assert roofline.share(ctx, "icp_nn") is None
