"""The mapping options of the scan-to-map front end in the port against the
reference on the CPU: mapping.insert_backend="hash" (voxel_map.insert_hash)
and mapping.extract_approx (voxel_map.extract_local(approx=True)).

Tolerances: insert_hash and extract_local entry for entry, bit for bit (the
same float32 and integer operations; uint32 hash arithmetic emulated in
int64); the reference's approx_max_k is an exact top-k off the TPU, and the
port selects exactly, so approx=True equals the exact extract in both. The
short scan-to-map run with both options within test_torch_slice.py's
bounds for its main log (3e-4 m, 6e-5 rad a frame), keyframes, map inserts
and map sizes equal.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_scan_to_map import _s2m_cfg
from test_torch_slice import GAPS, _assert_slice_agrees, _log, _run_both
from tpu_icp_slam.mapping import voxel_map as jvm
from tpu_icp_slam_torch.mapping import voxel_map as tvm


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Test files run in parallel worker processes: one torch thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scan(rng, n, spread=20.0, offset=0.0, invalid=0.1):
    pts = (rng.uniform(-spread, spread, (n, 3)) + offset).astype(np.float32)
    pts[:, 2] = rng.uniform(-2, 2, n)
    msk = rng.uniform(size=n) >= invalid
    pts[~msk] = 1.0e6
    nrm = rng.standard_normal((n, 3)).astype(np.float32)
    return pts, msk, nrm


def _assert_maps_equal(t, j):
    for f in ("points", "normals", "mask"):
        np.testing.assert_array_equal(getattr(t, f).numpy(),
                                      np.asarray(getattr(j, f)), err_msg=f)


# (capacity, points a scan, scans, with center, scan offset, table_mult,
# probes): room to spare; the map filling with no eviction (every
# occupied slot -inf, ties everywhere); spatial eviction; eviction into a
# small map; negative voxel keys far from the origin (their uint32 wrap);
# a table too small for the probes (overflow admits duplicates)
CASES = {
    "room": (4096, 1000, 3, False, 0.0, 2, 8),
    "fill_no_evict": (2048, 1500, 3, False, 0.0, 2, 8),
    "evict": (2048, 1500, 3, True, 0.0, 2, 8),
    "evict_small": (512, 1000, 3, True, 0.0, 2, 8),
    "negative_keys": (2048, 800, 3, True, -4.0e4, 2, 8),
    "overflow": (1024, 900, 3, False, 0.0, 1, 2),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_insert_hash_matches_reference(case):
    cap, n, scans, with_center, offset, mult, probes = CASES[case]
    rng = np.random.default_rng(sorted(CASES).index(case))
    jm, tm = jvm.create(cap), tvm.create(cap, device="cpu")
    for _ in range(scans):
        pts, msk, nrm = _scan(rng, n, offset=offset)
        pts[: n // 10] = pts[n // 10: 2 * (n // 10)]  # voxels twice a scan
        c = (rng.uniform(-5, 5, 3) + offset).astype(np.float32)
        kw = dict(voxel=0.5, table_mult=mult, probes=probes)
        jm = jvm.insert_hash(jm, jnp.asarray(pts), jnp.asarray(msk),
                             jnp.asarray(nrm),
                             center=jnp.asarray(c) if with_center else None,
                             **kw)
        tm = tvm.insert_hash(tm, torch.as_tensor(pts), torch.as_tensor(msk),
                             torch.as_tensor(nrm),
                             center=torch.as_tensor(c) if with_center
                             else None, **kw)
        _assert_maps_equal(tm, jm)
    assert 0 < int(tvm.count(tm)) <= cap


def test_insert_hash_keeps_slots_and_the_voxel_set():
    """Map points stay in their slots; without eviction the surviving voxel
    set is the sort-based insert's."""
    rng = np.random.default_rng(11)
    tm = tvm.create(8192, device="cpu")
    sm = tvm.create(8192, device="cpu")
    for _ in range(3):
        pts, msk, nrm = (torch.as_tensor(a) for a in _scan(rng, 1200))
        before = tm.points.clone(), tm.mask.clone()
        tm = tvm.insert_hash(tm, pts, msk, nrm, voxel=0.5)
        sm = tvm.insert(sm, pts, msk, nrm, voxel=0.5)
        assert torch.equal(tm.points[before[1]], before[0][before[1]])

    def voxels(m):
        q = torch.floor(m.points[m.mask] / 0.5).to(torch.int64)
        return set(map(tuple, q.tolist()))

    assert voxels(tm) == voxels(sm)


@pytest.mark.parametrize("size,radius", [(1024, 0.0), (4096, 0.0),
                                         (1024, 8.0)])
def test_extract_local_approx_matches_reference(size, radius):
    """approx=True equals the reference's CPU result (an exact top-k there)
    and the port's exact extract, entry for entry."""
    rng = np.random.default_rng(3)
    pts, msk, nrm = _scan(rng, 3000, invalid=0.0)
    jm = jvm.insert(jvm.create(4096), jnp.asarray(pts), jnp.asarray(msk),
                    jnp.asarray(nrm), voxel=0.3)
    tm = tvm.insert(tvm.create(4096, device="cpu"), torch.as_tensor(pts),
                    torch.as_tensor(msk), torch.as_tensor(nrm), voxel=0.3)
    c = np.array([1.0, 2.0, 0.0], np.float32)
    want = jvm.extract_local(jm, jnp.asarray(c), size, radius=radius,
                             approx=True)
    got = tvm.extract_local(tm, torch.as_tensor(c), size, radius=radius,
                            approx=True)
    exact = tvm.extract_local(tm, torch.as_tensor(c), size, radius=radius)
    for g, w, e in zip(got, want, exact):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert torch.equal(g, e)


def test_scan_to_map_with_both_options_matches_reference():
    pts, msk, gt = _log()
    cfg = _s2m_cfg()
    cfg = dataclasses.replace(cfg, mapping=dataclasses.replace(
        cfg.mapping, insert_backend="hash", extract_approx=True))
    ji, ti = _run_both(cfg, pts, msk)
    _assert_slice_agrees(ji, ti, gt, GAPS["main"])
    assert ti["map_inserted"].sum() >= 1
