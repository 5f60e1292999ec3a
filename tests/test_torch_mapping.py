"""Parity of the torch port's mapping layer (k-NN normals, voxel map insert
and local-model extraction) with the JAX reference."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_icp_slam.datasets import synthetic
from tpu_icp_slam.mapping import normals as jn
from tpu_icp_slam.mapping import voxel_map as jvm
from tpu_icp_slam.slam.runner import pad_scans
from tpu_icp_slam_torch.mapping import normals as tn
from tpu_icp_slam_torch.mapping import voxel_map as tvm


def _scan(capacity=2048, seed=0):
    scans, _ = synthetic.velodyne_log(n_frames=2, n_rings=16, n_azimuth=160,
                                      seed=seed)
    pts, msk = pad_scans(scans, capacity)
    return pts[1], msk[1]


def test_smallest_eigvec_matches_reference():
    rng = np.random.default_rng(0)
    X = rng.standard_normal((256, 8, 3)) * np.asarray([3.0, 1.0, 0.05])
    C = np.einsum("nki,nkj->nij", X, X).astype(np.float32) / 8
    C[0] = np.eye(3, dtype=np.float32)  # isotropic: +z fallback in both
    a = np.asarray(jn.smallest_eigvec_sym3(jnp.asarray(C)))
    b = tn.smallest_eigvec_sym3(torch.from_numpy(C)).numpy()
    assert np.all(np.sum(a * b, axis=1) >= 1 - 1e-4)


def _well_posed(pts, msk, ref_stride, k=8):
    """Points whose normal is decided by more than f32 rounding: a k-NN set
    with a gap above 1e-3 m² after its k-th member (the factored distance's
    f32 error at scene scale; ring scans have exact left/right neighbour
    ties), an eigen-gap λ2 − λ1 above 1e-2 λ3 (not a collinear ring
    segment), and a normal more than 1e-2 away from perpendicular to the
    view ray (where the orientation flip is a tie)."""
    P = pts.astype(np.float64)
    ref = P[::ref_stride]
    D = ((P[:, None] - ref[None]) ** 2).sum(-1)
    part = np.sort(np.partition(D, k, axis=1)[:, :k + 1], axis=1)
    gap = part[:, k] - part[:, k - 1] > 1e-3
    idx = np.argpartition(D, k - 1, axis=1)[:, :k]
    x = ref[idx] - ref[idx].mean(1, keepdims=True)
    ev, V = np.linalg.eigh(np.einsum("nki,nkj->nij", x, x) / k)
    eig = (ev[:, 1] - ev[:, 0]) > 1e-2 * ev[:, 2]
    view = np.abs((V[:, :, 0] * P).sum(1)) / np.linalg.norm(P, axis=1) > 1e-2
    return msk & gap & eig & view


@pytest.mark.parametrize("capacity,ref_stride", [(3000, 1), (3000, 4),
                                                 (2048, 4)])
def test_normals_knn_matches_reference(capacity, ref_stride):
    pts, msk = _scan(capacity)
    a = np.asarray(jn.normals_knn(jnp.asarray(pts), jnp.asarray(msk), k=8,
                                  ref_stride=ref_stride, approx=True,
                                  oversample=8))
    b = tn.normals_knn(torch.from_numpy(pts), torch.from_numpy(msk), k=8,
                       ref_stride=ref_stride, approx=True,
                       oversample=8).numpy()
    dot = np.sum(a * b, axis=1)
    ok = _well_posed(pts, msk, ref_stride)
    assert ok.sum() >= 0.7 * msk.sum()  # the comparison is not vacuous
    assert np.all(dot[ok] >= 1 - 1e-4), dot[ok].min()  # same orientation
    np.testing.assert_array_equal(b[~msk], 0.0)
    np.testing.assert_allclose(np.linalg.norm(b[msk], axis=1), 1.0,
                               atol=1e-5)


def _points(seed, n, spread=12.0, voxel=0.3):
    rng = np.random.default_rng(seed)
    p = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    # a few points exactly on voxel faces: floor() must agree there too
    p[: n // 10] = (np.round(p[: n // 10] / voxel) * voxel).astype(np.float32)
    nrm = rng.standard_normal((n, 3)).astype(np.float32)
    msk = rng.uniform(size=n) > 0.1
    return p, nrm, msk


def _assert_maps_equal(a, b):
    np.testing.assert_array_equal(b.points.numpy(), np.asarray(a.points))
    np.testing.assert_array_equal(b.normals.numpy(), np.asarray(a.normals))
    np.testing.assert_array_equal(b.mask.numpy(), np.asarray(a.mask))


@pytest.mark.parametrize("cap,with_center", [(4096, True), (700, True),
                                             (700, False)])
def test_voxel_insert_bitwise_equal(cap, with_center):
    """Two inserts with overlapping voxels; cap=700 overflows, exercising
    spatial (with center) and earliest-first (without) eviction."""
    voxel = 0.3
    ja, ta = jvm.create(cap), tvm.create(cap)
    for seed, shift in ((1, 0.0), (2, 0.05)):
        p, nrm, msk = _points(seed, 900, voxel=voxel)
        p = p + np.float32(shift)
        c = np.asarray([0.5, -1.0, 0.2], np.float32) if with_center else None
        ja = jvm.insert(ja, jnp.asarray(p), jnp.asarray(msk),
                        jnp.asarray(nrm), voxel=voxel,
                        center=None if c is None else jnp.asarray(c))
        ta = tvm.insert(ta, torch.from_numpy(p), torch.from_numpy(msk),
                        torch.from_numpy(nrm), voxel=voxel,
                        center=None if c is None else torch.from_numpy(c))
        _assert_maps_equal(ja, ta)
    assert int(tvm.count(ta)) == int(jvm.count(ja)) > 0


@pytest.mark.parametrize("size,radius", [(300, 0.0), (3000, 0.0),
                                         (600, 6.0)])
def test_extract_local_bitwise_equal(size, radius):
    p, nrm, msk = _points(3, 2000)
    ja = jvm.insert(jvm.create(4096), jnp.asarray(p), jnp.asarray(msk),
                    jnp.asarray(nrm), voxel=0.3)
    ta = tvm.insert(tvm.create(4096), torch.from_numpy(p),
                    torch.from_numpy(msk), torch.from_numpy(nrm), voxel=0.3)
    c = np.asarray([1.0, 2.0, -0.5], np.float32)
    a = jvm.extract_local(ja, jnp.asarray(c), size, radius=radius)
    b = tvm.extract_local(ta, torch.from_numpy(c), size, radius=radius)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(y.numpy(), np.asarray(x))


def test_voxel_map_small_cases():
    """The reference's own voxel-map cases (test_scan_to_map.py) on the port."""
    vm = tvm.create(64)
    pts = torch.tensor([[0.05, 0.05, 0.05], [0.06, 0.06, 0.06],
                        [1.0, 1.0, 1.0]])
    vm = tvm.insert(vm, pts, torch.ones(3, dtype=torch.bool),
                    torch.zeros(3, 3), voxel=0.4)
    assert int(tvm.count(vm)) == 2
    vm2 = tvm.insert(vm, pts + 0.01, torch.ones(3, dtype=torch.bool),
                     torch.zeros(3, 3), voxel=0.4)
    kept = np.sort(vm2.points[vm2.mask][:, 0].numpy())
    np.testing.assert_allclose(kept, [0.05, 1.0], atol=1e-6)
    line = torch.tensor([[float(i), 0.0, 0.0] for i in range(10)])
    vm = tvm.insert(tvm.create(32), line, torch.ones(10, dtype=torch.bool),
                    torch.zeros(10, 3), voxel=0.4)
    loc, _, msk, r_cover = tvm.extract_local(vm, torch.zeros(3), 4)
    np.testing.assert_allclose(np.sort(loc[msk][:, 0].numpy()), [0, 1, 2, 3])
    np.testing.assert_allclose(float(r_cover), 3.0, atol=1e-5)
