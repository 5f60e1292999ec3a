"""The plain versions of KN and EX, the scan-to-map frame's map stages,
against the JAX reference on the CPU; and their dispatch.

KN (kernels/knn_cuda.py) is held on the card to the plain k-NN
(kernels/nn_plain.py) and plain fit (mapping/normals.normals_knn_ref), EX
(kernels/select_cuda.py) to extract_local_ref (test_torch_cuda.py). Here
those plain versions meet the reference:
- the k-NN picks on integer coordinates, whose scores are exact and tie
  often, equal the reference's `knn_bruteforce_xla` index for index, order
  included (ties to the lower index), exact or prefiltered;
- the plain fit equals `normals_knn` on a lattice scene where every score
  is exact (dot >= 1 - 1e-4, the tolerance of
  test_torch_mapping.py::test_normals_knn_matches_reference, on every row
  whose fit is well posed) and on a ring scan (that test's filter), and
  on a full-size ring scan at stride 1 all but a handful of normals do;
- extract_local_ref's outputs equal the reference's bit for bit on maps
  with exact d² ties, with a radius, with fewer than `size` points and
  with exactly `size`;
- CPU tensors never reach the kernel build.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_icp_slam.datasets import synthetic
from tpu_icp_slam.kernels.nn_xla import knn_bruteforce_xla
from tpu_icp_slam.mapping import normals as jn
from tpu_icp_slam.mapping import voxel_map as jvm
from tpu_icp_slam.slam.runner import pad_scans
from tpu_icp_slam_torch.kernels import _build
from tpu_icp_slam_torch.kernels.nn_plain import knn_bruteforce
from tpu_icp_slam_torch.mapping import normals as tn
from tpu_icp_slam_torch.mapping import voxel_map as tvm
from test_torch_mapping import _scan, _well_posed


def _lattice(n, seed, lo=-3, hi=3):
    rng = np.random.default_rng(seed)
    return rng.integers(lo, hi + 1, (n, 3)).astype(np.float32)


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("approx,oversample", [(False, 0), (True, 8)])
def test_knn_ties_go_to_the_lower_index(stride, approx, oversample):
    """600 points on the integer lattice [-3, 3]³ (exact scores, many ties),
    k = 8 against every stride-th point: idx and d² equal the reference's,
    order included. `torch.topk`'s own order among ties matches 0-0.3% of
    the rows."""
    pts = _lattice(600, 0)
    ref = pts[::stride]
    want_i, want_d = knn_bruteforce_xla(jnp.asarray(pts), jnp.asarray(ref),
                                        k=8, approx=approx,
                                        oversample=oversample)
    got_i, got_d = knn_bruteforce(torch.from_numpy(pts),
                                  torch.from_numpy(ref), 8)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))


def test_knn_chunks_and_sorted_rows():
    """Across chunk edges, each row ascends by (d², index) and holds the
    exact k-NN set of a float64 brute force where its gap is clear."""
    rng = np.random.default_rng(3)
    src = rng.uniform(-20, 20, (700, 3)).astype(np.float32)
    dst = rng.uniform(-20, 20, (300, 3)).astype(np.float32)
    idx, d2 = knn_bruteforce(torch.from_numpy(src), torch.from_numpy(dst), 5,
                             chunk=128)
    idx, d2 = idx.numpy(), d2.numpy()
    assert np.all((d2[:, 1:] > d2[:, :-1]) | ((d2[:, 1:] == d2[:, :-1])
                                              & (idx[:, 1:] > idx[:, :-1])))
    D = ((src[:, None].astype(np.float64) - dst[None]) ** 2).sum(-1)
    part = np.sort(D, axis=1)
    clear = part[:, 5] - part[:, 4] > 1e-2
    want = np.sort(np.argsort(D, axis=1, kind="stable")[:, :5], axis=1)
    np.testing.assert_array_equal(np.sort(idx, axis=1)[clear], want[clear])


def _lattice_scene():
    """Two lattice planes at 0.5 m spacing, z = -1.5 and x = 6, and a padded
    tail: every coordinate a multiple of 0.5, so every score is exact."""
    g = np.arange(-10, 11) * 0.5
    xx, yy = np.meshgrid(g, g)
    floor = np.stack([xx.ravel(), yy.ravel(), np.full(xx.size, -1.5)], 1)
    wall = np.stack([np.full(xx.size, 6.0), xx.ravel(), yy.ravel() + 5.5], 1)
    pts = np.concatenate([floor, wall]).astype(np.float32)
    pad = np.full((40, 3), 1e6, np.float32)
    return (np.concatenate([pts, pad]),
            np.concatenate([np.ones(len(pts), bool), np.zeros(40, bool)]))


@pytest.mark.parametrize("stride", [1, 2])
def test_normals_knn_ref_matches_reference_on_exact_ties(stride):
    pts, msk = _lattice_scene()
    a = np.asarray(jn.normals_knn(jnp.asarray(pts), jnp.asarray(msk), k=8,
                                  ref_stride=stride, approx=True,
                                  oversample=8))
    b = tn.normals_knn(torch.from_numpy(pts), torch.from_numpy(msk), k=8,
                       ref_stride=stride, approx=True, oversample=8).numpy()
    # the well-posed rows: an eigen-gap, and a normal off perpendicular to
    # the view ray (the orientation flip's tie); every score here is exact
    ref = pts[::stride].astype(np.float64)
    idx, _ = knn_bruteforce(torch.from_numpy(pts), torch.from_numpy(
        pts[::stride]), 8)
    nb = ref[idx.numpy()]
    x = nb - nb.mean(1, keepdims=True)
    ev, V = np.linalg.eigh(np.einsum("nki,nkj->nij", x, x) / 8)
    eig = (ev[:, 1] - ev[:, 0]) > 1e-2 * ev[:, 2]
    P = pts.astype(np.float64)
    view = np.abs((V[:, :, 0] * P).sum(1)) / np.maximum(
        np.linalg.norm(P, axis=1), 1e-9) > 1e-2
    ok = msk & eig & view
    assert ok.sum() >= 0.8 * msk.sum()
    dot = np.sum(a * b, axis=1)
    assert np.all(dot[ok] >= 1 - 1e-4), dot[ok].min()
    np.testing.assert_array_equal(b[~msk], 0.0)


@pytest.mark.parametrize("ref_stride", [1, 2])
def test_normals_knn_ref_matches_reference_on_a_ring_scan(ref_stride):
    pts, msk = _scan(1500, seed=4)
    a = np.asarray(jn.normals_knn(jnp.asarray(pts), jnp.asarray(msk), k=8,
                                  ref_stride=ref_stride, approx=True,
                                  oversample=8))
    b = tn.normals_knn_ref(torch.from_numpy(pts), torch.from_numpy(msk), k=8,
                           ref_stride=ref_stride).numpy()
    ok = _well_posed(pts, msk, ref_stride)
    assert ok.sum() >= 0.7 * msk.sum()
    dot = np.sum(a * b, axis=1)
    assert np.all(dot[ok] >= 1 - 1e-4), dot[ok].min()


def test_normals_knn_ref_on_a_full_ring_scan():
    """A 16,384-point ring scan (velodyne_log(48, 1024), cut to capacity)
    at stride 1, where ring neighbours tie exactly: at most 8 normals
    differ from the reference's by more than 1e-4 in dot (3 with the
    (d, index) rule; 34 with topk's order among ties)."""
    scans, _ = synthetic.velodyne_log(n_frames=2, n_rings=48, n_azimuth=1024,
                                      seed=0)
    pts, msk = pad_scans(scans, 16384)
    pts, msk = pts[1], msk[1]
    a = np.asarray(jn.normals_knn(jnp.asarray(pts), jnp.asarray(msk), k=8,
                                  ref_stride=1, approx=True, oversample=8))
    b = tn.normals_knn_ref(torch.from_numpy(pts), torch.from_numpy(msk),
                           k=8).numpy()
    differ = int(((np.sum(a * b, axis=1) < 1 - 1e-4) & msk).sum())
    assert differ <= 8, differ


def _maps(points, normals, mask):
    return (jvm.VoxelMap(points=jnp.asarray(points),
                         normals=jnp.asarray(normals), mask=jnp.asarray(mask)),
            tvm.VoxelMap(points=torch.from_numpy(points),
                         normals=torch.from_numpy(normals),
                         mask=torch.from_numpy(mask)))


def _grid_map(cap, n_on, seed):
    """cap slots, n_on of them on the integer lattice [-4, 4]³ (exact d²
    from an integer centre, with many ties), the rest padding, shuffled."""
    rng = np.random.default_rng(seed)
    pts = np.full((cap, 3), 1e6, np.float32)
    nrm = np.zeros((cap, 3), np.float32)
    msk = np.zeros(cap, bool)
    on = rng.permutation(cap)[:n_on]
    pts[on] = rng.integers(-4, 5, (n_on, 3))
    nrm[on] = rng.standard_normal((n_on, 3))
    msk[on] = True
    return pts, nrm, msk


@pytest.mark.parametrize("cap,n_on,size,radius", [
    (2000, 1500, 300, 0.0),   # ties at the size-th distance
    (2000, 1500, 300, 2.5),   # a radius inside the selection
    (2000, 1500, 600, 9.0),   # a radius beyond it
    (2000, 200, 300, 0.0),    # fewer points than size
    (2000, 300, 300, 0.0),    # exactly size points
    (2000, 300, 300, 2.0),
])
def test_extract_local_ref_matches_reference(cap, n_on, size, radius):
    pts, nrm, msk = _grid_map(cap, n_on, seed=size + n_on)
    jm, tm = _maps(pts, nrm, msk)
    c = np.asarray([1.0, -1.0, 0.0], np.float32)
    want = jvm.extract_local(jm, jnp.asarray(c), size, radius=radius)
    got = tvm.extract_local_ref(tm, torch.from_numpy(c), size, radius=radius)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # and the dispatch takes the plain version for CPU tensors
    for g, h in zip(got, tvm.extract_local(tm, torch.from_numpy(c), size,
                                           radius=radius)):
        assert torch.equal(g, h)


def test_cpu_tensors_never_reach_the_kernels(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a CPU call reached the CUDA kernel build")

    monkeypatch.setattr(_build, "load", refuse)
    monkeypatch.setattr(_build, "build", refuse)
    pts, msk = _lattice_scene()
    want = tn.normals_knn_ref(torch.from_numpy(pts), torch.from_numpy(msk),
                              k=8, ref_stride=2)
    got = tn.normals_knn(torch.from_numpy(pts), torch.from_numpy(msk), k=8,
                         ref_stride=2)
    assert torch.equal(got, want)
    p, n, m = _grid_map(500, 300, seed=1)
    _, tm = _maps(p, n, m)
    tvm.extract_local(tm, torch.zeros(3), 100, radius=3.0)
