"""Golden CPU ICP oracle — float64 NumPy/SciPy, KD-tree correspondence.

The port's own copy of tpu_icp_slam/eval/golden.py, the same code: the
independent trajectory `cli eval` holds a run against. Deliberately boring
and precise: scipy cKDTree nearest neighbors, closed-form Umeyama
point-to-point solve or damped Gauss-Newton point-to-plane, float64
throughout.
"""

from __future__ import annotations

import dataclasses

import numpy as np
from scipy.spatial import cKDTree


@dataclasses.dataclass
class GoldenResult:
    T: np.ndarray  # (D+1, D+1) homogeneous transform src -> dst frame
    rmse: float
    iters: int
    n_inliers: int


def _umeyama_rigid(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """Rigid (no scale) least-squares transform: dst ≈ R src + t, fp64."""
    d = src.shape[1]
    mu_s = src.mean(axis=0)
    mu_d = dst.mean(axis=0)
    cov = (dst - mu_d).T @ (src - mu_s) / src.shape[0]
    U, _, Vt = np.linalg.svd(cov)
    D = np.eye(d)
    D[-1, -1] = np.sign(np.linalg.det(U @ Vt))
    R = U @ D @ Vt
    t = mu_d - R @ mu_s
    T = np.eye(d + 1)
    T[:d, :d] = R
    T[:d, d] = t
    return T


def icp_point_to_point(
    src: np.ndarray,
    dst: np.ndarray,
    init: np.ndarray | None = None,
    max_iters: int = 50,
    tol: float = 1e-10,
    max_corr_dist: float = np.inf,
) -> GoldenResult:
    """Classic point-to-point ICP, src (N, D) onto dst (M, D), fp64."""
    src = np.asarray(src, dtype=np.float64)
    dst = np.asarray(dst, dtype=np.float64)
    d = src.shape[1]
    T = np.eye(d + 1) if init is None else np.asarray(init, dtype=np.float64).copy()
    tree = cKDTree(dst)
    prev_rmse = np.inf
    rmse = np.inf
    n_inl = src.shape[0]
    it = 0
    for it in range(1, max_iters + 1):
        cur = src @ T[:d, :d].T + T[:d, d]
        dists, idx = tree.query(cur, k=1)
        sel = dists <= max_corr_dist
        if sel.sum() < d + 1:
            break
        n_inl = int(sel.sum())
        dT = _umeyama_rigid(cur[sel], dst[idx[sel]])
        T = dT @ T
        rmse = float(np.sqrt((dists[sel] ** 2).mean()))
        if abs(prev_rmse - rmse) < tol:
            break
        prev_rmse = rmse
    return GoldenResult(T=T, rmse=rmse, iters=it, n_inliers=n_inl)


def icp_point_to_plane(
    src: np.ndarray,
    dst: np.ndarray,
    dst_normals: np.ndarray,
    init: np.ndarray | None = None,
    max_iters: int = 50,
    tol: float = 1e-12,
    max_corr_dist: float = np.inf,
    damping: float = 1e-9,
) -> GoldenResult:
    """Point-to-plane ICP (3D), Gauss-Newton on se(3), fp64.

    Residual per correspondence: n^T (p' - q), with p' the transformed source
    point; Jacobian row [n^T, (p' x n)^T] for the update T <- exp([t, w]) T.
    """
    src = np.asarray(src, dtype=np.float64)
    dst = np.asarray(dst, dtype=np.float64)
    nrm = np.asarray(dst_normals, dtype=np.float64)
    T = np.eye(4) if init is None else np.asarray(init, dtype=np.float64).copy()
    tree = cKDTree(dst)
    prev_rmse = np.inf
    rmse = np.inf
    n_inl = src.shape[0]
    it = 0
    for it in range(1, max_iters + 1):
        cur = src @ T[:3, :3].T + T[:3, 3]
        dists, idx = tree.query(cur, k=1)
        sel = dists <= max_corr_dist
        if sel.sum() < 6:
            break
        n_inl = int(sel.sum())
        p = cur[sel]
        q = dst[idx[sel]]
        n = nrm[idx[sel]]
        r = np.einsum("ij,ij->i", n, p - q)
        J = np.concatenate([n, np.cross(p, n)], axis=1)  # (K, 6): [t, w]
        H = J.T @ J + damping * np.eye(6)
        g = J.T @ r
        xi = -np.linalg.solve(H, g)
        t, w = xi[:3], xi[3:]
        theta = np.linalg.norm(w)
        W = np.array(
            [[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]], dtype=np.float64
        )
        if theta < 1e-12:
            R = np.eye(3) + W
        else:
            R = (
                np.eye(3)
                + np.sin(theta) / theta * W
                + (1 - np.cos(theta)) / theta**2 * (W @ W)
            )
        dT = np.eye(4)
        dT[:3, :3] = R
        dT[:3, 3] = t
        T = dT @ T
        rmse = float(np.sqrt((r**2).mean()))
        if abs(prev_rmse - rmse) < tol:
            break
        prev_rmse = rmse
    return GoldenResult(T=T, rmse=rmse, iters=it, n_inliers=n_inl)


def odometry(
    scans: list[np.ndarray],
    max_iters: int = 30,
    max_corr_dist: float = np.inf,
) -> np.ndarray:
    """Sequential scan-to-scan point-to-point ICP odometry; (F, D+1, D+1) poses.

    The golden analogue of the reference's per-frame SLAM loop (SURVEY.md §3a
    entry point 1), minus the map: pose_i = pose_{i-1} ∘ T(scan_i -> scan_{i-1}).
    """
    d = scans[0].shape[1]
    poses = [np.eye(d + 1)]
    T_rel_prev = np.eye(d + 1)
    for i in range(1, len(scans)):
        res = icp_point_to_point(
            scans[i], scans[i - 1], init=T_rel_prev, max_iters=max_iters,
            max_corr_dist=max_corr_dist,
        )
        poses.append(poses[-1] @ res.T)
        T_rel_prev = res.T  # constant-velocity initial guess
    return np.stack(poses)
