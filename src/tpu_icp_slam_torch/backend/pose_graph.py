"""Pose-graph Gauss-Newton optimizer (port of
tpu_icp_slam/backend/pose_graph.py).

SE(3) relative-pose factors r = log(T_meas⁻¹ · X_i⁻¹ · X_j), minimized by
damped Gauss-Newton with right-perturbation updates X ← X·exp(ξ) and Huber
weights, on a fixed-capacity graph: (K, 4, 4) poses with a validity mask and
(F,) factor slots, weight 0 for an empty slot. Gauge freedom is fixed by a
strong diagonal prior on pose 0.

Jacobians (right perturbation, translation-first tangent [rho, phi]):
  E = T_meas⁻¹ A, A = X_i⁻¹ X_j
  ∂r/∂ξ_j =  Jr⁻¹(r)
  ∂r/∂ξ_i = -Jr⁻¹(r) · Ad(A⁻¹)

The port differs from the reference in two ways that do not change the
function. H is assembled with one-hot matrix products instead of
scatter-adds, because `index_put_(accumulate=True)` on CUDA sums in no fixed
order: the products give the same H in a fixed order (memory 4F·K·36
values, fine at the K ≤ max_keyframes this is sized for). The Cholesky is
`cholesky_ex`, which reports failure without a host sync; a failed
factorization gives a zero step, as the reference's NaN guard does. Slam3D
runs the graph in float64 on the device; the PCM clique search stays numpy,
as in the reference.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpu_icp_slam_torch.core import se3


@dataclasses.dataclass(frozen=True)
class PoseGraph:
    """Fixed-capacity pose graph. weight == 0 marks an empty factor slot."""

    poses: torch.Tensor  # (K, 4, 4) world <- keyframe
    pose_mask: torch.Tensor  # (K,) bool
    fi: torch.Tensor  # (F,) int64 factor tail (from)
    fj: torch.Tensor  # (F,) int64 factor head (to)
    T_meas: torch.Tensor  # (F, 4, 4) measured X_i⁻¹ X_j
    weight: torch.Tensor  # (F,) >= 0; 0 = empty slot

    @property
    def capacity(self) -> int:
        return self.poses.shape[0]

    @property
    def factor_capacity(self) -> int:
        return self.fi.shape[0]


def create(max_keyframes: int, max_factors: int, dtype=torch.float32,
           device: torch.device | str = "cpu") -> PoseGraph:
    eye = torch.eye(4, dtype=dtype, device=device)
    return PoseGraph(
        poses=eye.expand(max_keyframes, 4, 4).clone(),
        pose_mask=torch.zeros(max_keyframes, dtype=torch.bool, device=device),
        fi=torch.zeros(max_factors, dtype=torch.int64, device=device),
        fj=torch.zeros(max_factors, dtype=torch.int64, device=device),
        T_meas=eye.expand(max_factors, 4, 4).clone(),
        weight=torch.zeros(max_factors, dtype=dtype, device=device),
    )


def from_arrays(poses, factors, max_keyframes: int = 0, max_factors: int = 0,
                dtype=torch.float32, device: torch.device | str = "cpu"
                ) -> PoseGraph:
    """Host-side builder: poses (K, 4, 4); factors a list of
    (i, j, T_meas, w). The capacities grow to the actual counts."""
    k, f = len(poses), len(factors)
    kk, ff = max(max_keyframes, k), max(max_factors, f)
    pz = np.tile(np.eye(4), (kk, 1, 1))
    pz[:k] = np.asarray(poses)
    fi = np.zeros(ff, np.int64)
    fj = np.zeros(ff, np.int64)
    tm = np.tile(np.eye(4), (ff, 1, 1))
    w = np.zeros(ff, np.float64)
    for n, (i, j, T, wt) in enumerate(factors):
        fi[n], fj[n], tm[n], w[n] = i, j, np.asarray(T), wt
    mask = np.zeros(kk, bool)
    mask[:k] = True

    def dev(a, dt=None):
        return torch.as_tensor(a, dtype=dt, device=device)

    return PoseGraph(poses=dev(pz, dtype), pose_mask=dev(mask), fi=dev(fi),
                     fj=dev(fj), T_meas=dev(tm, dtype), weight=dev(w, dtype))


def residuals(g: PoseGraph) -> torch.Tensor:
    """(F, 6) factor residuals log(T_meas⁻¹ X_i⁻¹ X_j)."""
    A = se3.inverse(g.poses[g.fi]) @ g.poses[g.fj]
    return se3.log(se3.inverse(g.T_meas) @ A)


def linearize(g: PoseGraph, huber_delta: float = 0.0):
    """Factor blocks: (r (F, 6), Ji (F, 6, 6), Jj (F, 6, 6), w (F,))."""
    A = se3.inverse(g.poses[g.fi]) @ g.poses[g.fj]
    r = se3.log(se3.inverse(g.T_meas) @ A)
    Jr_inv = se3.right_jacobian_inv(r)
    Ji = -(Jr_inv @ se3.adjoint(se3.inverse(A)))
    w = g.weight
    if huber_delta > 0.0:
        rn = torch.linalg.vector_norm(r, dim=-1)
        w = w * torch.clamp(huber_delta / torch.clamp(rn, min=1e-12),
                            max=1.0)
    return r, Ji, Jr_inv, w


def assemble(g: PoseGraph, r, Ji, Jj, w, damping: float,
             anchor_weight: float):
    """Dense normal equations H (K, K, 6, 6) and g-vector (K, 6).

    Block (a, b) of H sums the blocks of every factor whose (row, column)
    pair is (a, b): with one-hot rows P (4F, K) and columns Q (4F, K) of
    the pairs (i, i), (j, j), (i, j), (j, i), H = Pᵀ · (Q ⊗ blocks)."""
    k = g.capacity
    wJi = Ji * w[:, None, None]
    wJj = Jj * w[:, None, None]
    Hii = torch.einsum("fab,fac->fbc", Ji, wJi)
    Hjj = torch.einsum("fab,fac->fbc", Jj, wJj)
    Hij = torch.einsum("fab,fac->fbc", Ji, wJj)
    blocks = torch.cat([Hii, Hjj, Hij, Hij.transpose(-1, -2)])  # (4F, 6, 6)
    rows = torch.cat([g.fi, g.fj, g.fi, g.fj])
    cols = torch.cat([g.fi, g.fj, g.fj, g.fi])
    eye_k = torch.eye(k, dtype=r.dtype, device=r.device)
    P, Q = eye_k[rows], eye_k[cols]  # (4F, K) one-hot
    QB = (Q[:, :, None] * blocks.reshape(-1, 1, 36)).reshape(len(rows), -1)
    H = (P.T @ QB).reshape(k, k, 6, 6)
    Pi, Pj = eye_k[g.fi], eye_k[g.fj]
    gv = Pi.T @ torch.einsum("fab,fa->fb", wJi, r) \
        + Pj.T @ torch.einsum("fab,fa->fb", wJj, r)

    # gauge anchor: pin pose 0; inactive poses get identity blocks so H
    # stays SPD
    eye6 = torch.eye(6, dtype=r.dtype, device=r.device)
    boost = (~g.pose_mask).to(r.dtype)
    boost[0] += anchor_weight
    diag = damping * eye6 + boost[:, None, None] * eye6  # (K, 6, 6)
    H = H + eye_k[:, :, None, None] * diag[:, None]
    return H, gv


def solve_dense(H: torch.Tensor, gv: torch.Tensor) -> torch.Tensor:
    """(K, K, 6, 6)-blocked H to a dense solve; returns dx (K, 6), zero
    where the factorization fails or the solution is not finite."""
    k = H.shape[0]
    Hd = H.permute(0, 2, 1, 3).reshape(k * 6, k * 6)
    b = -gv.reshape(k * 6, 1)
    L, info = torch.linalg.cholesky_ex(Hd)
    y = torch.linalg.solve_triangular(L, b, upper=False)
    x = torch.linalg.solve_triangular(L.T, y, upper=True)[:, 0]
    ok = (info == 0) & torch.all(torch.isfinite(x))
    return torch.where(ok, x, torch.zeros_like(x)).reshape(k, 6)


def apply_update(g: PoseGraph, dx: torch.Tensor) -> PoseGraph:
    """Right-perturbation X ← X exp(ξ) on active poses (pose 0 anchored)."""
    act = g.pose_mask.clone()
    act[0] = False
    dx = torch.where(act[:, None], dx, torch.zeros_like(dx))
    return dataclasses.replace(g, poses=g.poses @ se3.exp(dx))


def optimize(g: PoseGraph, iters: int = 10, damping: float = 1e-6,
             huber_delta: float = 0.0, anchor_weight: float = 1e6
             ) -> tuple[PoseGraph, torch.Tensor]:
    """Damped GN loop: returns (graph, per-iteration total chi2 (iters,))."""
    chis = []
    for _ in range(iters):
        r, Ji, Jj, w = linearize(g, huber_delta)
        chis.append(torch.sum(w * torch.sum(r * r, dim=-1)))
        H, gv = assemble(g, r, Ji, Jj, w, damping, anchor_weight)
        g = apply_update(g, solve_dense(H, gv))
    if not chis:
        return g, torch.zeros(0, dtype=g.poses.dtype, device=g.poses.device)
    return g, torch.stack(chis)


def _closure_arrays(odo_poses, closures, device):
    odo = torch.as_tensor(np.stack([np.asarray(p) for p in odo_poses]),
                          dtype=torch.float64, device=device)
    ii = np.asarray([c[0] for c in closures])
    jj = np.asarray([c[1] for c in closures])
    T = torch.as_tensor(np.stack([np.asarray(c[2]) for c in closures]),
                        dtype=torch.float64, device=device)
    return odo, ii, jj, T


def closure_cycle_matrix(odo_poses, closures,
                         device: torch.device | str = "cpu") -> np.ndarray:
    """(m, m) PCM cycle norms between all closure pairs.

    cyc[a, b] = ‖log(Ta⁻¹ · odo(i_a→i_b) · Tb · odo(j_b→j_a))‖ — the twist
    norm of the loop formed by two closures and the odometry between their
    endpoints; near zero when both agree with the local odometry."""
    odo, ii, jj, T = _closure_arrays(odo_poses, closures, device)
    Xi, Xj = odo[ii], odo[jj]
    A = torch.einsum("aij,bjk->abik", se3.inverse(Xi), Xi)  # (m, m, 4, 4)
    B = torch.einsum("bij,ajk->abik", se3.inverse(Xj), Xj)
    E = torch.einsum("aij,abjk,bkl,ablm->abim", se3.inverse(T), A, T, B)
    return torch.linalg.vector_norm(se3.log(E), dim=-1).cpu().numpy()


def closure_confidence(odo_poses, closures, suspect_cycle: float = 1.0,
                       device: torch.device | str = "cpu"):
    """Per-closure consistency score + suspect flag: score[a] = median over
    b ≠ a of the PCM cycle norm cyc[a, b]; suspect = score > suspect_cycle.
    Returns (score (m,), suspect (m,) bool); one closure scores nan."""
    m = len(closures)
    if m == 0:
        return np.zeros(0), np.zeros(0, bool)
    if m == 1:
        return np.full(1, np.nan), np.zeros(1, bool)
    cyc = closure_cycle_matrix(odo_poses, closures, device)
    score = np.nanmedian(cyc + np.diag(np.full(m, np.nan)), axis=1)
    return score, score > suspect_cycle


def pairwise_consistent_closures(odo_poses, closures, gamma: float = 0.5,
                                 device: torch.device | str = "cpu"):
    """Simplified PCM (Mangelson et al. 2018): boolean keep-mask of the
    largest mutually consistent closure set, greedy max-clique over the
    drift-aware consistency graph; with no mutual support, the closure
    closest to its odometry prediction."""
    m = len(closures)
    if m <= 1:
        return np.ones(m, bool)
    odo, ii, jj, T = _closure_arrays(odo_poses, closures, device)
    cyc = closure_cycle_matrix(odo_poses, closures, device)
    span = np.abs(ii[:, None] - ii[None, :]) + np.abs(jj[:, None] - jj[None, :])
    ok = cyc < gamma * np.sqrt(1.0 + span)
    ok = ok & ok.T
    np.fill_diagonal(ok, True)
    # greedy clique: seed at the highest-degree node, grow by degree
    keep = np.zeros(m, bool)
    cand = np.ones(m, bool)
    deg = ok.sum(1)
    order = np.argsort(-deg)
    clique: list = []
    for seed in order:
        if not cand[seed]:
            continue
        clique = [seed]
        inset = ok[seed].copy()
        inset[seed] = False
        while inset.any():
            nxt = np.argmax(np.where(inset, deg, -1))
            clique.append(int(nxt))
            inset &= ok[nxt]
            inset[nxt] = False
        break
    if len(clique) <= 1 and m > 1:
        pred = se3.log(se3.inverse(T) @ (se3.inverse(odo[ii]) @ odo[jj]))
        clique = [int(np.argmin(
            torch.linalg.vector_norm(pred, dim=-1).cpu().numpy()))]
    keep[np.asarray(clique, int)] = True
    return keep


def reject_inconsistent_loops(g: PoseGraph, loop_mask, reject_residual: float,
                              iters: int = 10, damping: float = 1e-6,
                              huber_delta: float = 0.0, rounds: int = 2):
    """Residual-gated loop-factor rejection: optimize, zero the weight of
    LOOP factors (loop_mask) whose residual norm at the optimum exceeds
    `reject_residual`, re-optimize; odometry factors are never dropped.
    Returns (kept_weight (F,), n_dropped); one host readback per round."""
    loop_mask = torch.as_tensor(np.asarray(loop_mask), device=g.weight.device)
    weight = g.weight
    n_dropped = 0
    for _ in range(rounds):
        g_opt, _ = optimize(dataclasses.replace(g, weight=weight),
                            iters=iters, damping=damping,
                            huber_delta=huber_delta)
        rn = torch.linalg.vector_norm(
            residuals(dataclasses.replace(g_opt, weight=weight)), dim=-1)
        drop = loop_mask & (rn > reject_residual) & (weight > 0)
        n_new = int(torch.sum(drop))
        if n_new == 0:
            break
        n_dropped += n_new
        weight = torch.where(drop, torch.zeros_like(weight), weight)
    return weight, n_dropped
