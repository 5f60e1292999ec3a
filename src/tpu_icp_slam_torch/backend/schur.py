"""Distributed Schur-complement pose-graph solve (port of
tpu_icp_slam/backend/schur.py).

BASELINE.json config 5: keyframes partition into contiguous blocks, one per
rank of the mesh's "graph" axis. Each rank linearizes only its own factors,
eliminates its *interior* poses (those touched by no cross-block factor)
with a local dense Cholesky, and contributes a Schur complement onto the
shared *separator* poses (endpoints of cross-block factors, and pose 0).
One all-reduce over the graph group sums the separator system; every rank
solves the same small reduced system (it stays replicated, no broadcast),
back-substitutes its interior update locally, and a second all-reduce
assembles the (K, 6) update.

Graph *structure* (partition, separator set) is host numpy per call
(`make_plan`, the reference's own); the numeric work runs on the rank's
device in the graph's dtype (float64 in Slam3D, as the dense solve).

Block routing uses dummy slots: every factor contribution is scatter-added
(`index_put_(..., accumulate=True)` on 2-D index pairs) into H_II, H_IS and
H_SS with effective indices that fall on a dummy row/column unless the
endpoint kinds match that matrix.

The reference caches one jit per partition shape (`_compiled_step`); torch
compiles nothing, so the port has no cache. A failed Cholesky gives a zero
step, as the port's dense solve does (the reference's would be NaN).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpu_icp_slam_torch.backend import pose_graph as pg
from tpu_icp_slam_torch.core import se3
from tpu_icp_slam_torch.dist.mesh import Mesh, all_reduce


@dataclasses.dataclass
class SchurPlan:
    """Host-computed static partition of a PoseGraph (all numpy)."""

    n_blocks: int
    n_active: int  # active pose count
    separator: np.ndarray  # (Ns,) global pose ids
    interior: np.ndarray  # (B, Ni_max) global pose ids, -1 padded
    fidx: np.ndarray  # (B, Fb_max) factor ids, -1 padded
    i_kind: np.ndarray  # (B, Fb_max) 0=interior, 1=separator
    i_slot: np.ndarray  # (B, Fb_max) slot in interior (local) or separator list
    j_kind: np.ndarray
    j_slot: np.ndarray
    block_of_pose: np.ndarray  # (K,)


def _np(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def make_plan(fi, fj, weight, pose_mask, n_blocks: int) -> SchurPlan:
    """Partition active poses into contiguous blocks; separators = endpoints
    of cross-block factors plus pose 0 (the gauge anchor)."""
    fi = _np(fi)
    fj = _np(fj)
    w = _np(weight)
    mask = _np(pose_mask)
    k = mask.shape[0]
    active = np.flatnonzero(mask)
    n_active = len(active)
    # contiguous ranges over the active poses
    bounds = np.linspace(0, n_active, n_blocks + 1).astype(int)
    block_of_rank = np.zeros(n_active, np.int32)
    for b in range(n_blocks):
        block_of_rank[bounds[b]:bounds[b + 1]] = b
    rank_of_pose = np.full(k, -1, np.int64)
    rank_of_pose[active] = np.arange(n_active)
    block_of_pose = np.full(k, -1, np.int32)
    block_of_pose[active] = block_of_rank

    live = w > 0
    cross = live & (block_of_pose[fi] != block_of_pose[fj])
    sep_ids = np.unique(
        np.concatenate([fi[cross], fj[cross], [0] if mask[0] else []])
    ).astype(np.int64)
    is_sep = np.zeros(k, bool)
    is_sep[sep_ids] = True

    # interior lists per block
    interiors = []
    for b in range(n_blocks):
        ids = active[(block_of_rank == b) & ~is_sep[active]]
        interiors.append(ids)
    ni_max = max(1, max(len(x) for x in interiors))
    interior = np.full((n_blocks, ni_max), -1, np.int64)
    for b, ids in enumerate(interiors):
        interior[b, : len(ids)] = ids

    # factor assignment: to the block of endpoint i (cross factors touch only
    # separators, so any owner is correct)
    owner = np.where(live, block_of_pose[fi], 0)
    fidx_lists = [np.flatnonzero(live & (owner == b)) for b in range(n_blocks)]
    fb_max = max(1, max(len(x) for x in fidx_lists))
    fidx = np.full((n_blocks, fb_max), -1, np.int64)
    for b, ids in enumerate(fidx_lists):
        fidx[b, : len(ids)] = ids

    # endpoint routing tables
    sep_slot = np.full(k, -1, np.int64)
    sep_slot[sep_ids] = np.arange(len(sep_ids))
    int_slot = np.full(k, -1, np.int64)
    for b, ids in enumerate(interiors):
        int_slot[ids] = np.arange(len(ids))

    def route(pid_arr, valid):
        kind = np.where(is_sep[pid_arr], 1, 0).astype(np.int32)
        slot = np.where(is_sep[pid_arr], sep_slot[pid_arr], int_slot[pid_arr])
        slot = np.where(valid, slot, 0).astype(np.int32)
        kind = np.where(valid, kind, 0).astype(np.int32)
        return kind, slot

    valid = fidx >= 0
    fid_safe = np.where(valid, fidx, 0)
    i_kind, i_slot = route(fi[fid_safe], valid)
    j_kind, j_slot = route(fj[fid_safe], valid)
    return SchurPlan(
        n_blocks=n_blocks,
        n_active=n_active,
        separator=sep_ids,
        interior=interior,
        fidx=fidx,
        i_kind=i_kind,
        i_slot=i_slot,
        j_kind=j_kind,
        j_slot=j_slot,
        block_of_pose=block_of_pose,
    )


def _chol_solve(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x with L Lᵀ x = b."""
    y = torch.linalg.solve_triangular(L, b, upper=False)
    return torch.linalg.solve_triangular(L.T, y, upper=True)


def _gn_step_distributed(poses, fi, fj, T_meas, weight, block, *, ni, ns,
                         huber_delta, damping, anchor_weight, mesh, axis):
    """One distributed GN step from this rank's block: returns the
    replicated dx (K, 6). `block` is (interior (Ni,), fidx (Fb,), i_kind,
    i_slot, j_kind, j_slot (Fb,), separator ids (Ns,)) on the device."""
    k = poses.shape[0]
    dtype, dev = poses.dtype, poses.device
    interior_b, fidx_b, ik, isl, jk, jsl, sep_ids = block
    fvalid = fidx_b >= 0
    f_safe = torch.where(fvalid, fidx_b, 0)

    # linearize local factors against the replicated poses
    Xi = poses[fi[f_safe]]
    Xj = poses[fj[f_safe]]
    A = se3.inverse(Xi) @ Xj
    E = se3.inverse(T_meas[f_safe]) @ A
    r = se3.log(E)
    Jr_inv = se3.right_jacobian_inv(r)
    Jj = Jr_inv
    Ji = -(Jr_inv @ se3.adjoint(se3.inverse(A)))
    w = weight[f_safe] * fvalid.to(dtype)
    if huber_delta > 0.0:
        rn = torch.linalg.vector_norm(r, dim=-1)
        w = w * torch.clamp(huber_delta / torch.clamp(rn, min=1e-12), max=1.0)

    wJi = Ji * w[:, None, None]
    wJj = Jj * w[:, None, None]
    Hii = torch.einsum("fab,fac->fbc", Ji, wJi)
    Hjj = torch.einsum("fab,fac->fbc", Jj, wJj)
    Hij = torch.einsum("fab,fac->fbc", Ji, wJj)
    Hji = Hij.transpose(-1, -2)
    gi = torch.einsum("fab,fa->fb", wJi, r)
    gj = torch.einsum("fab,fa->fb", wJj, r)

    # dummy-slot routing: interior index ni / separator index ns absorb
    # the other kind
    ii = torch.where(ik == 0, isl, ni)
    si = torch.where(ik == 1, isl, ns)
    ij = torch.where(jk == 0, jsl, ni)
    sj = torch.where(jk == 1, jsl, ns)

    H_II = torch.zeros((ni + 1, ni + 1, 6, 6), dtype=dtype, device=dev)
    H_IS = torch.zeros((ni + 1, ns + 1, 6, 6), dtype=dtype, device=dev)
    H_SS = torch.zeros((ns + 1, ns + 1, 6, 6), dtype=dtype, device=dev)
    g_I = torch.zeros((ni + 1, 6), dtype=dtype, device=dev)
    g_S = torch.zeros((ns + 1, 6), dtype=dtype, device=dev)
    for M, rows, cols, vals in (
            (H_II, ii, ii, Hii), (H_SS, si, si, Hii),  # (i, i) blocks
            (H_II, ij, ij, Hjj), (H_SS, sj, sj, Hjj),  # (j, j)
            (H_II, ii, ij, Hij), (H_II, ij, ii, Hji),  # (i, j) by kind pair
            (H_IS, ii, sj, Hij), (H_IS, ij, si, Hji),
            (H_SS, si, sj, Hij), (H_SS, sj, si, Hji)):
        M.index_put_((rows.long(), cols.long()), vals, accumulate=True)
    for v, rows, vals in ((g_I, ii, gi), (g_S, si, gi), (g_I, ij, gj),
                          (g_S, sj, gj)):
        v.index_put_((rows.long(),), vals, accumulate=True)

    # interior diagonal regularization for poses owned by this block;
    # dummy/padded interior slots get identity so the Cholesky is SPD
    int_valid = interior_b >= 0
    int_safe = torch.where(int_valid, interior_b, 0)
    eye6 = torch.eye(6, dtype=dtype, device=dev)
    zero = torch.zeros((), dtype=dtype, device=dev)
    int_boost = torch.where(int_valid, zero + damping, zero + 1.0)
    # pose 0 anchor if it happens to be interior (it is a separator by
    # construction, but stay safe)
    int_boost = int_boost + torch.where(int_valid & (int_safe == 0),
                                        zero + anchor_weight, zero)
    diag = torch.arange(ni, device=dev)
    H_II[diag, diag] += int_boost[:ni, None, None] * eye6
    # strip dummies, flatten to matrices
    Hii_m = H_II[:ni, :ni].permute(0, 2, 1, 3).reshape(ni * 6, ni * 6)
    His_m = H_IS[:ni, :ns].permute(0, 2, 1, 3).reshape(ni * 6, ns * 6)
    Hss_m = H_SS[:ns, :ns].permute(0, 2, 1, 3).reshape(ns * 6, ns * 6)
    gI_v = g_I[:ni].reshape(ni * 6)
    gS_v = g_S[:ns].reshape(ns * 6)

    # eliminate interiors: S = Hss - Hsi Hii^-1 His ; rhs = gS - Hsi Hii^-1 gI
    L, info = torch.linalg.cholesky_ex(Hii_m)
    X = _chol_solve(L, torch.cat([His_m, gI_v[:, None]], dim=1))
    Xh, xg = X[:, :-1], X[:, -1]
    S_b = Hss_m - His_m.T @ Xh
    rhs_b = gS_v - His_m.T @ xg

    # reduce the separator system across blocks: one all-reduce of [S | rhs]
    red = all_reduce(torch.cat([S_b, rhs_b[:, None]], dim=1), mesh, axis)
    S_tot, rhs_tot = red[:, :-1], red[:, -1]
    # separator regularization + anchor (added once: identical on all blocks)
    sep_boost = damping + torch.where(sep_ids == 0, zero + anchor_weight,
                                      zero)
    S_tot = S_tot + torch.diag(torch.repeat_interleave(sep_boost, 6))
    Ls, info_s = torch.linalg.cholesky_ex(S_tot)
    dx_S = _chol_solve(Ls, -rhs_tot[:, None])[:, 0]

    # back-substitute interiors: dx_I = -Hii^-1 (gI + His dx_S)
    dx_I = _chol_solve(L, -(gI_v + His_m @ dx_S)[:, None])[:, 0]

    # scatter into a (K, 6) update: interiors owned here + separators / B
    nb = mesh.shape[axis]
    dx = torch.zeros((k, 6), dtype=dtype, device=dev)
    dx.index_put_((int_safe,), torch.where(int_valid[:, None],
                                           dx_I.reshape(ni, 6), zero),
                  accumulate=True)
    dx.index_put_((sep_ids,), dx_S.reshape(ns, 6) / nb, accumulate=True)
    dx = all_reduce(dx, mesh, axis)
    ok = (info == 0) & (info_s == 0) & torch.all(torch.isfinite(dx))
    return torch.where(ok, dx, torch.zeros_like(dx))


def optimize_distributed(
    g: "pg.PoseGraph",
    mesh: Mesh,
    axis: str = "graph",
    iters: int = 10,
    damping: float = 1e-6,
    huber_delta: float = 0.0,
    anchor_weight: float = 1e6,
):
    """Distributed-Schur GN over mesh[axis] blocks, this rank solving the
    block of its coordinate; mirrors pg.optimize: returns (graph,
    per-iteration total chi2 (iters,)), the same on every rank."""
    n_blocks = mesh.shape[axis]
    b = mesh.index(axis)
    plan = make_plan(g.fi, g.fj, g.weight, g.pose_mask, n_blocks)
    ni = plan.interior.shape[1]
    ns = len(plan.separator)
    dev = g.poses.device

    def t(a):
        return torch.as_tensor(np.asarray(a, np.int64), device=dev)

    block = (t(plan.interior[b]), t(plan.fidx[b]), t(plan.i_kind[b]),
             t(plan.i_slot[b]), t(plan.j_kind[b]), t(plan.j_slot[b]),
             t(plan.separator))
    graph = g
    chis = []
    for _ in range(iters):
        r, _, _, w = pg.linearize(graph, huber_delta)
        chis.append(torch.sum(w * torch.sum(r * r, dim=-1)))
        dx = _gn_step_distributed(
            graph.poses, graph.fi, graph.fj, graph.T_meas, graph.weight,
            block, ni=ni, ns=ns, huber_delta=huber_delta, damping=damping,
            anchor_weight=anchor_weight, mesh=mesh, axis=axis)
        graph = pg.apply_update(graph, dx)
    if not chis:
        return graph, torch.zeros(0, dtype=g.poses.dtype, device=dev)
    return graph, torch.stack(chis)
