"""Plain reference of full SLAM: the semantics of the port's
`Slam3D.run(mode="fused")` (slam/slam3d.py; backend/loop_closure.py's
scan-context detector and batched point-to-point verification;
backend/pose_graph.py's PCM, residual gate and float64 Gauss-Newton) in
plain torch and numpy, over the front end of `reference.odometry`, worked
out from the scans alone.

Written from the port's eager path at slambench/configs/kitti-slam.json's
option values only (`check_config` refuses others). It imports nothing of
the program.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from slambench.reference import lie, odometry
from slambench.reference.nn import Arith, nearest_batched

# the detector's coarse-to-fine verification ICP (LoopDetector's defaults)
COARSE = dict(max_iters=50, max_corr_dist=6.0, huber_delta=1.5,
              min_inliers=30, tol=1e-5)
FINE = dict(COARSE, max_corr_dist=1.5, huber_delta=0.5, max_iters=30)
MAX_RANGE = 60.0


def check_config(cfg) -> None:
    odometry.check_config(cfg)
    b = cfg.backend
    want = {"enabled": True, "closure_dedup_kf": 0, "verify_stride": 1,
            "strain_on_clamp": False, "mesh_shape": [1]}
    got = {"enabled": b.enabled, "closure_dedup_kf": b.closure_dedup_kf,
           "verify_stride": b.verify_stride,
           "strain_on_clamp": b.strain_on_clamp,
           "mesh_shape": list(cfg.dist.mesh_shape)}
    if got != want or b.verify_chunk < b.candidate_topk:
        raise ValueError(f"the plain reference does not implement {got}")


@dataclasses.dataclass
class Closure:
    i: int
    j: int
    T_ij: np.ndarray
    rmse: float
    n_inliers: int
    # every yaw hypothesis's lock that passed the gates, the best first
    locks: np.ndarray | None = None


# ---- descriptors -----------------------------------------------------------

def _div(x: torch.Tensor, c: float) -> torch.Tensor:
    """x / c as a true float32 division."""
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


def scan_context(points, mask, rings, sectors):
    """(rings, sectors) polar image of the max point height per bin."""
    x, y = points[:, 0], points[:, 1]
    r = torch.sqrt(x * x + y * y)
    ring = torch.clamp((_div(r, MAX_RANGE) * rings).to(torch.int32), 0,
                       rings - 1)
    theta = torch.atan2(y, x)
    sector = torch.clamp((_div(theta + math.pi, 2 * math.pi) * sectors).to(
        torch.int32), 0, sectors - 1)
    flat = (ring * sectors + sector).long()
    z = torch.where(mask, points[:, 2], torch.full_like(points[:, 2],
                                                        -math.inf))
    desc = torch.full((rings * sectors,), -math.inf, dtype=points.dtype,
                      device=points.device)
    desc = desc.scatter_reduce(0, flat, z, reduce="amax")
    desc = torch.where(torch.isfinite(desc), desc, torch.zeros_like(desc))
    return desc.reshape(rings, sectors)


def shift_scores(ar: Arith, query, descs):
    """(K, S) column-cosine score of query (R, S) against descs (K, R, S)
    at every circular sector shift."""
    r, s = query.shape
    cols = torch.arange(s, device=query.device)
    shifted = query[:, (cols[None, :] - cols[:, None]) % s].permute(1, 0, 2)
    qcol = torch.linalg.vector_norm(shifted, dim=-2)  # (S, S)
    dcol = torch.linalg.vector_norm(descs, dim=-2)  # (K, S)
    # dots[k, m, c] = sum_r descs[k, r, c] shifted[m, r, c]
    dots = torch.sum(descs[:, None, :, :] * shifted[None], dim=-2)
    denom = dcol[:, None, :] * qcol[None, :, :]
    both = denom > 1e-9
    cos = torch.where(both, dots / torch.clamp(denom, min=1e-9),
                      torch.zeros_like(dots))
    n_both = torch.clamp(torch.sum(both, dim=-1), min=1)
    return torch.sum(cos, dim=-1) / n_both


def _top_k(x, k):
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _rotz(yaws):
    c, s = torch.cos(yaws), torch.sin(yaws)
    T = torch.eye(4, device=yaws.device).expand(*yaws.shape, 4, 4).clone()
    T[..., 0, 0], T[..., 0, 1] = c, -s
    T[..., 1, 0], T[..., 1, 1] = s, c
    return T


# ---- batched point-to-point verification -----------------------------------

def umeyama(ar: Arith, src, dst, weights):
    """Weighted rigid fit (B, 4, 4) with dst ≈ R src + t, SVD with the
    reflection correction."""
    w = weights[..., None]
    wsum = torch.clamp(torch.sum(w, dim=-2, keepdim=True), min=1e-12)
    mu_s = torch.sum(w * src, dim=-2, keepdim=True) / wsum
    mu_d = torch.sum(w * dst, dim=-2, keepdim=True) / wsum
    cov = ar.mm((dst - mu_d).transpose(-1, -2), (src - mu_s) * w) / wsum
    U, _, Vt = torch.linalg.svd(cov)
    sign = torch.sign(torch.linalg.det(U @ Vt))
    d_vec = torch.ones((*sign.shape, 3), dtype=cov.dtype, device=cov.device)
    d_vec[..., -1] = sign
    R = (U * d_vec[..., None, :]) @ Vt
    t = mu_d[..., 0, :] - torch.einsum("...ij,...j->...i", R, mu_s[..., 0, :])
    return lie.from_rt(R, t)


def align_batched(ar: Arith, src, src_mask, dst, T0, group: int, c: dict):
    """Element b aligns src onto dst[b // group] from T0[b]; all step until
    every one has converged or max_iters, each converged one frozen:
    (T, rmse, n_inliers, iters) with a leading (B,)."""
    b = T0.shape[0]
    dev = src.device
    dst_rep = dst.repeat_interleave(group, dim=0)
    mask_f = src_mask.to(torch.float32)
    eye = torch.eye(4, device=dev)
    T = T0.clone()
    rmse = torch.full((b,), math.inf, device=dev)
    n_inl = torch.zeros(b, dtype=torch.int64, device=dev)
    conv = torch.zeros(b, dtype=torch.bool, device=dev)
    iters = torch.zeros(b, dtype=torch.int64, device=dev)
    it = 0
    while it < c["max_iters"] and not (it > 0 and bool(conv.all())):
        cur = src[None] @ T[:, :3, :3].transpose(1, 2) + T[:, None, :3, 3]
        idx = nearest_batched(ar, cur, dst_rep)
        q = torch.gather(dst_rep, 1, idx[..., None].expand(-1, -1, 3))
        diff = cur - q
        d2 = torch.sum(diff * diff, dim=-1)
        w = (d2 <= c["max_corr_dist"] ** 2).to(torch.float32) * mask_f
        dist = torch.sqrt(torch.clamp(d2, min=1e-20))
        w = w * torch.clamp(c["huber_delta"] / dist, max=1.0)
        n_new = torch.sum(w > 0, dim=-1)
        dT = umeyama(ar, cur, q, w)
        dT = torch.where((n_new >= max(c["min_inliers"], 4))[:, None, None],
                         dT, eye)
        T_new = dT @ T
        r_new = torch.sqrt(torch.sum(w * d2, dim=-1)
                           / torch.clamp(torch.sum(w, dim=-1), min=1e-12))
        c_new = torch.abs(rmse - r_new) < c["tol"]
        stop = conv
        T = torch.where(stop[:, None, None], T, T_new)
        rmse = torch.where(stop, rmse, r_new)
        n_inl = torch.where(stop, n_inl, n_new)
        conv = torch.where(stop, conv, c_new)
        iters = iters + (~stop).to(torch.int64)
        it += 1
    return T, rmse, n_inl, iters


class Detector:
    """Keyframe descriptors, gated candidate search and the batched
    coarse-to-fine verification of each keyframe's candidates."""

    def __init__(self, b, ar: Arith, device):
        self.b, self.ar, self.device = b, ar, device
        self.descs: list = []
        self.positions: list = []
        self.verify_iters = 0

    def add_keyframe(self, points, mask, position) -> int:
        self.descs.append(scan_context(points, mask, self.b.descriptor_rings,
                                       self.b.descriptor_sectors))
        self.positions.append(np.asarray(position, np.float32))
        return len(self.descs) - 1

    def candidates(self, q: int) -> list:
        lo = q - self.b.min_loop_separation
        if lo <= 0:
            return []
        descs = torch.stack(self.descs[:lo])
        scores = torch.max(shift_scores(self.ar, self.descs[q], descs),
                           dim=-1)
        pos = torch.as_tensor(np.stack(self.positions[:lo]),
                              device=self.device)
        qpos = torch.as_tensor(self.positions[q], device=self.device)
        dist = torch.linalg.vector_norm(pos - qpos[None, :], dim=-1)
        radius = (self.b.gating_radius if self.b.gating_radius > 0
                  else math.inf)
        s = torch.where(dist <= float(np.float32(radius)), scores.values,
                        torch.full_like(scores.values, -math.inf))
        top_s, top_i = _top_k(s, self.b.candidate_topk)
        top_s = top_s.cpu().numpy()
        return [int(i) for v, i in zip(top_s, top_i.cpu().numpy())
                if np.isfinite(v)]

    def verify(self, q: int, matches: list, qp, qm, mp, T_preds,
               max_devs) -> list:
        b, ar = self.b, self.ar
        n_yaws = b.verify_yaws
        n_desc = (n_yaws + 1) // 2
        rows = shift_scores(ar, self.descs[q],
                            torch.stack([self.descs[m] for m in matches]))
        _, topd = _top_k(rows, n_desc)
        yaw_d = topd.to(torch.float32) * (2 * math.pi / b.descriptor_sectors)
        card = torch.tensor([0.0, math.pi, math.pi / 2, -math.pi / 2],
                            device=self.device)[:n_yaws - n_desc]
        yaws = torch.cat([yaw_d, card.expand(len(matches), -1)], dim=1)
        inits = _rotz(yaws).reshape(-1, 4, 4)
        T, _, _, it_c = align_batched(ar, qp, qm, mp, inits, n_yaws, COARSE)
        T, rmse, n_inl, it_f = align_batched(ar, qp, qm, mp, T, n_yaws, FINE)
        self.verify_iters += int(it_c.max()) + int(it_f.max())
        rmses = rmse.reshape(len(matches), n_yaws).cpu().numpy().astype(
            np.float64)
        inls = n_inl.reshape(len(matches), n_yaws).cpu().numpy()
        Ts = T.reshape(len(matches), n_yaws, 4, 4).cpu().numpy().astype(
            np.float64)
        n_valid = int(qm.sum())
        ok = (rmses <= b.verify_max_rmse) & (inls >= 0.3 * max(n_valid, 1))
        if b.verify_max_dev > 0:
            t_dev = np.linalg.norm(Ts[:, :, :3, 3]
                                   - T_preds[:, None, :3, 3], axis=-1)
            ok &= t_dev <= max_devs[:, None]
        out = []
        for c, m in enumerate(matches):
            if ok[c].any():
                order = np.argsort(np.where(ok[c], rmses[c], np.inf),
                                   kind="stable")[: int(ok[c].sum())]
                best = int(order[0])
                out.append(Closure(i=m, j=q, T_ij=Ts[c, best],
                                   rmse=float(rmses[c, best]),
                                   n_inliers=int(inls[c, best]),
                                   locks=Ts[c, order]))
        return out

    def keyframe(self, q, pts, msk, kf_frames, kf_poses, pose) -> list:
        matches = self.candidates(q)
        if not matches:
            return []
        b = self.b
        T_preds = np.stack([np.linalg.inv(kf_poses[m]) @ pose
                            for m in matches])
        max_devs = np.full(len(matches), b.verify_max_dev)
        if b.verify_drift_rate > 0:
            t_kf = np.asarray([np.asarray(p)[:3, 3] for p in kf_poses])
            cum = np.concatenate([[0.0], np.cumsum(np.linalg.norm(
                np.diff(t_kf, axis=0), axis=1))])
            max_devs = np.asarray([max(b.verify_max_dev, b.verify_drift_rate
                                       * abs(cum[q] - cum[m]))
                                   for m in matches])
        mp = torch.stack([pts[kf_frames[m]] for m in matches])
        return self.verify(q, matches, pts[kf_frames[q]], msk[kf_frames[q]],
                           mp, T_preds, max_devs)


# ---- pose graph (float64) --------------------------------------------------

def _graph(kf_poses, factors, max_k, max_f, device):
    k, f = len(kf_poses), len(factors)
    kk, ff = max(max_k, k), max(max_f, f)
    pz = np.tile(np.eye(4), (kk, 1, 1))
    pz[:k] = np.asarray(kf_poses)
    fi, fj = np.zeros(ff, np.int64), np.zeros(ff, np.int64)
    tm = np.tile(np.eye(4), (ff, 1, 1))
    w = np.zeros(ff)
    for n, (i, j, T, wt) in enumerate(factors):
        fi[n], fj[n], tm[n], w[n] = i, j, T, wt
    mask = np.zeros(kk, bool)
    mask[:k] = True

    def dev(a, dt=None):
        return torch.as_tensor(a, dtype=dt, device=device)

    return {"poses": dev(pz, torch.float64), "mask": dev(mask),
            "fi": dev(fi), "fj": dev(fj), "T_meas": dev(tm, torch.float64),
            "weight": dev(w, torch.float64)}


def _residuals(g):
    A = lie.inverse(g["poses"][g["fi"]]) @ g["poses"][g["fj"]]
    return lie.log(lie.inverse(g["T_meas"]) @ A)


def _optimize(g, iters, damping, huber, anchor_weight=1e6):
    g = dict(g)
    k = g["poses"].shape[0]
    for _ in range(iters):
        A = lie.inverse(g["poses"][g["fi"]]) @ g["poses"][g["fj"]]
        r = lie.log(lie.inverse(g["T_meas"]) @ A)
        Jj = lie.right_jacobian_inv(r)
        Ji = -(Jj @ lie.adjoint(lie.inverse(A)))
        w = g["weight"]
        if huber > 0.0:
            rn = torch.linalg.vector_norm(r, dim=-1)
            w = w * torch.clamp(huber / torch.clamp(rn, min=1e-12), max=1.0)
        wJi, wJj = Ji * w[:, None, None], Jj * w[:, None, None]
        # dense assembly by one-hot products (fixed summation order)
        eye_k = torch.eye(k, dtype=r.dtype, device=r.device)
        Hii = torch.einsum("fab,fac->fbc", Ji, wJi)
        Hjj = torch.einsum("fab,fac->fbc", Jj, wJj)
        Hij = torch.einsum("fab,fac->fbc", Ji, wJj)
        blocks = torch.cat([Hii, Hjj, Hij, Hij.transpose(-1, -2)])
        rows = torch.cat([g["fi"], g["fj"], g["fi"], g["fj"]])
        cols = torch.cat([g["fi"], g["fj"], g["fj"], g["fi"]])
        P, Q = eye_k[rows], eye_k[cols]
        QB = (Q[:, :, None] * blocks.reshape(-1, 1, 36)).reshape(len(rows), -1)
        Hb = (P.T @ QB).reshape(k, k, 6, 6)
        gv = eye_k[g["fi"]].T @ torch.einsum("fab,fa->fb", wJi, r) \
            + eye_k[g["fj"]].T @ torch.einsum("fab,fa->fb", wJj, r)
        eye6 = torch.eye(6, dtype=r.dtype, device=r.device)
        boost = (~g["mask"]).to(r.dtype)
        boost[0] += anchor_weight
        Hb = Hb + eye_k[:, :, None, None] * (
            damping * eye6 + boost[:, None, None] * eye6)[:, None]
        Hd = Hb.permute(0, 2, 1, 3).reshape(k * 6, k * 6)
        L, info = torch.linalg.cholesky_ex(Hd)
        y = torch.linalg.solve_triangular(L, -gv.reshape(k * 6, 1),
                                          upper=False)
        dx = torch.linalg.solve_triangular(L.T, y, upper=True)[:, 0]
        ok = (info == 0) & torch.all(torch.isfinite(dx))
        dx = torch.where(ok, dx, torch.zeros_like(dx)).reshape(k, 6)
        act = g["mask"].clone()
        act[0] = False
        dx = torch.where(act[:, None], dx, torch.zeros_like(dx))
        g["poses"] = g["poses"] @ lie.exp(dx)
    return g


def _cycles(odo, ii, jj, T):
    """(m, m) PCM cycle norms between closure pairs (float64)."""
    Xi, Xj = odo[ii], odo[jj]
    A = torch.einsum("aij,bjk->abik", lie.inverse(Xi), Xi)
    B = torch.einsum("bij,ajk->abik", lie.inverse(Xj), Xj)
    E = torch.einsum("aij,abjk,bkl,ablm->abim", lie.inverse(T), A, T, B)
    return torch.linalg.vector_norm(lie.log(E), dim=-1).cpu().numpy()


def consistent_closures(kf_poses, closures, gamma, device) -> np.ndarray:
    """Greedy max-clique pairwise consistency (PCM): the keep-mask."""
    m = len(closures)
    if m <= 1:
        return np.ones(m, bool)
    odo = torch.as_tensor(np.stack(kf_poses), dtype=torch.float64,
                          device=device)
    ii = np.asarray([c.i for c in closures])
    jj = np.asarray([c.j for c in closures])
    T = torch.as_tensor(np.stack([c.T_ij for c in closures]),
                        dtype=torch.float64, device=device)
    cyc = _cycles(odo, ii, jj, T)
    span = np.abs(ii[:, None] - ii[None, :]) + np.abs(jj[:, None]
                                                      - jj[None, :])
    ok = cyc < gamma * np.sqrt(1.0 + span)
    ok = ok & ok.T
    np.fill_diagonal(ok, True)
    deg = ok.sum(1)
    seed = int(np.argsort(-deg)[0])
    clique = [seed]
    inset = ok[seed].copy()
    inset[seed] = False
    while inset.any():
        nxt = int(np.argmax(np.where(inset, deg, -1)))
        clique.append(nxt)
        inset &= ok[nxt]
        inset[nxt] = False
    if len(clique) <= 1:
        pred = lie.log(lie.inverse(T) @ (lie.inverse(odo[ii]) @ odo[jj]))
        clique = [int(np.argmin(torch.linalg.vector_norm(
            pred, dim=-1).cpu().numpy()))]
    keep = np.zeros(m, bool)
    keep[np.asarray(clique, int)] = True
    return keep


def _strain(cfg, iters, converged) -> list:
    """Per frame from 0: whether the front end's ICP hit its cap without
    converging (the odometry factors' weights)."""
    return [False] + list((np.asarray(iters) >= cfg.icp.max_iters)
                          & ~np.asarray(converged, bool))


def _odometry_factors(b, kf_poses, kf_frames, strain) -> list:
    factors = []
    for k in range(1, len(kf_poses)):
        rel = np.linalg.inv(kf_poses[k - 1]) @ kf_poses[k]
        w = 1.0
        if b.odom_strain_penalty > 0:
            n_str = sum(strain[kf_frames[k - 1] + 1: kf_frames[k] + 1])
            w = 1.0 / (1.0 + b.odom_strain_penalty * n_str)
        factors.append((k - 1, k, rel, w))
    return factors


def _graph_of(b, kf_poses, kf_frames, strain, closures, device):
    factors = _odometry_factors(b, kf_poses, kf_frames, strain)
    factors += [(c.i, c.j, c.T_ij, 2.0) for c in closures]
    return _graph(kf_poses, factors,
                  min(max(len(kf_poses), 2), b.max_keyframes),
                  min(max(len(factors), 2), b.max_factors), device)


def select(b, kf_poses, kf_frames, strain, closures, device) -> list:
    """The verified closures the pose graph takes: pairwise consistency
    (PCM), then the residual gate (closures whose residual after a solve
    exceeds reject_residual drop, twice at most)."""
    if not closures:
        return []
    if b.pcm_gamma > 0 and len(closures) > 1:
        keep = consistent_closures(kf_poses, closures, b.pcm_gamma, device)
        closures = [c for c, k in zip(closures, keep) if k]
    if b.reject_residual <= 0:
        return closures
    g = _graph_of(b, kf_poses, kf_frames, strain, closures, device)
    n_odo = len(kf_poses) - 1
    loop = np.zeros(g["weight"].shape[0], bool)
    loop[n_odo: n_odo + len(closures)] = True
    loop = torch.as_tensor(loop, device=device)
    weight = g["weight"]
    for _ in range(2):
        g_opt = _optimize(dict(g, weight=weight), b.pg_iters, b.pg_damping,
                          b.huber_delta)
        rn = torch.linalg.vector_norm(_residuals(dict(g_opt, weight=weight)),
                                      dim=-1)
        drop = loop & (rn > b.reject_residual) & (weight > 0)
        if int(torch.sum(drop)) == 0:
            break
        weight = torch.where(drop, torch.zeros_like(weight), weight)
    kept = weight.cpu().numpy()
    return [c for k, c in enumerate(closures) if kept[n_odo + k] > 0]


def solve(b, kf_poses, kf_frames, strain, closures, poses, anchor, device):
    """The pose graph over the keyframes (odometry chain and the closures)
    in float64, and each frame moved rigidly with its anchor keyframe."""
    if not closures:
        return poses
    g = _optimize(_graph_of(b, kf_poses, kf_frames, strain, closures,
                            device), b.pg_iters, b.pg_damping, b.huber_delta)
    kf_opt = g["poses"].cpu().numpy()[: len(kf_poses)]
    return np.stack([kf_opt[a] @ (np.linalg.inv(kf_poses[a]) @ poses[f])
                     for f, a in enumerate(anchor)])


def run(cfg_dict: dict, points, mask, device, precision: str = "float32",
        forced=None, kf_frames=None, backend=None):
    """Full SLAM over a log from frame 0, on `device`: {poses (F, 4, 4),
    frontend_poses (F, 4, 4), rmse, is_keyframe, map_inserted, kf_frames,
    verified [Closure], kept [Closure], closures [(i, j)] (kept),
    verify_iters}.

    Followed, each stage starts from the program's output of the stage
    before it and is judged by itself. `forced`, the program's front end
    (poses (F, 4, 4), is_keyframe (F - 1,), map_inserted (F - 1,)): the
    front end follows it frame by frame (`odometry.run(forced=...)`:
    frontend_poses are its own poses of each frame), and the backend's
    keyframe positions and odometry gates are the program's poses;
    `kf_frames`, the program's keyframes, stand in for the reference's
    own keyframe decisions (`own_kf_frames` in the result), so that one
    keyframe decided on the other side of a threshold does not renumber
    every later closure. The loop verification is the reference's own on
    those keyframes (`verified`, `verify_iters`). `backend`, the
    program's {"verified": [(i, j, T_ij)], "kept": [(i, j)], "iters",
    "converged"}: the selection (`select`: PCM and the residual gate)
    runs on the program's verified closures, and the pose graph
    (`solve`) on the program's kept ones, with the odometry factors'
    strain from the program's iters and converged."""
    cfg = odometry.namespace(cfg_dict)
    check_config(cfg)
    b = cfg.backend
    ar = Arith(precision)
    pts = torch.as_tensor(points, dtype=torch.float32, device=device)
    msk = torch.as_tensor(mask, dtype=torch.bool, device=device)
    det = Detector(b, ar, device)
    with ar.scope():
        infos = odometry.run(cfg_dict, pts, msk, device, precision, forced
                             and (forced[0][1:], forced[1], forced[2]))
        own = np.concatenate([np.eye(4)[None],
                              infos["pose"].astype(np.float64)])
        traj = own if forced is None else np.asarray(forced[0], np.float64)
        own_kf = [0] + [f for f in range(1, len(pts))
                        if infos["is_keyframe"][f - 1]]
        is_kf = set(own_kf if kf_frames is None else kf_frames)
        kf_frames, kf_poses, anchor = [0], [np.eye(4)], [0]
        det.add_keyframe(pts[0], msk[0], np.zeros(3))
        verified: list = []
        for f in range(1, len(pts)):
            if f in is_kf:
                q = det.add_keyframe(pts[f], msk[f], traj[f][:3, 3])
                kf_frames.append(f)
                kf_poses.append(traj[f])
                verified += det.keyframe(q, pts, msk, kf_frames, kf_poses,
                                         traj[f])
            anchor.append(len(kf_frames) - 1)
        if backend is None:
            strain = _strain(cfg, infos["iters"], infos["converged"])
            kept = select(b, kf_poses, kf_frames, strain, verified, device)
            graph_closures = kept
        else:
            strain = _strain(cfg, backend["iters"], backend["converged"])
            theirs = [Closure(i=i, j=j, T_ij=np.asarray(T, np.float64),
                              rmse=0.0, n_inliers=0)
                      for i, j, T in backend["verified"]]
            kept = select(b, kf_poses, kf_frames, strain, theirs, device)
            want = set(map(tuple, backend["kept"]))
            graph_closures = [c for c in theirs if (c.i, c.j) in want]
        poses = solve(b, kf_poses, kf_frames, strain, graph_closures, traj,
                      anchor, device)
    return {"frontend_poses": own, "poses": poses, "own_kf_frames": own_kf,
            "rmse": infos["rmse"], "is_keyframe": infos["is_keyframe"],
            "map_inserted": infos["map_inserted"], "kf_frames": kf_frames,
            "verified": verified, "kept": kept,
            "closures": sorted((c.i, c.j) for c in kept),
            "verify_iters": det.verify_iters}
