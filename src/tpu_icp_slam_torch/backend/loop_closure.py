"""Loop-closure detection (port of tpu_icp_slam/backend/loop_closure.py).

Scan-context descriptors: each keyframe scan becomes a (rings × sectors)
polar image whose cells hold the max point height in that (range, azimuth)
bin, so yaw shifts the sector axis and matching under yaw is a max over
circular shifts of a column-cosine score. Candidates are gated by keyframe
separation and odometry position on the device, then verified
geometrically by coarse-to-fine point-to-point ICP over (candidates × yaw
hypotheses) in one batched loop (`icp.loop.align_batched`, whose NN is K1's
batched form on CUDA). Scans are 3D (SE(3) verification) or 2D (SE(2),
Slam2D's keyframes: batched K1 on 2-D points).

Parity notes against the reference: `.at[flat].max` is a `scatter_reduce`
("amax") from -inf, floored to 0; `astype(int32)` truncates toward zero, as
`.to(torch.int32)` does; `lax.top_k` breaks ties toward the lower index, so
the top-k here is a stable descending sort. float32 `arctan2` and `cos`/
`sin` may round differently from XLA's, which can move a point across a
sector edge or nudge a yaw initialization by an ulp.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from tpu_icp_slam_torch.config import BackendConfig, ICPConfig
from tpu_icp_slam_torch.core.pointcloud import PointCloud
from tpu_icp_slam_torch.icp.loop import ICPResult, align_batched
from tpu_icp_slam_torch.obs.profile import span


def _div(x: torch.Tensor, c: float) -> torch.Tensor:
    """x / c with a true float32 division on every device (CUDA divides by
    a host scalar as a multiplication by its reciprocal)."""
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


def scan_context(points: torch.Tensor, mask: torch.Tensor, rings: int = 20,
                 sectors: int = 60, max_range: float = 60.0) -> torch.Tensor:
    """Sensor-frame scan -> (rings, sectors) polar descriptor: max point
    height per (range, azimuth) bin for 3D scans (N, 3), occupancy count per
    bin for 2D scans (N, 2)."""
    x, y = points[:, 0], points[:, 1]
    r = torch.sqrt(x * x + y * y)
    ring = torch.clamp((_div(r, max_range) * rings).to(torch.int32), 0,
                       rings - 1)
    theta = torch.atan2(y, x)  # [-pi, pi)
    sector = torch.clamp(
        (_div(theta + math.pi, 2 * math.pi) * sectors).to(torch.int32), 0,
        sectors - 1)
    flat = (ring * sectors + sector).long()
    if points.shape[1] >= 3:
        # max height per bin; invalid points write -inf (then floored to 0)
        zval = torch.where(mask, points[:, 2],
                           torch.full_like(points[:, 2], -math.inf))
        desc = torch.full((rings * sectors,), -math.inf, dtype=points.dtype,
                          device=points.device)
        desc = desc.scatter_reduce(0, flat, zval, reduce="amax")
        desc = torch.where(torch.isfinite(desc), desc, torch.zeros_like(desc))
    else:
        desc = torch.zeros(rings * sectors, dtype=points.dtype,
                           device=points.device)
        desc = desc.index_add(0, flat, mask.to(points.dtype))
    return desc.reshape(rings, sectors)


def shift_score_matrix(query: torch.Tensor, descs: torch.Tensor
                       ) -> torch.Tensor:
    """(K, S) column-cosine score of `query` (R, S) against descs (K, R, S)
    at every circular sector shift."""
    s = query.shape[-1]
    cols = torch.arange(s, device=query.device)
    # shifted[m, :, c] = query[:, (c - m) mod S], i.e. roll by m
    shifted = query[:, (cols[None, :] - cols[:, None]) % s].permute(1, 0, 2)
    qcol = torch.linalg.vector_norm(shifted, dim=-2)  # (S, S)
    dcol = torch.linalg.vector_norm(descs, dim=-2)  # (K, S)
    dots = torch.einsum("krs,mrs->kms", descs, shifted)
    denom = dcol[:, None, :] * qcol[None, :, :]
    both = denom > 1e-9
    cos = torch.where(both, dots / torch.clamp(denom, min=1e-9),
                      torch.zeros_like(dots))
    n_both = torch.clamp(torch.sum(both, dim=-1), min=1)
    return torch.sum(cos, dim=-1) / n_both  # (K, S)


def shift_match_scores(query: torch.Tensor, descs: torch.Tensor):
    """Yaw-invariant similarity of `query` (R, S) against descs (K, R, S):
    (scores (K,), best_shift (K,) int32); shift s means the candidate is
    rotated by s·2π/S relative to the query."""
    best, shift = torch.max(shift_score_matrix(query, descs), dim=-1)
    return best, shift.to(torch.int32)


def _top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """lax.top_k over the last axis: ties toward the lower index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _gated_candidate_scores(query, descs, positions, qpos, lo: int,
                            gating_radius: float, topk: int):
    """Candidate search over the whole device store: shift-invariant scores,
    then the age gate (only keyframes [0, lo)) and the odometry-position gate
    (NaN positions pass) on the device; returns the top-k (scores, shifts,
    indices)."""
    scores, shifts = shift_match_scores(query, descs)
    cap = descs.shape[0]
    valid = torch.arange(cap, device=descs.device) < lo
    dist = torch.linalg.vector_norm(positions - qpos[None, :], dim=-1)
    gate = torch.where(torch.isnan(dist), torch.ones_like(valid),
                       dist <= gating_radius)
    scores = torch.where(valid & gate, scores,
                         torch.full_like(scores, -math.inf))
    top_s, top_i = _top_k(scores, topk)
    return top_s, shifts[top_i], top_i


def _rotz(yaws: torch.Tensor, dim: int = 3) -> torch.Tensor:
    """(...,) float32 yaws -> (..., D+1, D+1) rotations about z (in the
    plane for D = 2)."""
    c, s = torch.cos(yaws), torch.sin(yaws)
    T = torch.eye(dim + 1, dtype=torch.float32, device=yaws.device).expand(
        *yaws.shape, dim + 1, dim + 1).clone()
    T[..., 0, 0], T[..., 0, 1] = c, -s
    T[..., 1, 0], T[..., 1, 1] = s, c
    return T


def _batched_verify(query_points, query_mask, match_points, match_mask,
                    query_desc, match_descs, *, cfg_coarse: ICPConfig,
                    cfg_fine: ICPConfig, sectors: int, n_yaws: int = 8):
    """(candidates × yaw hypotheses) coarse-to-fine verification.

    Yaw hypotheses per candidate: the top ceil(Y/2) descriptor shifts plus
    (Y − that) cardinal yaws. The C·Y alignments run as one batch (the
    reference's nested vmap), each candidate's scan serving its Y rows.
    Returns (ICPResult with leading (C, Y), batched iterations run)."""
    n_desc = (n_yaws + 1) // 2
    n_card = n_yaws - n_desc
    rows = shift_score_matrix(query_desc, match_descs)  # (C, S)
    _, topd = _top_k(rows, n_desc)
    yaw_d = topd.to(torch.float32) * (2 * math.pi / sectors)
    cardinals = torch.zeros(4, dtype=torch.float32, device=rows.device)
    cardinals[1], cardinals[2], cardinals[3] = math.pi, math.pi / 2, \
        -math.pi / 2
    yaws = torch.cat([yaw_d, cardinals[:n_card].expand(rows.shape[0],
                                                       n_card)], dim=1)
    c, d = yaws.shape[0], query_points.shape[-1]
    inits = _rotz(yaws, d).reshape(c * n_yaws, d + 1, d + 1)
    src = PointCloud(points=query_points, mask=query_mask)
    coarse = align_batched(src, match_points, match_mask, inits, cfg_coarse)
    fine = align_batched(src, match_points, match_mask, coarse.T, cfg_fine)
    n_iter = torch.amax(coarse.iters) + torch.amax(fine.iters)
    return ICPResult(
        T=fine.T.reshape(c, n_yaws, d + 1, d + 1),
        rmse=fine.rmse.reshape(c, n_yaws),
        iters=fine.iters.reshape(c, n_yaws),
        n_inliers=fine.n_inliers.reshape(c, n_yaws),
        converged=fine.converged.reshape(c, n_yaws)), n_iter


@dataclasses.dataclass
class LoopCandidate:
    query_idx: int
    match_idx: int
    score: float
    yaw: float  # descriptor-estimated relative yaw (radians)


@dataclasses.dataclass
class LoopClosure:
    i: int  # earlier keyframe
    j: int  # later keyframe
    T_ij: np.ndarray  # (D+1, D+1) measured X_i⁻¹ X_j
    rmse: float
    n_inliers: int


class LoopDetector:
    """Keyframe descriptor store + candidate search + ICP verification.

    Host-orchestrated, once per keyframe; descriptors, the score matrix and
    the verification ICP run on `device`. `verify_iters` counts the batched
    ICP iterations verification has run (each one NN launch for the whole
    batch on CUDA).
    """

    def __init__(self, cfg: BackendConfig, icp_cfg: Optional[ICPConfig] = None,
                 max_range: float = 60.0,
                 device: torch.device | str = "cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        # coarse-to-fine: a wide gate locks on, a tight one refines
        self.icp_coarse = icp_cfg or ICPConfig(
            method="point_to_point", max_iters=50, max_corr_dist=6.0,
            nn_backend="auto", huber_delta=1.5, max_step_trans=3.0,
            max_step_rot=0.5, min_inliers=30, tol=1e-5)
        self.icp_fine = dataclasses.replace(
            self.icp_coarse, max_corr_dist=1.5, huber_delta=0.5, max_iters=30)
        self.max_range = max_range
        # host-side copies (checkpoint source) ...
        self._descs: list[np.ndarray] = []
        self._positions: list = []
        # ... and the device store the candidate search reads
        self._descs_dev: Optional[torch.Tensor] = None  # (cap, R, S)
        self._pos_dev: Optional[torch.Tensor] = None  # (cap, 3)
        self._n_dev: int = 0  # keyframes reflected in the device store
        self.verify_iters = 0

    # -- device keyframe store ----------------------------------------------

    def _ensure_capacity(self, n: int) -> None:
        r, s = self.cfg.descriptor_rings, self.cfg.descriptor_sectors
        if self._descs_dev is None:
            cap = max(64, getattr(self.cfg, "max_keyframes", 512))
            self._descs_dev = torch.zeros((cap, r, s), dtype=torch.float32,
                                          device=self.device)
            self._pos_dev = torch.full((cap, 3), math.nan,
                                       dtype=torch.float32,
                                       device=self.device)
        while self._descs_dev.shape[0] < n:  # double on overflow
            self._descs_dev = torch.cat(
                [self._descs_dev, torch.zeros_like(self._descs_dev)])
            self._pos_dev = torch.cat(
                [self._pos_dev, torch.full_like(self._pos_dev, math.nan)])

    def _sync_device_store(self) -> None:
        """Rebuild the device store from the host lists (a restored or
        hand-set detector writes the host lists directly)."""
        self._descs_dev = None
        self._ensure_capacity(len(self._descs) + 1)
        if self._descs:
            k = len(self._descs)
            self._descs_dev[:k] = torch.as_tensor(
                np.stack(self._descs), dtype=torch.float32,
                device=self.device)
            pos = np.full((k, 3), np.nan, np.float32)
            for i, p in enumerate(self._positions):
                if p is not None:  # pad 2D positions with z=0 (xy gating)
                    pos[i, :len(p)] = np.asarray(p, np.float32)
                    pos[i, len(p):] = 0.0
            self._pos_dev[:k] = torch.as_tensor(pos, device=self.device)
        self._n_dev = len(self._descs)

    def _descriptor(self, points, mask) -> torch.Tensor:
        return scan_context(
            torch.as_tensor(points, dtype=torch.float32, device=self.device),
            torch.as_tensor(mask, dtype=torch.bool, device=self.device),
            rings=self.cfg.descriptor_rings,
            sectors=self.cfg.descriptor_sectors, max_range=self.max_range)

    def add_keyframe(self, points, mask, position=None) -> int:
        d = self._descriptor(points, mask)
        idx = len(self._descs)
        if self._descs_dev is None or self._n_dev != idx:
            self._sync_device_store()  # host lists were mutated externally
        self._ensure_capacity(idx + 1)
        self._descs_dev[idx] = d
        self._n_dev = idx + 1
        if position is not None:
            p3 = np.full((3,), np.nan, np.float32)
            p3[:len(position)] = np.asarray(position, np.float32)
            # pad unknown z with 0 so 2D positions gate on xy distance
            self._pos_dev[idx] = torch.as_tensor(np.nan_to_num(p3, nan=0.0),
                                                 device=self.device)
        self._descs.append(d.cpu().numpy())
        self._positions.append(
            None if position is None else np.asarray(position, np.float64))
        return idx

    def candidates(self, query_idx: int) -> list[LoopCandidate]:
        """Descriptor matches against old-enough keyframes, gated by the
        odometry-estimate distance (cfg.gating_radius) where positions are
        known. One pass over the fixed-capacity store; the top-k triple comes
        back to the host."""
        lo = query_idx - self.cfg.min_loop_separation
        if lo <= 0:
            return []
        if self._descs_dev is None or self._n_dev != len(self._descs):
            self._sync_device_store()  # `!=`: a restore can shrink the lists
        qpos_np = self._positions[query_idx]
        qpos = (np.concatenate([np.asarray(qpos_np, np.float32),
                                np.zeros(3 - len(qpos_np), np.float32)])
                if qpos_np is not None else np.full(3, np.nan, np.float32))
        radius = (self.cfg.gating_radius if self.cfg.gating_radius > 0
                  else math.inf)
        top_s, top_shift, top_i = _gated_candidate_scores(
            self._descs_dev[query_idx], self._descs_dev, self._pos_dev,
            torch.as_tensor(qpos, device=self.device), lo,
            float(np.float32(radius)), topk=self.cfg.candidate_topk)
        top_s = top_s.cpu().numpy().astype(np.float64)
        top_shift = top_shift.cpu().numpy()
        top_i = top_i.cpu().numpy()
        out = []
        for k in range(len(top_i)):
            if not np.isfinite(top_s[k]):
                continue
            yaw = top_shift[k] * 2 * np.pi / self.cfg.descriptor_sectors
            if yaw > np.pi:
                yaw -= 2 * np.pi
            out.append(LoopCandidate(query_idx=query_idx,
                                     match_idx=int(top_i[k]),
                                     score=float(top_s[k]), yaw=float(yaw)))
        return out

    def verify(self, cand: LoopCandidate, query_points, query_mask,
               match_points, match_mask, T_pred=None, query_desc=None
               ) -> Optional[LoopClosure]:
        """Single-candidate wrapper over verify_batch (see there)."""
        return self.verify_batch(
            [cand], query_points, query_mask,
            np.asarray(match_points)[None], np.asarray(match_mask)[None],
            T_preds=None if T_pred is None else np.asarray(T_pred)[None],
            query_desc=query_desc)[0]

    def verify_batch(self, cands: list, query_points, query_mask,
                     match_points, match_mask, T_preds=None, query_desc=None,
                     max_devs=None) -> list:
        """Geometrically verify all candidates of a keyframe: coarse-to-fine
        ICP over (candidates × yaw hypotheses), verify_chunk candidates per
        batch (each batch the span verify.batch); the best-rmse lock that
        passes the gates wins.

        Gates per candidate: rmse ≤ verify_max_rmse, inliers ≥ 30% of the
        query and, with T_preds (C, D+1, D+1), the measured translation
        within verify_max_dev (or max_devs (C,)) of the odometry prediction.
        query_desc defaults to the stored descriptor of cands[0].query_idx.
        Returns a list aligned with `cands`: LoopClosure (i = match, j =
        query) or None.
        """
        if not cands:
            return []
        s_sec = self.cfg.descriptor_sectors
        if query_desc is None:
            query_desc = self._descs[cands[0].query_idx]
        if self._descs_dev is None or self._n_dev != len(self._descs):
            self._sync_device_store()
        d = int(np.asarray(query_points).shape[1])

        def dev(a, dtype=torch.float32):
            return torch.as_tensor(np.asarray(a), device=self.device).to(dtype)

        qp, qm = dev(query_points), dev(query_mask, torch.bool)
        qd = dev(query_desc)
        mp_all, mm_all = dev(match_points), dev(match_mask, torch.bool)
        midx = torch.as_tensor([c.match_idx for c in cands],
                               device=self.device)
        chunk = self.cfg.verify_chunk or len(cands)
        rm_l, in_l, t_l = [], [], []
        for c0 in range(0, len(cands), chunk):
            c1 = min(c0 + chunk, len(cands))
            with span("verify.batch"):
                fine, n_iter = _batched_verify(
                    qp, qm, mp_all[c0:c1].contiguous(), mm_all[c0:c1], qd,
                    self._descs_dev[midx[c0:c1]], cfg_coarse=self.icp_coarse,
                    cfg_fine=self.icp_fine, sectors=s_sec,
                    n_yaws=getattr(self.cfg, "verify_yaws", 8))
                self.verify_iters += int(n_iter)
                rm_l.append(fine.rmse.cpu().numpy().astype(np.float64))
                in_l.append(fine.n_inliers.cpu().numpy())
                t_l.append(fine.T.cpu().numpy().astype(np.float64))
        rmses = np.concatenate(rm_l)  # (C, Y)
        inls = np.concatenate(in_l)  # (C, Y)
        Ts = np.concatenate(t_l)  # (C, Y, D+1, D+1)
        n_valid = int(np.asarray(query_mask).sum())
        ok = (rmses <= self.cfg.verify_max_rmse) & (
            inls >= 0.3 * max(n_valid, 1))
        if T_preds is not None and self.cfg.verify_max_dev > 0:
            t_dev = np.linalg.norm(
                Ts[:, :, :d, d] - np.asarray(T_preds)[:, None, :d, d],
                axis=-1)
            allowed = (np.full(len(cands), self.cfg.verify_max_dev)
                       if max_devs is None
                       else np.asarray(max_devs, np.float64))
            ok &= t_dev <= allowed[:, None]
        out = []
        for c, cand in enumerate(cands):
            if not ok[c].any():
                out.append(None)
                continue
            best = int(np.argmin(np.where(ok[c], rmses[c], np.inf)))
            out.append(LoopClosure(i=cand.match_idx, j=cand.query_idx,
                                   T_ij=Ts[c, best],
                                   rmse=float(rmses[c, best]),
                                   n_inliers=int(inls[c, best])))
        return out

    def verify_keyframe_candidates(self, kf_idx: int, query_points,
                                   query_mask, scans_pts, scans_msk,
                                   kf_frames: list, kf_poses: list, pose,
                                   accepted: Optional[list] = None):
        """Candidate search + batched verification for one new keyframe,
        with the odometry-predicted relative poses as consistency gates.
        `accepted` enables the closure_dedup_kf region dedup;
        verify_stride > 1 decimates both scans; verify_drift_rate > 0 widens
        the deviation gate with the odometry path length between the two
        keyframes. Returns (n_candidates, accepted closures)."""
        cands = self.candidates(kf_idx)
        dd = getattr(self.cfg, "closure_dedup_kf", 0)
        if dd > 0 and accepted:
            cands = [c for c in cands
                     if not any(abs(c.match_idx - lc.i) <= dd
                                and abs(kf_idx - lc.j) <= dd
                                for lc in accepted)]
        if not cands:
            return 0, []
        stride = max(1, getattr(self.cfg, "verify_stride", 1))
        query_points = np.asarray(query_points)[::stride]
        query_mask = np.asarray(query_mask)[::stride]
        mp = np.stack([scans_pts[kf_frames[c.match_idx]][::stride]
                       for c in cands])
        mm = np.stack([scans_msk[kf_frames[c.match_idx]][::stride]
                       for c in cands])
        T_preds = np.stack([np.linalg.inv(kf_poses[c.match_idx]) @ pose
                            for c in cands])
        max_devs = None
        if self.cfg.verify_drift_rate > 0:
            t_kf = np.asarray([np.asarray(p)[:-1, -1] for p in kf_poses])
            seg = np.linalg.norm(np.diff(t_kf, axis=0), axis=1)
            cum = np.concatenate([[0.0], np.cumsum(seg)])
            q = cands[0].query_idx
            max_devs = np.asarray([
                max(self.cfg.verify_max_dev,
                    self.cfg.verify_drift_rate * abs(cum[q]
                                                     - cum[c.match_idx]))
                for c in cands])
        lcs = self.verify_batch(cands, query_points, query_mask, mp, mm,
                                T_preds=T_preds, max_devs=max_devs)
        return len(cands), [lc for lc in lcs if lc is not None]

    def relocalize(self, query_points, query_mask, kf_scans, kf_poses,
                   topk: int = 3):
        """Global relocalization with no odometry prior: descriptor ranking
        over all keyframes, then multi-yaw verification of the top `topk`.
        Returns (pose (D+1, D+1), match_idx, rmse) or None."""
        if not self._descs:
            return None
        d = self._descriptor(query_points, query_mask)
        descs = torch.as_tensor(np.stack(self._descs), device=self.device)
        scores, shifts = shift_match_scores(d, descs)
        scores, shifts = scores.cpu().numpy(), shifts.cpu().numpy()
        n_q = len(self._descs)  # informational query index (not stored)
        qd = d.cpu().numpy()
        for m in np.argsort(-scores)[:topk]:
            yaw = shifts[m] * 2 * np.pi / self.cfg.descriptor_sectors
            if yaw > np.pi:
                yaw -= 2 * np.pi
            cand = LoopCandidate(query_idx=n_q, match_idx=int(m),
                                 score=float(scores[m]), yaw=float(yaw))
            lc = self.verify(cand, query_points, query_mask,
                             kf_scans[m][0], kf_scans[m][1], query_desc=qd)
            if lc is not None:
                return np.asarray(kf_poses[m]) @ lc.T_ij, int(m), lc.rmse
        return None
