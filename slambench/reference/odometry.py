"""Plain reference of the scan-to-map front end: the semantics of the
port's `ScanToMapPipeline` (slam/scan_to_map.py `_step`: prediction,
local-model extract, point-to-plane ICP, keyframe and map-health gates,
k-NN normals and the voxel-dedup insert) in plain torch ops, worked out
from the scans alone.

Written from the port's eager path at the configurations of
slambench/configs, for those option values only: `check_config` refuses
any other. Every matrix product goes through `nn.Arith.mm`. It imports
nothing of the program.
"""

from __future__ import annotations

import math
from types import SimpleNamespace

import numpy as np
import torch

from slambench.reference import lie
from slambench.reference.nn import Arith, knn, nearest

PAD_COORD = 1.0e6
# quantized voxel coordinates live in [-2^19, 2^19); invalid slots sort last
_QMAX = 1 << 19
_QINVALID = _QMAX + 7
_KEY_BITS = 21


def namespace(d: dict) -> SimpleNamespace:
    return SimpleNamespace(**{k: namespace(v) if isinstance(v, dict) else v
                              for k, v in d.items()})


def check_config(cfg) -> None:
    """The option values this reference implements."""
    ic, m, p = cfg.icp, cfg.mapping, cfg.pipeline
    want = {
        "icp.method": (ic.method, "point_to_plane"),
        "icp.loop_backend": (ic.loop_backend, "steps"),
        "icp.nn_backend": (ic.nn_backend, "auto"),
        "icp.anderson": (ic.anderson, False),
        "icp.degen_eps": (ic.degen_eps, 0.0),
        "icp.corr_range_rate": (ic.corr_range_rate, 0.0),
        "icp.unroll_iters": (ic.unroll_iters, 0),
        "mapping.insert_backend": (m.insert_backend, "sort"),
        "mapping.extract_hysteresis": (m.extract_hysteresis, 0.0),
        "pipeline.mode": (p.mode, "scan_to_map"),
        "pipeline.motion_model": (p.motion_model, "constant_velocity"),
    }
    bad = {k: v for k, (v, w) in want.items() if v != w}
    if bad or ic.nn_precision not in ("highest", "rescore"):
        raise ValueError(f"the plain reference does not implement {bad}, "
                         f"nn_precision {ic.nn_precision}")


# ---- the voxel map -------------------------------------------------------

def _quantize(pts, msk, voxel):
    q = torch.floor(pts / voxel).to(torch.int32)
    q = torch.clamp(q, -_QMAX, _QMAX - 1)
    return torch.where(msk[:, None], q, torch.full_like(q, _QINVALID))


def _voxel_key(q):
    b = q.to(torch.int64) + _QMAX
    return (b[:, 0] << (2 * _KEY_BITS)) | (b[:, 1] << _KEY_BITS) | b[:, 2]


def map_create(cap: int, device) -> dict:
    return {"points": torch.full((cap, 3), PAD_COORD, device=device),
            "normals": torch.zeros((cap, 3), device=device),
            "mask": torch.zeros(cap, dtype=torch.bool, device=device)}


def map_insert(vm: dict, pts, msk, nrm, voxel: float, center=None) -> dict:
    """Merge a world-frame scan with voxel dedup: map points win their
    voxel; on overflow the points nearest `center` (or the earliest
    inserted) survive."""
    cap = vm["points"].shape[0]
    all_pts = torch.cat([vm["points"], pts])
    all_nrm = torch.cat([vm["normals"], nrm])
    all_msk = torch.cat([vm["mask"], msk])
    q = _quantize(all_pts, all_msk, voxel)
    _, order = torch.sort(_voxel_key(q), stable=True)
    qs = q[order]
    same = torch.all(qs == torch.roll(qs, 1, dims=0), dim=1)
    same[0] = False
    keep = ~same & all_msk[order]
    if center is not None:
        diff = all_pts[order] - center[None, :]
        prio = torch.sum(diff * diff, dim=-1)
    else:
        prio = order.to(all_pts.dtype)
    rank = torch.sort(prio, stable=True).indices
    rank = rank[torch.sort((~keep[rank]).to(torch.uint8), stable=True).indices]
    chosen = order[rank[:cap]]
    new_msk = keep[rank[:cap]]
    return {"points": torch.where(new_msk[:, None], all_pts[chosen],
                                  torch.full_like(all_pts[chosen], PAD_COORD)),
            "normals": torch.where(new_msk[:, None], all_nrm[chosen],
                                   torch.zeros_like(all_nrm[chosen])),
            "mask": new_msk}


def extract_local(vm: dict, center, size: int):
    """The `size` map points nearest `center`, ties to the lower slot, in
    map order: (pts, nrm, msk, r_cover)."""
    diff = vm["points"] - center[None, :]
    d2 = diff[:, 0] * diff[:, 0] + diff[:, 1] * diff[:, 1] \
        + diff[:, 2] * diff[:, 2]
    d2 = torch.where(vm["mask"], d2, torch.full_like(d2, math.inf))
    d2_sel, idx = torch.sort(d2, stable=True)
    d2_sel, idx = d2_sel[:size], idx[:size]
    msk = torch.isfinite(d2_sel)
    full = torch.sum(vm["mask"]) > size
    r_sel = torch.sqrt(torch.clamp(torch.max(torch.where(
        msk, d2_sel, torch.zeros_like(d2_sel))), min=0.0))
    r_cover = torch.where(full, r_sel, torch.full_like(r_sel, math.inf))
    big = torch.full_like(idx, torch.iinfo(torch.int32).max)
    order = torch.sort(torch.where(msk, idx, big), stable=True).indices
    idx, msk = idx[order], msk[order]
    pts = torch.where(msk[:, None], vm["points"][idx],
                      torch.full_like(vm["points"][idx], PAD_COORD))
    nrm = torch.where(msk[:, None], vm["normals"][idx],
                      torch.zeros_like(vm["normals"][idx]))
    return pts, nrm, msk, r_cover


# ---- normals ---------------------------------------------------------------

def smallest_eigvec_sym3(C: torch.Tensor) -> torch.Tensor:
    """Smallest eigenvector of symmetric 3x3 matrices, closed form; +z for
    isotropic neighbourhoods."""
    eye = torch.eye(3, dtype=C.dtype, device=C.device)
    q = (C[..., 0, 0] + C[..., 1, 1] + C[..., 2, 2]) / 3.0
    c00, c11, c22 = C[..., 0, 0], C[..., 1, 1], C[..., 2, 2]
    c01, c02, c12 = C[..., 0, 1], C[..., 0, 2], C[..., 1, 2]
    p1 = c01 * c01 + c02 * c02 + c12 * c12
    p2 = (c00 - q) ** 2 + (c11 - q) ** 2 + (c22 - q) ** 2 + 2.0 * p1
    p = torch.sqrt(torch.clamp(p2 / 6.0, min=1e-30))
    B = (C - q[..., None, None] * eye) / p[..., None, None]
    detB = (B[..., 0, 0] * (B[..., 1, 1] * B[..., 2, 2]
                            - B[..., 1, 2] * B[..., 2, 1])
            - B[..., 0, 1] * (B[..., 1, 0] * B[..., 2, 2]
                              - B[..., 1, 2] * B[..., 2, 0])
            + B[..., 0, 2] * (B[..., 1, 0] * B[..., 2, 1]
                              - B[..., 1, 1] * B[..., 2, 0]))
    phi = torch.arccos(torch.clamp(detB / 2.0, -1.0, 1.0)) / 3.0
    lam_min = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    A = C - lam_min[..., None, None] * eye
    r0, r1, r2 = A[..., 0, :], A[..., 1, :], A[..., 2, :]
    cands = torch.stack([torch.linalg.cross(r0, r1, dim=-1),
                         torch.linalg.cross(r0, r2, dim=-1),
                         torch.linalg.cross(r1, r2, dim=-1)], dim=-2)
    best = torch.argmax(torch.sum(cands * cands, dim=-1), dim=-1)
    pick = best[..., None, None].expand(*best.shape, 1, 3)
    v = torch.gather(cands, -2, pick)[..., 0, :]
    vn = torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True))
    fallback = torch.zeros_like(v)
    fallback[..., 2] = 1.0
    return torch.where((vn[..., 0] > 1e-20)[..., None],
                       v / torch.clamp(vn, min=1e-30), fallback)


def normals_knn(ar: Arith, points, mask, k: int, ref_stride: int):
    """Unit normals by a plane fit to the k nearest of every ref_stride-th
    point, facing the sensor at the origin; zero on padded slots."""
    ref = points if ref_stride <= 1 else points[::ref_stride]
    idx, _ = knn(ar, points, ref, k)
    nbrs = ref[idx]
    x = nbrs - torch.mean(nbrs, dim=1, keepdim=True)
    cov = ar.mm(x.transpose(1, 2), x) / k
    n = smallest_eigvec_sym3(cov)
    flip = torch.sum(n * (-points), dim=-1, keepdim=True) < 0
    n = torch.where(flip, -n, n)
    return torch.where(mask[:, None], n, torch.zeros_like(n))


# ---- ICP -------------------------------------------------------------------

def solve_increment(H, g, ic, prior_w, xi_prior):
    k = H.shape[0]
    H = H + torch.diag(prior_w)
    g = g + prior_w * xi_prior
    lam = ic.damping * torch.clamp(torch.trace(H) / k, min=1.0)
    Hd = H + lam * torch.eye(k, dtype=H.dtype, device=H.device)
    L, info = torch.linalg.cholesky_ex(Hd)
    y = torch.linalg.solve_triangular(L, -g[:, None], upper=False)
    xi = torch.linalg.solve_triangular(L.T, y, upper=True)[:, 0]
    ok = (info == 0) & torch.all(torch.isfinite(xi))
    xi = torch.where(ok, xi, torch.zeros_like(xi))
    if ic.max_step_trans > 0.0:
        tn = torch.linalg.vector_norm(xi[:3])
        xi = xi * torch.clamp(ic.max_step_trans / torch.clamp(tn, min=1e-12),
                              max=1.0)
    if ic.max_step_rot > 0.0:
        wn = torch.linalg.vector_norm(xi[3:])
        xi = xi * torch.clamp(ic.max_step_rot / torch.clamp(wn, min=1e-12),
                              max=1.0)
    return xi


def project_total(ic, T_new, T0, T0_inv):
    """Trust region: the total correction log(T_new T0⁻¹) onto its ball."""
    xi = lie.log(T_new @ T0_inv)
    s = torch.ones(xi.shape[:-1], dtype=T_new.dtype, device=T_new.device)
    if ic.max_total_trans > 0.0:
        tn = torch.linalg.vector_norm(xi[..., :3], dim=-1)
        s = torch.minimum(s, ic.max_total_trans / torch.clamp(tn, min=1e-12))
    if ic.max_total_rot > 0.0:
        rn = torch.linalg.vector_norm(xi[..., 3:], dim=-1)
        s = torch.minimum(s, ic.max_total_rot / torch.clamp(rn, min=1e-12))
    return torch.where(s[..., None, None] < 1.0,
                       lie.exp(s[..., None] * xi) @ T0, T_new)


def icp(ar: Arith, ic, points, mask, model, model_nrm, r_gate):
    """Point-to-plane ICP of the scan against the model (sensor frame of
    the prediction) from the identity, with the motion prior, Huber
    weights, step clamps, over-relaxation and the trust region: (T, rmse,
    iters, n_inliers, converged)."""
    dev = points.device
    eye = torch.eye(4, device=dev)
    T, T0, T0_inv = eye, eye, eye
    prior_scale = torch.tensor([ic.prior_trans_weight] * 3
                               + [ic.prior_rot_weight] * 3, device=dev)
    use_prior = ic.prior_trans_weight > 0.0 or ic.prior_rot_weight > 0.0
    trust = ic.max_total_trans > 0.0 or ic.max_total_rot > 0.0
    mask_f = mask.to(torch.float32)
    min_inl = max(ic.min_inliers, 4)
    rmse_prev = torch.tensor(math.inf, device=dev)
    n_inl = torch.zeros((), dtype=torch.int64, device=dev)
    converged = torch.zeros((), dtype=torch.bool, device=dev)
    it = 0
    while it < ic.max_iters and not (it > 0 and bool(converged)):
        cur = points @ T[:3, :3].T + T[:3, 3]
        idx = nearest(ar, cur, model)
        q, n = model[idx], model_nrm[idx]
        diff = cur - q
        d2 = torch.sum(diff * diff, dim=-1)
        gate = (d2 <= ic.max_corr_dist ** 2).to(torch.float32)
        gate = gate * (torch.sum(cur * cur, dim=-1) <= r_gate * r_gate)
        w = gate * mask_f
        if ic.huber_delta > 0.0:
            dist = torch.sqrt(torch.clamp(d2, min=1e-20))
            w = w * torch.clamp(ic.huber_delta / dist, max=1.0)
        n_inl = torch.sum(w > 0)
        r = torch.sum(n * (cur - q), dim=-1)
        J = torch.cat([n, torch.linalg.cross(cur, n, dim=-1)], dim=-1)
        Jw = J * w[:, None]
        H = ar.mm(J.T, Jw)
        g = ar.mm(Jw.T, r[:, None])[:, 0]
        if use_prior:
            prior_w = torch.clamp(torch.sum(w), min=1e-6) * prior_scale
            xi_prior = lie.log(T @ T0_inv)
        else:
            prior_w = xi_prior = torch.zeros(6, device=dev)
        dT = lie.exp(solve_increment(H, g, ic, prior_w, xi_prior))
        if ic.step_scale != 1.0:
            dT = lie.exp(ic.step_scale * lie.log(dT))
        dT = torch.where(n_inl >= min_inl, dT, eye)
        T_new = dT @ T
        if trust:
            T_new = project_total(ic, T_new, T0, T0_inv)
        rmse = torch.sqrt(torch.sum(w * d2) / torch.clamp(torch.sum(w),
                                                          min=1e-12))
        converged = torch.abs(rmse_prev - rmse) < ic.tol
        if ic.tol_update > 0.0:
            step = torch.linalg.vector_norm(dT[:3, 3]) + \
                torch.linalg.matrix_norm(dT[:3, :3] - eye[:3, :3])
            converged = converged | (step < ic.tol_update)
        T, rmse_prev = T_new, rmse
        it += 1
    return T, rmse_prev, it, n_inl, converged


# ---- the frame -------------------------------------------------------------

def init_state(ar: Arith, cfg, points, mask) -> dict:
    p = cfg.pipeline
    nrm = normals_knn(ar, points, mask, p.normal_k, p.normal_ref_stride)
    vm = map_insert(map_create(cfg.mapping.map_capacity, points.device),
                    points, mask, nrm, cfg.mapping.map_voxel)
    eye = torch.eye(4, device=points.device)
    return {"pose": eye, "T_rel": eye, "last_kf": eye, "map": vm}


def _predict(state, p):
    alpha = p.motion_damping
    alpha_r = p.motion_damping_rot if p.motion_damping_rot >= 0 else alpha
    if alpha >= 1.0 and alpha_r >= 1.0:
        return state["pose"] @ state["T_rel"]
    if alpha <= 0.0 and alpha_r <= 0.0:
        return state["pose"]
    xi = lie.log(state["T_rel"])
    return state["pose"] @ lie.exp(torch.cat([alpha * xi[:3],
                                              alpha_r * xi[3:]]))


def step(ar: Arith, cfg, state: dict, points, mask, forced=None):
    """One frame: (new state, info {pose, rmse, iters, n_inliers,
    converged, is_keyframe, map_inserted, map_points}). With `forced`, the
    program's (pose, is_keyframe, map_inserted) of the frame, the state
    goes on from them (the next prediction, the keyframe anchor and the
    map insert at that pose), while the info keeps this frame's own ICP
    result and decisions."""
    m, p, ic = cfg.mapping, cfg.pipeline, cfg.icp
    init = _predict(state, p)
    loc, loc_n, loc_m, r_cover = extract_local(state["map"], init[:3, 3],
                                               m.local_model_size)
    inv = lie.inverse(init)
    model = torch.where(loc_m[:, None], loc @ inv[:3, :3].T + inv[:3, 3],
                        torch.full_like(loc, PAD_COORD))
    model_nrm = loc_n @ inv[:3, :3].T
    r_gate = torch.clamp(r_cover - ic.max_corr_dist, min=0.0)
    T, rmse, iters, n_inl, conv = icp(ar, ic, points, mask, model, model_nrm,
                                      r_gate)
    pose = init @ T
    dK = lie.inverse(state["last_kf"]) @ pose
    trans = torch.linalg.vector_norm(dK[:3, 3])
    rot = lie.rotation_angle(dK[:3, :3])
    moved = (trans > p.keyframe_trans) | (rot > p.keyframe_rot)
    cur = points @ T[:3, :3].T + T[:3, 3]
    in_cov = torch.sum(cur * cur, dim=-1) <= r_gate * r_gate
    n_total = torch.clamp(torch.sum(mask.to(torch.int32)), min=1)
    n_valid = torch.clamp(torch.sum((mask & in_cov).to(torch.int32)), min=1)
    enough = n_valid * 10 >= n_total
    quality = conv | (rmse < p.keyframe_max_rmse)
    healthy = quality & enough & (
        n_inl >= (n_valid * p.keyframe_min_inlier_frac).to(torch.int32))
    is_kf = moved & healthy
    if p.frontier_insert:
        pressure = (n_valid < n_total * p.frontier_cov_frac) | (
            rot > 0.5 * p.keyframe_rot)
        moved_a_bit = (trans > 0.3) | (rot > 0.05)
        insert = healthy & (moved | (pressure & moved_a_bit))
    else:
        insert = is_kf
    own, own_kf, own_insert = pose, is_kf, insert
    if forced is not None:
        pose, is_kf, insert = forced
    vm = state["map"]
    if bool(insert):
        world = torch.where(mask[:, None],
                            points @ pose[:3, :3].T + pose[:3, 3],
                            torch.full_like(points, PAD_COORD))
        nrm = normals_knn(ar, points, mask, p.normal_k, p.normal_ref_stride)
        vm = map_insert(vm, world, mask, nrm @ pose[:3, :3].T, m.map_voxel,
                        center=pose[:3, 3])
    new = {"pose": pose, "T_rel": lie.inverse(state["pose"]) @ pose,
           "last_kf": torch.where(is_kf, pose, state["last_kf"]), "map": vm}
    info = {"pose": own, "rmse": rmse, "iters": iters, "n_inliers": n_inl,
            "converged": conv, "is_keyframe": own_kf,
            "map_inserted": own_insert,
            "map_points": torch.sum(vm["mask"])}
    return new, info


def run(cfg_dict: dict, points, mask, device, precision: str = "float32",
        forced=None):
    """The front end over a log (F, C, 3) from frame 0, on `device`: per
    frame after the first, the info's fields stacked, as numpy. `forced`,
    the program's per-frame (poses (F - 1, 4, 4), is_keyframe (F - 1,),
    map_inserted (F - 1,)) of frames 1.., makes each frame start from the
    program's trajectory and decisions up to the frame before it (see
    `step`), with the map this reference builds at those poses."""
    cfg = namespace(cfg_dict)
    check_config(cfg)
    ar = Arith(precision)
    points = torch.as_tensor(points, dtype=torch.float32, device=device)
    mask = torch.as_tensor(mask, dtype=torch.bool, device=device)
    if forced is not None:
        f_pose = torch.as_tensor(np.asarray(forced[0]), dtype=torch.float32,
                                 device=device)
        f_kf, f_ins = (torch.as_tensor(np.asarray(x, bool), device=device)
                       for x in forced[1:])
    infos = []
    with ar.scope():
        state = init_state(ar, cfg, points[0], mask[0])
        for f in range(1, points.shape[0]):
            state, info = step(
                ar, cfg, state, points[f], mask[f],
                None if forced is None else (f_pose[f - 1], f_kf[f - 1],
                                             f_ins[f - 1]))
            infos.append(info)
    return {k: torch.stack([torch.as_tensor(i[k]) for i in infos]
                           ).cpu().numpy() for k in infos[0]}
