"""Plain reference of RGB-D odometry, config 3: the semantics of the
port's `RGBDOdometry` (slam/rgbd.py `_step`, and the JAX package's
slam/rgbd.py it ports) in plain torch ops, worked out from the depth
images alone. A frame backprojects its depth, builds its normals by
central differences, takes its (strided) valid vertices as the source and
runs frame-to-frame projective point-to-plane ICP (KinectFusion's
association) against the previous frame's maps, from the constant-
velocity prediction (the last inter-frame motion).

Written from the port's eager path at configs/rgbd.json's options, for
those alone: `check_config` refuses any other. True division by the focal
lengths, as the port's `icp/projective._const` keeps it; round half to
even at the lookup; the normal gate inert (the lookup gets no source
normals), as in the port and the JAX package. Every matrix product goes
through `nn.Arith.mm`, so that the TF32 control rounds them all. It
imports nothing of the program.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from slambench.reference import lie
from slambench.reference.nn import Arith
from slambench.reference.odometry import namespace, solve_increment

PAD_COORD = 1.0e6  # the port's padding sentinel for invalid source rows


def check_config(cfg) -> None:
    """The option values this reference implements."""
    ic, p = cfg.icp, cfg.pipeline
    want = {
        "icp.method": (ic.method, "point_to_plane"),
        "icp.loop_backend": (ic.loop_backend, "steps"),
        "icp.gn_backend": (ic.gn_backend, "auto"),
        "icp.anderson": (ic.anderson, False),
        "icp.degen_eps": (ic.degen_eps, 0.0),
        "icp.unroll_iters": (ic.unroll_iters, 0),
        "icp.huber_delta": (ic.huber_delta, 0.0),
        "icp.prior_trans_weight": (ic.prior_trans_weight, 0.0),
        "icp.prior_rot_weight": (ic.prior_rot_weight, 0.0),
        "icp.max_step_trans": (ic.max_step_trans, 0.0),
        "icp.max_step_rot": (ic.max_step_rot, 0.0),
        "icp.max_total_trans": (ic.max_total_trans, 0.0),
        "icp.max_total_rot": (ic.max_total_rot, 0.0),
        "icp.step_scale": (ic.step_scale, 1.0),
        "icp.tol_update": (ic.tol_update, 0.0),
        "pipeline.motion_model": (p.motion_model, "constant_velocity"),
    }
    bad = {k: v for k, (v, w) in want.items() if v != w}
    if bad:
        raise ValueError(f"the plain reference does not implement {bad}")


def _scalar(v: float, like: torch.Tensor) -> torch.Tensor:
    """v as a 0-dim float32 tensor: dividing by it is true division on
    every device (a Python float may become a product by its
    reciprocal)."""
    return torch.full((), v, dtype=torch.float32, device=like.device)


# ---- the frame's maps -------------------------------------------------------

def backproject(depth: torch.Tensor, cam) -> tuple:
    """(H, W) depth -> the (H, W, 3) camera-frame vertex map and its (H, W)
    validity (depth > 0)."""
    h, w = depth.shape
    u = torch.arange(w, dtype=torch.float32, device=depth.device)[None, :]
    v = torch.arange(h, dtype=torch.float32, device=depth.device)[:, None]
    x = (u - cam.cx) / _scalar(cam.fx, depth) * depth
    y = (v - cam.cy) / _scalar(cam.fy, depth) * depth
    return torch.stack([x, y, depth], dim=-1), depth > 0


def normals(vmap: torch.Tensor, valid: torch.Tensor) -> tuple:
    """Unit normals of the vertex map, the cross product of its central
    differences (right - left) x (down - up), wrapping around the image,
    turned to face the camera; valid where the pixel and its four
    neighbours are and the cross product is not zero, never on the
    one-pixel border; zero where not valid."""
    dx = torch.roll(vmap, -1, dims=1) - torch.roll(vmap, 1, dims=1)
    dy = torch.roll(vmap, -1, dims=0) - torch.roll(vmap, 1, dims=0)
    ax, ay, az = dx.unbind(-1)
    bx, by, bz = dy.unbind(-1)
    n = torch.stack([ay * bz - az * by, az * bx - ax * bz,
                     ax * by - ay * bx], dim=-1)
    norm = torch.sqrt(torch.sum(n * n, dim=-1))
    n = n / torch.clamp(norm, min=1e-12)[..., None]
    facing_away = torch.sum(n * vmap, dim=-1) > 0
    n = torch.where(facing_away[..., None], -n, n)
    ok = valid & (norm > 1e-12)
    for shift, dim in ((-1, 1), (1, 1), (-1, 0), (1, 0)):
        ok = ok & torch.roll(valid, shift, dims=dim)
    ok[0, :] = ok[-1, :] = False
    ok[:, 0] = ok[:, -1] = False
    return torch.where(ok[..., None], n, torch.zeros_like(n)), ok


def maps(depth: torch.Tensor, cam) -> tuple:
    """(vertex map, normal map, validity) of one depth image."""
    vmap, valid = backproject(depth, cam)
    nmap, ok = normals(vmap, valid)
    return vmap, nmap, valid & ok


def source(vmap: torch.Tensor, valid: torch.Tensor, stride: int) -> tuple:
    """The source: every stride-th row and column of the vertex map,
    flattened, invalid rows at the padding sentinel: ((M, 3), (M,))."""
    s = max(int(stride), 1)
    pts = vmap[::s, ::s].reshape(-1, 3)
    mask = valid[::s, ::s].reshape(-1)
    return torch.where(mask[:, None], pts, torch.full_like(pts, PAD_COORD)), \
        mask


def lookup(cam, target: tuple, cur: torch.Tensor, max_d2: float) -> tuple:
    """Projective association of points in the target camera's frame:
    (pixel index (M,), q (M, 3), n (M, 3), gate (M,) bool, d2 (M,)). The
    pixel is round-half-to-even of u = x / z * fx + cx (and v), clamped to
    the image; it counts where it lies in the image, in front of the
    camera, on a valid pixel, within the distance gate."""
    vmap, nmap, valid = target
    h, w = valid.shape
    z = cur[:, 2]
    front = z > 1e-6
    sz = torch.where(front, z, torch.ones_like(z))
    u = cur[:, 0] / sz * _scalar(cam.fx, cur) + cam.cx
    v = cur[:, 1] / sz * _scalar(cam.fy, cur) + cam.cy
    ui = torch.clamp(torch.round(u), 0, w - 1).long()
    vi = torch.clamp(torch.round(v), 0, h - 1).long()
    inside = front & (u >= -0.5) & (u <= w - 0.5) & (v >= -0.5) & (
        v <= h - 0.5)
    idx = vi * w + ui
    q = vmap.reshape(-1, 3)[idx]
    n = nmap.reshape(-1, 3)[idx]
    diff = cur - q
    d2 = torch.sum(diff * diff, dim=-1)
    gate = inside & valid.reshape(-1)[idx] & (d2 <= max_d2)
    return idx, q, n, gate, d2


# ---- ICP --------------------------------------------------------------------

def moved(ar: Arith, pts: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    return ar.mm(pts, T[:3, :3].T) + T[:3, 3]


def icp(ar: Arith, cfg, cam, src: tuple, target: tuple,
        T0: torch.Tensor) -> tuple:
    """Point-to-plane ICP of the source onto the target's maps from T0:
    (T, rmse, iters, n_inliers, converged). An iteration: the lookup at
    the source moved by T, weights gate x mask, residual n . (p - q),
    Jacobian row [n, p x n], the damped Cholesky step (solve_increment),
    held where fewer than max(min_inliers, 4) pairs count, composed on
    the left; it stops after an iteration whose inlier RMS distance moved
    by less than tol, or at max_iters (the condition read before each
    iteration, as the program's while loop reads it)."""
    ic = cfg.icp
    pts, mask = src
    dev = pts.device
    eye = torch.eye(4, device=dev)
    zero6 = torch.zeros(6, device=dev)
    mask_f = mask.to(torch.float32)
    min_inl = max(ic.min_inliers, 4)
    max_d2 = ic.max_corr_dist * ic.max_corr_dist
    T = T0
    rmse_prev = torch.tensor(math.inf, device=dev)
    n_inl = torch.zeros((), dtype=torch.int64, device=dev)
    converged = torch.zeros((), dtype=torch.bool, device=dev)
    it = 0
    while it < ic.max_iters and not (it > 0 and bool(converged)):
        cur = moved(ar, pts, T)
        _, q, n, gate, d2 = lookup(cam, target, cur, max_d2)
        w = gate.to(torch.float32) * mask_f
        n_inl = torch.sum(w > 0)
        r = torch.sum(n * (cur - q), dim=-1)
        J = torch.cat([n, torch.linalg.cross(cur, n, dim=-1)], dim=-1)
        Jw = J * w[:, None]
        H = ar.mm(J.T, Jw)
        g = ar.mm(Jw.T, r[:, None])[:, 0]
        dT = lie.exp(solve_increment(H, g, ic, zero6, zero6))
        dT = torch.where(n_inl >= min_inl, dT, eye)
        T = ar.mm(dT, T)
        rmse = torch.sqrt(torch.sum(w * d2) / torch.clamp(torch.sum(w),
                                                          min=1e-12))
        converged = torch.abs(rmse_prev - rmse) < ic.tol
        rmse_prev = rmse
        it += 1
    return T, rmse_prev, it, n_inl, converged


# ---- the log ----------------------------------------------------------------

def run(cfg_dict: dict, depths, device, precision: str = "float32",
        forced=None) -> dict:
    """The odometry over a (F, H, W) depth log from frame 0, on `device`:
    per frame after the first, {pose, T, rmse, iters, n_inliers,
    converged} stacked, as numpy. `forced`, the program's (F - 1, 4, 4)
    poses of frames 1.., makes frame f start from the program's pose and
    inter-frame motion at f - 1 (its prediction, T0); the reference's own
    ICP result T of frame f is composed onto the program's pose at f - 1
    (`pose`). Free, it goes on from its own."""
    cfg = namespace(cfg_dict)
    check_config(cfg)
    cam = cfg.camera
    ar = Arith(precision)
    depths = torch.as_tensor(np.asarray(depths), dtype=torch.float32,
                             device=device)
    if forced is not None:
        forced = np.asarray(forced, np.float64)
    eye64 = np.eye(4)
    pose, T_rel = eye64, eye64
    infos = []
    with ar.scope():
        target = maps(depths[0], cam)
        for f in range(1, depths.shape[0]):
            frame = maps(depths[f], cam)
            src = source(frame[0], frame[2], cfg.pipeline.rgbd_src_stride)
            T0 = torch.as_tensor(T_rel, dtype=torch.float32, device=device)
            T, rmse, iters, n_inl, conv = icp(ar, cfg, cam, src, target, T0)
            T64 = T.double().cpu().numpy()
            own = pose @ T64
            infos.append({"pose": own, "T": T64, "rmse": float(rmse),
                          "iters": iters, "n_inliers": int(n_inl),
                          "converged": bool(conv)})
            if forced is None:
                pose, T_rel = own, T64
            else:
                T_rel = np.linalg.inv(pose) @ forced[f - 1]
                pose = forced[f - 1]
            target = frame
    return {k: np.stack([np.asarray(i[k]) for i in infos]) for k in infos[0]}
