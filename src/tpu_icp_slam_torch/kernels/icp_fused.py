"""K5: the whole point-to-plane ICP loop of one align in one launch — CUDA
kernel and plain version.

`icp_fused(...)` is the port of tpu_icp_slam/kernels/icp_fused_pallas.py::
icp_fused_pallas: same arguments (less the TPU tile sizes), same result
`(T, rmse, iters, n_inliers, converged)` as device tensors. The model is
recentred on the midpoint of its valid bounding box, `init_T` is moved into
that frame and the result conjugated back; the coverage gate is measured on
|cur + c|, in the original frame. CUDA tensors launch csrc/icp_fused.cu once
(no host sync); CPU tensors run `icp_fused_ref`, a torch loop that computes
the same thing (one host sync per iteration).

Both versions use the reference's polynomial arccos (|err| <= 5e-5 rad) in
the SE(3) log of the motion prior and the trust region: it defines this
path's numbers. In bf16 mode both versions rebuild the gathered q and n from
their bf16 hi/lo halves in float32 (`nn_bf16.hi_lo`), as the reference's
gather operand holds them; at "highest" they are gathered exactly. At
"highest" the NN scores the exact difference form, as K1 does
(bit for bit); at "bf16" the kernel scores the packed operands on the tensor
cores (csrc/packed_mma.cuh), the plain version with a float32 product, so
the two may pick differently on near-ties (packed_mma.near_ties).
"""

from __future__ import annotations

import ctypes
import math

import torch

from tpu_icp_slam_torch.core import se3
from tpu_icp_slam_torch.icp.point_to_plane import solve_increment
from tpu_icp_slam_torch.kernels import _build
from tpu_icp_slam_torch.kernels.gn_cuda import gn_accum_ref
from tpu_icp_slam_torch.kernels.nn_bf16 import (
    VALID_ABS,
    hi_lo,
    pack_source,
    pack_target,
    packed_argmin_ref,
    valid_centre,
)
from tpu_icp_slam_torch.kernels.nn_cuda import nn_bruteforce_ref

_ROWS = 64  # sources per block tile (kRows in csrc/icp_fused.cu)
_SUMS_STRIDE = 32  # floats per block partial (kStride)
_FLOAT_PARAMS = ("tol", "tol_update", "max_d2", "huber", "damping",
                 "step_scale", "max_step_trans", "max_step_rot", "prior_t",
                 "prior_r", "max_total_trans", "max_total_rot")


class _Params(ctypes.Structure):
    """csrc/icp_fused.cu::IcpParams."""
    _fields_ = [("max_iters", ctypes.c_int), ("min_inliers", ctypes.c_int)] \
        + [(name, ctypes.c_float) for name in _FLOAT_PARAMS]


def _params(max_iters=6, tol=1e-5, tol_update=0.01, max_corr_dist=1.5,
            huber_delta=0.3, damping=1e-3, step_scale=1.4,
            max_step_trans=1.0, max_step_rot=0.3, min_inliers=50,
            prior_trans_weight=0.0, prior_rot_weight=0.0,
            max_total_trans=0.0, max_total_rot=0.0) -> dict:
    """icp_fused_pallas's keyword defaults, under the kernel's names."""
    return dict(
        max_iters=int(max_iters), min_inliers=max(int(min_inliers), 4),
        tol=float(tol), tol_update=float(tol_update),
        max_d2=float(max_corr_dist) ** 2, huber=float(huber_delta),
        damping=float(damping), step_scale=float(step_scale),
        max_step_trans=float(max_step_trans),
        max_step_rot=float(max_step_rot),
        prior_t=float(prior_trans_weight), prior_r=float(prior_rot_weight),
        max_total_trans=float(max_total_trans),
        max_total_rot=float(max_total_rot))


def fused_args(ic) -> tuple[str, dict]:
    """(precision, keyword arguments) of `icp_fused` for an ICPConfig, as
    the reference's fused branch passes them (scan_to_map.py:196-223):
    rescore has no fused form and maps to exact "highest"."""
    kw = dict(max_iters=ic.max_iters, tol=ic.tol, tol_update=ic.tol_update,
              max_corr_dist=ic.max_corr_dist, huber_delta=ic.huber_delta,
              damping=ic.damping, step_scale=ic.step_scale,
              max_step_trans=ic.max_step_trans, max_step_rot=ic.max_step_rot,
              min_inliers=ic.min_inliers,
              prior_trans_weight=ic.prior_trans_weight,
              prior_rot_weight=ic.prior_rot_weight,
              max_total_trans=ic.max_total_trans,
              max_total_rot=ic.max_total_rot)
    return ("bf16" if ic.nn_precision == "bf16" else "highest"), kw


def _prepare(src, smask, dst, nrm, dmask, init_T, r_gate):
    """Recentre on the valid model's bounding-box midpoint c
    (icp_fused_pallas.py:736-752): returns the shifted source, its mask as
    f32, the shifted model (invalid rows at the 1e6 sentinel), its normals
    (invalid rows zero), init_T in the shifted frame and [r_gate, c]."""
    f32, dev = torch.float32, src.device
    src, dst, nrm = src.to(f32), dst.to(f32), nrm.to(f32)
    T0 = (torch.eye(4, dtype=f32, device=dev) if init_T is None
          else init_T.to(f32))
    valid = (torch.all(torch.abs(dst) < VALID_ABS, dim=1) & dmask)[:, None]
    c = valid_centre(dst, valid)
    dstc = torch.where(valid, dst - c, 1.0e6)
    nrmc = torch.where(valid, nrm, 0.0)
    # x' = x - c, so T' = Shift(-c)·T·Shift(c)
    T0c = se3.from_rt(T0[:3, :3], T0[:3, 3] + T0[:3, :3] @ c - c)
    gate = torch.cat([torch.as_tensor(r_gate, dtype=f32, device=dev)
                      .reshape(1), c])
    return src - c, smask.to(f32), dstc, nrmc, T0c, gate


def _conjugate_out(Tc: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """T = Shift(c)·T_cent·Shift(-c)."""
    return se3.from_rt(Tc[:3, :3], Tc[:3, 3] - Tc[:3, :3] @ c + c)


def _acos_poly(x: torch.Tensor) -> torch.Tensor:
    """arccos by Abramowitz-Stegun 4.4.45 (icp_fused_pallas.py:181-192)."""
    t = torch.abs(x)
    p = torch.sqrt(torch.clamp(1.0 - t, min=0.0)) * (
        1.5707288 + t * (-0.2121144 + t * (0.0742610 + t * (-0.0187293))))
    return torch.where(x >= 0.0, p, math.pi - p)


def _log_poly(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """se3.log of (R, t) as icp_fused_pallas._se3_log_scalars computes it."""
    tr = R[0, 0] + R[1, 1] + R[2, 2]
    theta = _acos_poly(torch.clamp(0.5 * (tr - 1.0), -1.0, 1.0))
    t2 = theta * theta
    small = t2 < 1e-8
    s = torch.sin(theta)
    k = torch.where(small, 0.5 + t2 / 12.0,
                    theta / torch.clamp(2.0 * s, min=1e-12))
    phi = k * se3.vee(R - R.T)
    A = torch.where(small, 1.0 - t2 / 6.0, s / torch.clamp(theta, min=1e-12))
    B = torch.where(small, 0.5 - t2 / 24.0,
                    (1.0 - torch.cos(theta)) / torch.clamp(t2, min=1e-16))
    cf = torch.where(small, 1.0 / 12.0,
                     (1.0 - A / torch.clamp(2.0 * B, min=1e-12))
                     / torch.clamp(t2, min=1e-16))
    W = se3.hat(phi)
    Vinv = torch.eye(3, dtype=R.dtype, device=R.device) - 0.5 * W \
        + cf * (W @ W)
    return torch.cat([Vinv @ t, phi])


def _orig_correction(T, T0, c):
    """(R, t) of S·(T·T0⁻¹)·S⁻¹, the correction in the original frame:
    same rotation, t_orig = t_x + c - R_x·c (icp_fused_pallas.py:234-254)."""
    R0t = T0[:3, :3].T
    Rx = T[:3, :3] @ R0t
    tx = T[:3, :3] @ -(R0t @ T0[:3, 3]) + T[:3, 3]
    return Rx, tx + c - Rx @ c


def _loop_ref(srcc, smask, dstc, nrmc, T0c, gate, p, bf16):
    """The plain ICP loop in the recentred frame; T stays recentred."""
    f32, dev = torch.float32, srcc.device
    c, r_gate = gate[1:], gate[0]
    baug = pack_target(dstc) if bf16 else None
    prior_scale = torch.tensor([p["prior_t"]] * 3 + [p["prior_r"]] * 3,
                               dtype=f32, device=dev)
    use_prior = p["prior_t"] > 0.0 or p["prior_r"] > 0.0
    eye3 = torch.eye(3, dtype=f32, device=dev)
    T = T0c
    rmse = torch.tensor(float("inf"), dtype=f32, device=dev)
    n_inl = torch.zeros((), dtype=f32, device=dev)
    conv = torch.zeros((), dtype=torch.bool, device=dev)
    it = 0
    while it < p["max_iters"] and not (it > 0 and bool(conv)):
        cur = srcc @ T[:3, :3].T + T[:3, 3]
        if bf16:
            idx, _ = packed_argmin_ref(pack_source(cur), baug)
        else:
            idx, _ = nn_bruteforce_ref(cur, dstc)
        q, n = dstc[idx.long()], nrmc[idx.long()]
        if bf16:
            q, n = hi_lo(q), hi_lo(n)
        diff = cur - q
        d2 = torch.sum(diff * diff, dim=-1)
        w = (d2 <= p["max_d2"]).to(f32) * smask
        g_orig = cur + c
        w = w * (torch.sum(g_orig * g_orig, dim=-1)
                 <= r_gate * r_gate).to(f32)
        n_inl = torch.sum(w)  # inliers before Huber down-weighting
        if p["huber"] > 0.0:
            w = w * torch.clamp(
                p["huber"] / torch.sqrt(torch.clamp(d2, min=1e-20)), max=1.0)
        H, g = gn_accum_ref(cur, q, n, w)
        wsum = torch.sum(w)
        prior_w = xi_prior = None
        if use_prior:
            prior_w = torch.clamp(wsum, min=1e-6) * prior_scale
            xi_prior = _log_poly(*_orig_correction(T, T0c, c))
        xi = solve_increment(H, g, p["damping"], p["max_step_trans"],
                             p["max_step_rot"], prior_w=prior_w,
                             xi_prior=xi_prior)
        if p["step_scale"] != 1.0:
            xi = xi * p["step_scale"]
        xi = torch.where(n_inl >= p["min_inliers"], xi, torch.zeros_like(xi))
        dT = se3.exp(xi)
        T_new = dT @ T
        if p["max_total_trans"] > 0.0 or p["max_total_rot"] > 0.0:
            xt = _log_poly(*_orig_correction(T_new, T0c, c))
            s = torch.ones((), dtype=f32, device=dev)
            if p["max_total_trans"] > 0.0:
                s = torch.minimum(s, p["max_total_trans"] / torch.clamp(
                    torch.linalg.vector_norm(xt[:3]), min=1e-12))
            if p["max_total_rot"] > 0.0:
                s = torch.minimum(s, p["max_total_rot"] / torch.clamp(
                    torch.linalg.vector_norm(xt[3:]), min=1e-12))
            X = se3.exp(s * xt)
            # back to the recentred frame: t_cent = t + R·c - c, T = X·T0
            Xc = se3.from_rt(X[:3, :3], X[:3, 3] + X[:3, :3] @ c - c)
            T_new = torch.where(s < 1.0, Xc @ T0c, T_new)
        rmse_new = torch.sqrt(torch.sum(w * d2)
                              / torch.clamp(wsum, min=1e-12))
        conv = torch.abs(rmse - rmse_new) < p["tol"]
        if p["tol_update"] > 0.0:
            step = torch.linalg.vector_norm(dT[:3, 3]) + \
                torch.linalg.matrix_norm(dT[:3, :3] - eye3)
            conv = conv | (step < p["tol_update"])
        T, rmse = T_new, rmse_new
        it += 1
    return (T, rmse, torch.tensor(it, dtype=torch.int32, device=dev),
            n_inl.to(torch.int32), conv)


def icp_fused_ref(src_pts, src_mask, dst_pts, dst_nrm, dst_mask,
                  init_T=None, r_gate=1e9, *, precision="bf16", **kw):
    """Plain torch on any device: see `icp_fused`."""
    srcc, smask, dstc, nrmc, T0c, gate = _prepare(
        src_pts, src_mask, dst_pts, dst_nrm, dst_mask, init_T, r_gate)
    T, rmse, it, n_inl, conv = _loop_ref(srcc, smask, dstc, nrmc, T0c, gate,
                                         _params(**kw), precision == "bf16")
    return _conjugate_out(T, gate[1:]), rmse, it, n_inl, conv


_max_blocks: dict[tuple[int, bool], int] = {}


def max_blocks(device: torch.device, bf16: bool) -> int:
    """K5's co-resident block count on `device` (occupancy x SMs); raises if
    the device cannot launch cooperative kernels."""
    key = (torch.device(device).index or 0, bool(bf16))
    if key not in _max_blocks:
        lib = _build.load()
        out = ctypes.c_int(0)
        with torch.cuda.device(device):
            _build.check(lib.icp_fused_max_blocks(int(bf16),
                                                  ctypes.addressof(out)),
                         "icp_fused_max_blocks (cooperative launch)")
        _max_blocks[key] = out.value
    return _max_blocks[key]


def icp_fused(src_pts, src_mask, dst_pts, dst_nrm, dst_mask, init_T=None,
              r_gate=1e9, *, precision="bf16", **kw):
    """Whole-loop point-to-plane ICP of src (M, 3) onto the model dst (N, 3)
    with normals, in the frame the points are given in. Keyword arguments as
    icp_fused_pallas (max_iters, tol, tol_update, max_corr_dist, huber_delta,
    damping, step_scale, max_step_trans, max_step_rot, min_inliers,
    prior_trans_weight, prior_rot_weight, max_total_trans, max_total_rot);
    precision "highest" or "bf16". Returns (T (4, 4), rmse, iters int32,
    n_inliers int32, converged bool) as tensors. CPU tensors take the plain
    version; CUDA tensors launch the kernel once, with no host sync."""
    if precision not in ("highest", "bf16"):
        raise ValueError(f"icp_fused: unknown precision {precision!r}")
    tensors = [t for t in (src_pts, src_mask, dst_pts, dst_nrm, dst_mask,
                           init_T, r_gate) if isinstance(t, torch.Tensor)]
    if all(t.device.type == "cpu" for t in tensors):
        return icp_fused_ref(src_pts, src_mask, dst_pts, dst_nrm, dst_mask,
                             init_T, r_gate, precision=precision, **kw)
    _build.require_points("icp_fused", src_pts=src_pts, dst_pts=dst_pts,
                          dst_nrm=dst_nrm)
    dev = src_pts.device
    m, n = src_pts.shape[0], dst_pts.shape[0]
    for name, t, shape in (("src_mask", src_mask, (m,)),
                           ("dst_mask", dst_mask, (n,)),
                           ("init_T", init_T, (4, 4)), ("r_gate", r_gate, ())):
        if isinstance(t, torch.Tensor) and (
                t.device != dev or tuple(t.shape) != shape):
            raise ValueError(f"icp_fused: {name} must be {shape} on {dev}, "
                             f"got {tuple(t.shape)} on {t.device}")
    bf16 = precision == "bf16"
    srcc, smask, dstc, nrmc, T0c, gate = _prepare(
        src_pts, src_mask, dst_pts, dst_nrm, dst_mask, init_T, r_gate)
    src4 = torch.cat([srcc, smask[:, None]], dim=1)
    model4 = torch.nn.functional.pad(dstc, (0, 1))
    nrm4 = torch.nn.functional.pad(nrmc, (0, 1))
    baug = pack_target(dstc) if bf16 else None
    grid = min(-(-m // _ROWS), max_blocks(dev, bf16))
    partials = torch.empty((2, grid, _SUMS_STRIDE), dtype=torch.float32,
                           device=dev)
    out = torch.empty(20, dtype=torch.float32, device=dev)
    params = _Params(**_params(**kw))
    lib = _build.load()
    err = lib.icp_fused_f32(
        src4.data_ptr(), m, dstc.data_ptr(), model4.data_ptr(),
        nrm4.data_ptr(),
        None if baug is None else baug.data_ptr(), n, T0c.data_ptr(),
        gate.data_ptr(), ctypes.addressof(params), int(bf16), grid,
        partials.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "icp_fused_f32")
    icp_fused.launches += 1
    return (_conjugate_out(out[:16].view(4, 4), gate[1:]), out[16],
            out[17].to(torch.int32), out[18].to(torch.int32), out[19] > 0.5)


icp_fused.launches = 0
