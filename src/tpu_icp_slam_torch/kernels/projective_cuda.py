"""PJ: the projective correspondence of RGB-D ICP — the CUDA launch.

`projective_lookup(cur, vertex, normal, valid, fxy, cx, cy, max_d2,
src_normals, normal_gate_cos)` launches csrc/projective.cu: cur (M, 3)
float32 in the target camera's frame, the target's vertex and normal maps
(H, W, 3) float32 and validity (H, W) bool, fxy (2,) float32 on the
device -> (q (M, 3), n (M, 3), gate (M,) float32 0/1, d2 (M,)), one thread
a row, one launch, no host read. The plain version, the dispatch and the
CPU path are icp/projective.py's (`_lookup_ref`, `projective_correspondence`);
q and n equal the plain version's bit for bit, d2 within an ulp.
"""

from __future__ import annotations

import torch

from tpu_icp_slam_torch.kernels import _build


def projective_lookup(cur: torch.Tensor, vertex: torch.Tensor,
                      normal: torch.Tensor, valid: torch.Tensor,
                      fxy: torch.Tensor, cx: float, cy: float, max_d2: float,
                      src_normals: torch.Tensor | None,
                      normal_gate_cos: float):
    """One PJ launch on cur's CUDA device (see the module docstring);
    src_normals (M, 3) or None (no normal gate)."""
    h, w = valid.shape
    m = cur.shape[0]
    for name, t, dtype, shape in (
            ("cur", cur, torch.float32, (m, 3)),
            ("vertex", vertex, torch.float32, (h, w, 3)),
            ("normal", normal, torch.float32, (h, w, 3)),
            ("valid", valid, torch.bool, (h, w)),
            ("fxy", fxy, torch.float32, (2,)),
            ("src_normals", src_normals, torch.float32, (m, 3))):
        if t is None and name == "src_normals":
            continue
        if (t.device != cur.device or t.device.type != "cuda"
                or t.dtype != dtype or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(f"projective_lookup: {name} must be contiguous "
                             f"{dtype} {shape} on cur's CUDA device, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if m == 0:
        raise ValueError("projective_lookup: cur is empty")
    q = torch.empty((m, 3), dtype=torch.float32, device=cur.device)
    n = torch.empty_like(q)
    gate = torch.empty(m, dtype=torch.float32, device=cur.device)
    d2 = torch.empty_like(gate)
    err = _build.load().projective_f32(
        cur.data_ptr(), m, vertex.data_ptr(), normal.data_ptr(),
        valid.data_ptr(), fxy.data_ptr(), cx, cy, h, w, max_d2,
        None if src_normals is None else src_normals.data_ptr(),
        normal_gate_cos, q.data_ptr(), n.data_ptr(), gate.data_ptr(),
        d2.data_ptr(), torch.cuda.current_stream(cur.device).cuda_stream)
    _build.check(err, "projective_f32")
    projective_lookup.launches += 1
    return q, n, gate, d2


projective_lookup.launches = 0  # every launch
