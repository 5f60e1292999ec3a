"""Communication-volume accounting for the distributed paths (port of
tpu_icp_slam/dist/comm.py).

Scaling across cards cannot be *measured* on one card, so this module gives
the falsifiable proxy: exact per-step collective payloads computed from
program parameters, and an analytic compute-vs-interconnect model with its
break-even point. Every formula names the collective that moves the bytes;
`obs/bench.py` rung 5 emits these numbers beside its timing rows when the
world has two or more cards.

Conventions:
- payload = logical tensor size reduced/gathered, in bytes;
- wire bytes per device for a ring all-reduce of payload P over n devices
  = 2·(n−1)/n · P (reduce-scatter + all-gather halves), the standard ring
  model.

Stated deviation: the constants are the H100's, not the TPU's. The payload
and wire-byte functions and `schur_separator_count` are the reference's,
unchanged; the models take the peak of the arithmetic each one counts.
"""

from __future__ import annotations

import dataclasses

# Published NVIDIA H100 SXM5 figures (H100 datasheet; dense, no sparsity):
H100_BF16_FLOPS = 989e12  # bf16 tensor-core peak (chip_smoke.py's figure)
H100_FP32_FLOPS = 67e12  # FP32 peak (chip_smoke.py's figure)
H100_FP64_FLOPS = 67e12  # FP64 tensor-core peak (the Schur solve is float64)
# NVLink 4: 900 GB/s per card over 18 links, both directions together
NVLINK_BYTES_PER_S = 450e9  # one direction, per card
# InfiniBand NDR: 400 Gb/s per port, the cross-host class
IB_NDR_BYTES_PER_S = 50e9
# Measured shares of peak on an H100 (PERF.md §6, chip_smoke.py): the
# sharded ICP's model counts the 16-lane packed bf16 score (2·M·N·16
# operations an iteration), whose kernel (K3) reaches 10% of the bf16 peak.
ICP_MFU = 0.10
# No share of a small float64 Cholesky has been measured on the H100; the
# smallest share PERF.md §6 records (K2, 4%, a reduction of small systems)
# stands in until one is.
SCHUR_MFU = 0.04


def ring_allreduce_wire_bytes(payload_bytes: float, n_devices: int) -> float:
    """Wire bytes per device for one all-reduce (the reference's psum) of
    `payload_bytes` over n devices."""
    if n_devices <= 1:
        return 0.0
    return 2.0 * (n_devices - 1) / n_devices * payload_bytes


def sharded_icp_psum_payload(method: str, d: int = 3,
                             dtype_bytes: int = 4) -> dict:
    """Per-ICP-iteration all-reduce payloads of dist/sharded_icp.py (the
    reference's psum; the names are the reference's).

    point_to_point: raw Umeyama moments — Σw (1), Σw·p (d), Σw·q (d),
    Σw·p·qᵀ (d²) — plus the 3-float stats vector (Σw, Σw·d², inliers).
    point_to_plane: the 6×6 normal-equation block H (lower-triangle counted
    full — the all-reduce moves the dense tensor), the gradient g (6), plus
    stats. Exactly one all-reduce per iteration, the statistics packed into
    one tensor.
    """
    if method == "point_to_plane":
        k = 6 if d == 3 else 3
        floats = k * k + k + 3
    else:
        floats = 1 + d + d + d * d + 3
    return {
        "method": method,
        "floats_per_iteration": floats,
        "payload_bytes_per_iteration": floats * dtype_bytes,
    }


def schur_psum_payload(n_separator: int, d: int = 3,
                       dtype_bytes: int = 4) -> dict:
    """Per-GN-iteration payload of the distributed Schur solve's separator
    all-reduce.

    One all-reduce of the reduced separator system per iteration: H_SS
    ((Ns·k)² floats, k = 6 twist dims in 3D) + g_S (Ns·k), packed as one
    tensor (backend/schur.py); the (K, 6) update's all-reduce comes on top.
    """
    k = 6 if d == 3 else 3
    floats = (n_separator * k) ** 2 + n_separator * k
    return {
        "n_separator": n_separator,
        "floats_per_iteration": floats,
        "payload_bytes_per_iteration": floats * dtype_bytes,
    }


def schur_separator_count(graph, n_blocks: int) -> int:
    """Ns for a concrete graph partition (host-side plan, cheap)."""
    from tpu_icp_slam_torch.backend.schur import make_plan

    plan = make_plan(
        graph.fi, graph.fj, graph.weight, graph.pose_mask, n_blocks
    )
    return int(len(plan.separator))


@dataclasses.dataclass(frozen=True)
class ScalingModel:
    """Analytic multi-card efficiency estimate for one pipeline step.

    compute_mfu: fraction of `peak_flops` the step's compute actually
    sustains — peak-rate compute times make the comm fraction look
    artificially large. Callers pass the measured rate (ICP_MFU, SCHUR_MFU
    above); 1.0 gives the most pessimistic (peak-compute) bound.
    """

    compute_flops: float  # per step, total across devices
    comm_payload_bytes: float  # per step, summed all-reduce payloads
    n_devices: int
    link_bytes_per_s: float
    compute_mfu: float = 1.0
    peak_flops: float = H100_BF16_FLOPS  # per device

    @property
    def compute_s(self) -> float:
        rate = self.n_devices * self.peak_flops * self.compute_mfu
        return self.compute_flops / rate

    @property
    def comm_s(self) -> float:
        wire = ring_allreduce_wire_bytes(
            self.comm_payload_bytes, self.n_devices
        )
        return wire / self.link_bytes_per_s

    @property
    def efficiency_bound(self) -> float:
        """Upper bound on parallel efficiency: serial fraction = comm that
        cannot overlap compute (worst case, no overlap)."""
        c, m = self.compute_s, self.comm_s
        return c / (c + m) if (c + m) > 0 else 1.0


def sharded_icp_scaling_model(
    m_points: int, n_points: int, iters: float, n_devices: int,
    method: str = "point_to_plane", lanes: int = 16, passes: int = 1,
    link_bytes_per_s: float = NVLINK_BYTES_PER_S,
    compute_mfu: float = ICP_MFU,
) -> dict:
    """Compute-vs-NVLink model for the point-sharded ICP (config 5 front
    end).

    Compute = the NN contraction (2·M·N·lanes·passes per iteration, the
    dominant kernel) at the measured kernel rate (compute_mfu of the bf16
    peak); comm = one moment/normal-equation all-reduce per iteration.
    Returns the model row emitted by bench rung 5.
    """
    payload = sharded_icp_psum_payload(method)["payload_bytes_per_iteration"]
    model = ScalingModel(
        compute_flops=2.0 * m_points * n_points * lanes * passes * iters,
        comm_payload_bytes=payload * iters,
        n_devices=n_devices,
        link_bytes_per_s=link_bytes_per_s,
        compute_mfu=compute_mfu,
    )
    return {
        "kind": "sharded_icp",
        "devices": n_devices,
        "compute_flops_per_step": model.compute_flops,
        "psum_payload_bytes_per_step": model.comm_payload_bytes,
        "wire_bytes_per_device_per_step": ring_allreduce_wire_bytes(
            model.comm_payload_bytes, n_devices
        ),
        "compute_s_at_peak": model.compute_s,
        "comm_s": model.comm_s,
        "efficiency_bound": round(model.efficiency_bound, 4),
    }


def schur_scaling_model(
    n_separator: int, n_interior_max: int, n_factors: int, iters: int,
    n_devices: int, link_bytes_per_s: float = IB_NDR_BYTES_PER_S,
    dtype_bytes: int = 8, compute_mfu: float = SCHUR_MFU,
) -> dict:
    """Compute-vs-InfiniBand model for the distributed Schur solve (config 5
    backend; keyframe blocks across HOSTS, so the slower cross-host link is
    the honest one; float64, as the port solves).

    Per-block compute ≈ interior Cholesky ((Ni·6)³/3) + factor linearize
    (~O(F/B · 400 flops)) at compute_mfu of the FP64 peak; comm = the
    separator all-reduce per iteration.
    """
    k = 6
    chol = ((n_interior_max * k) ** 3) / 3.0
    linz = 400.0 * n_factors / max(n_devices, 1)
    payload = schur_psum_payload(n_separator, dtype_bytes=dtype_bytes)
    model = ScalingModel(
        compute_flops=(chol + linz) * n_devices * iters,
        comm_payload_bytes=payload["payload_bytes_per_iteration"] * iters,
        n_devices=n_devices,
        link_bytes_per_s=link_bytes_per_s,
        compute_mfu=compute_mfu,
        peak_flops=H100_FP64_FLOPS,
    )
    return {
        "kind": "distributed_schur",
        "devices": n_devices,
        "n_separator": n_separator,
        "psum_payload_bytes_per_iteration":
            payload["payload_bytes_per_iteration"],
        "wire_bytes_per_device_per_step": ring_allreduce_wire_bytes(
            model.comm_payload_bytes, n_devices
        ),
        "compute_s_at_peak": model.compute_s,
        "comm_s": model.comm_s,
        "efficiency_bound": round(model.efficiency_bound, 4),
    }
