// The recentred, hi/lo-packed bf16 squared distance shared by the packed
// searches: the lane layout, the split, K5's in-kernel source packing and
// its hi/lo gather (icp_fused.cu); the device packing of K3 and K4
// (packed_prep.cuh) uses the split. The tensor cores score the packed rows
// (packed_mma.cuh).
//
// Port of the "bf16" contraction of tpu_icp_slam/kernels/nn_pallas.py
// (:232-245, :279-314), which icp_fused_pallas.py (:348-376) uses as well.
// Both clouds are recentred on the valid targets' bounding-box midpoint,
// every value x splits Dekker-style into hi = bf16(x) and lo = bf16(x - hi)
// (round to nearest even, as JAX's astype), and 13 of 16 lanes hold
//
//   a = [-2a_hi(3), -2a_lo(3), -2a_hi(3), |a|²_hi, |a|²_lo, 1, 1, 0, 0, 0]
//   b = [ b_hi(3),   b_hi(3),   b_lo(3),  1,       1, |b|²_hi, |b|²_lo, 0...]
//
// so a·b ≈ |a|² + |b|² - 2a·b = d², dropping only the lo·lo terms. The
// product of two bf16 values is exact in float32, so a float32 sum of the
// products is the conformant accumulation of nn_pallas.py:72-84; only the
// order and rounding of that sum differ between the plain version and a
// matrix unit's.

#pragma once

#include <cuda_bf16.h>

namespace packed {

constexpr int kLanes = 16;  // stored per point; lanes 13..15 are zero

__device__ __forceinline__ void split(float x, float& hi, float& lo) {
  hi = __bfloat162float(__float2bfloat16_rn(x));
  lo = __bfloat162float(__float2bfloat16_rn(x - hi));
}

// x rebuilt from its two bf16 halves, hi + lo in float32: what K5's bf16
// gather returns for each model coordinate and normal component
// (icp_fused_pallas.py:452-459, _split_hi_lo at :90-93).
__device__ __forceinline__ float hi_lo(float x) {
  float hi, lo;
  split(x, hi, lo);
  return __fadd_rn(hi, lo);
}

// Source-side packing of a (recentred) point, as a float lane vector.
// |a|² is summed left to right without contraction, like the plain version.
__device__ __forceinline__ void pack_source(float x, float y, float z,
                                            float (&a)[kLanes]) {
  float hx, lx, hy, ly, hz, lz, sh, sl;
  split(x, hx, lx);
  split(y, hy, ly);
  split(z, hz, lz);
  const float sq =
      __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z));
  split(sq, sh, sl);
  a[0] = -2.f * hx;
  a[1] = -2.f * hy;
  a[2] = -2.f * hz;
  a[3] = -2.f * lx;
  a[4] = -2.f * ly;
  a[5] = -2.f * lz;
  a[6] = a[0];
  a[7] = a[1];
  a[8] = a[2];
  a[9] = sh;
  a[10] = sl;
  a[11] = 1.f;
  a[12] = 1.f;
  a[13] = a[14] = a[15] = 0.f;
}

}  // namespace packed
