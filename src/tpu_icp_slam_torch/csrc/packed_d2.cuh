// The recentred, hi/lo-packed bf16 squared distance shared by K3
// (nn_bf16.cu) and K5 (icp_fused.cu).
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
// product of two bf16 values is exact in float32, so summing the 13 products
// in float32 is the conformant accumulation of nn_pallas.py:72-84; only the
// order of the float32 sum differs from a matrix unit's (here: lane order).

#pragma once

#include <cuda_bf16.h>

namespace packed {

constexpr int kLanes = 16;  // stored per point; lanes 13..15 are zero

// One stored (16,) bf16 row -> 16 floats. bf16 -> f32 is exact: the bf16
// bits are the high half of the float's.
__device__ __forceinline__ void load_row(const __nv_bfloat16* __restrict__ row,
                                         float (&v)[kLanes]) {
  const uint4* p = reinterpret_cast<const uint4*>(row);
  const uint4 u0 = p[0], u1 = p[1];
  const unsigned w[8] = {u0.x, u0.y, u0.z, u0.w, u1.x, u1.y, u1.z, u1.w};
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    v[2 * k] = __uint_as_float(w[k] << 16);
    v[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
  }
}

__device__ __forceinline__ void split(float x, float& hi, float& lo) {
  hi = __bfloat162float(__float2bfloat16_rn(x));
  lo = __bfloat162float(__float2bfloat16_rn(x - hi));
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

// Σ_k a[k]·b[k] over the 13 live lanes, in lane order; b is a target row
// staged as four float4 (lanes 0-3, 4-7, 8-11, 12-15).
__device__ __forceinline__ float d2(const float (&a)[kLanes],
                                    const float4* __restrict__ b) {
  const float4 b0 = b[0], b1 = b[1], b2 = b[2], b3 = b[3];
  float e = a[0] * b0.x;
  e = fmaf(a[1], b0.y, e);
  e = fmaf(a[2], b0.z, e);
  e = fmaf(a[3], b0.w, e);
  e = fmaf(a[4], b1.x, e);
  e = fmaf(a[5], b1.y, e);
  e = fmaf(a[6], b1.z, e);
  e = fmaf(a[7], b1.w, e);
  e = fmaf(a[8], b2.x, e);
  e = fmaf(a[9], b2.y, e);
  e = fmaf(a[10], b2.z, e);
  e = fmaf(a[11], b2.w, e);
  e = fmaf(a[12], b3.x, e);
  return e;
}

// Stage one stored target row into shared memory as four float4.
__device__ __forceinline__ void stage_row(const __nv_bfloat16* __restrict__ row,
                                          float4* __restrict__ dst) {
  float v[kLanes];
  load_row(row, v);
  dst[0] = make_float4(v[0], v[1], v[2], v[3]);
  dst[1] = make_float4(v[4], v[5], v[6], v[7]);
  dst[2] = make_float4(v[8], v[9], v[10], v[11]);
  dst[3] = make_float4(v[12], v[13], v[14], v[15]);
}

}  // namespace packed
