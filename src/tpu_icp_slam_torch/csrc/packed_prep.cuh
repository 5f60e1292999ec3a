// Recentring and packing on the device for the packed bf16 searches K3
// (nn_bf16.cu) and K4 (nn_shortlist.cu): two launches that take the place
// of kernels/nn_bf16.py::recentre, pack_source and pack_target (and, for
// K4, nn_rescore._prepare's padded target), bit for bit.
//
//  - nn_centre_kernel (one block a target): the valid targets'
//    (|coordinates| < 1e5) bounding box and its midpoint c, as
//    nn_bf16.valid_centre computes it (min/max are exact, c = 0.5 * (lo +
//    hi); 0 when no target is valid).
//  - nn_pack_kernel (one thread a row, blockIdx.y the batch row): rows
//    [0, m) are sources, rows [m, m + np) the target, padded with the 1e6
//    sentinel past its n real rows (K4; K3 passes np = n). Each row is
//    recentred and packed into 16 bf16 lanes (packed_d2.cuh) with the plain
//    version's roundings in its order: RNE casts, |x|² summed as (x·x +
//    y·y) + z·z without contraction. The recentred float32 points go to sc
//    and dp when those are not null (K4's rescore reads them; K3 does not).
//
// Batched (the reference's vmap of its whole wrapper): src (B, m, 3) and
// dst (B/G, n, 3). Target t has its own centre, from its own rows; batch
// row b packs its sources against target b / G's centre, and the rows b
// with b % G == 0 pack target b / G. Every row and target is what the
// unbatched launch (B = G = 1) computes on it, bit for bit.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "packed_d2.cuh"

namespace {

constexpr float kValidAbs = 1.0e5f;  // nn_bf16.py::VALID_ABS
constexpr float kPad = 1.0e6f;       // nn_rescore.py::PAD
constexpr int kCentreThreads = 1024;
constexpr int kPackThreads = 256;

__global__ void __launch_bounds__(kCentreThreads)
nn_centre_kernel(const float* __restrict__ dst, int n, float* __restrict__ c) {
  dst += 3 * (size_t)n * blockIdx.x;
  c += 3 * blockIdx.x;
  __shared__ float s_lo[3][kCentreThreads / 32], s_hi[3][kCentreThreads / 32];
  __shared__ int s_any[kCentreThreads / 32];
  float lo[3] = {3.0e38f, 3.0e38f, 3.0e38f};
  float hi[3] = {-3.0e38f, -3.0e38f, -3.0e38f};
  int any = 0;
  for (int i = threadIdx.x; i < n; i += kCentreThreads) {
    const float x = dst[3 * i], y = dst[3 * i + 1], z = dst[3 * i + 2];
    if (fabsf(x) < kValidAbs && fabsf(y) < kValidAbs && fabsf(z) < kValidAbs) {
      lo[0] = fminf(lo[0], x);
      lo[1] = fminf(lo[1], y);
      lo[2] = fminf(lo[2], z);
      hi[0] = fmaxf(hi[0], x);
      hi[1] = fmaxf(hi[1], y);
      hi[2] = fmaxf(hi[2], z);
      any = 1;
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      lo[k] = fminf(lo[k], __shfl_xor_sync(0xffffffffu, lo[k], off));
      hi[k] = fmaxf(hi[k], __shfl_xor_sync(0xffffffffu, hi[k], off));
    }
    any |= __shfl_xor_sync(0xffffffffu, any, off);
  }
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    for (int k = 0; k < 3; ++k) {
      s_lo[k][warp] = lo[k];
      s_hi[k][warp] = hi[k];
    }
    s_any[warp] = any;
  }
  __syncthreads();
  if (threadIdx.x < 3) {
    const int k = threadIdx.x;
    float l = s_lo[k][0], h = s_hi[k][0];
    int a = s_any[0];
    for (int w = 1; w < kCentreThreads / 32; ++w) {
      l = fminf(l, s_lo[k][w]);
      h = fmaxf(h, s_hi[k][w]);
      a |= s_any[w];
    }
    c[k] = a ? __fmul_rn(0.5f, __fadd_rn(l, h)) : 0.f;
  }
}

__device__ __forceinline__ unsigned short bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

// 16 bf16 lanes (as their bits) -> one stored row (two 16-byte stores).
__device__ __forceinline__ void store_lanes(__nv_bfloat16* row,
                                            const unsigned short (&l)[16]) {
  unsigned w[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) w[k] = l[2 * k] | ((unsigned)l[2 * k + 1] << 16);
  uint4* p = reinterpret_cast<uint4*>(row);
  p[0] = make_uint4(w[0], w[1], w[2], w[3]);
  p[1] = make_uint4(w[4], w[5], w[6], w[7]);
}

__global__ void __launch_bounds__(kPackThreads)
nn_pack_kernel(const float* __restrict__ src, const float* __restrict__ dst,
               int m, int n, int np, int group, const float* __restrict__ c,
               float* __restrict__ sc, float* __restrict__ dp,
               __nv_bfloat16* __restrict__ a_aug,
               __nv_bfloat16* __restrict__ b_aug) {
  const int r = blockIdx.x * kPackThreads + threadIdx.x;
  const size_t b = blockIdx.y, t = b / group;
  if (r >= m + (b % group == 0 ? np : 0)) return;
  const bool source = r < m;
  const int j = source ? r : r - m;
  src += 3 * m * b;
  dst += 3 * n * t;
  c += 3 * t;
  if (sc) sc += 3 * m * b;
  if (dp) dp += 3 * np * t;
  a_aug += 16 * m * b;
  b_aug += 16 * np * t;
  float x, y, z;
  if (source || j < n) {
    const float* p = source ? src + 3 * (size_t)j : dst + 3 * (size_t)j;
    x = __fsub_rn(p[0], c[0]);
    y = __fsub_rn(p[1], c[1]);
    z = __fsub_rn(p[2], c[2]);
  } else {
    x = y = z = kPad;
  }
  float* out = source ? sc : dp;
  if (out) {
    out[3 * (size_t)j] = x;
    out[3 * (size_t)j + 1] = y;
    out[3 * (size_t)j + 2] = z;
  }
  float hx, lx, hy, ly, hz, lz, sh, sl;
  packed::split(x, hx, lx);
  packed::split(y, hy, ly);
  packed::split(z, hz, lz);
  const float sq =
      __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z));
  packed::split(sq, sh, sl);
  const unsigned short one = 0x3f80, zero = 0;
  if (source) {
    // [-2a_hi, -2a_lo, -2a_hi, |a|²_hi, |a|²_lo, 1, 1, 0, 0, 0]
    const unsigned short h0 = bf16_bits(-2.f * hx), h1 = bf16_bits(-2.f * hy),
                         h2 = bf16_bits(-2.f * hz);
    const unsigned short l[16] = {h0, h1, h2, bf16_bits(-2.f * lx),
                                  bf16_bits(-2.f * ly), bf16_bits(-2.f * lz),
                                  h0, h1, h2, bf16_bits(sh), bf16_bits(sl),
                                  one, one, zero, zero, zero};
    store_lanes(a_aug + 16 * (size_t)j, l);
  } else {
    // [b_hi, b_hi, b_lo, 1, 1, |b|²_hi, |b|²_lo, 0, 0, 0]
    const unsigned short h0 = bf16_bits(hx), h1 = bf16_bits(hy),
                         h2 = bf16_bits(hz);
    const unsigned short l[16] = {h0, h1, h2, h0, h1, h2, bf16_bits(lx),
                                  bf16_bits(ly), bf16_bits(lz), one, one,
                                  bf16_bits(sh), bf16_bits(sl), zero, zero,
                                  zero};
    store_lanes(b_aug + 16 * (size_t)j, l);
  }
}

// Recentre on each target's valid midpoint (into centre, (B/G, 3)) and
// pack: the two launches above, on `stream`, for `batch` source rows of
// which each `group` consecutive ones share a target.
inline cudaError_t prepare_packed(const float* src, const float* dst, int m,
                                  int n, int np, int batch, int group,
                                  float* centre, float* sc, float* dp,
                                  __nv_bfloat16* a_aug, __nv_bfloat16* b_aug,
                                  cudaStream_t stream) {
  if (batch <= 0 || group <= 0 || batch % group || batch > 65535)
    return cudaErrorInvalidValue;
  nn_centre_kernel<<<batch / group, kCentreThreads, 0, stream>>>(dst, n,
                                                                 centre);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid((m + np + kPackThreads - 1) / kPackThreads, batch);
  nn_pack_kernel<<<grid, kPackThreads, 0, stream>>>(
      src, dst, m, n, np, group, centre, sc, dp, a_aug, b_aug);
  return cudaGetLastError();
}

}  // namespace
