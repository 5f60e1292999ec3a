// K4: the rescore nearest neighbour — a per-(row, slot) shortlist on
// recentred, hi/lo-packed bf16 operands, then an exact float32 rescore of
// the shortlist — for sm_90a.
//
// Replaces tpu_icp_slam/kernels/nn_pallas.py::_nn_kernel_shortlist
// (nn_pallas.py:142; its pallas_call at :325) and the rescore that follows
// it (nn_bruteforce_pallas(precision="rescore"), groups = 1).
//
// What it computes. Both clouds are recentred on the bounding-box midpoint
// of the valid targets (|coordinates| < 1e5), the target is padded to
// Np = S * TN rows with the 1e6 sentinel, and both are packed into 16-lane
// bf16 rows (packed_d2.cuh). The reference deals the padded target
// round-robin across its S target tiles, so tile ("slot") j holds the rows
// whose ORIGINAL index is j mod S, in ascending index order. Per source row
// and slot, the first minimum of the packed score gives one candidate: S
// candidates per row. The rescore then takes the first minimum over slots IN
// SLOT ORDER of the exact float32 difference-form d² on the recentred
// coordinates. So an exact tie goes to the lowest slot, not to the lowest
// index.
//
// What bounds it on an H100: the 16-lane bf16 contraction on the tensor
// cores, 2.7e8 pairs x 32 flops at 16,384² = 0.0087 ms at 989 TFLOP/s. In
// practice the argmin bookkeeping on the CUDA cores (a compare and two
// selects per score, ~3 instructions, against one mma per 128 scores) sets
// the pace.
//
// Design, four launches per call, no atomics, bit-reproducible:
//  - nn_centre_kernel (one block): the valid targets' bounding box and its
//    midpoint c, as kernels/nn_bf16.py::valid_centre computes it (min/max
//    are exact, c = 0.5 * (lo + hi)).
//  - nn_pack_kernel (one thread a row): the recentred source and padded
//    target in float32 (what the rescore reads) and their packed bf16 rows,
//    bit-equal to nn_bf16.recentre/pack_source/pack_target and
//    nn_rescore._prepare: the same roundings in the same order (RNE casts,
//    |x|² summed as (x·x + y·y) + z·z without contraction).
//  - nn_shortlist_kernel: the packed score on the tensor cores through
//    packed_mma.cuh. A work item is 128 source rows (4 warps x 2 m-tiles of
//    16) against one slot; a persistent grid of sms x blocks_per_sm blocks
//    walks the (row tiles x slots) items. Slot j is the strided row set j,
//    j + S, ... of the packed target, staged as bf16 rows (two 16-byte
//    cp.async a row, no widening) 256 at a time, double-buffered. The A
//    fragments stay in registers for the whole slot. It writes the ORIGINAL
//    index w * S + j of each pick to cand (S, M), and its score to
//    cand_score when that pointer is not null (chip_smoke.py phase 11).
//  - nn_rescore_kernel: one thread per source row, S gathers of the padded
//    recentred target, d² = (dx² + dy²) + dz² with the products and sums
//    rounded separately (no FMA contraction), as the plain torch version and
//    the reference compute it; strict `<` in slot order.
// The tensor cores' scores sat within 5.1e-8 * sum|a_k b_k| of the float64
// packed score on chip_smoke.py phase 11's 16,384² problem on an H100 (the
// bound held is tau = 2^-19 = 1.9e-6); times in PERF.md §6.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "packed_d2.cuh"
#include "packed_mma.cuh"

namespace {

constexpr float kValidAbs = 1.0e5f;  // nn_bf16.py::VALID_ABS
constexpr float kPad = 1.0e6f;       // nn_rescore.py::PAD
constexpr int kCentreThreads = 1024;
constexpr int kPackThreads = 256;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kMt = 2;                          // m-tiles of 16 rows a warp
constexpr int kBlockRows = kWarps * kMt * 16;   // 128
constexpr int kTile = 256;                      // targets per staged tile
constexpr int kTileBytes = kTile * packed_mma::kRowBytes;

__global__ void __launch_bounds__(kCentreThreads)
nn_centre_kernel(const float* __restrict__ dst, int n, float* __restrict__ c) {
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

// Rows [0, m) are sources, [m, m + np) the padded target (rows >= n of it
// hold the sentinel). Writes the recentred float32 point and its packed row.
__global__ void __launch_bounds__(kPackThreads)
nn_pack_kernel(const float* __restrict__ src, const float* __restrict__ dst,
               int m, int n, int np, const float* __restrict__ c,
               float* __restrict__ sc, float* __restrict__ dp,
               __nv_bfloat16* __restrict__ a_aug,
               __nv_bfloat16* __restrict__ b_aug) {
  const int r = blockIdx.x * kPackThreads + threadIdx.x;
  if (r >= m + np) return;
  const bool source = r < m;
  const int j = source ? r : r - m;
  float x, y, z;
  if (source || j < n) {
    const float* p = source ? src + 3 * (size_t)j : dst + 3 * (size_t)j;
    x = __fsub_rn(p[0], c[0]);
    y = __fsub_rn(p[1], c[1]);
    z = __fsub_rn(p[2], c[2]);
  } else {
    x = y = z = kPad;
  }
  float* out = source ? sc + 3 * (size_t)j : dp + 3 * (size_t)j;
  out[0] = x;
  out[1] = y;
  out[2] = z;
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

// Rows w = t0 .. t0 + len - 1 of a slot (global rows w * stride + slot)
// into the tile; rows [len, round_up(len, 16)) get the padding row.
__device__ __forceinline__ void stage_slot_tile(
    unsigned char* tile, const __nv_bfloat16* __restrict__ b_aug, int t0,
    int len, int stride, int slot) {
  const unsigned base = cp_async::smem_addr(tile);
  for (int i = threadIdx.x; i < len; i += kThreads)
    packed_mma::stage_row(base, i,
                          b_aug + 16 * ((size_t)(t0 + i) * stride + slot));
  for (int i = len + threadIdx.x; i < ((len + 15) & ~15); i += kThreads)
    packed_mma::pad_row(tile, i);
}

__global__ void __launch_bounds__(kThreads)
nn_shortlist_kernel(const __nv_bfloat16* __restrict__ a_aug,
                    const __nv_bfloat16* __restrict__ b_aug, int m,
                    int n_slots, int tile_n, int* __restrict__ cand,
                    float* __restrict__ cand_score) {
  __shared__ __align__(128) unsigned char s_b[2][kTileBytes];
  __shared__ __align__(128)
      unsigned char s_a[kBlockRows * packed_mma::kRowBytes];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row_tiles = (m + kBlockRows - 1) / kBlockRows;
  const int n_tiles = (tile_n + kTile - 1) / kTile;
  const unsigned a_base = cp_async::smem_addr(s_a);

  for (int item = blockIdx.x; item < row_tiles * n_slots; item += gridDim.x) {
    const int slot = item / row_tiles;
    const int row0 = (item - slot * row_tiles) * kBlockRows;
    // the block's source rows (rows >= m are zero and never written out)
    for (int i = threadIdx.x; i < kBlockRows; i += kThreads) {
      if (row0 + i < m) {
        packed_mma::stage_row(a_base, i, a_aug + 16 * (size_t)(row0 + i));
      } else {
        *reinterpret_cast<uint4*>(s_a + packed_mma::offset(i, 0)) =
            make_uint4(0, 0, 0, 0);
        *reinterpret_cast<uint4*>(s_a + packed_mma::offset(i, 1)) =
            make_uint4(0, 0, 0, 0);
      }
    }
    stage_slot_tile(s_b[0], b_aug, 0, min(kTile, tile_n), n_slots, slot);
    cp_async::commit();

    unsigned a[kMt][4];
    float best[kMt][2];
    int idx[kMt][2];
#pragma unroll
    for (int mt = 0; mt < kMt; ++mt)
      for (int h = 0; h < 2; ++h) {
        best[mt][h] = INFINITY;
        idx[mt][h] = 0;
      }
    for (int t = 0; t < n_tiles; ++t) {
      const int t0 = t * kTile;
      const int len = min(kTile, tile_n - t0);
      if (t + 1 < n_tiles)
        stage_slot_tile(s_b[(t + 1) & 1], b_aug, t0 + kTile,
                        min(kTile, tile_n - t0 - kTile), n_slots, slot);
      cp_async::commit();
      cp_async::wait_prior();  // tile t (and the sources) landed
      __syncthreads();
      if (t == 0) {
#pragma unroll
        for (int mt = 0; mt < kMt; ++mt)
          packed_mma::load_a(a[mt], a_base, (warp * kMt + mt) * 16, lane);
      }
      const unsigned tile = cp_async::smem_addr(s_b[t & 1]);
      for (int n0 = 0; n0 < len; n0 += 16)
        packed_mma::score16<kMt>(a, tile, n0, t0, lane, best, idx);
      __syncthreads();  // every warp is done with this buffer
    }
#pragma unroll
    for (int mt = 0; mt < kMt; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        packed_mma::quad_min(best[mt][h], idx[mt][h]);
        const int row = row0 + (warp * kMt + mt) * 16 + (lane >> 2) + 8 * h;
        if ((lane & 3) == 0 && row < m) {
          cand[(size_t)slot * m + row] = idx[mt][h] * n_slots + slot;
          if (cand_score) cand_score[(size_t)slot * m + row] = best[mt][h];
        }
      }
  }
}

__global__ void nn_rescore_kernel(const float* __restrict__ src,
                                  const float* __restrict__ dst, int m,
                                  int n_slots, const int* __restrict__ cand,
                                  int* __restrict__ idx,
                                  float* __restrict__ d2) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= m) return;
  const float sx = src[3 * row + 0];
  const float sy = src[3 * row + 1];
  const float sz = src[3 * row + 2];
  float best = INFINITY;
  int best_idx = cand[row];
  for (int s = 0; s < n_slots; ++s) {
    const int c = cand[(size_t)s * m + row];
    const float dx = sx - dst[3 * (size_t)c + 0];
    const float dy = sy - dst[3 * (size_t)c + 1];
    const float dz = sz - dst[3 * (size_t)c + 2];
    const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                              __fmul_rn(dz, dz));
    if (d < best) {
      best = d;
      best_idx = c;
    }
  }
  idx[row] = best_idx;
  d2[row] = best;
}

}  // namespace

// Blocks of the shortlist kernel one SM holds at once, for the wrapper's
// persistent grid.
extern "C" cudaError_t nn_shortlist_blocks_per_sm(int* out) {
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, nn_shortlist_kernel,
                                                       kThreads, 0);
}

// The whole rescore NN: recentre and pack (two launches), shortlist (grid
// blocks), rescore. src (m, 3), dst (n, 3) float32. Scratch, for the padded
// target's np = n_slots * tile_n rows: centre (3,), sc (m, 3) and dp (np, 3)
// float32, a_aug (m, 16) and b_aug (np, 16) bf16, cand (n_slots, m) int32;
// cand_score (n_slots, m) float32 or null. Outputs idx (m,) int32 (an index
// into the padded target) and d2 (m,) float32, the exact difference-form
// squared distance of the pick.
extern "C" cudaError_t nn_rescore_f32(const float* src, const float* dst,
                                      int m, int n, int n_slots, int tile_n,
                                      int grid, float* centre, float* sc,
                                      float* dp, void* a_aug, void* b_aug,
                                      int* cand, float* cand_score, int* idx,
                                      float* d2, cudaStream_t stream) {
  if (m <= 0 || n <= 0 || n_slots <= 0 || tile_n <= 0 || grid <= 0 ||
      (long long)n_slots * tile_n < n)
    return cudaErrorInvalidValue;
  const int np = n_slots * tile_n;
  nn_centre_kernel<<<1, kCentreThreads, 0, stream>>>(dst, n, centre);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  nn_pack_kernel<<<(m + np + kPackThreads - 1) / kPackThreads, kPackThreads, 0,
                   stream>>>(src, dst, m, n, np, centre, sc, dp,
                             static_cast<__nv_bfloat16*>(a_aug),
                             static_cast<__nv_bfloat16*>(b_aug));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  nn_shortlist_kernel<<<grid, kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(a_aug),
      static_cast<const __nv_bfloat16*>(b_aug), m, n_slots, tile_n, cand,
      cand_score);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  nn_rescore_kernel<<<(m + 255) / 256, 256, 0, stream>>>(sc, dp, m, n_slots,
                                                          cand, idx, d2);
  return cudaGetLastError();
}

// The tensor-core scorer over a whole target: for each of the m packed
// source rows, the first minimum e_min and its index idx over the n packed
// target rows (the shortlist kernel with one slot). For tests and
// chip_smoke.py phase 11; the main path does not call it.
extern "C" cudaError_t packed_mma_argmin(const void* a_aug, const void* b_aug,
                                         int m, int n, float* e_min, int* idx,
                                         cudaStream_t stream) {
  if (m <= 0 || n <= 0) return cudaErrorInvalidValue;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, nn_shortlist_kernel, kThreads, 0);
  if (err != cudaSuccess) return err;
  const int items = (m + kBlockRows - 1) / kBlockRows;
  const int grid = items < sms * per_sm ? items : sms * per_sm;
  nn_shortlist_kernel<<<grid, kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(a_aug),
      static_cast<const __nv_bfloat16*>(b_aug), m, 1, n, idx, e_min);
  return cudaGetLastError();
}
