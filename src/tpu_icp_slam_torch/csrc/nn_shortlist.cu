// K4: the rescore nearest neighbour — a per-(row, slot) shortlist on
// recentred, hi/lo-packed bf16 operands, then an exact float32 rescore of
// the shortlist — for sm_90a.
//
// Replaces tpu_icp_slam/kernels/nn_pallas.py::_nn_kernel_shortlist and the
// rescore that follows its pallas_call (nn_bruteforce_pallas(precision=
// "rescore"), nn_pallas.py:214-373, groups = 1).
//
// What it computes. The padded target has Np = S * TN rows (rows >= N hold
// the 1e6 sentinel). The reference deals it round-robin across its S target
// tiles, so tile ("slot") j holds the rows whose ORIGINAL index is j mod S,
// in ascending index order. Per source row and slot, the first minimum of
// the packed score (packed_d2.cuh, the same 13 exact products as K3) gives
// one candidate: S candidates per row. The rescore then takes the first
// minimum over slots IN SLOT ORDER of the exact float32 difference-form d²
// on the recentred coordinates. So an exact tie goes to the lowest slot,
// not to the lowest index.
//
// What bounds it on an H100: FP32 CUDA-core issue rate, as K3 — 13 FMAs per
// (row, target) pair over M x Np pairs; the rescore is S gathers and ~9
// flops per row. This first version keeps to the CUDA cores; the 16-lane
// operands fit mma.sync m16n8k16, which is later work (as for K3).
//
// Design:
//  - shortlist kernel: grid (source tiles of kThreads rows) x (S slots). No
//    physical deal: slot j is the strided row set j, j + S, j + 2S, ... of
//    the packed target, staged through shared memory kTile rows at a time
//    (every thread reads the same row: a broadcast). One thread owns one
//    source row and keeps its running (min, argmin) with a strict `<`, so
//    the first minimum in slot order wins. It writes the ORIGINAL index
//    w * S + j of its pick to cand (S, M).
//  - rescore kernel: one thread per source row, S gathers of the padded
//    recentred target, d² = (dx² + dy²) + dz² with the products and sums
//    rounded separately (no FMA contraction), as the plain torch version and
//    the reference compute it; strict `<` in slot order.
//  - Two launches per call, no atomics: bit-reproducible.

#include <cuda_runtime.h>
#include <math.h>

#include "packed_d2.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 512;  // 512 rows x 64 B = 32 KB of shared memory

__global__ void __launch_bounds__(kThreads)
nn_shortlist_kernel(const __nv_bfloat16* __restrict__ a_aug,
                    const __nv_bfloat16* __restrict__ b_aug, int m,
                    int n_slots, int tile_n, int* __restrict__ cand) {
  __shared__ float4 tile[kTile][4];
  const int row = blockIdx.x * kThreads + threadIdx.x;
  const int slot = blockIdx.y;

  float a[packed::kLanes] = {};
  if (row < m) packed::load_row(a_aug + (size_t)packed::kLanes * row, a);
  float best = INFINITY;
  int best_w = 0;

  for (int w0 = 0; w0 < tile_n; w0 += kTile) {
    const int len = min(kTile, tile_n - w0);
    __syncthreads();  // previous tile fully consumed
    for (int i = threadIdx.x; i < len; i += kThreads) {
      const size_t orig = (size_t)(w0 + i) * n_slots + slot;
      packed::stage_row(b_aug + packed::kLanes * orig, tile[i]);
    }
    __syncthreads();
    if (row < m) {
#pragma unroll 4
      for (int j = 0; j < len; ++j) {
        const float d = packed::d2(a, tile[j]);
        if (d < best) {
          best = d;
          best_w = w0 + j;
        }
      }
    }
  }
  if (row < m) cand[(size_t)slot * m + row] = best_w * n_slots + slot;
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

// a_aug (m, 16) and b_aug (n_slots * tile_n, 16) bf16 contiguous: the packed
// recentred source and padded target, target in original index order.
// src (m, 3) and dst (n_slots * tile_n, 3) float32: the same points,
// recentred (dst padded with the sentinel). Scratch cand (n_slots, m) int32;
// outputs idx (m,) int32 (an index into the padded target) and d2 (m,)
// float32, the exact difference-form squared distance of the pick.
extern "C" cudaError_t nn_rescore_f32(const void* a_aug, const void* b_aug,
                                      const float* src, const float* dst,
                                      int m, int n_slots, int tile_n,
                                      int* cand, int* idx, float* d2,
                                      cudaStream_t stream) {
  if (m <= 0 || n_slots <= 0 || tile_n <= 0) return cudaErrorInvalidValue;
  const dim3 grid((m + kThreads - 1) / kThreads, n_slots);
  nn_shortlist_kernel<<<grid, kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(a_aug),
      static_cast<const __nv_bfloat16*>(b_aug), m, n_slots, tile_n, cand);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  nn_rescore_kernel<<<(m + 255) / 256, 256, 0, stream>>>(src, dst, m, n_slots,
                                                          cand, idx, d2);
  return cudaGetLastError();
}
