// K3: brute-force nearest neighbour on recentred, hi/lo-packed bf16 operands,
// for sm_90a.
//
// Replaces the "bf16" branch of tpu_icp_slam/kernels/nn_pallas.py::_nn_kernel
// (wrapper nn_bruteforce_pallas(precision="bf16")): for every packed source
// row, the index of the target row with the smallest packed score
// a_aug · b_aug ≈ d² (packed_d2.cuh) and that score.
//
// What bounds it on an H100: FP32 CUDA-core issue rate, as for K1. At the
// main-path shape (M = N = 16,384) it scores 2.7e8 pairs of 13 lanes. The
// operands are 16-lane bf16 rows, which fit mma.sync m16n8k16 exactly; this
// first version keeps to the CUDA cores (13 FMAs per pair, float32
// accumulation of exact bf16 products), and the tensor-core form is later
// work.
//
// Design: K1's (nn_bruteforce.cu). One thread owns one source row (16 floats
// in registers); a block walks its target split in kTile-row tiles staged in
// shared memory as float rows (every thread reads the same row: a
// broadcast); the target axis is cut into `n_split` ranges so that the grid
// fills the SMs, and nn_fold.cuh folds the splits in index order. Strict `<`
// throughout keeps the lowest-index tie rule. Targets padded with the 1e6
// sentinel score ~1e12 and never win.

#include <cuda_runtime.h>
#include <math.h>

#include "nn_fold.cuh"
#include "packed_d2.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 512;  // 512 rows x 64 B = 32 KB of shared memory

__global__ void __launch_bounds__(kThreads)
nn_bf16_split_kernel(const __nv_bfloat16* __restrict__ a_aug,
                     const __nv_bfloat16* __restrict__ b_aug, int m, int n,
                     int split_len, float* __restrict__ part_d2,
                     int* __restrict__ part_idx) {
  __shared__ float4 tile[kTile][4];
  const int row = blockIdx.x * kThreads + threadIdx.x;
  const int begin = blockIdx.y * split_len;
  const int end = min(n, begin + split_len);

  float a[packed::kLanes] = {};
  if (row < m) packed::load_row(a_aug + (size_t)packed::kLanes * row, a);
  float best = INFINITY;
  int best_idx = begin;

  for (int t0 = begin; t0 < end; t0 += kTile) {
    const int len = min(kTile, end - t0);
    __syncthreads();  // previous tile fully consumed
    for (int i = threadIdx.x; i < len; i += kThreads) {
      packed::stage_row(b_aug + (size_t)packed::kLanes * (t0 + i), tile[i]);
    }
    __syncthreads();
    if (row < m) {
#pragma unroll 4
      for (int j = 0; j < len; ++j) {
        const float d = packed::d2(a, tile[j]);
        if (d < best) {
          best = d;
          best_idx = t0 + j;
        }
      }
    }
  }
  if (row < m) {
    part_d2[(size_t)blockIdx.y * m + row] = best;
    part_idx[(size_t)blockIdx.y * m + row] = best_idx;
  }
}

}  // namespace

// a_aug (m, 16), b_aug (n, 16) bf16 contiguous; scratch part_d2/part_idx
// (n_split, m); outputs e_min (m,) float32 (the packed score, may be
// slightly negative) and idx (m,) int32.
extern "C" cudaError_t nn_bf16_f32(const void* a_aug, const void* b_aug,
                                   int m, int n, int n_split, float* part_d2,
                                   int* part_idx, float* e_min, int* idx,
                                   cudaStream_t stream) {
  if (m <= 0 || n <= 0 || n_split <= 0) return cudaErrorInvalidValue;
  const int split_len = (n + n_split - 1) / n_split;
  const dim3 grid((m + kThreads - 1) / kThreads, n_split);
  nn_bf16_split_kernel<<<grid, kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(a_aug),
      static_cast<const __nv_bfloat16*>(b_aug), m, n, split_len, part_d2,
      part_idx);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  nn_fold_kernel<<<(m + 255) / 256, 256, 0, stream>>>(part_d2, part_idx, m,
                                                      n_split, e_min, idx);
  return cudaGetLastError();
}
