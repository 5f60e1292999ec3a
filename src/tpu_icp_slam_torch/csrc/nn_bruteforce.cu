// K1: exact brute-force nearest neighbour, float32, for sm_90a.
//
// Replaces tpu_icp_slam/kernels/nn_pallas.py::_nn_kernel in "highest" mode
// (wrapper nn_bruteforce_pallas): for every source point, the index and
// squared distance of its nearest target point.
//
// What bounds it on an H100: FP32 CUDA-core issue rate. The main path calls
// it with M = N = 16,384 points, i.e. 2.7e8 pairs x ~9 flops ~ 2.4 GFLOP per
// call, while the bytes are tiny (< 0.5 MB). A depth-3 contraction gives the
// tensor cores nothing to do in float32, and TF32 would throw away the
// selection precision the flagship configuration needs, so the pairs are
// scored on the CUDA cores.
//
// Design:
//  - One thread owns one source point (kept in registers). A block of
//    kThreads threads walks the targets of its split in kTile-point tiles
//    staged through shared memory as float4 (x, y, z, 0); every thread reads
//    the same float4, a broadcast.
//  - The target axis is cut into `n_split` contiguous ranges (gridDim.y) so
//    that the grid fills the SMs even at M = 16,384 (64 blocks along x).
//    Each (block, split) writes its running (min, argmin) to scratch, and a
//    second launch folds the splits in index order.
//  - Scores are the exact difference form (a-b)·(a-b), not the factored
//    ‖b‖² - 2a·b of the TPU kernel: that form cancels ~|p|²·eps at scene
//    scale, and consumers recompute d² in difference form anyway
//    (icp/loop.py). Selection can therefore differ from the reference only
//    on near-ties below the factored form's f32 error (~1e-3 m²), and from
//    the plain torch version only by the rounding of the two FMAs.
//  - Ties go to the lowest index, as in the reference: each thread scans its
//    targets in index order with a strict `<`, and the fold over splits
//    (ascending index ranges) uses strict `<` too.
//  - Padded targets carry the 1e6 sentinel: (a - 1e6)² ~ 1e12 is finite in
//    float32 and always loses, so no mask is read.
//  - Batched form (loop-closure verification: candidates x yaw hypotheses,
//    the reference's nested vmap over align): gridDim.z is the batch.
//    Source b is searched in target b / group, so `group` consecutive batch
//    rows (the yaw hypotheses of one candidate) share one target scan. Each
//    batch element runs exactly the unbatched computation: B = 1 is the
//    unbatched call, bit for bit.

#include <cuda_runtime.h>
#include <math.h>

#include "nn_fold.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 1024;

__global__ void __launch_bounds__(kThreads)
nn_split_kernel(const float* __restrict__ src, const float* __restrict__ dst,
                int m, int n, int group, int split_len,
                float* __restrict__ part_d2, int* __restrict__ part_idx) {
  __shared__ float4 tile[kTile];
  const int row = blockIdx.x * kThreads + threadIdx.x;
  const int split = blockIdx.y;
  const size_t batch_i = blockIdx.z;
  src += batch_i * m * 3;
  dst += (batch_i / group) * n * 3;
  part_d2 += batch_i * gridDim.y * m;
  part_idx += batch_i * gridDim.y * m;
  const int begin = split * split_len;
  const int end = min(n, begin + split_len);

  float ax = 0.f, ay = 0.f, az = 0.f;
  if (row < m) {
    ax = src[3 * row + 0];
    ay = src[3 * row + 1];
    az = src[3 * row + 2];
  }
  float best = INFINITY;
  int best_idx = begin;

  for (int t0 = begin; t0 < end; t0 += kTile) {
    const int len = min(kTile, end - t0);
    __syncthreads();  // previous tile fully consumed
    const float* base = dst + 3 * (size_t)t0;
    for (int i = threadIdx.x; i < 3 * len; i += kThreads) {
      reinterpret_cast<float*>(tile)[(i / 3) * 4 + (i % 3)] = base[i];
    }
    __syncthreads();
    if (row < m) {
#pragma unroll 8
      for (int j = 0; j < len; ++j) {
        const float4 b = tile[j];
        const float dx = ax - b.x;
        const float dy = ay - b.y;
        const float dz = az - b.z;
        float d = dx * dx;
        d = fmaf(dy, dy, d);
        d = fmaf(dz, dz, d);
        if (d < best) {
          best = d;
          best_idx = t0 + j;
        }
      }
    }
  }
  if (row < m) {
    part_d2[(size_t)split * m + row] = best;
    part_idx[(size_t)split * m + row] = best_idx;
  }
}

}  // namespace

// src (batch, m, 3) and dst (batch / group, n, 3) float32 contiguous;
// scratch part_d2/part_idx (batch, n_split, m); outputs d2 (batch, m)
// float32 and idx (batch, m) int32. batch = group = 1 is the unbatched call.
extern "C" cudaError_t nn_bruteforce_f32(const float* src, const float* dst,
                                         int batch, int group, int m, int n,
                                         int n_split, float* part_d2,
                                         int* part_idx, float* d2, int* idx,
                                         cudaStream_t stream) {
  if (m <= 0 || n <= 0 || n_split <= 0 || batch <= 0 || group <= 0 ||
      batch % group != 0 || batch > 65535)
    return cudaErrorInvalidValue;
  const int split_len = (n + n_split - 1) / n_split;
  const dim3 grid((m + kThreads - 1) / kThreads, n_split, batch);
  nn_split_kernel<<<grid, kThreads, 0, stream>>>(src, dst, m, n, group,
                                                 split_len, part_d2, part_idx);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 fold_grid((m + 255) / 256, batch);
  nn_fold_kernel<<<fold_grid, 256, 0, stream>>>(part_d2, part_idx, m, n_split,
                                                d2, idx);
  return cudaGetLastError();
}
