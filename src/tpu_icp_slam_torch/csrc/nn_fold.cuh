// Fold of per-split (min, argmin) partials for the brute-force NN kernels
// K1 (nn_bruteforce.cu) and K3 (nn_bf16.cu): each split holds the running
// first minimum over one contiguous, ascending target range, and the splits
// are ordered by their ranges, so folding them in split order with a strict
// `<` keeps the lowest index on ties. blockIdx.y is the batch element (K1's
// batched form; 1 for K3): partials (B, n_split, m), outputs (B, m). The
// minimum goes to d2 as it is, and as max(minimum, 0) to d2_clamped (K3's
// packed score, which can fall below zero), each where it is not null.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kFoldBatch = 8;  // split partials loaded together

__global__ void nn_fold_kernel(const float* __restrict__ part_d2,
                               const int* __restrict__ part_idx, int m,
                               int n_split, float* __restrict__ d2,
                               int* __restrict__ idx,
                               float* __restrict__ d2_clamped) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= m) return;
  const size_t b = blockIdx.y;
  part_d2 += b * n_split * m;
  part_idx += b * n_split * m;
  float best = part_d2[row];
  int best_split = 0;
  // kFoldBatch loads in flight at a time, then compared in split order
  for (int s0 = 1; s0 < n_split; s0 += kFoldBatch) {
    float d[kFoldBatch];
#pragma unroll
    for (int k = 0; k < kFoldBatch; ++k)
      d[k] = s0 + k < n_split ? part_d2[(size_t)(s0 + k) * m + row]
                              : INFINITY;
#pragma unroll
    for (int k = 0; k < kFoldBatch; ++k) {
      if (d[k] < best) {
        best = d[k];
        best_split = s0 + k;
      }
    }
  }
  if (d2) d2[b * m + row] = best;
  if (d2_clamped) d2_clamped[b * m + row] = best < 0.f ? 0.f : best;
  idx[b * m + row] = part_idx[(size_t)best_split * m + row];
}

}  // namespace
