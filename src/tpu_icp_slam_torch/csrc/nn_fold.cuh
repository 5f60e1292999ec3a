// Fold of per-split (min, argmin) partials for the brute-force NN kernels
// K1 (nn_bruteforce.cu) and K3 (nn_bf16.cu): each split holds the running
// minimum over one contiguous, ascending target range, so folding the splits
// in order with a strict `<` keeps the lowest-index tie rule. blockIdx.y is
// the batch element (K1's batched form; 1 for K3): partials (B, n_split, m),
// outputs (B, m).

#pragma once

#include <cuda_runtime.h>

namespace {

__global__ void nn_fold_kernel(const float* __restrict__ part_d2,
                               const int* __restrict__ part_idx, int m,
                               int n_split, float* __restrict__ d2,
                               int* __restrict__ idx) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= m) return;
  const size_t b = blockIdx.y;
  part_d2 += b * n_split * m;
  part_idx += b * n_split * m;
  d2 += b * m;
  idx += b * m;
  float best = part_d2[row];
  int best_idx = part_idx[row];
  for (int s = 1; s < n_split; ++s) {
    const float d = part_d2[(size_t)s * m + row];
    if (d < best) {
      best = d;
      best_idx = part_idx[(size_t)s * m + row];
    }
  }
  d2[row] = best;
  idx[row] = best_idx;
}

}  // namespace
