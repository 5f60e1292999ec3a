// The row sums of point-to-plane Gauss-Newton and their grid reduction,
// shared by K2 (gn_accum.cu) and K2S (gn_step.cu) so that the two give H
// and g bit for bit alike: the same terms, the same row partition (a
// grid-stride loop over kThreads-thread blocks), the same shuffle tree, the
// same warp order in a block and the same block order in the last block.
#pragma once

#include <cuda_runtime.h>

namespace gn_rows {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTerms = 27;  // 21 of H's upper triangle, then 6 of g

// Adds row i's terms to acc[0, 27): the Jacobian J = [n, p x n] and the
// residual r = n·(p - q), w JᵀJ by rows of the upper triangle, then w r J.
__device__ __forceinline__ void add_row(const float* __restrict__ p,
                                        const float* __restrict__ q,
                                        const float* __restrict__ nrm, int i,
                                        float wi, float* acc) {
  const float px = p[3 * i], py = p[3 * i + 1], pz = p[3 * i + 2];
  const float qx = q[3 * i], qy = q[3 * i + 1], qz = q[3 * i + 2];
  const float nx = nrm[3 * i], ny = nrm[3 * i + 1], nz = nrm[3 * i + 2];
  float J[6];
  J[0] = nx;
  J[1] = ny;
  J[2] = nz;
  J[3] = py * nz - pz * ny;
  J[4] = pz * nx - px * nz;
  J[5] = px * ny - py * nx;
  const float r = (px - qx) * nx + (py - qy) * ny + (pz - qz) * nz;
  int k = 0;
#pragma unroll
  for (int a = 0; a < 6; ++a) {
    const float wa = wi * J[a];
#pragma unroll
    for (int b = a; b < 6; ++b) acc[k++] += wa * J[b];
  }
  const float wr = wi * r;
#pragma unroll
  for (int a = 0; a < 6; ++a) acc[21 + a] += wr * J[a];
}

// The grid's sums of acc[0, S): each block reduces its threads' sums (warp
// shuffles, then the warps in order) into its partial[blockIdx.x * S ...],
// fences it and takes a ticket. Returns false in every block but the last
// to finish, where sums[0, S) (shared) then hold the partials summed in
// block order. atomicInc wraps the ticket back to 0 in the last block,
// ready for the next launch. Called by every thread of the block.
template <int S>
__device__ __forceinline__ bool grid_sum(float (&acc)[S],
                                         float* __restrict__ partial,
                                         unsigned* __restrict__ ticket,
                                         float* sums) {
#pragma unroll
  for (int k = 0; k < S; ++k) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc[k] += __shfl_down_sync(0xffffffffu, acc[k], off);
  }
  __shared__ float warp_sums[kWarps][S];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < S; ++k) warp_sums[warp][k] = acc[k];
  }
  __syncthreads();
  if (threadIdx.x < S) {
    float s = 0.f;
#pragma unroll
    for (int v = 0; v < kWarps; ++v) s += warp_sums[v][threadIdx.x];
    partial[blockIdx.x * S + threadIdx.x] = s;
    __threadfence();  // the partial is visible before the ticket is taken
  }
  __syncthreads();
  __shared__ bool last;
  if (threadIdx.x == 0)
    last = atomicInc(ticket, gridDim.x - 1) == gridDim.x - 1;
  __syncthreads();
  if (!last) return false;
  const int t = threadIdx.x;
  if (t < S) {
    float s = 0.f;
    for (unsigned b = 0; b < gridDim.x; ++b) s += __ldcg(partial + b * S + t);
    sums[t] = s;
  }
  __syncthreads();
  return true;
}

// sums[0, 27) -> H (6x6, symmetric, row-major) and g (6), by threads
// 0-35 of the block.
__device__ __forceinline__ void write_hg(const float* sums,
                                         float* __restrict__ H,
                                         float* __restrict__ g) {
  const int t = threadIdx.x;
  if (t < 36) {
    const int a = t / 6, b = t % 6;
    const int lo = min(a, b), hi = max(a, b);
    // row `lo` of the upper triangle starts at lo*6 - lo*(lo-1)/2
    const int k = lo * 6 - (lo * (lo - 1)) / 2 + (hi - lo);
    H[t] = sums[k];
  }
  if (t < 6) g[t] = sums[21 + t];
}

}  // namespace gn_rows
