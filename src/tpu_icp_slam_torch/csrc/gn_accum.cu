// K2: point-to-plane Gauss-Newton accumulation, float32, for sm_90a.
//
// Replaces tpu_icp_slam/kernels/gn_pallas.py::_gn_kernel (wrapper
// gn_accum_pallas): per row the Jacobian J = [n, p x n] and residual
// r = n·(p - q), summed into H = Σ w JᵀJ (6x6) and g = Σ w r J (6).
//
// What bounds it on an H100: launch latency. The main path calls it with
// M = 16,384 rows, ~0.7 MB read (p, q, n, w) and ~30 flops a row, a few
// microseconds of memory traffic; the two launches cost as much.
//
// Design:
//  - Each thread accumulates the 27 unique sums (21 of H's upper triangle,
//    6 of g) over a grid-stride range of rows, in registers.
//  - Warp shuffles reduce them, then the block's warps are summed in
//    shared memory in warp order; each block writes one (27,) partial.
//  - A second single-block launch sums the partials in block order and
//    writes H (symmetric) and g.
//  - No float atomics: for a given grid the summation order is fixed, so
//    a run on the card is bit-reproducible (the streaming and the fused
//    pipeline runs must agree exactly).
//  - Rows with w = 0 (gated or padded correspondences) add nothing.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSums = 27;

__global__ void __launch_bounds__(kThreads)
gn_partial_kernel(const float* __restrict__ p, const float* __restrict__ q,
                  const float* __restrict__ nrm, const float* __restrict__ w,
                  int m, float* __restrict__ partial) {
  float acc[kSums];
#pragma unroll
  for (int k = 0; k < kSums; ++k) acc[k] = 0.f;

  for (int i = blockIdx.x * kThreads + threadIdx.x; i < m;
       i += gridDim.x * kThreads) {
    const float px = p[3 * i], py = p[3 * i + 1], pz = p[3 * i + 2];
    const float qx = q[3 * i], qy = q[3 * i + 1], qz = q[3 * i + 2];
    const float nx = nrm[3 * i], ny = nrm[3 * i + 1], nz = nrm[3 * i + 2];
    const float wi = w[i];
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

#pragma unroll
  for (int k = 0; k < kSums; ++k) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc[k] += __shfl_down_sync(0xffffffffu, acc[k], off);
  }
  __shared__ float warp_sums[kWarps][kSums];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < kSums; ++k) warp_sums[warp][k] = acc[k];
  }
  __syncthreads();
  if (threadIdx.x < kSums) {
    float s = 0.f;
#pragma unroll
    for (int v = 0; v < kWarps; ++v) s += warp_sums[v][threadIdx.x];
    partial[blockIdx.x * kSums + threadIdx.x] = s;
  }
}

__global__ void gn_final_kernel(const float* __restrict__ partial,
                                int n_blocks, float* __restrict__ H,
                                float* __restrict__ g) {
  __shared__ float sums[kSums];
  const int t = threadIdx.x;
  if (t < kSums) {
    float s = 0.f;
    for (int b = 0; b < n_blocks; ++b) s += partial[b * kSums + t];
    sums[t] = s;
  }
  __syncthreads();
  if (t < 36) {
    const int a = t / 6, b = t % 6;
    const int lo = min(a, b), hi = max(a, b);
    // row `lo` of the upper triangle starts at lo*6 - lo*(lo-1)/2
    const int k = lo * 6 - (lo * (lo - 1)) / 2 + (hi - lo);
    H[t] = sums[k];
  }
  if (t < 6) g[t] = sums[21 + t];
}

}  // namespace

// p, q, n (m, 3) and w (m,) float32 contiguous; scratch partial
// (n_blocks, 27); outputs H (6, 6) and g (6,) float32.
extern "C" cudaError_t gn_accum_f32(const float* p, const float* q,
                                    const float* n, const float* w, int m,
                                    int n_blocks, float* partial, float* H,
                                    float* g, cudaStream_t stream) {
  if (m < 0 || n_blocks <= 0) return cudaErrorInvalidValue;
  gn_partial_kernel<<<n_blocks, kThreads, 0, stream>>>(p, q, n, w, m,
                                                       partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gn_final_kernel<<<1, 64, 0, stream>>>(partial, n_blocks, H, g);
  return cudaGetLastError();
}
