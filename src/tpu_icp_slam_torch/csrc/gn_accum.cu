// K2: point-to-plane Gauss-Newton accumulation, float32, for sm_90a.
//
// Replaces tpu_icp_slam/kernels/gn_pallas.py::_gn_kernel (gn_pallas.py:28,
// its pallas_call at :97; wrapper gn_accum_pallas): per row the Jacobian
// J = [n, p x n] and residual r = n·(p - q), summed into H = Σ w JᵀJ (6x6)
// and g = Σ w r J (6).
//
// What bounds it on an H100: one launch. The main path calls it with
// M = 16,384 rows: 0.66 MB read (p, q, n, w), 0.2 us at 3.35 TB/s, and ~60
// flops a row; the launch itself costs a few microseconds, so the design
// makes it one launch and keeps the wrapper's host work small.
//
// Design:
//  - Each thread accumulates the 27 unique sums (21 of H's upper triangle,
//    6 of g) over a grid-stride range of rows, in registers.
//  - Warp shuffles reduce them, then the block's warps are summed in
//    shared memory in warp order; each block writes one (27,) partial.
//  - One launch: each block fences its partial and takes a ticket; the
//    last block to finish sums the partials in block order and writes H
//    (symmetric) and g. atomicInc wraps the ticket back to 0 in that last
//    block, ready for the next call. The partial scratch and the ticket
//    belong to the wrapper's device cache: calls on one stream (the port
//    runs on one) never overlap.
//  - The row partition, the shuffle tree and the block order are those of
//    the earlier two-launch form of this kernel, so H and g are bit for bit
//    its results.
//  - No float atomics: for a given grid the summation order is fixed, so
//    a run on the card is bit-reproducible (the streaming and the fused
//    pipeline runs must agree exactly).
//  - Rows with w = 0 (gated or padded correspondences) add nothing; M = 0
//    gives H = 0 and g = 0 from a single block.
//
// Batched form (the reference's vmap of gn_accum_pallas in the sharded
// align, one pallas_call with grid (B, M/TM)): p, q, n (B, M, 3) and w
// (B, M) give H (B, 6, 6) and g (B, 6) in one launch with the batch on the
// grid's y axis. Row b has its own partial slab and its own ticket, and its
// last block resets only that ticket; its blocks keep the unbatched
// kernel's row partition, shuffle tree and block order, so row b is bit for
// bit the unbatched call on (p[b], q[b], n[b], w[b]).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSums = 27;

__global__ void __launch_bounds__(kThreads)
gn_accum_kernel(const float* __restrict__ p, const float* __restrict__ q,
                const float* __restrict__ nrm, const float* __restrict__ w,
                int m, float* __restrict__ partial,
                unsigned* __restrict__ ticket, float* __restrict__ H,
                float* __restrict__ g) {
  {  // this batch row's inputs, partial slab, ticket and outputs
    const size_t b = blockIdx.y;
    p += 3 * m * b;
    q += 3 * m * b;
    nrm += 3 * m * b;
    w += m * b;
    partial += (size_t)gridDim.x * kSums * b;
    ticket += b;
    H += 36 * b;
    g += 6 * b;
  }
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
    __threadfence();  // the partial is visible before the ticket is taken
  }
  __syncthreads();
  __shared__ bool last;
  if (threadIdx.x == 0)
    last = atomicInc(ticket, gridDim.x - 1) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;

  __shared__ float sums[kSums];
  const int t = threadIdx.x;
  if (t < kSums) {
    float s = 0.f;
    for (unsigned b = 0; b < gridDim.x; ++b)
      s += __ldcg(partial + b * kSums + t);
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

// p, q, n (batch, m, 3) and w (batch, m) float32 contiguous; scratch
// partial (batch, n_blocks, 27) and ticket (batch unsigned, 0 before the
// first call and left at 0 by every call); outputs H (batch, 6, 6) and g
// (batch, 6) float32. The unbatched call is batch = 1.
extern "C" cudaError_t gn_accum_batched_f32(const float* p, const float* q,
                                            const float* n, const float* w,
                                            int m, int batch, int n_blocks,
                                            float* partial, unsigned* ticket,
                                            float* H, float* g,
                                            cudaStream_t stream) {
  if (m < 0 || n_blocks <= 0 || batch <= 0 || batch > 65535)
    return cudaErrorInvalidValue;
  gn_accum_kernel<<<dim3(n_blocks, batch), kThreads, 0, stream>>>(
      p, q, n, w, m, partial, ticket, H, g);
  return cudaGetLastError();
}
