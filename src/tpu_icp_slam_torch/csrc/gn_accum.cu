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
//    6 of g) over a grid-stride range of rows, in registers. The terms and
//    the grid reduction live in gn_rows.cuh, shared with K2S (gn_step.cu),
//    whose H and g are this kernel's bit for bit.
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

#include "gn_rows.cuh"

namespace {

constexpr int kThreads = gn_rows::kThreads;
constexpr int kSums = gn_rows::kTerms;

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
       i += gridDim.x * kThreads)
    gn_rows::add_row(p, q, nrm, i, w[i], acc);

  __shared__ float sums[kSums];
  if (!gn_rows::grid_sum<kSums>(acc, partial, ticket, sums)) return;
  gn_rows::write_hg(sums, H, g);
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
