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
//  - nn_centre_kernel and nn_pack_kernel (packed_prep.cuh, shared with K3):
//    the centre c, the recentred source and padded target in float32 (what
//    the rescore reads) and their packed bf16 rows, bit-equal to
//    nn_rescore._prepare, nn_bf16.pack_source and pack_target.
//  - packed_scan_kernel (packed_scan.cuh, shared with K3): the shortlist on
//    the tensor cores. Each slot is one part of the target, the strided
//    rows j, j + S, ... (part_step 1, stride S), so a pick's index is the
//    ORIGINAL index w * S + j. It writes the picks to cand (S, M) and their
//    scores to cand_score when that pointer is not null (chip_smoke.py
//    phase 11).
//  - nn_rescore_kernel: one thread per source row, S gathers of the padded
//    recentred target, d² = (dx² + dy²) + dz² with the products and sums
//    rounded separately (no FMA contraction), as the plain torch version and
//    the reference compute it; strict `<` in slot order.
// The tensor cores' scores sat within 5.1e-8 * sum|a_k b_k| of the float64
// packed score on chip_smoke.py phase 11's 16,384² problem on an H100 (the
// bound held is tau = 2^-19 = 1.9e-6); times in PERF.md §6.
//
// Batched form (nn_rescore_batched_f32; the reference's vmap of
// nn_bruteforce_pallas(precision="rescore") in the sharded align, one
// pallas_call with the batch as a leading grid axis): src (B, m, 3)
// against dst (B/G, n, 3), row b against target b / G, each target with
// its own centre and the same slots (they depend on n only). The same four
// launches whatever B is; the rescore with the batch on grid y. Row b is
// bit-equal to the unbatched call on (src[b], dst[b / G]).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "packed_prep.cuh"
#include "packed_scan.cuh"

namespace {

// blockIdx.y is the batch row b: src (B, m, 3), dst (B/G, np, 3), cand
// (B, n_slots, m), idx and d2 (B, m).
__global__ void nn_rescore_kernel(const float* __restrict__ src,
                                  const float* __restrict__ dst, int m,
                                  int np, int group, int n_slots,
                                  const int* __restrict__ cand,
                                  int* __restrict__ idx,
                                  float* __restrict__ d2) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= m) return;
  const size_t b = blockIdx.y;
  src += 3 * m * b;
  dst += 3 * np * (b / group);
  cand += (size_t)n_slots * m * b;
  idx += m * b;
  d2 += m * b;
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

// The whole rescore NN: recentre and pack (two launches), shortlist (a
// persistent grid of `grid` blocks), rescore. src (batch, m, 3), dst
// (batch / group, n, 3) float32. Scratch, for the padded target's np =
// n_slots * tile_n rows: centre (batch / group, 3), sc (batch, m, 3) and dp
// (batch / group, np, 3) float32, a_aug (batch, m, 16) and b_aug (batch /
// group, np, 16) bf16, cand (batch, n_slots, m) int32; cand_score (batch,
// n_slots, m) float32 or null. Outputs idx (batch, m) int32 (an index into
// the padded target) and d2 (batch, m) float32, the exact difference-form
// squared distance of the pick.
extern "C" cudaError_t nn_rescore_batched_f32(
    const float* src, const float* dst, int m, int n, int batch, int group,
    int n_slots, int tile_n, int grid, float* centre, float* sc, float* dp,
    void* a_aug, void* b_aug, int* cand, float* cand_score, int* idx,
    float* d2, cudaStream_t stream) {
  if (m <= 0 || n <= 0 || n_slots <= 0 || tile_n <= 0 || grid <= 0 ||
      (long long)n_slots * tile_n < n)
    return cudaErrorInvalidValue;
  const int np = n_slots * tile_n;
  cudaError_t err = prepare_packed(src, dst, m, n, np, batch, group, centre,
                                   sc, dp, static_cast<__nv_bfloat16*>(a_aug),
                                   static_cast<__nv_bfloat16*>(b_aug), stream);
  if (err != cudaSuccess) return err;
  packed_scan_kernel<<<grid, kScanThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(a_aug),
      static_cast<const __nv_bfloat16*>(b_aug), m, np, batch, group, n_slots,
      1, n_slots, tile_n, cand, cand_score);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  nn_rescore_kernel<<<dim3((m + 255) / 256, batch), 256, 0, stream>>>(
      sc, dp, m, np, group, n_slots, cand, idx, d2);
  return cudaGetLastError();
}

// The unbatched call, the batched form at batch = group = 1 (chip_ab.py
// calls it beside an earlier build's entry point of the same signature).
extern "C" cudaError_t nn_rescore_f32(const float* src, const float* dst,
                                      int m, int n, int n_slots, int tile_n,
                                      int grid, float* centre, float* sc,
                                      float* dp, void* a_aug, void* b_aug,
                                      int* cand, float* cand_score, int* idx,
                                      float* d2, cudaStream_t stream) {
  return nn_rescore_batched_f32(src, dst, m, n, 1, 1, n_slots, tile_n, grid,
                                centre, sc, dp, a_aug, b_aug, cand,
                                cand_score, idx, d2, stream);
}
