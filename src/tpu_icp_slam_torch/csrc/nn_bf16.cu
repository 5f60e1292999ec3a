// K3: brute-force nearest neighbour on recentred, hi/lo-packed bf16 operands,
// for sm_90a.
//
// Replaces the "bf16" branch of tpu_icp_slam/kernels/nn_pallas.py::_nn_kernel
// (nn_pallas.py:111; its pallas_call at :374; wrapper
// nn_bruteforce_pallas(precision="bf16"), :232-245, :279-314). Both clouds
// are recentred on the bounding-box midpoint of the valid targets
// (|coordinates| < 1e5) and packed into 16-lane bf16 rows whose product
// a_aug · b_aug ≈ d² (packed_d2.cuh); for every source row the first
// minimum, in index order, of that packed score gives idx, and d2 =
// max(e_min, 0).
//
// What bounds it on an H100: the 16-lane bf16 contraction on the tensor
// cores, 2.7e8 pairs x 32 flops at M = N = 16,384 = 0.0087 ms at
// 989 TFLOP/s. The products are exact bf16 x bf16 and one mma.sync
// m16n8k16 scores 128 pairs, so in practice the argmin bookkeeping on the
// CUDA cores (a compare and two selects a score) sets the pace, as for K4.
//
// Design, four launches per call, nothing else on the device:
//  - nn_centre_kernel and nn_pack_kernel (packed_prep.cuh, shared with K4):
//    the centre and both packed operands, bit-equal to nn_bf16.recentre,
//    pack_source and pack_target (the target unpadded: np = n).
//  - packed_scan_kernel (packed_scan.cuh, shared with K4): the packed score
//    on the tensor cores over n_split contiguous target splits of split_len
//    rows (a multiple of 16; the last may be shorter), a persistent grid
//    over (128-row source tiles x splits) sized by the wrapper
//    (kernels/nn_bf16.splits) to the blocks the card holds at once. Each
//    split's first minimum and its index go to the partials (n_split, m).
//  - nn_fold_kernel (nn_fold.cuh, shared with K1): the splits in order with
//    a strict `<`, so ties go to the lowest index, then d2 = max(e, 0).
// Its scores are the tensor core's float32 sums, held to the float64 packed
// score within tau * sum|a_k b_k| (kernels/packed_mma.py); its picks equal
// the plain version's but for near-ties. Sentinel targets (1e6) score ~1e12
// and never win. Times in PERF.md §6.
//
// Batched form (nn_bf16_batched_f32; the reference's vmap of
// nn_bruteforce_pallas(precision="bf16") in the sharded align, one
// pallas_call with the batch as a leading grid axis): src (B, m, 3)
// against dst (B/G, n, 3), row b against target b / G with that target's
// own centre. The same four launches whatever B is: one centre block a
// target, the pack and the fold with the batch on grid y, the scan's
// persistent grid over every row's items. Row b is bit-equal to the
// unbatched call on (src[b], dst[b / G]).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "nn_fold.cuh"
#include "packed_prep.cuh"
#include "packed_scan.cuh"

namespace {

// The scan over contiguous splits and the fold. e_min (the raw minimum) and
// d2 (clamped at 0) are written where they are not null.
// Batched: a_aug (batch, m, 16) against b_aug (batch / group, n, 16),
// partials (batch, n_split, m), outputs (batch, m).
cudaError_t scan_and_fold(const void* a_aug, const void* b_aug, int m, int n,
                          int batch, int group, int n_split, int split_len,
                          int grid, float* part_e, int* part_idx,
                          float* e_min, int* idx, float* d2,
                          cudaStream_t stream) {
  if (m <= 0 || n <= 0 || n_split <= 0 || split_len <= 0 || grid <= 0 ||
      batch <= 0 || group <= 0 || batch % group || batch > 65535 ||
      (long long)n_split * split_len < n ||
      (long long)(n_split - 1) * split_len >= n)
    return cudaErrorInvalidValue;
  packed_scan_kernel<<<grid, kScanThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(a_aug),
      static_cast<const __nv_bfloat16*>(b_aug), m, n, batch, group, n_split,
      split_len, 1, split_len, part_idx, part_e);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  nn_fold_kernel<<<dim3((m + 255) / 256, batch), 256, 0, stream>>>(
      part_e, part_idx, m, n_split, e_min, idx, d2);
  return cudaGetLastError();
}

}  // namespace

// Blocks of the scan kernel that one SM holds at once, for the wrappers'
// persistent grids (K3's and K4's, whose scan is the same source).
extern "C" cudaError_t packed_scan_blocks_per_sm(int* out) {
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, packed_scan_kernel,
                                                       kScanThreads, 0);
}

// The whole bf16 NN. src (batch, m, 3), dst (batch / group, n, 3) float32.
// Scratch: centre (batch / group, 3) float32, a_aug (batch, m, 16) and
// b_aug (batch / group, n, 16) bf16, part_e (batch, n_split, m) float32,
// part_idx (batch, n_split, m) int32. Outputs idx (batch, m) int32 and d2
// (batch, m) float32; e_min (batch, m) float32, the raw packed minimum, or
// null. The unbatched call is batch = group = 1.
extern "C" cudaError_t nn_bf16_batched_f32(
    const float* src, const float* dst, int m, int n, int batch, int group,
    int n_split, int split_len, int grid, float* centre, void* a_aug,
    void* b_aug, float* part_e, int* part_idx, float* e_min, int* idx,
    float* d2, cudaStream_t stream) {
  if (m <= 0 || n <= 0) return cudaErrorInvalidValue;
  const cudaError_t err = prepare_packed(
      src, dst, m, n, n, batch, group, centre, nullptr, nullptr,
      static_cast<__nv_bfloat16*>(a_aug), static_cast<__nv_bfloat16*>(b_aug),
      stream);
  if (err != cudaSuccess) return err;
  return scan_and_fold(a_aug, b_aug, m, n, batch, group, n_split, split_len,
                       grid, part_e, part_idx, e_min, idx, d2, stream);
}

// K3's scan and fold on given packed operands, a_aug (m, 16) and b_aug
// (n, 16) bf16: for each source row the first minimum e_min (m,) float32 of
// the packed score over the whole target and its index idx (m,) int32.
// Scratch part_e, part_idx as for nn_bf16_batched_f32 at batch 1. For tests
// and chip_smoke.py phase 11.
extern "C" cudaError_t packed_mma_argmin(const void* a_aug, const void* b_aug,
                                         int m, int n, int n_split,
                                         int split_len, int grid,
                                         float* part_e, int* part_idx,
                                         float* e_min, int* idx,
                                         cudaStream_t stream) {
  return scan_and_fold(a_aug, b_aug, m, n, 1, 1, n_split, split_len, grid,
                       part_e, part_idx, e_min, idx, nullptr, stream);
}
