// K1: exact brute-force nearest neighbour, float32, for sm_90a.
//
// Replaces tpu_icp_slam/kernels/nn_pallas.py::_nn_kernel in "highest" mode
// (kernels/nn_pallas.py:111, its pallas_call at :374, wrapper
// nn_bruteforce_pallas): for every source point, the index and squared
// distance of its nearest target point, for 3-D points (the scan-to-map and
// scan-to-scan searches) and 2-D points (2D lidar odometry and loop
// verification; the reference pads 2-D lanes with zeros, nn_pallas.py:319).
//
// What bounds it on an H100: FP32 CUDA-core issue rate. The main path calls
// it with M = N = 16,384 points: 2.68e8 pairs x 9 flops = 2.42 GFLOP, 0.036
// ms at the card's 67 TFLOP/s, while the bytes are tiny (< 0.5 MB). A
// depth-3 contraction gives the tensor cores nothing to do in float32, and
// TF32 would throw away the selection precision the flagship configuration
// needs, so the pairs are scored on the CUDA cores, and the design is about
// instructions per pair.
//
// Design:
//  - Register blocking, min-only runs with a rescan of the winning run, and
//    cp.async double-buffered tiles: the loop of nn_exact.cuh (shared with
//    K5's "highest" search). A block of kThreads threads owns kBlockRows
//    source points, kRows per thread (rows threadIdx.x + k * kThreads, so
//    the one load of the sources is coalesced); every thread of the block
//    scores the same staged tile.
//  - Grid sizing. The target axis is cut into n_split contiguous ranges,
//    each a multiple of four targets (gridDim.y); the wrapper picks n_split
//    from the SM count and the blocks an SM holds at once
//    (nn_bruteforce_blocks_per_sm) so that row blocks x splits x batch
//    leaves no ragged last wave (kernels/nn_cuda.py::n_split): at
//    M = N = 16,384, 16 x 33 = 528 blocks, four on each of 132 SMs; at
//    B = 16, 256 x 2 = 512. A second small launch (nn_fold.cuh) folds the
//    splits in index order with a strict `<`.
//  - The score is the exact difference form dx*dx, then fma(dy, dy, .),
//    then fma(dz, dz, .), written with __fmul_rn/__fmaf_rn so that no loop
//    contracts it differently: the scores, and so idx and d2, are bit for
//    bit those of the earlier one-row-per-thread form of this kernel. The
//    factored form ‖b‖² - 2a·b of the TPU kernel cancels ~|p|²·eps at
//    scene scale, and consumers recompute d² in difference form anyway
//    (icp/loop.py), so selection can differ from the reference only on
//    near-ties below the factored form's f32 error (~1e-3 m²), and from the
//    plain torch version only by the rounding of the two FMAs.
//  - 2-D points: the dimension D is a template parameter of the scan
//    (nn_exact.cuh), so a 2-D search stages two floats a target and scores
//    dx*dx + dy*dy with the plain version's rounding: idx and d2 equal the
//    plain torch version's bit for bit. No padded copy of the clouds is made.
//  - Padded targets carry the 1e6 sentinel: (a - 1e6)² ~ 1e12 is finite in
//    float32 and always loses, so no mask is read.
//  - Batched form (loop-closure verification: candidates x yaw hypotheses,
//    the reference's nested vmap over align): gridDim.z is the batch.
//    Source b is searched in target b / group, so `group` consecutive batch
//    rows (the yaw hypotheses of one candidate) share one target. Each batch
//    element runs exactly the unbatched computation: B = 1 is the unbatched
//    call, bit for bit.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "nn_exact.cuh"
#include "nn_fold.cuh"

namespace {

using exact::kSub;

constexpr int kThreads = 128;
constexpr int kRows = 8;
constexpr int kBlockRows = kThreads * kRows;  // nn_cuda.py::_BLOCK_ROWS
constexpr int kTile = 256;                    // targets per staged tile
constexpr int kSplitAlign = 4;                // nn_cuda.py::_SPLIT_ALIGN
static_assert(kTile % kSub == 0, "tile shape");

template <int D>
__global__ void __launch_bounds__(kThreads)
nn_split_kernel(const float* __restrict__ src, const float* __restrict__ dst,
                int m, int n, int group, int split_len,
                float* __restrict__ part_d2, int* __restrict__ part_idx) {
  __shared__ __align__(16) float tiles[2][D * kTile];
  const int row0 = blockIdx.x * kBlockRows + threadIdx.x;
  const int split = blockIdx.y;
  const size_t batch_i = blockIdx.z;
  src += batch_i * m * D;
  dst += (batch_i / group) * n * D;
  part_d2 += batch_i * gridDim.y * m;
  part_idx += batch_i * gridDim.y * m;
  const int begin = split * split_len;
  const int end = min(n, begin + split_len);
  const bool vec16 = (reinterpret_cast<uintptr_t>(dst) & 15) == 0;

  float ax[kRows], ay[kRows], az[kRows], run[kRows], best[kRows];
  int best_run[kRows];
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const int row = row0 + k * kThreads;
    ax[k] = ay[k] = az[k] = 0.f;
    if (row < m) {
      ax[k] = src[D * row + 0];
      ay[k] = src[D * row + 1];
      if (D == 3) az[k] = src[D * row + D - 1];
    }
    run[k] = best[k] = INFINITY;
    best_run[k] = begin;
  }

  const int n_tiles = (end - begin + kTile - 1) / kTile;
  if (n_tiles > 0) {
    const int len = min(kTile, end - begin);
    exact::stage_tile<kThreads, D>(tiles[0], dst + D * (size_t)begin, len,
                                   (len + 3) & ~3, vec16, threadIdx.x);
  }
  cp_async::commit();
  for (int t = 0; t < n_tiles; ++t) {
    const int t0 = begin + t * kTile;
    const int len = min(kTile, end - t0);
    if (t + 1 < n_tiles) {
      const int t1 = t0 + kTile;
      const int len1 = min(kTile, end - t1);
      exact::stage_tile<kThreads, D>(tiles[(t + 1) & 1],
                                     dst + D * (size_t)t1, len1,
                                     (len1 + 3) & ~3, vec16, threadIdx.x);
    }
    cp_async::commit();
    cp_async::wait_prior();  // tile t has landed (t + 1 may be in flight)
    __syncthreads();
    const float4* v = reinterpret_cast<const float4*>(tiles[t & 1]);
    const int groups = (len + 3) >> 2;  // four targets = D float4
    for (int g0 = 0; g0 < groups; g0 += kSub / 4) {
      exact::run_min<kRows, D>(v + D * g0, groups - g0, ax, ay, az, run);
      exact::close_run<kRows>(run, best, best_run, t0 + 4 * g0);
    }
    __syncthreads();  // every thread is done with this buffer
  }

  // The first target of the winning run that scores the best.
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const int row = row0 + k * kThreads;
    if (row >= m) continue;
    int idx = begin;
    if (best[k] < INFINITY) {
      const int j0 = best_run[k];
      idx = exact::rescan<D>(ax[k], ay[k], az[k], best[k], j0,
                             min(kSub, end - j0), dst + D * (size_t)j0);
    }
    part_d2[(size_t)split * m + row] = best[k];
    part_idx[(size_t)split * m + row] = idx;
  }
}

}  // namespace

// Blocks of the split kernel for dim-D points one SM holds at once
// (registers, shared memory), for the wrapper's choice of n_split.
extern "C" cudaError_t nn_bruteforce_blocks_per_sm(int dim, int* out) {
  if (dim == 2)
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        out, nn_split_kernel<2>, kThreads, 0);
  if (dim == 3)
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        out, nn_split_kernel<3>, kThreads, 0);
  return cudaErrorInvalidValue;
}

// src (batch, m, dim) and dst (batch / group, n, dim) float32 contiguous,
// dim 2 or 3;
// scratch part_d2/part_idx (batch, n_split, m); outputs d2 (batch, m)
// float32 and idx (batch, m) int32. batch = group = 1 is the unbatched call.
// Split s covers targets [s * L, min(n, (s + 1) * L)) with L = ceil(n /
// n_split) rounded up to a multiple of 4; no split may be empty.
extern "C" cudaError_t nn_bruteforce_f32(const float* src, const float* dst,
                                         int batch, int group, int m, int n,
                                         int dim, int n_split, float* part_d2,
                                         int* part_idx, float* d2, int* idx,
                                         cudaStream_t stream) {
  if (m <= 0 || n <= 0 || n_split <= 0 || batch <= 0 || group <= 0 ||
      batch % group != 0 || batch > 65535 || n_split > 65535 ||
      (dim != 2 && dim != 3))
    return cudaErrorInvalidValue;
  const int split_len =
      ((n + n_split - 1) / n_split + kSplitAlign - 1) & ~(kSplitAlign - 1);
  if ((long long)(n_split - 1) * split_len >= n) return cudaErrorInvalidValue;
  const dim3 grid((m + kBlockRows - 1) / kBlockRows, n_split, batch);
  if (dim == 2)
    nn_split_kernel<2><<<grid, kThreads, 0, stream>>>(
        src, dst, m, n, group, split_len, part_d2, part_idx);
  else
    nn_split_kernel<3><<<grid, kThreads, 0, stream>>>(
        src, dst, m, n, group, split_len, part_d2, part_idx);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 fold_grid((m + 127) / 128, batch);
  nn_fold_kernel<<<fold_grid, 128, 0, stream>>>(part_d2, part_idx, m, n_split,
                                                d2, idx, nullptr);
  return cudaGetLastError();
}
