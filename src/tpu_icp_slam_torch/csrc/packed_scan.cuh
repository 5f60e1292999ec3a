// The packed bf16 search over parts of the target on the tensor cores,
// shared by K3 (nn_bf16.cu: contiguous target splits) and K4
// (nn_shortlist.cu: the reference's dealt slots).
//
// Part p of the target is the rows first + w * stride, w = 0 .. len - 1,
// with first = p * part_step and len = min(part_len, ceil((n - first) /
// stride)): K3's split p is the contiguous range [p * L, min(n, (p + 1) * L))
// (part_step = L, stride = 1), K4's slot j the strided rows j, j + S, ...
// (part_step = 1, stride = S). For each source row and part, the first
// minimum in index order of the packed score (packed_mma.cuh) goes to
// out_idx (n_parts, m) as the target's index first + w * stride, and its
// score to out_score (n_parts, m) when that pointer is not null.
//
// Batched (the reference's vmap): a_aug (B, m, 16) against b_aug (B/G, n,
// 16), row b against target b / G, outputs (B, n_parts, m). A work item
// is one row's (source tile, part), and it computes what the unbatched
// launch computes for that item, so every row is bit-equal to its own
// call whatever the grid.
//
// What bounds it on an H100: the 16-lane bf16 contraction on the tensor
// cores, 2.7e8 pairs x 32 flops at 16,384² = 0.0087 ms at 989 TFLOP/s; in
// practice the argmin bookkeeping on the CUDA cores (a compare and two
// selects per score, against one mma per 128 scores) sets the pace.
//
// Design. A work item is 128 source rows (4 warps x 2 m-tiles of 16)
// against one part; a persistent grid (the wrapper sizes it to the blocks
// that fit on the card at once) walks the (batch x parts x row tiles)
// items, row tiles fastest. A part's rows are staged as bf16 rows (two 16-byte
// cp.async a row, no widening) 256 at a time, double-buffered, a ragged
// last tile padded with packed_mma::pad_row; the A fragments stay in
// registers for the whole part. Each thread keeps its rows' running (min,
// first index) through packed_mma::score16, and packed_mma::quad_min folds
// the four threads of a row, so ties inside a part go to the lower index.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "cp_async.cuh"
#include "packed_mma.cuh"

namespace {

constexpr int kScanWarps = 4;
constexpr int kScanThreads = 32 * kScanWarps;
constexpr int kScanMt = 2;                                // m-tiles a warp
constexpr int kScanRows = kScanWarps * kScanMt * 16;      // 128
constexpr int kScanTile = 256;                            // targets a tile
constexpr int kScanTileBytes = kScanTile * packed_mma::kRowBytes;
// Blocks an SM is to hold: 8 x 128 threads caps a thread at 64 registers
// (without the cap ptxas takes 72, and the SM holds 7).
constexpr int kScanMinBlocks = 8;

// Rows w = t0 .. t0 + len - 1 of a part (global rows first + w * stride)
// into the tile; rows [len, round_up(len, 16)) get the padding row.
__device__ __forceinline__ void stage_part_tile(
    unsigned char* tile, const __nv_bfloat16* __restrict__ b_aug, int first,
    int stride, int t0, int len) {
  const unsigned base = cp_async::smem_addr(tile);
  for (int i = threadIdx.x; i < len; i += kScanThreads)
    packed_mma::stage_row(base, i,
                          b_aug + 16 * ((size_t)(t0 + i) * stride + first));
  for (int i = len + threadIdx.x; i < ((len + 15) & ~15); i += kScanThreads)
    packed_mma::pad_row(tile, i);
}

__global__ void __launch_bounds__(kScanThreads, kScanMinBlocks)
packed_scan_kernel(const __nv_bfloat16* __restrict__ a_all,
                   const __nv_bfloat16* __restrict__ b_all, int m, int n,
                   int batch, int group, int n_parts, int part_step,
                   int stride, int part_len, int* __restrict__ out_idx,
                   float* __restrict__ out_score) {
  __shared__ __align__(128) unsigned char s_b[2][kScanTileBytes];
  __shared__ __align__(128)
      unsigned char s_a[kScanRows * packed_mma::kRowBytes];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row_tiles = (m + kScanRows - 1) / kScanRows;
  const int row_items = row_tiles * n_parts;  // items of one batch row
  const unsigned a_base = cp_async::smem_addr(s_a);

  for (int item = blockIdx.x; item < batch * row_items; item += gridDim.x) {
    const int b = item / row_items;
    const int part = (item - b * row_items) / row_tiles;
    const int row0 = (item - b * row_items - part * row_tiles) * kScanRows;
    const __nv_bfloat16* a_aug = a_all + 16 * (size_t)m * b;
    const __nv_bfloat16* b_aug = b_all + 16 * (size_t)n * (b / group);
    const size_t out0 = (size_t)n_parts * m * b;
    const int first = part * part_step;
    const int len = min(part_len, (n - first + stride - 1) / stride);
    const int n_tiles = (len + kScanTile - 1) / kScanTile;
    // the block's source rows (rows >= m are zero and never written out)
    for (int i = threadIdx.x; i < kScanRows; i += kScanThreads) {
      if (row0 + i < m) {
        packed_mma::stage_row(a_base, i, a_aug + 16 * (size_t)(row0 + i));
      } else {
        *reinterpret_cast<uint4*>(s_a + packed_mma::offset(i, 0)) =
            make_uint4(0, 0, 0, 0);
        *reinterpret_cast<uint4*>(s_a + packed_mma::offset(i, 1)) =
            make_uint4(0, 0, 0, 0);
      }
    }
    stage_part_tile(s_b[0], b_aug, first, stride, 0, min(kScanTile, len));
    cp_async::commit();

    unsigned a[kScanMt][4];
    float best[kScanMt][2];
    int idx[kScanMt][2];
#pragma unroll
    for (int mt = 0; mt < kScanMt; ++mt)
      for (int h = 0; h < 2; ++h) {
        best[mt][h] = INFINITY;
        idx[mt][h] = 0;
      }
    for (int t = 0; t < n_tiles; ++t) {
      const int t0 = t * kScanTile;
      const int tile_len = min(kScanTile, len - t0);
      if (t + 1 < n_tiles)
        stage_part_tile(s_b[(t + 1) & 1], b_aug, first, stride,
                        t0 + kScanTile, min(kScanTile, len - t0 - kScanTile));
      cp_async::commit();
      cp_async::wait_prior();  // tile t (and the sources) landed
      __syncthreads();
      if (t == 0) {
#pragma unroll
        for (int mt = 0; mt < kScanMt; ++mt)
          packed_mma::load_a(a[mt], a_base, (warp * kScanMt + mt) * 16, lane);
      }
      const unsigned tile = cp_async::smem_addr(s_b[t & 1]);
      for (int n0 = 0; n0 < tile_len; n0 += 16)
        packed_mma::score16<kScanMt>(a, tile, n0, t0, lane, best, idx);
      __syncthreads();  // every warp is done with this buffer
    }
#pragma unroll
    for (int mt = 0; mt < kScanMt; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        packed_mma::quad_min(best[mt][h], idx[mt][h]);
        const int row =
            row0 + (warp * kScanMt + mt) * 16 + (lane >> 2) + 8 * h;
        if ((lane & 3) == 0 && row < m) {
          out_idx[out0 + (size_t)part * m + row] =
              first + idx[mt][h] * stride;
          if (out_score)
            out_score[out0 + (size_t)part * m + row] = best[mt][h];
        }
      }
  }
}

}  // namespace
