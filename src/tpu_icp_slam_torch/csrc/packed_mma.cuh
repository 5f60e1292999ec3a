// The packed bf16 score of packed_d2.cuh on Hopper's tensor cores:
// mma.sync.aligned.m16n8k16 with float32 accumulation, operands loaded from
// shared memory with ldmatrix. Used by the packed scan of K3 and K4
// (packed_scan.cuh) and K5's bf16 search (icp_fused.cu).
//
// Operands. A is 16 packed source rows and B is 8 packed target rows, both
// bf16 exactly as stored (16 lanes, 32 B a row): the 16 lanes are one k-step,
// so one mma scores 128 (row, target) pairs. Rows sit in shared memory at 32
// B each, the two 16-byte halves of row r swapped when bit 2 of r is set
// (`offset`): the eight rows that one ldmatrix phase reads then fall on 32
// distinct banks.
//
// Fragments (PTX ISA, mma.m16n8k16 with .bf16; g = lane / 4, t = lane % 4):
// A registers 0-3 hold (row g, lanes 2t..2t+1), (row g+8, lanes 2t..2t+1),
// (row g, lanes 8+2t..), (row g+8, lanes 8+2t..); B registers 0-1 hold
// (target g, lanes 2t..2t+1) and (target g, lanes 8+2t..); the float32 result
// d0..d3 is (row g, target 2t), (row g, 2t+1), (row g+8, 2t), (row g+8, 2t+1).
//
// Argmin bookkeeping. A thread sees 2 of the 8 targets of each mma, for 2
// rows. It keeps a running (min, index) per row with a strict `<`, visiting
// its targets in increasing index order; at the end a shuffle over the four
// threads of a row keeps the smaller score, and on equal scores the lower
// index. That is the first minimum in index order, as the reference's argmin
// gives. Sentinel targets (1e6) score ~1e12 and never win; no mask is read.
// A ragged tile is padded with `pad_row`: +inf in lane 11, which meets the
// source's constant 1 there, zero elsewhere, so its score is +inf.
//
// Precision. Each bf16 x bf16 product is exact in float32, but the tensor
// core adds them in its own order and rounding, so its score is not bit-equal
// to the plain version's float32 product. It is held to the float64
// sum E of the same exact products: |e - E| <= tau * sum_k |a_k b_k|
// (kernels/packed_mma.py::TAU, measured by chip_smoke.py phase 11).
//
// Why mma.sync and not wgmma: at k = 16 the product is one instruction per
// 128 scores; the time goes to the argmin bookkeeping on the CUDA cores (a
// compare and two selects per score), which wgmma does not remove.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace packed_mma {

constexpr int kRowBytes = 32;  // 16 bf16 lanes

// Byte offset of half h (0: lanes 0-7, 1: lanes 8-15) of row r in a tile.
__device__ __forceinline__ unsigned offset(int r, int h) {
  return (unsigned)r * kRowBytes + (unsigned)((h ^ ((r >> 2) & 1)) << 4);
}

// Start copying global row `src` (32 B) into row r of the tile at `tile`.
__device__ __forceinline__ void stage_row(unsigned tile, int r,
                                          const __nv_bfloat16* src) {
  cp_async::copy16(tile + offset(r, 0), src);
  cp_async::copy16(tile + offset(r, 1), src + 8);
}

// Row r of the tile at `tile` (a generic pointer) := the padding row.
__device__ __forceinline__ void pad_row(unsigned char* tile, int r) {
  *reinterpret_cast<uint4*>(tile + offset(r, 0)) = make_uint4(0, 0, 0, 0);
  *reinterpret_cast<uint4*>(tile + offset(r, 1)) =
      make_uint4(0, 0x7f800000u, 0, 0);  // lane 11 = +inf
}

// Row r of the tile := 16 float lanes that are bf16 values (exact: the bf16
// bits are the float's high half).
__device__ __forceinline__ void store_row(unsigned char* tile, int r,
                                          const float (&v)[16]) {
  unsigned w[8];
#pragma unroll
  for (int k = 0; k < 8; ++k)
    w[k] = (__float_as_uint(v[2 * k]) >> 16) |
           (__float_as_uint(v[2 * k + 1]) & 0xffff0000u);
  *reinterpret_cast<uint4*>(tile + offset(r, 0)) =
      make_uint4(w[0], w[1], w[2], w[3]);
  *reinterpret_cast<uint4*>(tile + offset(r, 1)) =
      make_uint4(w[4], w[5], w[6], w[7]);
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// A fragment of the 16 source rows r0..r0+15 of the tile at `tile`.
__device__ __forceinline__ void load_a(unsigned (&a)[4], unsigned tile, int r0,
                                       int lane) {
  const int mat = lane >> 3;
  ldmatrix_x4(a, tile + offset(r0 + (lane & 7) + ((mat & 1) << 3), mat >> 1));
}

// B fragments of targets n0..n0+7 (b[0], b[1]) and n0+8..n0+15 (b[2], b[3]).
__device__ __forceinline__ void load_b2(unsigned (&b)[4], unsigned tile,
                                        int n0, int lane) {
  const int mat = lane >> 3;
  ldmatrix_x4(b, tile + offset(n0 + (lane & 7) + ((mat >> 1) << 3), mat & 1));
}

// d = A·B (C = 0).
__device__ __forceinline__ void mma(const unsigned (&a)[4], unsigned b0,
                                    unsigned b1, float (&d)[4]) {
  d[0] = d[1] = d[2] = d[3] = 0.f;
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Score kMt m-tiles (a[mt]) against the 16 targets n0..n0+15 of the tile
// (tile-local index; `base` + local is what is kept) and fold each score into
// the running (best, idx) of its row: best[mt][0] is row g, [1] row g+8.
template <int kMt>
__device__ __forceinline__ void score16(unsigned (&a)[kMt][4],
                                        unsigned tile, int n0, int base,
                                        int lane, float (&best)[kMt][2],
                                        int (&idx)[kMt][2]) {
  unsigned b[4];
  load_b2(b, tile, n0, lane);
  const int j0 = base + n0 + 2 * (lane & 3);
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
    for (int mt = 0; mt < kMt; ++mt) {
      float d[4];
      mma(a[mt], b[2 * nt], b[2 * nt + 1], d);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        if (d[e] < best[mt][h]) {
          best[mt][h] = d[e];
          idx[mt][h] = j0 + 8 * nt + (e & 1);
        }
      }
    }
  }
}

// The row's (min, first index) across the four threads that share it.
__device__ __forceinline__ void quad_min(float& best, int& idx) {
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    const float ob = __shfl_xor_sync(0xffffffffu, best, off);
    const int oi = __shfl_xor_sync(0xffffffffu, idx, off);
    if (ob < best || (ob == best && oi < idx)) {
      best = ob;
      idx = oi;
    }
  }
}

}  // namespace packed_mma
