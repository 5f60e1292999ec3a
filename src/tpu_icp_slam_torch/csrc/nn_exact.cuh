// The exact float32 nearest-neighbour loop shared by K1 (nn_bruteforce.cu)
// and K5's "highest" search (icp_fused.cu).
//
// D (2 or 3, default 3) is the point dimension: a 2-D search stages and
// scores two coordinates. K5 is 3-D only and takes the default.
//
// A thread holds kRows source points in registers; every staged target
// serves all of them from one broadcast shared-memory read (four targets are
// D float4 of the packed coordinate stream).
//  - Score: the exact difference form. At D = 3, dx*dx, then fma(dy, dy, .),
//    then fma(dz, dz, .); at D = 2, dx*dx + dy*dy with each product and the
//    sum rounded, which is the plain torch version's arithmetic bit for bit.
//    Written with __fmul_rn/__fmaf_rn/__fadd_rn so that no caller contracts
//    it differently.
//  - Min-only runs: within a run of kSub targets a row keeps only the
//    minimum (one FMNMX a pair). After the run, the run's minimum replaces
//    the row's best with a strict `<`, and the run's first target is kept.
//    `rescan` then recomputes the winning run (kSub targets from global
//    memory, the same chain, all loads in flight together) and returns the
//    first target whose score equals the best. Strict `<` across runs and the
//    first equal index in the winning run give the first minimum in index
//    order.
//  - Tiles arrive through cp.async (16-byte copies when the target array is
//    16-byte aligned, 4-byte ones otherwise; no integer division), padded
//    with +inf, whose score is +inf and never a minimum.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace exact {

constexpr int kSub = 16;  // targets per min-only run
static_assert(kSub % 4 == 0, "a run is whole groups of four targets");

template <int D = 3>
__device__ __forceinline__ float pair_d2(float ax, float ay, float az,
                                         float bx, float by, float bz) {
  static_assert(D == 2 || D == 3, "2-D or 3-D points");
  const float dx = __fsub_rn(ax, bx);
  const float dy = __fsub_rn(ay, by);
  if constexpr (D == 2) {
    return __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
  } else {
    const float dz = __fsub_rn(az, bz);
    return __fmaf_rn(dz, dz, __fmaf_rn(dy, dy, __fmul_rn(dx, dx)));
  }
}

// Start copying targets [t0, t0 + len) (g points at target t0) into buf as
// packed D-coordinate floats, and pad the tile with +inf to len_pad targets
// (len_pad a multiple of four). kThreads threads take part; tid is this
// one's rank among them.
template <int kThreads, int D = 3>
__device__ __forceinline__ void stage_tile(float* buf, const float* g, int len,
                                           int len_pad, bool vec16, int tid) {
  const int nf = D * len;
  int i = tid;
  if (vec16) {
    const int nv = nf >> 2;
    for (; i < nv; i += kThreads)
      cp_async::copy16(cp_async::smem_addr(buf + 4 * i), g + 4 * i);
    i = 4 * nv + tid;
  }
  for (; i < nf; i += kThreads)
    cp_async::copy4(cp_async::smem_addr(buf + i), g + i);
  for (i = nf + tid; i < D * len_pad; i += kThreads) buf[i] = INFINITY;
}

// Fold `groups` (<= kSub / 4) groups of four staged targets (v: D float4 a
// group) into each row's run minimum. At D = 2, az is not read.
template <int kRows, int D = 3>
__device__ __forceinline__ void run_min(const float4* __restrict__ v,
                                        int groups, const float (&ax)[kRows],
                                        const float (&ay)[kRows],
                                        const float (&az)[kRows],
                                        float (&run)[kRows]) {
#pragma unroll
  for (int gi = 0; gi < kSub / 4; ++gi) {
    if (gi < groups) {
      if constexpr (D == 2) {
        const float4 p = v[2 * gi + 0];
        const float4 q = v[2 * gi + 1];
#pragma unroll
        for (int k = 0; k < kRows; ++k) {
          const float d0 = pair_d2<2>(ax[k], ay[k], 0.f, p.x, p.y, 0.f);
          const float d1 = pair_d2<2>(ax[k], ay[k], 0.f, p.z, p.w, 0.f);
          const float d2 = pair_d2<2>(ax[k], ay[k], 0.f, q.x, q.y, 0.f);
          const float d3 = pair_d2<2>(ax[k], ay[k], 0.f, q.z, q.w, 0.f);
          run[k] = fminf(run[k], fminf(fminf(d0, d1), fminf(d2, d3)));
        }
      } else {
        const float4 p = v[3 * gi + 0];
        const float4 q = v[3 * gi + 1];
        const float4 r = v[3 * gi + 2];
#pragma unroll
        for (int k = 0; k < kRows; ++k) {
          const float d0 = pair_d2(ax[k], ay[k], az[k], p.x, p.y, p.z);
          const float d1 = pair_d2(ax[k], ay[k], az[k], p.w, q.x, q.y);
          const float d2 = pair_d2(ax[k], ay[k], az[k], q.z, q.w, r.x);
          const float d3 = pair_d2(ax[k], ay[k], az[k], r.y, r.z, r.w);
          run[k] = fminf(run[k], fminf(fminf(d0, d1), fminf(d2, d3)));
        }
      }
    }
  }
}

// End a run that started at target `start`: keep it if its minimum is lower
// than the row's best (strict `<`), and reset it.
template <int kRows>
__device__ __forceinline__ void close_run(float (&run)[kRows],
                                          float (&best)[kRows],
                                          int (&best_run)[kRows], int start) {
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    if (run[k] < best[k]) {
      best[k] = run[k];
      best_run[k] = start;
    }
    run[k] = INFINITY;
  }
}

// The first target of the run [j0, j0 + cnt) (cnt <= kSub; b points at
// target j0 of the packed D-coordinate array) whose score equals `best`.
template <int D = 3>
__device__ __forceinline__ int rescan(float ax, float ay, float az,
                                      float best, int j0, int cnt,
                                      const float* __restrict__ b) {
  float d[kSub];
#pragma unroll
  for (int j = 0; j < kSub; ++j)
    d[j] = j < cnt ? pair_d2<D>(ax, ay, az, __ldg(b + D * j),
                                __ldg(b + D * j + 1),
                                D == 3 ? __ldg(b + D * j + D - 1) : 0.f)
                   : INFINITY;
  int idx = j0;
#pragma unroll
  for (int j = kSub - 1; j >= 0; --j)
    if (d[j] == best) idx = j0 + j;
  return idx;
}

}  // namespace exact
