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
//    element gives exactly what the unbatched call gives on it.
//
// Two scans, chosen by the input (no setting):
//  - nn_split_kernel<D> (above): the unbatched call at D = 2 and 3 (the
//    front end's search, 3.2 a frame on a new local model) and the batched
//    call at D = 2. It scores every pair in the difference form: 3 FSUB,
//    FMUL, 2 FFMA and one FMNMX into the run minimum, 7 instructions a pair
//    (+ ~0.3 for the broadcast loads, run closes and loop).
//  - factored::nn_split_kernel_factored (below): the batched call at D = 3,
//    loop verification's. It scores every pair in the factored form s =
//    ‖b‖² − 2a·b as fma(−2ax, bx, fma(−2ay, by, fma(−2az, bz, ‖b‖²))) with
//    −2a in registers and each staged target one float4 (x, y, z, ‖b‖²),
//    ‖b‖² computed as the tile is staged: 3 FFMA and one FMNMX, 4
//    instructions a pair. That score only filters: its float32 error
//    (~‖p‖²·u, up to ~1e-3 m² at 60 m) would move picks on near-ties, so
//    selection stays the difference form on a rescan of every run that a
//    rigorous bound cannot rule out, and idx and d2 are the first kernel's
//    bit for bit. The split by form is one of scope, not of a measured
//    difference: no run has yet timed the factored scan on the unbatched
//    call (the front end of the odometry cells), so that call keeps the
//    first scan until one does; if it is not slower there, every 3-D call
//    can take it.
//
// The factored scan's filter. u = 2^-24, γk = k·u / (1 − k·u); a row a,
// targets b, G = ‖a − b‖² − ‖a‖² = ‖b‖² − 2a·b, E the difference form's
// computed score, D = ‖a − b‖².
//  - Rounding. nb = fl(‖b‖²) and na = fl(‖a‖²) (FMUL, FFMA, FFMA) lie within
//    γ3 of the norm. Each target is staged with w = nb − kCB·nb rounded
//    down (__fmaf_rd), and its score is F = fl(w − 2a·b): the three FMAs
//    round w three times, az·bz three, ay·by twice, ax·bx once, so |F − (w
//    − 2a·b)| ≤ γ3 (w + 2Σ|ai bi|) ≤ γ3 (nb + ‖a‖² + ‖b‖²). With ‖b‖² ≤
//    nb / (1 − γ3), ‖a‖² ≤ na / (1 − γ3) and cB = γ3 (3 − γ3) / (1 − γ3) ≈
//    9u ≤ kCB: F ≤ G + cA·na with cA = γ3 / (1 − γ3) ≈ 3u, and, as w lies
//    within one ulp (≤ 2u·nb) below nb − kCB·nb, G ≤ F + 3·kCB·nb + cA·na.
//    E's terms are rounded at most five times (the subtraction squared,
//    FMUL, two FFMA), so |E − D| ≤ γ5·D.
//  - Bound. Let j* hold the least E (any of them, on ties) and k be any
//    target. E_j* ≤ E_k gives D_j* ≤ D_k (1 + γ5) / (1 − γ5), so G_j* ≤ G_k
//    + cE·D_k with cE = 2γ5 / (1 − γ5) ≈ 10u. A run r of 32 targets with
//    least computed score lo_r and largest norm nb_r has lo_r − cA·na below
//    every G in it, and hi_r = lo_r + 3·kCB·nb_r with G_k ≤ hi_r + cA·na for
//    its minimising k (a padded target in a run widens hi_r, not lo_r).
//    With V the least hi over the runs so far (so D_k ≤ V + cA·na + ‖a‖²),
//    a run that holds j* has
//        lo_r ≤ V + 2·cA·na + cE·(V + cA·na + ‖a‖²) =: thr(V).
//    A run with lo_r > thr(V) holds no least E and is never rescanned. V
//    only falls and thr is increasing, so a run ruled out early stays ruled
//    out; thr(V) is the least thr(hi_r) over the runs so far. As hi_r +
//    cA·na ≥ G_k ≥ −‖a‖², V + cA·na + ‖a‖² ≥ 0 and thr is linear in V:
//    thr(V) = V + cE·V + c with c = 2·cA·na + cE·(cA·na + ‖a‖²), one FMA
//    and one add a kept run. The kernel takes kCB, kCA, kCE as 9u, 3u, 10u
//    times (1 + 2^-12) (their O(u²) terms), ‖a‖² ≤ na·(1 + 2^-21), rounds
//    hi and every term of thr up (__fadd_ru, __fmul_ru, __fmaf_ru), and adds
//    kEta = 2^-60 for results in the subnormal range (no flush to zero).
//    The bound holds while every norm is below kRange = 2^100, so that no
//    score overflows. On a run a row spends 32 x (3 FFMA + FMNMX) and one
//    compare with thr.
//  - Selection. A row keeps (lo_r, start) of each run with lo_r ≤ thr: the
//    newest in registers, and the one before it, when a newer run comes and
//    thr still keeps it, in up to kSlots = 4 shared-memory slots, in index
//    order (a kept run mostly lowers thr past the one before it, so the
//    slots are seldom written). Full slots first drop what the current thr
//    rules out; slots still full make the row overflow, and it rescans its
//    whole split in the difference form. At the end each kept run with lo_r
//    ≤ thr(V) is rescanned in the difference form (nn_exact.cuh's chain,
//    from global memory), in index order with a strict `<`: the least E and
//    its first index, the first kernel's pick. The splits and the fold
//    (nn_fold.cuh) are the first kernel's.
//  - Occupancy: __launch_bounds__(kThreads, 4) holds ptxas to 128
//    registers and four blocks an SM (41 KB of shared memory each) with no
//    spill; left free it took 96 and spilled, 13% slower on an H100.
//  - Far rows. At ‖a‖² ≥ kFar = 2^32, E's own rounding (~‖a‖²·u) ties many
//    targets and the filter would keep most runs. Padded rows hold the 1e6
//    sentinel, all moved by one pose, so they repeat the block's last row:
//    such a row takes that row's pick, which the whole block finds once (a
//    strided difference-form scan of the split and a reduction to the first
//    least score), and keeps no run; a block of such rows alone skips the
//    scan. A block with any other far row, or that stages a norm outside
//    kRange (or NaN), drops the filter: every row scans its split in the
//    difference form, as an overflowed row does (no input of the benchmark
//    does this; it keeps the picks exact on any input).
//  - Counts (when the wrapper passes its buffer): runs rescanned, rows,
//    fallback rows (overflowed, or in a block that dropped the filter) and
//    rows that took the last row's pick, each row once a split, added once
//    a block.

#include <cuda_runtime.h>
#include <limits.h>
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


// ---- the batched 3-D scan: factored filter, certified exact selection ----
namespace factored {

constexpr int kRows = 8;
constexpr int kBlockRows = kThreads * kRows;  // nn_cuda.py::_BLOCK_ROWS
constexpr int kTile = 2 * kThreads;  // targets a staged tile, two a thread
constexpr int kRun = 32;             // targets a run: one warp stages one
constexpr int kRunsPerTile = kTile / kRun;
constexpr int kSlots = 4;  // kept runs a row holds (nn_cuda.py::SLOTS)
constexpr float kU = 0x1p-24f;  // unit roundoff
// The bound's coefficients (nn_cuda.py::C_B, C_A, C_E), each its exact
// value times (1 + 2^-12), which covers their O(u²) terms.
constexpr float kCB = 9.0f * kU * (1.0f + 0x1p-12f);
constexpr float kCHi = 3.0f * kCB;  // a run's upper score: 3·kCB·nb_r
constexpr float kCA = 3.0f * kU * (1.0f + 0x1p-12f);
constexpr float kCE = 10.0f * kU * (1.0f + 0x1p-12f);
constexpr float kNaUp = 1.0f + 0x1p-21f;  // ‖a‖² <= na (1 + 3.0001u)
constexpr float kEta = 0x1p-60f;          // subnormal results (nn_cuda.ETA)
constexpr float kRange = 0x1p100f;  // a squared norm the filter covers
constexpr float kFar = 0x1p32f;     // a row this far keeps no run
static_assert(kRun == 32 && kTile % kRun == 0, "a run is a warp's targets");

struct Shared {
  float4 tile[2][kTile];  // (x, y, z, w), NaN past the split's end
  float e_b[2][kRunsPerTile];  // kCHi · the run's largest nb, rounded up
  float slot_lo[kSlots][kBlockRows];  // a kept run's lower score
  int slot_run[kSlots][kBlockRows];   // and its first target
  unsigned long long sums[4];
  float pick_d2[kThreads / 32];  // the last row's pick, by warp, then [0]
  int pick_idx[kThreads / 32];
};

__device__ __forceinline__ float sq_norm(float x, float y, float z) {
  return __fmaf_rn(z, z, __fmaf_rn(y, y, __fmul_rn(x, x)));
}

// This thread's two targets of a tile (tile-relative tid and tid + kThreads)
struct Staged {
  float x[2], y[2], z[2];
};

__device__ __forceinline__ void load_tile(Staged& s,
                                          const float* __restrict__ g,
                                          int len) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int j = threadIdx.x + i * kThreads;
    if (j < len) {
      s.x[i] = __ldg(g + 3 * j);
      s.y[i] = __ldg(g + 3 * j + 1);
      s.z[i] = __ldg(g + 3 * j + 2);
    }
  }
}

// Write the staged targets with w = nb − kCB·nb rounded down (NaN past
// len, which no score of either form takes as a minimum) and each run's
// e_b. Returns whether this thread staged a norm outside kRange (or NaN).
__device__ __forceinline__ bool store_tile(const Staged& s, float4* tile,
                                           float* e_b, int len) {
  bool bad = false;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int j = threadIdx.x + i * kThreads;
    float nb = 0.f;
    if (j < len) {
      nb = sq_norm(s.x[i], s.y[i], s.z[i]);
      tile[j] = make_float4(s.x[i], s.y[i], s.z[i],
                            __fmaf_rd(-kCB, nb, nb));
      bad |= !(nb < kRange);
    } else {
      tile[j] = make_float4(NAN, NAN, NAN, NAN);
    }
    float mx = nb;  // the run's largest norm: 32 lanes, 32 targets
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    if ((threadIdx.x & 31) == 0) e_b[j / kRun] = __fmul_ru(kCHi, mx);
  }
  return bad;
}

// The row's part of thr(V) = V + cE·V + c: c = 2·cA·na + cE·(cA·na +
// ‖a‖²) + kEta, rounded up (V + cA·na + ‖a‖² ≥ 0, see the source note).
__device__ __forceinline__ float bound_const(float ax, float ay, float az) {
  const float na = sq_norm(ax, ay, az);
  const float e_a = __fmul_ru(kCA, na);
  const float d = __fadd_ru(e_a, __fmul_ru(kNaUp, na));
  return __fadd_ru(__fadd_ru(2.f * e_a, __fmul_ru(kCE, d)), kEta);
}

// Append (lo, start) to row r's slots (k: its four bits of cnt), first
// dropping what thr rules out when they are full; kSlots + 1 marks an
// overflow. Returns cnt.
__device__ __noinline__ unsigned push(Shared& sh, int k, int r, float lo,
                                      int start, float thr, unsigned cnt) {
  unsigned c = (cnt >> (4 * k)) & 15u;
  if (c == kSlots) {
    c = 0;
    for (int s = 0; s < kSlots; ++s) {
      const float l = sh.slot_lo[s][r];
      if (l <= thr) {
        sh.slot_lo[c][r] = l;
        sh.slot_run[c][r] = sh.slot_run[s][r];
        ++c;
      }
    }
    if (c == kSlots) c = kSlots + 1;
  }
  if (c < kSlots) {
    sh.slot_lo[c][r] = lo;
    sh.slot_run[c][r] = start;
    ++c;
  }
  return (cnt & ~(15u << (4 * k))) | (c << (4 * k));
}

// Fold the exact scores of targets [j0, j0 + cnt) (b points at j0) into
// (best, idx) in index order, strict `<`: the first minimum.
__device__ __forceinline__ void exact_range(float ax, float ay, float az,
                                            int j0, int cnt,
                                            const float* __restrict__ b,
                                            float& best, int& idx) {
  for (int h = 0; h < cnt; h += exact::kSub) {
    float d[exact::kSub];
#pragma unroll
    for (int j = 0; j < exact::kSub; ++j)
      d[j] = h + j < cnt ? exact::pair_d2(ax, ay, az, __ldg(b + 3 * (h + j)),
                                          __ldg(b + 3 * (h + j) + 1),
                                          __ldg(b + 3 * (h + j) + 2))
                         : INFINITY;
#pragma unroll
    for (int j = 0; j < exact::kSub; ++j)
      if (d[j] < best) {
        best = d[j];
        idx = j0 + h + j;
      }
  }
}

// The first least difference-form score of row (ax, ay, az) over targets
// [begin, begin + cnt) (b points at begin), every thread of the block a
// strided part, into sh.pick_d2[0] and sh.pick_idx[0] (begin where no score
// is below +inf, as a split's pick).
__device__ __forceinline__ void last_row_pick(Shared& sh, float ax, float ay,
                                              float az, int begin, int cnt,
                                              const float* __restrict__ b) {
  float best = INFINITY;
  int idx = INT_MAX;
  for (int j = threadIdx.x; j < cnt; j += kThreads) {
    const float d = exact::pair_d2(ax, ay, az, __ldg(b + 3 * j),
                                   __ldg(b + 3 * j + 1), __ldg(b + 3 * j + 2));
    if (d < best) {
      best = d;
      idx = begin + j;
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    const float od = __shfl_down_sync(0xffffffffu, best, off);
    const int oi = __shfl_down_sync(0xffffffffu, idx, off);
    if (od < best || (od == best && oi < idx)) {
      best = od;
      idx = oi;
    }
  }
  if ((threadIdx.x & 31) == 0) {
    sh.pick_d2[threadIdx.x / 32] = best;
    sh.pick_idx[threadIdx.x / 32] = idx;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kThreads / 32; ++w)
      if (sh.pick_d2[w] < best || (sh.pick_d2[w] == best &&
                                   sh.pick_idx[w] < idx)) {
        best = sh.pick_d2[w];
        idx = sh.pick_idx[w];
      }
    sh.pick_d2[0] = best;
    sh.pick_idx[0] = best < INFINITY ? idx : begin;
  }
  __syncthreads();
}

// Stage tile t + 1 (if any) while the caller scores tile t; `score(t0,
// len, v, e_b)` runs on each tile. Returns false, at a tile boundary, as
// soon as a staged norm lies outside kRange (or is NaN).
template <class Score>
__device__ __forceinline__ bool scan_tiles(Shared& sh,
                                           const float* __restrict__ dst,
                                           int begin, int end, Score score) {
  const int n_tiles = (end - begin + kTile - 1) / kTile;
  Staged st;
  load_tile(st, dst + 3 * (size_t)begin, min(kTile, end - begin));
  bool bad = store_tile(st, sh.tile[0], sh.e_b[0], min(kTile, end - begin));
  if (__syncthreads_or(bad)) return false;
  for (int t = 0; t < n_tiles; ++t) {
    const int t0 = begin + t * kTile;
    const int len1 = min(kTile, end - t0 - kTile);
    if (t + 1 < n_tiles) load_tile(st, dst + 3 * (size_t)(t0 + kTile), len1);
    score(t0, min(kTile, end - t0), sh.tile[t & 1], sh.e_b[t & 1]);
    bad = t + 1 < n_tiles &&
          store_tile(st, sh.tile[(t + 1) & 1], sh.e_b[(t + 1) & 1], len1);
    // tile t + 1 is in, and every thread is done with tile t's buffer
    if (__syncthreads_or(bad)) return false;
  }
  return true;
}

__global__ void __launch_bounds__(kThreads, 4)
nn_split_kernel_factored(const float* __restrict__ src,
                         const float* __restrict__ dst, int m, int n,
                         int group, int split_len,
                         float* __restrict__ part_d2,
                         int* __restrict__ part_idx,
                         unsigned long long* __restrict__ counts) {
  __shared__ Shared sh;
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * kBlockRows + tid;
  const int split = blockIdx.y;
  const size_t batch_i = blockIdx.z;
  src += batch_i * m * 3;
  dst += (batch_i / group) * n * 3;
  part_d2 += batch_i * gridDim.y * m;
  part_idx += batch_i * gridDim.y * m;
  const int begin = split * split_len;
  const int end = min(n, begin + split_len);
  if (tid < 4) sh.sums[tid] = 0ull;

  // A far row (padding holds the 1e6 sentinel) that repeats the block's
  // last row bit for bit shares that row's pick, which the whole block
  // finds once; any other far row makes the block drop the filter.
  const int last = min(m, (int)(blockIdx.x + 1) * kBlockRows) - 1;
  const float lx = src[3 * last], ly = src[3 * last + 1],
              lz = src[3 * last + 2];
  float m2x[kRows], m2y[kRows], m2z[kRows];  // −2a, exact (a = −0.5 of it)
  unsigned far = 0;  // a bit a row
  bool odd = false, near = false;
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const int row = row0 + k * kThreads;
    float ax = 0.f, ay = 0.f, az = 0.f;
    if (row < m) {
      ax = src[3 * row + 0];
      ay = src[3 * row + 1];
      az = src[3 * row + 2];
      const bool f = !(sq_norm(ax, ay, az) < kFar);
      far |= (unsigned)f << k;
      odd |= f && (__float_as_uint(ax) != __float_as_uint(lx) ||
                   __float_as_uint(ay) != __float_as_uint(ly) ||
                   __float_as_uint(az) != __float_as_uint(lz));
      near |= !f;
    }
    m2x[k] = -2.f * ax;
    m2y[k] = -2.f * ay;
    m2z[k] = -2.f * az;
  }
  odd = __syncthreads_or(odd);
  near = __syncthreads_or(near);
  if (__syncthreads_or(far != 0) && !odd)
    last_row_pick(sh, lx, ly, lz, begin, end - begin, dst + 3 * (size_t)begin);

  float thr[kRows], thr_c[kRows], last_lo[kRows];
  int last_run[kRows];
  unsigned cnt = 0;  // kept runs, four bits a row (kSlots + 1: overflow)
  unsigned n_rescanned = 0, n_rows = 0, n_fallback = 0, n_shared = 0;
  bool filtered = !odd && !near;  // every row shares the last row's pick
  if (!odd && near) {
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      thr[k] = (far >> k) & 1u ? -INFINITY : INFINITY;  // keeps no run
      last_lo[k] = INFINITY;
      last_run[k] = begin;
      thr_c[k] = bound_const(-0.5f * m2x[k], -0.5f * m2y[k], -0.5f * m2z[k]);
    }
    filtered = scan_tiles(sh, dst, begin, end, [&](int t0, int len,
                                                   const float4* v,
                                                   const float* e_b) {
      const int n_runs = (len + kRun - 1) / kRun;
      for (int q = 0; q < n_runs; ++q) {
        float run[kRows];  // the run's least score: its lower score lo_r
#pragma unroll
        for (int g = 0; g < kRun; g += 4) {
          const float4 p0 = v[q * kRun + g + 0];
          const float4 p1 = v[q * kRun + g + 1];
          const float4 p2 = v[q * kRun + g + 2];
          const float4 p3 = v[q * kRun + g + 3];
#pragma unroll
          for (int k = 0; k < kRows; ++k) {
            const float d0 = __fmaf_rn(m2x[k], p0.x, __fmaf_rn(m2y[k], p0.y,
                             __fmaf_rn(m2z[k], p0.z, p0.w)));
            const float d1 = __fmaf_rn(m2x[k], p1.x, __fmaf_rn(m2y[k], p1.y,
                             __fmaf_rn(m2z[k], p1.z, p1.w)));
            const float d2 = __fmaf_rn(m2x[k], p2.x, __fmaf_rn(m2y[k], p2.y,
                             __fmaf_rn(m2z[k], p2.z, p2.w)));
            const float d3 = __fmaf_rn(m2x[k], p3.x, __fmaf_rn(m2y[k], p3.y,
                             __fmaf_rn(m2z[k], p3.z, p3.w)));
            const float d = fminf(fminf(d0, d1), fminf(d2, d3));
            run[k] = g == 0 ? d : fminf(run[k], d);
          }
        }
        const float eb = e_b[q];
        const int start = t0 + q * kRun;
#pragma unroll
        for (int k = 0; k < kRows; ++k) {
          const float lo = run[k];
          if (!(lo <= thr[k])) continue;  // ruled out: the common case
          // thr(hi_r): V only falls, and thr(V) is the least thr(hi_r)
          const float hi = __fadd_ru(lo, eb);
          thr[k] = fminf(thr[k], __fadd_ru(hi, __fmaf_ru(kCE, hi, thr_c[k])));
          // the newest kept run waits in registers; the one before it goes
          // to the row's slots only if the bound still keeps it
          if (last_lo[k] <= thr[k])
            cnt = push(sh, k, k * kThreads + tid, last_lo[k], last_run[k],
                       thr[k], cnt);
          last_lo[k] = lo;
          last_run[k] = start;
        }
      }
    });
  }

  // the kept runs, rescanned in index order; an overflowed row, or every
  // row of a block the filter cannot take, scans its split exactly
  const float* split_dst = dst + 3 * (size_t)begin;
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const int row = row0 + k * kThreads;
    if (row >= m) continue;
    const float ax = src[3 * row], ay = src[3 * row + 1],
                az = src[3 * row + 2];
    float b = INFINITY;
    int idx = begin;
    const unsigned c = (cnt >> (4 * k)) & 15u;
    if (!filtered || (!((far >> k) & 1u) && c > kSlots)) {
      exact_range(ax, ay, az, begin, end - begin, split_dst, b, idx);
      ++n_fallback;
    } else if ((far >> k) & 1u) {
      b = sh.pick_d2[0];
      idx = sh.pick_idx[0];
      ++n_shared;
    } else {
      const int r = k * kThreads + tid;
      for (int s = 0; s <= (int)c; ++s) {  // the slots, then the newest
        const float l = s < (int)c ? sh.slot_lo[s][r] : last_lo[k];
        const int j0 = s < (int)c ? sh.slot_run[s][r] : last_run[k];
        if (!(l <= thr[k])) continue;
        exact_range(ax, ay, az, j0, min(kRun, end - j0),
                    dst + 3 * (size_t)j0, b, idx);
        ++n_rescanned;
      }
    }
    part_d2[(size_t)split * m + row] = b;
    part_idx[(size_t)split * m + row] = idx;
    ++n_rows;
  }

  if (counts) {  // one add a block of each count
    unsigned long long v[4] = {n_rescanned, n_rows, n_fallback, n_shared};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v[i] += __shfl_xor_sync(0xffffffffu, v[i], off);
      if ((tid & 31) == 0) atomicAdd(&sh.sums[i], v[i]);
    }
    __syncthreads();
    if (tid < 4) atomicAdd(counts + tid, sh.sums[tid]);
  }
}

}  // namespace factored

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


// Blocks of the batched 3-D scan (factored::nn_split_kernel_factored) one SM
// holds at once, for the wrapper's choice of n_split.
extern "C" cudaError_t nn_bruteforce_factored_blocks_per_sm(int* out) {
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, factored::nn_split_kernel_factored, kThreads, 0);
}

// The batched 3-D search on the factored filter: src (batch, m, 3), dst
// (batch / group, n, 3), scratch and outputs as nn_bruteforce_f32's, which
// it gives bit for bit. counts (4 uint64: runs rescanned, rows, fallback
// rows, rows that took the last row's pick; each row counted once a split)
// is added to unless it is null.
extern "C" cudaError_t nn_bruteforce_factored_f32(
    const float* src, const float* dst, int batch, int group, int m, int n,
    int n_split, float* part_d2, int* part_idx, float* d2, int* idx,
    unsigned long long* counts, cudaStream_t stream) {
  if (m <= 0 || n <= 0 || n_split <= 0 || batch <= 0 || group <= 0 ||
      batch % group != 0 || batch > 65535 || n_split > 65535)
    return cudaErrorInvalidValue;
  const int split_len =
      ((n + n_split - 1) / n_split + kSplitAlign - 1) & ~(kSplitAlign - 1);
  if ((long long)(n_split - 1) * split_len >= n) return cudaErrorInvalidValue;
  const dim3 grid((m + factored::kBlockRows - 1) / factored::kBlockRows,
                  n_split, batch);
  factored::nn_split_kernel_factored<<<grid, kThreads, 0, stream>>>(
      src, dst, m, n, group, split_len, part_d2, part_idx, counts);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 fold_grid((m + 127) / 128, batch);
  nn_fold_kernel<<<fold_grid, 128, 0, stream>>>(part_d2, part_idx, m, n_split,
                                                d2, idx, nullptr);
  return cudaGetLastError();
}
