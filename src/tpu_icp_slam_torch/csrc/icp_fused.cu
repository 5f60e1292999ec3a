// K5: the whole point-to-plane ICP loop of one align in one launch, for
// sm_90a.
//
// Replaces tpu_icp_slam/kernels/icp_fused_pallas.py::_icp_kernel
// (icp_fused_pallas.py:288; its pallas_call at :803, wrapper
// icp_fused_pallas). Every iteration: transform the scan by T, find each
// point's nearest model point (exact float32 difference form, or the packed
// bf16 score of packed_d2.cuh), gather q and n, gate by distance, coverage
// (on |cur + c|, the original frame) and mask, count inliers, Huber-weight,
// accumulate H and g, add the motion prior and damping, solve the 6x6
// Cholesky system, clamp and scale the step, update T = exp(xi)·T, project
// onto the total-correction trust region and test convergence. Everything
// runs in the frame recentred on the model's bounding box; the wrapper
// (kernels/icp_fused.py) conjugates in and out.
//
// What bounds it on an H100 (chip_smoke.k5_bound): per iteration, the NN
// over M x N pairs — 9 FP32 flops a pair at "highest" (0.0361 ms per
// iteration at M = N = 16,384 and 67 TFLOP/s), the 16-lane bf16 contraction
// at "bf16" (0.0087 ms at 989 TFLOP/s); everything else is small. What the
// single launch removes is the host: the steps loop issues ~85 small
// launches and one host sync per iteration, this kernel one launch per
// align.
//
// Design:
//  - One cooperative launch (cudaLaunchCooperativeKernel): the grid is sized
//    to be co-resident (occupancy x SMs, icp_fused_max_blocks) and
//    grid.sync() separates the phases of an iteration. Nothing returns to
//    the host until the loop ends.
//  - A block owns kRows = 64 sources at a time (grid-stride over source
//    tiles). Its first 64 threads transform them once into shared memory
//    (and, at "bf16", pack them with packed::pack_source into bf16 rows).
//    The block's threads split the model axis: each staged model tile is
//    cut into kSplits equal parts, one per split, so a split sees an
//    ascending set of model indices. The splits' (min, argmin) fold per row
//    in shared memory by (score, index), so ties go to the lowest index, as
//    in the reference.
//  - "highest": the loop of nn_exact.cuh, shared with K1. 32 splits of 8
//    threads, 8 rows a thread (rows g, g + 8, ..., g + 56), every staged
//    model point serving all 8 from one broadcast read; min-only runs of 16
//    with a rescan of the winning run; 1,024-point tiles of the packed
//    (x, y, z) model through cp.async, double-buffered. The scores are
//    K1's, bit for bit, and so are the picks of the earlier one-row-per-
//    thread form of this kernel.
//  - "bf16": the tensor cores through packed_mma.cuh. 8 splits of one warp;
//    a warp holds the A fragments of all 64 rows (4 m-tiles, ldmatrix from
//    the packed rows) and scores 64 of each 512-row tile of baug, staged as
//    bf16 rows by cp.async, double-buffered.
//  - The 30 sums of an iteration (21 of H's upper triangle, 6 of g, Σw,
//    Σw·d², the inlier count) go per source row into shared memory, are
//    summed in row order per block, and written as a per-block partial,
//    double-buffered by iteration parity. After one grid.sync() EVERY block
//    sums all partials in the same fixed order and solves redundantly: the
//    blocks reach bit-identical T and convergence flags, so they leave the
//    loop together and no second grid sync is needed. No float atomics: an
//    align is bit-reproducible for a given grid.
//  - The gather is an indexed load of q and n (the reference's one-hot
//    matmul gather and transposed layouts are TPU workarounds). At "bf16"
//    each coordinate and normal component is rebuilt from its bf16 hi/lo
//    halves (packed::hi_lo), as the reference's bf16 gather operand holds
//    them; at "highest" they are the float32 values.
//  - The scalar step (solve, prior, trust region) runs on one thread per
//    block, __noinline__ so that it does not raise the register count of the
//    NN loop. arccos is the reference's Abramowitz-Stegun polynomial
//    (icp_fused_pallas.py:181-192, |err| <= 5e-5 rad): it defines this
//    path's numbers, so the kernel and its plain version both use it.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

#include "nn_exact.cuh"
#include "packed_d2.cuh"
#include "packed_mma.cuh"
#include "se3_scalar.cuh"

namespace cg = cooperative_groups;

// Mirrors kernels/icp_fused.py::_Params field by field.
struct IcpParams {
  int max_iters;
  int min_inliers;  // already max(min_inliers, 4)
  float tol, tol_update, max_d2, huber, damping, step_scale;
  float max_step_trans, max_step_rot, prior_t, prior_r;
  float max_total_trans, max_total_rot;
};

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 64;  // sources per block tile
constexpr int kSums = 30;
constexpr int kStride = 32;  // floats per partial
constexpr int kChunks = kThreads / kStride;

// ---- scalar SE(3) helpers (icp_fused_pallas.py:143-285) -----------------

using se3s::chol6_solve;
using se3s::hat2;

__device__ float acos_poly(float x) {
  const float t = fabsf(x);
  const float p = sqrtf(fmaxf(1.f - t, 0.f)) *
                  (1.5707288f +
                   t * (-0.2121144f + t * (0.0742610f + t * (-0.0187293f))));
  return x >= 0.f ? p : 3.14159265358979f - p;
}

// se3.exp: xi = [rho, phi] -> (R, t), with the small-angle Taylor branches.
__device__ void se3_exp(const float xi[6], float R[3][3], float t[3]) {
  const float* phi = xi + 3;
  const float t2 = phi[0] * phi[0] + phi[1] * phi[1] + phi[2] * phi[2];
  const float theta = sqrtf(t2 + 1e-16f);
  const bool small = t2 < 1e-8f;
  const float s = sinf(theta), c = cosf(theta);
  const float A = small ? 1.f - t2 / 6.f : s / theta;
  const float B = small ? 0.5f - t2 / 24.f : (1.f - c) / fmaxf(t2, 1e-16f);
  const float C = small ? 1.f / 6.f - t2 / 120.f
                        : (theta - s) / fmaxf(t2 * theta, 1e-24f);
  float W[3][3], W2[3][3];
  hat2(phi, W, W2);
  float V[3][3];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      const float e = i == j ? 1.f : 0.f;
      R[i][j] = e + A * W[i][j] + B * W2[i][j];
      V[i][j] = e + B * W[i][j] + C * W2[i][j];
    }
  for (int i = 0; i < 3; ++i)
    t[i] = V[i][0] * xi[0] + V[i][1] * xi[1] + V[i][2] * xi[2];
}

// se3.log on (R, t) with the polynomial arccos (icp_fused_pallas.py:195).
__device__ void se3_log(const float R[3][3], const float t[3], float xi[6]) {
  const float tr = R[0][0] + R[1][1] + R[2][2];
  const float cos_t = fminf(fmaxf(0.5f * (tr - 1.f), -1.f), 1.f);
  const float theta = acos_poly(cos_t);
  const float t2 = theta * theta;
  const bool small = t2 < 1e-8f;
  const float s = sinf(theta);
  const float k = small ? 0.5f + t2 / 12.f : theta / fmaxf(2.f * s, 1e-12f);
  float phi[3] = {k * (R[2][1] - R[1][2]), k * (R[0][2] - R[2][0]),
                  k * (R[1][0] - R[0][1])};
  const float A = small ? 1.f - t2 / 6.f : s / fmaxf(theta, 1e-12f);
  const float B = small ? 0.5f - t2 / 24.f
                        : (1.f - cosf(theta)) / fmaxf(t2, 1e-16f);
  const float c = small ? 1.f / 12.f
                        : (1.f - A / fmaxf(2.f * B, 1e-12f)) /
                              fmaxf(t2, 1e-16f);
  float W[3][3], W2[3][3], Vinv[3][3];
  hat2(phi, W, W2);
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      Vinv[i][j] = (i == j ? 1.f : 0.f) - 0.5f * W[i][j] + c * W2[i][j];
  for (int i = 0; i < 3; ++i) {
    xi[i] = Vinv[i][0] * t[0] + Vinv[i][1] * t[1] + Vinv[i][2] * t[2];
    xi[3 + i] = phi[i];
  }
}

// Original-frame correction X = S·(T·T0⁻¹)·S⁻¹ (icp_fused_pallas.py:234):
// same rotation, t_orig = t_x + c - R_x·c. T, T0 are row-major 4x4.
__device__ void orig_correction(const float* T, const float* T0,
                                const float c[3], float Rx[3][3],
                                float t_orig[3]) {
  float t0i[3], tx[3];
  for (int i = 0; i < 3; ++i)  // -R0ᵀ t0
    t0i[i] = -(T0[0 * 4 + i] * T0[3] + T0[1 * 4 + i] * T0[7] +
               T0[2 * 4 + i] * T0[11]);
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j)  // R·R0ᵀ
      Rx[i][j] = T[i * 4 + 0] * T0[j * 4 + 0] + T[i * 4 + 1] * T0[j * 4 + 1] +
                 T[i * 4 + 2] * T0[j * 4 + 2];
    tx[i] = T[i * 4 + 0] * t0i[0] + T[i * 4 + 1] * t0i[1] +
            T[i * 4 + 2] * t0i[2] + T[i * 4 + 3];
  }
  for (int i = 0; i < 3; ++i)
    t_orig[i] = tx[i] + c[i] -
                (Rx[i][0] * c[0] + Rx[i][1] * c[1] + Rx[i][2] * c[2]);
}

// One iteration's scalar step (icp_fused_pallas.py:517-636) from the 30
// summed terms. Updates T in place; state <- [rmse, n_inl, converged].
__device__ __noinline__ void solve_step(const float* sums, float* T,
                                        const float* T0, const float c[3],
                                        const IcpParams& p, float prev_rmse,
                                        float* state) {
  float h[6][6], g[6];
  int k = 0;
  for (int a = 0; a < 6; ++a)
    for (int b = a; b < 6; ++b) {
      h[a][b] = sums[k];
      h[b][a] = sums[k];
      ++k;
    }
  for (int a = 0; a < 6; ++a) g[a] = sums[21 + a];
  if (p.prior_t > 0.f || p.prior_r > 0.f) {
    // motion prior anchored at the init pose, weight relative to Σw
    float Rx[3][3], tx[3], xc[6];
    orig_correction(T, T0, c, Rx, tx);
    se3_log(Rx, tx, xc);
    const float wsum_pr = fmaxf(sums[27], 1e-6f);
    for (int a = 0; a < 6; ++a) {
      const float pw = wsum_pr * (a < 3 ? p.prior_t : p.prior_r);
      h[a][a] += pw;
      g[a] += pw * xc[a];
    }
  }
  const float wsum = fmaxf(sums[27], 1e-12f);
  const float wd2 = sums[28];
  const float n_inl = sums[29];
  const float trace = h[0][0] + h[1][1] + h[2][2] + h[3][3] + h[4][4] + h[5][5];
  const float lam = p.damping * fmaxf(trace / 6.f, 1.f);
  for (int a = 0; a < 6; ++a) h[a][a] += lam;
  float xi[6];
  chol6_solve(h, g, xi);
  bool finite = true;
  for (int a = 0; a < 6; ++a) finite = finite && isfinite(xi[a]);
  for (int a = 0; a < 6; ++a) xi[a] = finite ? xi[a] : 0.f;
  // trust clamps, translation first, each scaling the whole step
  if (p.max_step_trans > 0.f) {
    const float tn = sqrtf(xi[0] * xi[0] + xi[1] * xi[1] + xi[2] * xi[2]);
    const float s = fminf(1.f, p.max_step_trans / fmaxf(tn, 1e-12f));
    for (int a = 0; a < 6; ++a) xi[a] *= s;
  }
  if (p.max_step_rot > 0.f) {
    const float wn = sqrtf(xi[3] * xi[3] + xi[4] * xi[4] + xi[5] * xi[5]);
    const float s = fminf(1.f, p.max_step_rot / fmaxf(wn, 1e-12f));
    for (int a = 0; a < 6; ++a) xi[a] *= s;
  }
  if (p.step_scale != 1.f)
    for (int a = 0; a < 6; ++a) xi[a] *= p.step_scale;
  const bool ok = n_inl >= (float)p.min_inliers;  // else hold the pose
  for (int a = 0; a < 6; ++a) xi[a] = ok ? xi[a] : 0.f;

  // T = exp(xi)·T (row 3 of T stays [0, 0, 0, 1])
  float R[3][3], t[3];
  se3_exp(xi, R, t);
  float Tn[12];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 4; ++j)
      Tn[i * 4 + j] = R[i][0] * T[j] + R[i][1] * T[4 + j] +
                      R[i][2] * T[8 + j] + (j == 3 ? t[i] : 0.f);
  for (int e = 0; e < 12; ++e) T[e] = Tn[e];

  if (p.max_total_trans > 0.f || p.max_total_rot > 0.f) {
    // project the total correction, measured in the original frame, back
    // onto the trust ball around the init pose
    float Rx[3][3], tx[3], xt[6];
    orig_correction(T, T0, c, Rx, tx);
    se3_log(Rx, tx, xt);
    float s = 1.f;
    if (p.max_total_trans > 0.f) {
      const float tn = sqrtf(xt[0] * xt[0] + xt[1] * xt[1] + xt[2] * xt[2]);
      s = fminf(s, p.max_total_trans / fmaxf(tn, 1e-12f));
    }
    if (p.max_total_rot > 0.f) {
      const float rn = sqrtf(xt[3] * xt[3] + xt[4] * xt[4] + xt[5] * xt[5]);
      s = fminf(s, p.max_total_rot / fmaxf(rn, 1e-12f));
    }
    if (s < 1.f) {
      for (int a = 0; a < 6; ++a) xt[a] *= s;
      float Rc[3][3], tc[3];
      se3_exp(xt, Rc, tc);
      for (int i = 0; i < 3; ++i) {
        // back to the recentred frame: t_cent = t + Rc·c - c; T = X·T0
        const float tcent =
            tc[i] + (Rc[i][0] * c[0] + Rc[i][1] * c[1] + Rc[i][2] * c[2]) -
            c[i];
        for (int j = 0; j < 4; ++j)
          T[i * 4 + j] = Rc[i][0] * T0[j] + Rc[i][1] * T0[4 + j] +
                         Rc[i][2] * T0[8 + j] + tcent * T0[12 + j];
      }
    }
  }

  const float rmse = sqrtf(wd2 / wsum);
  bool conv = fabsf(prev_rmse - rmse) < p.tol;
  if (p.tol_update > 0.f) {
    // step magnitude of exp(xi): |t| + |R - I|_F
    float rf = 0.f;
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) {
        const float d = R[i][j] - (i == j ? 1.f : 0.f);
        rf += d * d;
      }
    const float tm = sqrtf(t[0] * t[0] + t[1] * t[1] + t[2] * t[2]);
    conv = conv || (tm + sqrtf(rf) < p.tol_update);
  }
  state[0] = rmse;
  state[1] = n_inl;
  state[2] = conv ? 1.f : 0.f;
}

// ---- the NN of one source tile ------------------------------------------

// "highest": kSplitsH splits of kThreads / kSplitsH threads, kRowsH rows a
// thread; each kTileH-point tile gives every split kPartH points.
constexpr int kSplitsH = 32;
constexpr int kRowsH = kRows * kSplitsH / kThreads;  // 8
constexpr int kTileH = 1024;
constexpr int kPartH = kTileH / kSplitsH;  // 32: two runs
static_assert(kPartH % exact::kSub == 0, "whole runs per split");
// "bf16": one warp a split, all kRows rows (kMtB m-tiles) per warp; each
// kTileB-row tile of baug gives every split kPartB rows.
constexpr int kSplitsB = kThreads / 32;
constexpr int kMtB = kRows / 16;
constexpr int kTileB = 512;
constexpr int kPartB = kTileB / kSplitsB;  // 64
constexpr int kTileBytesB = kTileB * packed_mma::kRowBytes;
static_assert(kPartB % 16 == 0, "whole ldmatrix.x4 steps per split");

// Start copying model points [t0, t0 + kTileH) into buf (packed x, y, z),
// past n padded with +inf.
__device__ __forceinline__ void stage_h(float* buf, const float* model3,
                                        int t0, int n, bool vec16) {
  exact::stage_tile<kThreads>(buf, model3 + 3 * (size_t)t0,
                              min(kTileH, n - t0), kTileH, vec16, threadIdx.x);
}

// Start copying baug rows [t0, t0 + kTileB) into buf, past n padded with
// packed_mma's padding row.
__device__ __forceinline__ void stage_b(unsigned char* buf,
                                        const __nv_bfloat16* baug, int t0,
                                        int n) {
  const int len = min(kTileB, n - t0);
  const unsigned base = cp_async::smem_addr(buf);
  for (int i = threadIdx.x; i < len; i += kThreads)
    packed_mma::stage_row(base, i, baug + 16 * (size_t)(t0 + i));
  for (int i = len + threadIdx.x; i < kTileB; i += kThreads)
    packed_mma::pad_row(buf, i);
}

// Exact search of the kRows points in s_p over the model; tile 0 is already
// in flight in tiles[0]. Leaves each split's (min, first index) per row in
// s_best/s_idx [split][row], which alias the tiles.
__device__ __forceinline__ void nn_highest(const float* __restrict__ model3,
                                           int n, bool vec16,
                                           const float4* s_p, float* tiles,
                                           float* s_best, int* s_idx) {
  const int split = threadIdx.x / (kThreads / kSplitsH);
  const int g = threadIdx.x % (kThreads / kSplitsH);
  float ax[kRowsH], ay[kRowsH], az[kRowsH], run[kRowsH], best[kRowsH];
  int best_run[kRowsH];
#pragma unroll
  for (int k = 0; k < kRowsH; ++k) {
    const float4 q = s_p[g + k * (kThreads / kSplitsH)];
    ax[k] = q.x;
    ay[k] = q.y;
    az[k] = q.z;
    run[k] = best[k] = INFINITY;
    best_run[k] = 0;
  }
  const int n_tiles = (n + kTileH - 1) / kTileH;
  for (int t = 0; t < n_tiles; ++t) {
    const int t0 = t * kTileH;
    if (t + 1 < n_tiles)
      stage_h(tiles + ((t + 1) & 1) * 3 * kTileH, model3, t0 + kTileH, n,
              vec16);
    cp_async::commit();
    cp_async::wait_prior();  // tile t has landed
    __syncthreads();
    const float4* v = reinterpret_cast<const float4*>(tiles +
                                                      (t & 1) * 3 * kTileH) +
                      3 * (split * kPartH / 4);
#pragma unroll
    for (int r = 0; r < kPartH / exact::kSub; ++r) {
      exact::run_min<kRowsH>(v + 3 * r * (exact::kSub / 4), exact::kSub / 4,
                             ax, ay, az, run);
      exact::close_run<kRowsH>(run, best, best_run,
                               t0 + split * kPartH + r * exact::kSub);
    }
    __syncthreads();  // every split is done with this buffer
  }
#pragma unroll
  for (int k = 0; k < kRowsH; ++k) {
    int idx = 0;
    if (best[k] < INFINITY) {
      const int j0 = best_run[k];
      idx = exact::rescan(ax[k], ay[k], az[k], best[k], j0,
                          min(exact::kSub, n - j0), model3 + 3 * (size_t)j0);
    }
    const int row = g + k * (kThreads / kSplitsH);
    s_best[split * kRows + row] = best[k];
    s_idx[split * kRows + row] = idx;
  }
}

// Packed bf16 search of the kRows packed rows in s_a over baug on the
// tensor cores; tile 0 is already in flight in tiles[0]. Leaves each split's
// (min, first index) per row in s_best/s_idx, which alias the tiles.
__device__ __forceinline__ void nn_bf16(const __nv_bfloat16* __restrict__ baug,
                                        int n, const unsigned char* s_a,
                                        unsigned char* tiles, float* s_best,
                                        int* s_idx) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned a[kMtB][4];
  float best[kMtB][2];
  int idx[kMtB][2];
#pragma unroll
  for (int mt = 0; mt < kMtB; ++mt) {
    packed_mma::load_a(a[mt], cp_async::smem_addr(s_a), 16 * mt, lane);
    best[mt][0] = best[mt][1] = INFINITY;
    idx[mt][0] = idx[mt][1] = 0;
  }
  const int n_tiles = (n + kTileB - 1) / kTileB;
  for (int t = 0; t < n_tiles; ++t) {
    const int t0 = t * kTileB;
    if (t + 1 < n_tiles)
      stage_b(tiles + ((t + 1) & 1) * kTileBytesB, baug, t0 + kTileB, n);
    cp_async::commit();
    cp_async::wait_prior();  // tile t has landed
    __syncthreads();
    const unsigned tile =
        cp_async::smem_addr(tiles + (t & 1) * kTileBytesB);
#pragma unroll
    for (int n0 = 0; n0 < kPartB; n0 += 16)
      packed_mma::score16<kMtB>(a, tile, warp * kPartB + n0, t0, lane, best,
                                idx);
    __syncthreads();  // every split is done with this buffer
  }
#pragma unroll
  for (int mt = 0; mt < kMtB; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      packed_mma::quad_min(best[mt][h], idx[mt][h]);
      if ((lane & 3) == 0) {
        const int row = 16 * mt + (lane >> 2) + 8 * h;
        s_best[warp * kRows + row] = best[mt][h];
        s_idx[warp * kRows + row] = idx[mt][h];
      }
    }
}

// ---- the kernel ----------------------------------------------------------

template <bool kBf16>
__global__ void __launch_bounds__(kThreads, 2)
icp_fused_kernel(const float4* __restrict__ src,   // (m) [x-c, y, z, mask]
                 int m,
                 const float* __restrict__ model3,  // (n, 3) [x-c, y, z]
                 const float4* __restrict__ model,  // (n) [x-c, y, z, 0]
                 const float4* __restrict__ nrm,    // (n) [nx, ny, nz, 0]
                 const __nv_bfloat16* __restrict__ baug,  // (n, 16), bf16
                 int n,
                 const float* __restrict__ T0,    // (16) recentred init T
                 const float* __restrict__ gate,  // (4) [r_gate, c]
                 IcpParams p,
                 float* __restrict__ partials,    // (2, gridDim.x, kStride)
                 float* __restrict__ out) {       // (20) T, rmse, it, inl, conv
  constexpr int kSplits = kBf16 ? kSplitsB : kSplitsH;
  constexpr int kNnBytes = kBf16 ? 2 * kTileBytesB : 2 * 3 * kTileH * 4;
  static_assert(kSplits * kRows * 8 <= kNnBytes, "fold arrays fit the tiles");
  __shared__ __align__(128) unsigned char s_nn[kNnBytes];
  __shared__ __align__(128) unsigned char s_a[kBf16 ? kRows * 32 : 16];
  __shared__ float4 s_p[kRows];  // transformed sources [x, y, z, mask]
  __shared__ float s_acc[kRows][kSums + 1];
  __shared__ float s_red[kChunks][kStride];
  __shared__ float s_sums[kStride];
  __shared__ float s_T[16], s_T0[16], s_state[3];
  float* s_best = reinterpret_cast<float*>(s_nn);
  int* s_idx = reinterpret_cast<int*>(s_nn + kSplits * kRows * 4);

  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x;
  if (tid < 16) {
    s_T[tid] = T0[tid];
    s_T0[tid] = T0[tid];
  }
  const float c[3] = {gate[1], gate[2], gate[3]};
  const float rg2 = gate[0] * gate[0];
  const int n_tiles = (m + kRows - 1) / kRows;
  const bool vec16 = (reinterpret_cast<uintptr_t>(model3) & 15) == 0;
  __syncthreads();

  int it = 0;
  float rmse = INFINITY, n_inl = 0.f;
  bool conv = false;
  while (it < p.max_iters && !conv) {
    for (int k = tid; k < kRows * (kSums + 1); k += kThreads)
      (&s_acc[0][0])[k] = 0.f;

    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const int i = tile * kRows + tid;
      __syncthreads();  // the previous tile's fold and gather are done
      // the first model tile flies while the sources are transformed
      if constexpr (kBf16)
        stage_b(s_nn, baug, 0, n);
      else
        stage_h(reinterpret_cast<float*>(s_nn), model3, 0, n, vec16);
      cp_async::commit();
      if (tid < kRows) {
        float T[12];
#pragma unroll
        for (int e = 0; e < 12; ++e) T[e] = s_T[e];
        float px = 0.f, py = 0.f, pz = 0.f, pm = 0.f;
        if (i < m) {
          const float4 s = src[i];
          px = T[0] * s.x + T[1] * s.y + T[2] * s.z + T[3];
          py = T[4] * s.x + T[5] * s.y + T[6] * s.z + T[7];
          pz = T[8] * s.x + T[9] * s.y + T[10] * s.z + T[11];
          pm = s.w;
        }
        s_p[tid] = make_float4(px, py, pz, pm);
        if constexpr (kBf16) {
          float a[packed::kLanes];
          packed::pack_source(px, py, pz, a);
          packed_mma::store_row(s_a, tid, a);
        }
      }
      __syncthreads();
      if constexpr (kBf16)
        nn_bf16(baug, n, s_a, s_nn, s_best, s_idx);
      else
        nn_highest(model3, n, vec16, s_p, reinterpret_cast<float*>(s_nn),
                   s_best, s_idx);
      __syncthreads();
      if (tid < kRows && i < m) {
        const int row = tid;
        // fold the splits: the lowest score, on equal scores the lowest index
        float best = s_best[row];
        int best_idx = s_idx[row];
        for (int sp = 1; sp < kSplits; ++sp) {
          const float b = s_best[sp * kRows + row];
          const int j = s_idx[sp * kRows + row];
          if (b < best || (b == best && j < best_idx)) {
            best = b;
            best_idx = j;
          }
        }
        const float4 pt = s_p[row];
        const float px = pt.x, py = pt.y, pz = pt.z, pm = pt.w;
        float4 q = model[best_idx];
        float4 nv = nrm[best_idx];
        if constexpr (kBf16) {
          q = make_float4(packed::hi_lo(q.x), packed::hi_lo(q.y),
                          packed::hi_lo(q.z), 0.f);
          nv = make_float4(packed::hi_lo(nv.x), packed::hi_lo(nv.y),
                           packed::hi_lo(nv.z), 0.f);
        }
        const float dx = px - q.x, dy = py - q.y, dz = pz - q.z;
        const float d2 = dx * dx + dy * dy + dz * dz;
        float w = (d2 <= p.max_d2 ? 1.f : 0.f) * pm;
        const float g0 = px + c[0], g1 = py + c[1], g2 = pz + c[2];
        w *= (g0 * g0 + g1 * g1 + g2 * g2 <= rg2) ? 1.f : 0.f;
        const float inlier = w;  // counted before Huber down-weighting
        if (p.huber > 0.f)
          w *= fminf(1.f, p.huber / sqrtf(fmaxf(d2, 1e-20f)));
        const float J[6] = {nv.x, nv.y, nv.z, py * nv.z - pz * nv.y,
                            pz * nv.x - px * nv.z, px * nv.y - py * nv.x};
        const float r = dx * nv.x + dy * nv.y + dz * nv.z;
        float* acc = s_acc[row];
        int k = 0;
#pragma unroll
        for (int aa = 0; aa < 6; ++aa) {
          const float wa = w * J[aa];
#pragma unroll
          for (int bb = aa; bb < 6; ++bb) acc[k++] += wa * J[bb];
        }
        const float wr = w * r;
#pragma unroll
        for (int aa = 0; aa < 6; ++aa) acc[21 + aa] += wr * J[aa];
        acc[27] += w;
        acc[28] += w * d2;
        acc[29] += inlier;
      }
    }
    __syncthreads();
    // this block's partial: rows summed in order
    float* part = partials + (size_t)(it & 1) * gridDim.x * kStride;
    if (tid < kSums) {
      float s = 0.f;
      for (int r = 0; r < kRows; ++r) s += s_acc[r][tid];
      part[(size_t)blockIdx.x * kStride + tid] = s;
    }
    grid.sync();
    // every block: all partials in the same fixed order
    {
      const int k = tid % kStride, chunk = tid / kStride;
      float s = 0.f;
      if (k < kSums)
        for (int b = chunk; b < (int)gridDim.x; b += kChunks)
          s += __ldcg(part + (size_t)b * kStride + k);
      s_red[chunk][k] = s;
    }
    __syncthreads();
    if (tid < kSums) {
      float s = 0.f;
      for (int ch = 0; ch < kChunks; ++ch) s += s_red[ch][tid];
      s_sums[tid] = s;
    }
    __syncthreads();
    if (tid == 0) solve_step(s_sums, s_T, s_T0, c, p, rmse, s_state);
    __syncthreads();
    rmse = s_state[0];
    n_inl = s_state[1];
    conv = s_state[2] != 0.f;
    ++it;
  }
  if (blockIdx.x == 0 && tid < 16) out[tid] = s_T[tid];
  if (blockIdx.x == 0 && tid == 0) {
    out[16] = rmse;
    out[17] = (float)it;
    out[18] = n_inl;
    out[19] = conv ? 1.f : 0.f;
  }
}

template <bool kBf16>
cudaError_t max_blocks(int* blocks) {
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, icp_fused_kernel<kBf16>, kThreads, 0);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  *blocks = per_sm * sms;
  return cudaSuccess;
}

}  // namespace

// The most blocks of K5 (precision bf16 != 0) that are co-resident on the
// current device; cudaErrorNotSupported without cooperative launch.
extern "C" cudaError_t icp_fused_max_blocks(int bf16, int* blocks) {
  return bf16 ? max_blocks<true>(blocks) : max_blocks<false>(blocks);
}

// src4 (m, 4), model3 (n, 3), model4/nrm4 (n, 4) float32 (model3 and
// model4 the same points), baug (n, 16) bf16 (bf16 mode, else unused), T0
// (4, 4) and gate (4,) float32 on the device; params on the host; scratch
// partials (2, grid, 32); out (20,) float32. The grid must not exceed
// icp_fused_max_blocks: a larger cooperative launch is refused.
extern "C" cudaError_t icp_fused_f32(const float* src4, int m,
                                     const float* model3, const float* model4,
                                     const float* nrm4, const void* baug,
                                     int n, const float* T0,
                                     const float* gate,
                                     const IcpParams* params, int bf16,
                                     int grid, float* partials, float* out,
                                     cudaStream_t stream) {
  if (m <= 0 || n <= 0 || grid <= 0) return cudaErrorInvalidValue;
  const float4* s = reinterpret_cast<const float4*>(src4);
  const float4* mo = reinterpret_cast<const float4*>(model4);
  const float4* no = reinterpret_cast<const float4*>(nrm4);
  const __nv_bfloat16* b = static_cast<const __nv_bfloat16*>(baug);
  IcpParams p = *params;
  void* args[] = {&s,  &m,    &model3, &mo, &no,       &b,  &n,
                  &T0, &gate, &p,      &partials, &out};
  const void* fn = bf16 ? (const void*)icp_fused_kernel<true>
                        : (const void*)icp_fused_kernel<false>;
  cudaError_t err = cudaLaunchCooperativeKernel(fn, dim3(grid),
                                                dim3(kThreads), args, 0,
                                                stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
