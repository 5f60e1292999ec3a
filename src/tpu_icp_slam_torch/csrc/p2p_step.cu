// K2P: one point-to-point ICP iteration after the correspondence, float32
// (float64 inside the rigid fit), for sm_90a: the step of icp/loop.py::
// gn_step_ref for the Umeyama methods, in SE(2) and SE(3), unbatched or
// batched, in two launches.
//
// Replaces the tail of the reference's compiled iteration for
// method="point_to_point", tpu_icp_slam/icp/loop.py:150-235 (the body of
// the lax.while_loop at :301, vmapped by backend/loop_closure.py:133-180
// for verification): the Umeyama branch at :202, icp/point_to_point.py:
// 47-65 (umeyama_masked, the centred form) and :25-44 (rigid_from_stats's
// SVD), then over-relaxation as exp(s·log dT), the min_inliers hold,
// T <- dT·T, AA(1) (icp.anderson), the total-correction trust region, the
// rmse and the convergence test (tol, tol_update), in core/se2.py's or
// core/se3.py's algebra. From the correspondence (cur, q, gate, d2) and
// the source's float mask it computes per row the Huber weight w =
// huber(gate·mask, d2), the inlier count (w > 0), Σw, Σw·src, Σw·dst and
// Σw·d²; then the weighted means; then the centred cross-covariance
// Σ w (dst - mu_d)(src - mu_s)ᵀ / Σw; then, once, the rest of the step,
// and it writes the carried state (loop._init_state's seven fields) in
// place, frozen as the loops freeze it (converged; unrolled, also iters >=
// max_iters), and counts the iteration.
//
// What bounds it on an H100: its bytes and two launches. A row reads
// 2D + 3 floats (cur, q, gate, d2, mask) in each pass: 0.3 MB at M =
// 16,384, D = 3, and 8.4 MB at verification's B = 16 (the second pass
// reads them from L2). The torch step it replaces was ~60 kernels a trip
// in 2D scan-to-scan and ~220 in Slam2D's lifted frame, with cuBLAS's
// covariance gemm and RF among them.
//
// Design:
//  - The batch is on the grid's y axis (B >= 1; B = 1 is the unbatched
//    loop). Each element has its own partial slab, its own ticket and its
//    own stats row; elements never meet.
//  - Launch 1 sums the 2D + 3 row terms of each element; the last block
//    of an element (gn_rows.cuh's grid reduction: fixed shuffle tree, warp
//    order and block order, the ticket reset by its wrap) writes them to
//    the element's stats row.
//  - Launch 2 reads the means from the stats row (every thread divides the
//    same floats alike) and sums the D² centred terms, the reference's
//    centred form, not raw moments minus mu_d mu_sᵀ; its last block writes
//    them beside the first pass's sums, then one thread runs the scalar
//    step in __noinline__ code: the rigid fit of rigid_fit.cuh (RF's own
//    code, float64), se3_scalar.cuh's or se2_scalar.cuh's exp and log.
//  - A frozen element is read by every block of both launches first: then
//    nothing is summed or written and no ticket is taken.
//  - No float atomics and no host read: for a given grid a launch is
//    bit-reproducible, and a CUDA graph can hold both launches.
//  - The scratch (partials, tickets, stats rows) belongs to the wrapper's
//    device cache and is never freed, since a captured graph keeps its
//    pointers.

#include <cuda_runtime.h>
#include <math.h>

#include "gn_rows.cuh"
#include "rigid_fit.cuh"
#include "se2_scalar.cuh"
#include "se3_scalar.cuh"

// Mirrors kernels/p2p_step.py::_Params field by field.
struct P2PParams {
  int min_inliers;  // already max(min_inliers, D + 1)
  int max_iters;    // the unrolled loop's freeze
  int it;           // Anderson's arm: the trip's `it`, or -1 to read iters
  int unrolled;     // freeze on converged | iters >= max_iters
  int anderson;
  int trust;        // max_total_trans > 0 or max_total_rot > 0
  float huber, step_scale, max_total_trans, max_total_rot, tol, tol_update;
};

// The carried state, loop._init_state's order, each field (B, ...) in
// place.
struct P2PState {
  float* T;     // (B, D+1, D+1)
  float* rmse;  // (B,) prev_rmse in, rmse out
  int* n_inl;
  bool* conv;
  float* f;     // (B, K) Anderson's f_prev, K = 3 (2D) or 6 (3D)
  float* g;     // (B, K) Anderson's g_prev
  int* iters;
};

namespace {

constexpr int kThreads = gn_rows::kThreads;
constexpr int kStats = 20;  // an element's stats row: 2D + 3, then D²

template <int D>
struct Lie;

template <>
struct Lie<3> {
  static constexpr int K = 6;
  __device__ static void exp(const float* xi, float T[4][4]) {
    se3t::exp(xi, T);
  }
  __device__ static void log(const float T[4][4], float* xi) {
    se3t::log(T, xi);
  }
  __device__ static void mul(const float A[4][4], const float B[4][4],
                             float C[4][4]) {
    se3t::mul4(A, B, C);
  }
};

template <>
struct Lie<2> {
  static constexpr int K = 3;
  __device__ static void exp(const float* xi, float T[3][3]) {
    se2t::exp(xi, T);
  }
  __device__ static void log(const float T[3][3], float* xi) {
    se2t::log(T, xi);
  }
  __device__ static void mul(const float A[3][3], const float B[3][3],
                             float C[3][3]) {
    se2t::mul3(A, B, C);
  }
};

__device__ inline bool frozen(const P2PParams& p, const P2PState& st,
                              int b) {
  return st.conv[b] || (p.unrolled && st.iters[b] >= p.max_iters);
}

// loop.huber(gate·mask, d2) as K2S computes it (delta / dist as
// reciprocal(dist)·delta), NaN kept as torch.clamp keeps it.
__device__ __forceinline__ float weight(float gate, float mask, float dd,
                                        float huber) {
  float w = gate * mask;
  if (huber > 0.f) {
    const float dist = sqrtf(dd < 1e-20f ? 1e-20f : dd);
    const float r = (1.f / dist) * huber;
    w = w * (r > 1.f ? 1.f : r);
  }
  return w;
}

template <int D>
__device__ inline float norm(const float* v) {
  float s = 0.f;
#pragma unroll
  for (int a = 0; a < D; ++a) s += v[a] * v[a];
  return sqrtf(s);
}

template <int E>
__device__ inline void load(const float* src, float T[E][E]) {
#pragma unroll
  for (int i = 0; i < E; ++i)
#pragma unroll
    for (int j = 0; j < E; ++j) T[i][j] = src[E * i + j];
}

// Launch 1: per element, Σw, Σw·cur, Σw·q, Σw·d², the inlier count.
template <int D>
__global__ void __launch_bounds__(kThreads)
p2p_sums_kernel(const float* __restrict__ cur, const float* __restrict__ q,
                const float* __restrict__ gate, const float* __restrict__ d2,
                const float* __restrict__ mask, int m, P2PParams prm,
                P2PState st, float* __restrict__ partial,
                unsigned* __restrict__ ticket, float* __restrict__ stats) {
  constexpr int S = 2 * D + 3;
  const int b = blockIdx.y;
  if (frozen(prm, st, b)) return;
  cur += (size_t)D * m * b;
  q += (size_t)D * m * b;
  gate += (size_t)m * b;
  d2 += (size_t)m * b;
  partial += (size_t)gridDim.x * S * b;
  float acc[S];
#pragma unroll
  for (int k = 0; k < S; ++k) acc[k] = 0.f;
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < m;
       i += gridDim.x * kThreads) {
    const float dd = d2[i];
    const float w = weight(gate[i], mask[i], dd, prm.huber);
    acc[0] += w;
#pragma unroll
    for (int k = 0; k < D; ++k) {
      acc[1 + k] += w * cur[D * i + k];
      acc[1 + D + k] += w * q[D * i + k];
    }
    acc[1 + 2 * D] += w * dd;
    acc[2 + 2 * D] += w > 0.f ? 1.f : 0.f;
  }
  __shared__ float sums[S];
  if (!gn_rows::grid_sum<S>(acc, partial, ticket + b, sums)) return;
  if (threadIdx.x < S) stats[kStats * b + threadIdx.x] = sums[threadIdx.x];
}

// The scalar step of one element from its stats row (launch 1's sums,
// then the D² centred sums), in gn_step_ref's order; writes the state.
template <int D>
__device__ __noinline__ void scalar_step(const float* sm,
                                         const P2PParams& p,
                                         const P2PState& st, int b,
                                         const float* T0_, const float* T0i_,
                                         bool armed) {
  constexpr int E = D + 1;
  constexpr int K = Lie<D>::K;
  using L = Lie<D>;
  float T[E][E];
  load<E>(st.T + E * E * b, T);
  const float wsum_raw = sm[0];
  const float wsum = wsum_raw < 1e-12f ? 1e-12f : wsum_raw;
  const float* cs = sm + 2 * D + 3;
  // umeyama_masked: mu = Σw·x / wsum, cov = Σ w xd xsᵀ / wsum, float32;
  // then rigid_from_stats in float64 (RF's code)
  double c[D * D], ms[D], md[D];
  bool finite = true;
#pragma unroll
  for (int i = 0; i < D * D; ++i) {
    const float v = cs[i] / wsum;
    c[i] = v;
    finite = finite && isfinite(v);
  }
#pragma unroll
  for (int k = 0; k < D; ++k) {
    const float a = sm[1 + k] / wsum, e = sm[1 + D + k] / wsum;
    ms[k] = a;
    md[k] = e;
    finite = finite && isfinite(a) && isfinite(e);
  }
  float dT[E][E];
  rigid::transform<D>(c, ms, md, finite, &dT[0][0]);
  if (p.step_scale != 1.f) {  // over-relaxation, exp(s·log dT)
    float xl[K];
    L::log(dT, xl);
#pragma unroll
    for (int a = 0; a < K; ++a) xl[a] = p.step_scale * xl[a];
    L::exp(xl, dT);
  }
  const int n_inl = (int)sm[2 + 2 * D];
  if (n_inl < p.min_inliers) {  // hold the pose
#pragma unroll
    for (int i = 0; i < E; ++i)
#pragma unroll
      for (int j = 0; j < E; ++j) dT[i][j] = i == j ? 1.f : 0.f;
  }
  float Tn[E][E];
  L::mul(dT, T, Tn);

  float f_new[K], g_new[K];
  if (p.anderson) {
    // AA(1) on twists: x = log T, g = log(dT T), f = g - x,
    // x+ = g - γ (g - g_prev), γ = fᵀ(f - f_prev)/|f - f_prev|² in [-1, 1];
    // the plain step on the first iteration or when |f| grew
    float x[K], f_prev[K], g_prev[K];
    L::log(T, x);
    L::log(Tn, g_new);
    float denom = 0.f, num = 0.f, nf = 0.f, nfp = 0.f;
#pragma unroll
    for (int a = 0; a < K; ++a) {
      f_prev[a] = st.f[K * b + a];
      g_prev[a] = st.g[K * b + a];
      f_new[a] = g_new[a] - x[a];
      const float df = f_new[a] - f_prev[a];
      denom += df * df;
      num += f_new[a] * df;
      nf += f_new[a] * f_new[a];
      nfp += f_prev[a] * f_prev[a];
    }
    float gamma = denom > 1e-20f ? num / (denom < 1e-20f ? 1e-20f : denom)
                                 : 0.f;
    gamma = fminf(fmaxf(gamma, -1.f), 1.f);
    if (armed && sqrtf(nf) <= sqrtf(nfp)) {
      float xa[K];
#pragma unroll
      for (int a = 0; a < K; ++a)
        xa[a] = g_new[a] - gamma * (g_new[a] - g_prev[a]);
      L::exp(xa, Tn);
    }
  }
  if (p.trust) {
    // project the total correction log(T T0⁻¹) onto the ball around T0
    float T0i[E][E], X[E][E], xt[K];
    load<E>(T0i_ + E * E * b, T0i);
    L::mul(Tn, T0i, X);
    L::log(X, xt);
    float s = 1.f;
    if (p.max_total_trans > 0.f) {
      const float tn = norm<D>(xt);
      s = fminf(s, p.max_total_trans / (tn < 1e-12f ? 1e-12f : tn));
    }
    if (p.max_total_rot > 0.f) {
      const float rn = norm<K - D>(xt + D);
      s = fminf(s, p.max_total_rot / (rn < 1e-12f ? 1e-12f : rn));
    }
    if (s < 1.f) {
      float T0[E][E], Ex[E][E];
      load<E>(T0_ + E * E * b, T0);
#pragma unroll
      for (int a = 0; a < K; ++a) xt[a] = s * xt[a];
      L::exp(xt, Ex);
      L::mul(Ex, T0, Tn);
    }
  }
  const float rmse = sqrtf(sm[1 + 2 * D] / wsum);
  bool conv = fabsf(st.rmse[b] - rmse) < p.tol;
  if (p.tol_update > 0.f) {
    // |dT's translation| + |dT's rotation - I|_F
    float rf = 0.f, tv[D];
#pragma unroll
    for (int i = 0; i < D; ++i) {
      tv[i] = dT[i][D];
#pragma unroll
      for (int j = 0; j < D; ++j) {
        const float e = dT[i][j] - (i == j ? 1.f : 0.f);
        rf += e * e;
      }
    }
    conv = conv || (norm<D>(tv) + sqrtf(rf) < p.tol_update);
  }
#pragma unroll
  for (int i = 0; i < E; ++i)
#pragma unroll
    for (int j = 0; j < E; ++j) st.T[E * E * b + E * i + j] = Tn[i][j];
  st.rmse[b] = rmse;
  st.n_inl[b] = n_inl;
  st.conv[b] = conv;
  if (p.anderson)
#pragma unroll
    for (int a = 0; a < K; ++a) {
      st.f[K * b + a] = f_new[a];
      st.g[K * b + a] = g_new[a];
    }
  st.iters[b] = st.iters[b] + 1;
}

// Launch 2: per element, the centred cross-covariance about launch 1's
// means, then the scalar step on the last block.
template <int D>
__global__ void __launch_bounds__(kThreads)
p2p_cov_kernel(const float* __restrict__ cur, const float* __restrict__ q,
               const float* __restrict__ gate, const float* __restrict__ d2,
               const float* __restrict__ mask, int m, P2PParams prm,
               P2PState st, const float* __restrict__ T0,
               const float* __restrict__ T0_inv, float* __restrict__ partial,
               unsigned* __restrict__ ticket, float* __restrict__ stats) {
  constexpr int S = D * D;
  const int b = blockIdx.y;
  const int iters0 = st.iters[b];
  if (frozen(prm, st, b)) return;
  cur += (size_t)D * m * b;
  q += (size_t)D * m * b;
  gate += (size_t)m * b;
  d2 += (size_t)m * b;
  partial += (size_t)gridDim.x * S * b;
  float* sm = stats + kStats * b;
  float mu_s[D], mu_d[D];
  {
    const float ws = sm[0] < 1e-12f ? 1e-12f : sm[0];
#pragma unroll
    for (int k = 0; k < D; ++k) {
      mu_s[k] = sm[1 + k] / ws;
      mu_d[k] = sm[1 + D + k] / ws;
    }
  }
  float acc[S];
#pragma unroll
  for (int k = 0; k < S; ++k) acc[k] = 0.f;
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < m;
       i += gridDim.x * kThreads) {
    const float w = weight(gate[i], mask[i], d2[i], prm.huber);
    float xs[D], xd[D];
#pragma unroll
    for (int k = 0; k < D; ++k) {
      xs[k] = (cur[D * i + k] - mu_s[k]) * w;
      xd[k] = q[D * i + k] - mu_d[k];
    }
#pragma unroll
    for (int r = 0; r < D; ++r)
#pragma unroll
      for (int c = 0; c < D; ++c) acc[D * r + c] += xd[r] * xs[c];
  }
  __shared__ float sums[S];
  if (!gn_rows::grid_sum<S>(acc, partial, ticket + b, sums)) return;
  if (threadIdx.x < S) sm[2 * D + 3 + threadIdx.x] = sums[threadIdx.x];
  __syncthreads();
  if (threadIdx.x == 0)
    scalar_step<D>(sm, prm, st, b, T0, T0_inv,
                   prm.it < 0 ? iters0 > 0 : prm.it > 0);
}

template <int D>
cudaError_t launch(const float* cur, const float* q, const float* gate,
                   const float* d2, const float* mask, int m, int batch,
                   const P2PParams& prm, const P2PState& st, const float* T0,
                   const float* T0_inv, int n_blocks, float* partial,
                   unsigned* ticket, float* stats, cudaStream_t stream) {
  const dim3 grid(n_blocks, batch);
  p2p_sums_kernel<D><<<grid, kThreads, 0, stream>>>(
      cur, q, gate, d2, mask, m, prm, st, partial, ticket, stats);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  p2p_cov_kernel<D><<<grid, kThreads, 0, stream>>>(
      cur, q, gate, d2, mask, m, prm, st, T0, T0_inv, partial, ticket,
      stats);
  return cudaGetLastError();
}

}  // namespace

// cur, q (batch, m, d) and gate, d2 (batch, m) float32 contiguous, mask
// (m,) float32 shared by the batch, d = 2 or 3; the state's seven fields
// on the device, each with a leading (batch,) (T (d+1, d+1), rmse, f and g
// (3 or 6) float32, n_inl and iters int32, conv bool); T0 and T0_inv
// (batch, d+1, d+1), read with a trust region (else may be null); scratch
// partial (batch, n_blocks, 9) float32, ticket (batch unsigned, 0 before
// the first call and left at 0 by every call) and stats (batch, 20)
// float32, each unfrozen element's sums, handed from launch 1 to launch 2.
extern "C" cudaError_t p2p_step_f32(const float* cur, const float* q,
                                    const float* gate, const float* d2,
                                    const float* mask, int m, int d,
                                    int batch, const P2PParams* params,
                                    const P2PState* state, const float* T0,
                                    const float* T0_inv, int n_blocks,
                                    float* partial, unsigned* ticket,
                                    float* stats, cudaStream_t stream) {
  if (m <= 0 || n_blocks <= 0 || batch <= 0 || batch > 65535 ||
      (d != 2 && d != 3))
    return cudaErrorInvalidValue;
  if (d == 2)
    return launch<2>(cur, q, gate, d2, mask, m, batch, *params, *state, T0,
                     T0_inv, n_blocks, partial, ticket, stats, stream);
  return launch<3>(cur, q, gate, d2, mask, m, batch, *params, *state, T0,
                   T0_inv, n_blocks, partial, ticket, stats, stream);
}
