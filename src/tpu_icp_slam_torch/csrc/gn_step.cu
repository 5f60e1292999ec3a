// K2S: one point-to-plane ICP iteration after the correspondence, float32,
// for sm_90a: the step of icp/loop.py::_body (3D, "point_to_plane") in one
// launch.
//
// Replaces the tail of the reference's compiled iteration,
// tpu_icp_slam/icp/loop.py:150-235 (the body of the lax.while_loop at
// :301): K2's pallas_call (gn_pallas.py:97, through point_to_plane.py:
// 136-138) and the small XLA ops that the compiler fuses around it. From
// the correspondence (cur, q, n, gate, d2) and the source's float mask it
// does, per row, the Huber weight w = huber(gate·mask, d2), the inlier
// count and the Gauss-Newton sums; then, once, the motion prior, the
// damped 6x6 Cholesky with its non-PD / non-finite guard, the step clamps,
// exp, over-relaxation as exp(s·log dT), the min_inliers hold, T ← dT·T,
// AA(1) (icp.anderson), the total-correction trust region, the rmse and
// the convergence test; and it writes the carried state
// (loop._init_state's seven fields) in place, frozen as
// loop._batched_trip freezes it (converged), or as the unrolled loop does
// (converged or iters >= max_iters), and counts the iteration.
//
// What bounds it on an H100: its bytes. The main path's M = 16,384 rows
// read 0.39 MB (cur, q, n, gate, d2, mask: 0.12 us at 3.35 TB/s), the
// RGB-D path's 307,200 rows 7.4 MB (2.2 us); ~70 flops a row. The torch
// tail it replaces was ~600 launches a trip on the scan-to-map frame.
//
// Design:
//  - The rows are K2's (gn_rows.cuh): the same row partition, shuffle tree,
//    warp order and block order, so H and g are K2's bit for bit on the
//    same weights. Three more sums ride along: Σw, Σw·d² and the inlier
//    count (exact in float32 below 2^24 rows), 30 in all, as in K5.
//  - The last block by ticket (K2's pattern) sums the partials in block
//    order and writes H and g to `hg` (42 floats, for tests); then one
//    thread does the scalar step in __noinline__ code, so that its
//    registers do not weigh on the row loop. Its SE(3) math is core/se3.py's
//    (se3_scalar.cuh's se3t), not K5's polynomial arccos.
//  - A frozen state is read by every block first: then nothing is summed
//    or written and no ticket is taken.
//  - No float atomics: a launch is bit-reproducible for a given grid.
//  - The scratch (a (30,) partial a block and the ticket) belongs to the
//    wrapper's device cache and is never freed, since a CUDA graph that
//    captured a launch keeps its pointers.

#include <cuda_runtime.h>
#include <math.h>

#include "gn_rows.cuh"
#include "se3_scalar.cuh"

// Mirrors kernels/gn_step.py::_Params field by field.
struct StepParams {
  int min_inliers;  // already max(min_inliers, 4)
  int max_iters;    // the unrolled loop's freeze
  int it;           // Anderson's arm: the trip's `it`, or -1 to read iters
  int unrolled;     // freeze on converged | iters >= max_iters
  int anderson;
  int has_prior;
  int trust;        // max_total_trans > 0 or max_total_rot > 0
  float huber, damping, step_scale, max_step_trans, max_step_rot;
  float max_total_trans, max_total_rot, tol, tol_update;
};

// The carried state, loop._init_state's order, each field in place.
struct StepState {
  float* T;        // (4, 4)
  float* rmse;     // prev_rmse in, rmse out
  int* n_inl;
  bool* conv;
  float* f;        // (6,) Anderson's f_prev
  float* g;        // (6,) Anderson's g_prev
  int* iters;
};

namespace {

constexpr int kThreads = gn_rows::kThreads;
constexpr int kSums = gn_rows::kTerms + 3;  // + Σw, Σw·d², inliers

__device__ inline float norm3(const float* v) {
  return sqrtf(v[0] * v[0] + v[1] * v[1] + v[2] * v[2]);
}

// xi scaled so that |xi[0:3]| <= max_trans and |xi[3:6]| <= max_rot
// (solve_increment's clamps, translation first, each scaling the whole
// step; a bound of 0 is off).
__device__ inline void clamp_step(float xi[6], float max_trans,
                                  float max_rot) {
  if (max_trans > 0.f) {
    const float tn = norm3(xi);
    float s = max_trans / (tn < 1e-12f ? 1e-12f : tn);
    s = s > 1.f ? 1.f : s;
    for (int a = 0; a < 6; ++a) xi[a] *= s;
  }
  if (max_rot > 0.f) {
    const float wn = norm3(xi + 3);
    float s = max_rot / (wn < 1e-12f ? 1e-12f : wn);
    s = s > 1.f ? 1.f : s;
    for (int a = 0; a < 6; ++a) xi[a] *= s;
  }
}

__device__ inline void load4(const float* src, float T[4][4]) {
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j) T[i][j] = src[4 * i + j];
}

// The scalar step of one iteration from the 30 sums, in _body's order;
// writes the state (not frozen: the caller checked).
__device__ __noinline__ void scalar_step(const float* sums,
                                         const StepParams& p,
                                         const StepState& st,
                                         const float* T0_, const float* T0i_,
                                         const float* prior_scale, bool armed) {
  float T[4][4];
  load4(st.T, T);
  float H[6][6], g[6];
  int k = 0;
  for (int a = 0; a < 6; ++a)
    for (int b = a; b < 6; ++b) {
      H[a][b] = sums[k];
      H[b][a] = sums[k];
      ++k;
    }
  for (int a = 0; a < 6; ++a) g[a] = sums[21 + a];
  const float wsum_raw = sums[27];
  const float wd2 = sums[28];
  const int n_inl = (int)sums[29];

  if (p.has_prior) {
    // H += diag(pw), g += pw·log(T T0⁻¹), pw = max(Σw, 1e-6)·scale
    float T0i[4][4], X[4][4], xp[6];
    load4(T0i_, T0i);
    se3t::mul4(T, T0i, X);
    se3t::log(X, xp);
    const float base = wsum_raw < 1e-6f ? 1e-6f : wsum_raw;
    for (int a = 0; a < 6; ++a) {
      const float pw = base * prior_scale[a];
      H[a][a] = H[a][a] + pw;
      g[a] = g[a] + pw * xp[a];
    }
  }
  // damping relative to the trace (on CUDA the diagonal's sum)
  float trace = 0.f;
  for (int a = 0; a < 6; ++a) trace += H[a][a];
  float tr6 = trace / 6.f;
  tr6 = tr6 < 1.f ? 1.f : tr6;
  const float lam = p.damping * tr6;
  for (int a = 0; a < 6; ++a) H[a][a] = H[a][a] + lam;
  float xi[6];
  se3s::chol6_solve(H, g, xi);
  bool finite = true;  // a failed Cholesky leaves NaN or inf: zero step
  for (int a = 0; a < 6; ++a) finite = finite && isfinite(xi[a]);
  for (int a = 0; a < 6; ++a) xi[a] = finite ? xi[a] : 0.f;
  clamp_step(xi, p.max_step_trans, p.max_step_rot);

  float dT[4][4];
  se3t::exp(xi, dT);
  if (p.step_scale != 1.f) {  // over-relaxation, exp(s·log dT)
    float xl[6];
    se3t::log(dT, xl);
    for (int a = 0; a < 6; ++a) xl[a] = p.step_scale * xl[a];
    se3t::exp(xl, dT);
  }
  if (n_inl < p.min_inliers) se3t::eye4(dT);  // hold the pose
  float Tn[4][4];
  se3t::mul4(dT, T, Tn);

  float f_new[6], g_new[6];
  if (p.anderson) {
    // AA(1) on twists: x = log T, g = log(dT T), f = g - x,
    // x+ = g - γ (g - g_prev), γ = fᵀ(f - f_prev)/|f - f_prev|² in [-1, 1];
    // the plain step on the first iteration or when |f| grew
    float x[6], f_prev[6], g_prev[6];
    se3t::log(T, x);
    se3t::log(Tn, g_new);
    float denom = 0.f, num = 0.f, nf = 0.f, nfp = 0.f;
    for (int a = 0; a < 6; ++a) {
      f_prev[a] = st.f[a];
      g_prev[a] = st.g[a];
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
      float xa[6];
      for (int a = 0; a < 6; ++a) xa[a] = g_new[a] - gamma * (g_new[a] - g_prev[a]);
      se3t::exp(xa, Tn);
    }
  }
  if (p.trust) {
    // project the total correction log(T T0⁻¹) onto the ball around T0
    float T0i[4][4], X[4][4], xt[6];
    load4(T0i_, T0i);
    se3t::mul4(Tn, T0i, X);
    se3t::log(X, xt);
    float s = 1.f;
    if (p.max_total_trans > 0.f) {
      const float tn = norm3(xt);
      s = fminf(s, p.max_total_trans / (tn < 1e-12f ? 1e-12f : tn));
    }
    if (p.max_total_rot > 0.f) {
      const float rn = norm3(xt + 3);
      s = fminf(s, p.max_total_rot / (rn < 1e-12f ? 1e-12f : rn));
    }
    if (s < 1.f) {
      float T0[4][4], E[4][4];
      load4(T0_, T0);
      for (int a = 0; a < 6; ++a) xt[a] = s * xt[a];
      se3t::exp(xt, E);
      se3t::mul4(E, T0, Tn);
    }
  }
  const float wsum = wsum_raw < 1e-12f ? 1e-12f : wsum_raw;
  const float rmse = sqrtf(wd2 / wsum);
  bool conv = fabsf(*st.rmse - rmse) < p.tol;
  if (p.tol_update > 0.f) {
    // |dT's translation| + |dT's rotation - I|_F
    float rf = 0.f;
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) {
        const float d = dT[i][j] - (i == j ? 1.f : 0.f);
        rf += d * d;
      }
    const float tv[3] = {dT[0][3], dT[1][3], dT[2][3]};
    conv = conv || (norm3(tv) + sqrtf(rf) < p.tol_update);
  }
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j) st.T[4 * i + j] = Tn[i][j];
  *st.rmse = rmse;
  *st.n_inl = n_inl;
  *st.conv = conv;
  if (p.anderson)
    for (int a = 0; a < 6; ++a) {
      st.f[a] = f_new[a];
      st.g[a] = g_new[a];
    }
  *st.iters = *st.iters + 1;
}

__global__ void __launch_bounds__(kThreads)
gn_step_kernel(const float* __restrict__ cur, const float* __restrict__ q,
               const float* __restrict__ nrm, const float* __restrict__ gate,
               const float* __restrict__ d2, const float* __restrict__ mask,
               int m, StepParams prm, StepState st,
               const float* __restrict__ T0, const float* __restrict__ T0_inv,
               const float* __restrict__ prior_scale,
               float* __restrict__ partial, unsigned* __restrict__ ticket,
               float* __restrict__ hg) {
  // a frozen state: every block leaves before it takes a ticket
  const int iters0 = *st.iters;
  if (*st.conv || (prm.unrolled && iters0 >= prm.max_iters)) return;

  float acc[kSums];
#pragma unroll
  for (int k = 0; k < kSums; ++k) acc[k] = 0.f;
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < m;
       i += gridDim.x * kThreads) {
    // gn_step.huber(gate·mask, d2) as torch computes it (delta / dist is
    // reciprocal(dist)·delta there), NaN kept as torch.clamp keeps it
    float wi = gate[i] * mask[i];
    const float dd = d2[i];
    if (prm.huber > 0.f) {
      const float dist = sqrtf(dd < 1e-20f ? 1e-20f : dd);
      const float r = (1.f / dist) * prm.huber;
      wi = wi * (r > 1.f ? 1.f : r);
    }
    gn_rows::add_row(cur, q, nrm, i, wi, acc);
    acc[27] += wi;
    acc[28] += wi * dd;
    acc[29] += wi > 0.f ? 1.f : 0.f;
  }
  __shared__ float sums[kSums];
  if (!gn_rows::grid_sum<kSums>(acc, partial, ticket, sums)) return;
  gn_rows::write_hg(sums, hg, hg + 36);
  if (threadIdx.x == 0)
    scalar_step(sums, prm, st, T0, T0_inv, prior_scale,
                prm.it < 0 ? iters0 > 0 : prm.it > 0);
}

}  // namespace

// cur, q, n (m, 3) and gate, d2, mask (m,) float32 contiguous; the state's
// seven fields on the device (T (4, 4), rmse, f and g (6,) float32, n_inl
// and iters int32, conv bool); T0 and T0_inv (4, 4) (T0_inv read with a
// prior or a trust region, T0 with a trust region; else may be null),
// prior_scale (6,) (with a prior); scratch partial (n_blocks, 30) and
// ticket (one unsigned, 0 before the first call and left at 0 by every
// call); hg (42,) float32 receives H and g (unless the state is frozen).
extern "C" cudaError_t gn_step_f32(const float* cur, const float* q,
                                   const float* n, const float* gate,
                                   const float* d2, const float* mask, int m,
                                   const StepParams* params,
                                   const StepState* state, const float* T0,
                                   const float* T0_inv,
                                   const float* prior_scale, int n_blocks,
                                   float* partial, unsigned* ticket,
                                   float* hg, cudaStream_t stream) {
  if (m <= 0 || n_blocks <= 0) return cudaErrorInvalidValue;
  gn_step_kernel<<<n_blocks, kThreads, 0, stream>>>(
      cur, q, n, gate, d2, mask, m, *params, *state, T0, T0_inv, prior_scale,
      partial, ticket, hg);
  return cudaGetLastError();
}
