// RF: the rigid fit of a point-to-point ICP step, batched, float32 in and
// out with float64 arithmetic inside, for sm_90a.
//
// Replaces jnp.linalg.svd in tpu_icp_slam/icp/point_to_point.py:33, the SVD
// of rigid_from_stats (:25-44). That is an XLA op, not a Pallas kernel. Its
// torch counterpart, torch.linalg.svd, checks LAPACK's info on the host: on
// CUDA a device-to-host sync in every point-to-point iteration, which also
// keeps the iteration out of a CUDA graph. RF computes the same function
// with no host read: per batch element, cov (D, D) = E_w[(dst - mu_d)
// (src - mu_s)ᵀ], mu_s (D) and mu_d (D) give T (D+1, D+1) with
// R = U diag(1, .., 1, sign det(U Vᵀ)) Vᵀ and t = mu_d - R mu_s.
//
// What bounds it on an H100: launch latency. An element reads 60 bytes and
// writes 64 (D = 3) and does a few hundred float64 operations; the
// verification batches are B = 8-32 elements. One launch, one thread an
// element, the caller's stream.
//
// Design (the rotation code lives in rigid_fit.cuh, shared with K2P):
//  - D = 2: the closed form. R(θ) maximises tr(R covᵀ) = cos θ (c00 + c11)
//    + sin θ (c10 - c01), so θ = atan2(c10 - c01, c00 + c11): what the SVD
//    with the reflection correction gives, always a proper rotation, and
//    the identity for cov = 0 (atan2(0, 0) = 0), as the SVD of zero gives.
//  - D = 3: cyclic Jacobi on A = covᵀ cov in float64 (a fixed kSweeps
//    sweeps of the three pairs; a 3x3 reaches float64's off-diagonal floor
//    in four or five), eigenvalues σ² sorted down with their vectors
//    v1, v2. Then u1 = cov v1 / |cov v1|, u2 = cov v2 with its u1 part
//    removed, normalised, and the third pair as cross products: u3 = u1 x
//    u2, v3 = v1 x v2. R = u1 v1ᵀ + u2 v2ᵀ + u3 v3ᵀ is U diag(1, 1, s) Vᵀ
//    with the correction on the pair of the smallest singular value, as the
//    reference applies it, and it is proper by construction. Squaring cov
//    costs nothing here: float64 resolves σ3/σ1 down to ~1e-8, below
//    float32's noise in cov.
//  - Rank D-1 (config 2 lifts its scans to z = 0, so cov's third row and
//    column are zero): u3 and v3 come from cross products, never from a
//    division by σ3 ≈ 0, so the kernel returns Umeyama's unique rotation.
//  - Rank <= D-2 (collinear inliers): the answer is not unique (the
//    reference's depends on LAPACK). When cov v2 has no part left beside u1
//    (|.| <= 1e-12 σ1), u2 is v2 or, failing that, the axis least aligned
//    with u1, made orthogonal to u1: a finite proper rotation. cov = 0
//    leaves A diagonal, V = I and u_i = v_i: the identity.
//  - A non-finite input gives a NaN rotation and translation, never a
//    silent identity.

#include <cuda_runtime.h>

#include "rigid_fit.cuh"

namespace {

constexpr int kThreads = 128;

template <int D>
__global__ void __launch_bounds__(kThreads)
rigid_fit_kernel(const float* __restrict__ cov, const float* __restrict__ mu_s,
                 const float* __restrict__ mu_d, int batch,
                 float* __restrict__ T) {
  const int b = blockIdx.x * kThreads + threadIdx.x;
  if (b >= batch) return;
  cov += (size_t)D * D * b;
  mu_s += (size_t)D * b;
  mu_d += (size_t)D * b;
  T += (size_t)(D + 1) * (D + 1) * b;
  double c[D * D], ms[D], md[D];
  bool finite = true;
#pragma unroll
  for (int i = 0; i < D * D; ++i) {
    c[i] = cov[i];
    finite &= isfinite(cov[i]);
  }
#pragma unroll
  for (int i = 0; i < D; ++i) {
    ms[i] = mu_s[i];
    md[i] = mu_d[i];
    finite &= isfinite(mu_s[i]) && isfinite(mu_d[i]);
  }
  rigid::transform<D>(c, ms, md, finite, T);
}

}  // namespace

// cov (batch, d, d), mu_s (batch, d), mu_d (batch, d) float32 contiguous,
// d = 2 or 3 -> T (batch, d+1, d+1) float32. batch = 0 launches nothing.
extern "C" cudaError_t rigid_fit_f32(const float* cov, const float* mu_s,
                                     const float* mu_d, int batch, int d,
                                     float* T, cudaStream_t stream) {
  if (batch < 0 || (d != 2 && d != 3)) return cudaErrorInvalidValue;
  if (batch == 0) return cudaSuccess;
  const int grid = (batch + kThreads - 1) / kThreads;
  if (d == 2)
    rigid_fit_kernel<2><<<grid, kThreads, 0, stream>>>(cov, mu_s, mu_d, batch,
                                                       T);
  else
    rigid_fit_kernel<3><<<grid, kThreads, 0, stream>>>(cov, mu_s, mu_d, batch,
                                                       T);
  return cudaGetLastError();
}
