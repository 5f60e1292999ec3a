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
// Design:
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

namespace {

constexpr int kThreads = 128;
constexpr int kSweeps = 8;

__device__ __forceinline__ double dot3(const double* a, const double* b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

__device__ __forceinline__ void cross3(const double* a, const double* b,
                                       double* c) {
  c[0] = a[1] * b[2] - a[2] * b[1];
  c[1] = a[2] * b[0] - a[0] * b[2];
  c[2] = a[0] * b[1] - a[1] * b[0];
}

__device__ __forceinline__ void scale3(double* a, double s) {
  a[0] *= s;
  a[1] *= s;
  a[2] *= s;
}

// u := u - (u·e) e, then |u|; e a unit vector
__device__ __forceinline__ double reject3(double* u, const double* e) {
  const double k = dot3(u, e);
  u[0] -= k * e[0];
  u[1] -= k * e[1];
  u[2] -= k * e[2];
  return sqrt(dot3(u, u));
}

__device__ void rotation2(const double* c, double* R) {
  const double th = atan2(c[2] - c[1], c[0] + c[3]);
  double s, co;
  sincos(th, &s, &co);
  R[0] = co;
  R[1] = -s;
  R[2] = s;
  R[3] = co;
}

// one Jacobi rotation zeroing A[p][q] of the symmetric A, accumulated in V
__device__ __forceinline__ void jacobi_pair(double (*A)[3], double (*V)[3],
                                            int p, int q) {
  const double apq = A[p][q];
  if (apq == 0.0) return;
  const double theta = (A[q][q] - A[p][p]) / (2.0 * apq);
  const double t =
      (theta >= 0.0 ? 1.0 : -1.0) / (fabs(theta) + hypot(theta, 1.0));
  const double c = 1.0 / sqrt(t * t + 1.0), s = t * c;
#pragma unroll
  for (int k = 0; k < 3; ++k) {  // A P
    const double akp = A[k][p], akq = A[k][q];
    A[k][p] = c * akp - s * akq;
    A[k][q] = s * akp + c * akq;
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) {  // Pᵀ (A P)
    const double apk = A[p][k], aqk = A[q][k];
    A[p][k] = c * apk - s * aqk;
    A[q][k] = s * apk + c * aqk;
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) {  // V P
    const double vkp = V[k][p], vkq = V[k][q];
    V[k][p] = c * vkp - s * vkq;
    V[k][q] = s * vkp + c * vkq;
  }
}

__device__ void rotation3(const double* c, double* R) {
  double A[3][3], V[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      A[i][j] = c[i] * c[j] + c[3 + i] * c[3 + j] + c[6 + i] * c[6 + j];
      V[i][j] = i == j ? 1.0 : 0.0;
    }
  }
  for (int sweep = 0; sweep < kSweeps; ++sweep) {
    jacobi_pair(A, V, 0, 1);
    jacobi_pair(A, V, 0, 2);
    jacobi_pair(A, V, 1, 2);
  }
  // the two largest eigenvalues' vectors, first on ties
  int i1 = 0;
  if (A[1][1] > A[i1][i1]) i1 = 1;
  if (A[2][2] > A[i1][i1]) i1 = 2;
  const int j = i1 == 0 ? 1 : 0, k = i1 == 2 ? 1 : 2;
  const int i2 = A[k][k] > A[j][j] ? k : j;
  double v1[3], v2[3], v3[3], u1[3], u2[3], u3[3];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    v1[r] = V[r][i1];
    v2[r] = V[r][i2];
  }
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    u1[r] = c[3 * r] * v1[0] + c[3 * r + 1] * v1[1] + c[3 * r + 2] * v1[2];
    u2[r] = c[3 * r] * v2[0] + c[3 * r + 1] * v2[1] + c[3 * r + 2] * v2[2];
  }
  const double s1 = sqrt(dot3(u1, u1));
  if (s1 > 0.0) {
    scale3(u1, 1.0 / s1);
  } else {
#pragma unroll
    for (int r = 0; r < 3; ++r) u1[r] = v1[r];
  }
  double s2 = reject3(u2, u1);
  if (!(s2 > 1e-12 * s1)) {  // rank <= 1: any unit vector beside u1
#pragma unroll
    for (int r = 0; r < 3; ++r) u2[r] = v2[r];
    s2 = reject3(u2, u1);
    if (!(s2 > 1e-6)) {
      const double ax = fabs(u1[0]), ay = fabs(u1[1]), az = fabs(u1[2]);
      const int a = (ax <= ay && ax <= az) ? 0 : (ay <= az ? 1 : 2);
      u2[0] = u2[1] = u2[2] = 0.0;
      u2[a] = 1.0;
      s2 = reject3(u2, u1);
    }
  }
  scale3(u2, 1.0 / s2);
  cross3(u1, u2, u3);
  cross3(v1, v2, v3);
#pragma unroll
  for (int r = 0; r < 3; ++r) {
#pragma unroll
    for (int q = 0; q < 3; ++q)
      R[3 * r + q] = u1[r] * v1[q] + u2[r] * v2[q] + u3[r] * v3[q];
  }
}

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
  double c[D * D], ms[D], md[D], R[D * D];
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
  if constexpr (D == 2)
    rotation2(c, R);
  else
    rotation3(c, R);
  const float nan = __int_as_float(0x7fc00000);
#pragma unroll
  for (int r = 0; r < D; ++r) {
    double t = md[r];
#pragma unroll
    for (int q = 0; q < D; ++q) t -= R[D * r + q] * ms[q];
#pragma unroll
    for (int q = 0; q < D; ++q)
      T[(D + 1) * r + q] = finite ? (float)R[D * r + q] : nan;
    T[(D + 1) * r + D] = finite ? (float)t : nan;
  }
#pragma unroll
  for (int q = 0; q < D; ++q) T[(D + 1) * D + q] = 0.f;
  T[(D + 1) * (D + 1) - 1] = 1.f;
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
