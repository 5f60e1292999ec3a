// The rigid fit of a point-to-point ICP step on one thread, float64: the
// rotation of the weighted Umeyama problem from its D x D cross-covariance
// (RF, rigid_fit.cu, one thread an element; K2P, p2p_step.cu, in its
// scalar tail). rigid_fit.cu's header comment gives the method: D = 2 in
// closed form, D = 3 by cyclic Jacobi on covᵀ cov, the reflection
// correction on the smallest singular value's pair, and a proper rotation
// at rank D-1 and below.
#pragma once

#include <math.h>

namespace rigid {

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

__device__ inline void rotation2(const double* c, double* R) {
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

__device__ inline void rotation3(const double* c, double* R) {
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


// T (D+1, D+1), row-major float: R from cov (D x D, row-major, float64),
// t = mu_d - R mu_s in float64, each rounded once; NaN in every entry of R
// and t where `finite` is false (a non-finite input).
template <int D>
__device__ inline void transform(const double* c, const double* ms,
                                 const double* md, bool finite, float* T) {
  double R[D * D];
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

}  // namespace rigid
