// Scalar SE(2) helpers for one thread: K2P's scalar step in 2D
// (p2p_step.cu), the counterpart of se3_scalar.cuh's `se3t`.
//
// The functions follow core/se2.py (the port's torch SE(2), itself the
// reference's tpu_icp_slam/core/se2.py) operation for operation: twists
// are [rho_x, rho_y, phi], V = [[a, -b], [b, a]] with a = sin(phi)/phi and
// b = (1 - cos(phi))/phi, and the Taylor branch below |phi| = 1e-5.
#pragma once

#include <math.h>

namespace se2t {

// C = A·B of 3x3 row-major matrices.
__device__ inline void mul3(const float A[3][3], const float B[3][3],
                            float C[3][3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      C[i][j] = A[i][0] * B[0][j] + A[i][1] * B[1][j] + A[i][2] * B[2][j];
}

__device__ inline void eye3(float T[3][3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) T[i][j] = i == j ? 1.f : 0.f;
}

// se2._v_coeffs: (a, b) of the left Jacobian.
__device__ inline void v_coeffs(float phi, float* a, float* b) {
  const bool small = fabsf(phi) < 1e-5f;
  *a = small ? 1.f - phi * phi / 6.f : sinf(phi) / phi;
  *b = small ? phi / 2.f : (1.f - cosf(phi)) / phi;
}

// se2.exp: xi = [rho, phi] -> T (3x3).
__device__ inline void exp(const float xi[3], float T[3][3]) {
  const float phi = xi[2];
  const float c = cosf(phi), s = sinf(phi);
  float a, b;
  v_coeffs(phi, &a, &b);
  T[0][0] = c;
  T[0][1] = -s;
  T[0][2] = a * xi[0] - b * xi[1];
  T[1][0] = s;
  T[1][1] = c;
  T[1][2] = b * xi[0] + a * xi[1];
  T[2][0] = T[2][1] = 0.f;
  T[2][2] = 1.f;
}

// se2.log: T -> xi = [V⁻¹ t, atan2(T10, T00)].
__device__ inline void log(const float T[3][3], float xi[3]) {
  const float phi = atan2f(T[1][0], T[0][0]);
  float a, b;
  v_coeffs(phi, &a, &b);
  const float det = a * a + b * b;
  xi[0] = (a * T[0][2] + b * T[1][2]) / det;
  xi[1] = (-b * T[0][2] + a * T[1][2]) / det;
  xi[2] = phi;
}

}  // namespace se2t
