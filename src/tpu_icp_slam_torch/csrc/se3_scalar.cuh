// Scalar 6x6 and SE(3) device helpers for one thread: the scalar steps of
// K5 (icp_fused.cu) and K2S (gn_step.cu).
//
// hat2 and chol6_solve are shared by both kernels. The functions of
// `se3t` follow core/se3.py (the port's torch SE(3), itself the
// reference's tpu_icp_slam/core/se3.py) operation for operation: arccos
// with the small-angle (theta < 1e-4) and near-pi branches in so3_log, the
// D coefficient of log's V⁻¹, and exp's Taylor branch below theta² = 1e-8.
// They define K2S's numbers; K5 keeps its own polynomial arccos and its
// recentred-frame correction (icp_fused.cu), which define the fused path's.
#pragma once

#include <math.h>

namespace se3s {

// W = hat(w) and W² = W·W.
__device__ inline void hat2(const float w[3], float W[3][3], float W2[3][3]) {
  W[0][0] = 0.f;   W[0][1] = -w[2]; W[0][2] = w[1];
  W[1][0] = w[2];  W[1][1] = 0.f;   W[1][2] = -w[0];
  W[2][0] = -w[1]; W[2][1] = w[0];  W[2][2] = 0.f;
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      W2[i][j] = W[i][0] * W[0][j] + W[i][1] * W[1][j] + W[i][2] * W[2][j];
}

// Unrolled 6x6 Cholesky solve of h·xi = -g; a non-positive pivot gives NaN,
// which the caller's finite check turns into a zero step.
__device__ inline void chol6_solve(const float h[6][6], const float g[6],
                                   float xi[6]) {
  float L[6][6] = {};
  for (int j = 0; j < 6; ++j) {
    float s = h[j][j];
    for (int k = 0; k < j; ++k) s -= L[j][k] * L[j][k];
    L[j][j] = sqrtf(s);
    const float inv = 1.f / L[j][j];
    for (int i = j + 1; i < 6; ++i) {
      float v = h[i][j];
      for (int k = 0; k < j; ++k) v -= L[i][k] * L[j][k];
      L[i][j] = v * inv;
    }
  }
  float y[6];
  for (int i = 0; i < 6; ++i) {
    float s = -g[i];
    for (int k = 0; k < i; ++k) s -= L[i][k] * y[k];
    y[i] = s / L[i][i];
  }
  for (int i = 5; i >= 0; --i) {
    float s = y[i];
    for (int k = i + 1; k < 6; ++k) s -= L[k][i] * xi[k];
    xi[i] = s / L[i][i];
  }
}

}  // namespace se3s

namespace se3t {

// C = A·B of 4x4 row-major matrices.
__device__ inline void mul4(const float A[4][4], const float B[4][4],
                            float C[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      C[i][j] = A[i][0] * B[0][j] + A[i][1] * B[1][j] + A[i][2] * B[2][j] +
                A[i][3] * B[3][j];
}

__device__ inline void eye4(float T[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) T[i][j] = i == j ? 1.f : 0.f;
}

// se3.exp: xi = [rho, phi] -> T (4x4). se3._so3_coeffs: A = sin t / t,
// B = (1 - cos t)/t², C = (t - sin t)/t³, Taylor where t² < 1e-8.
__device__ inline void exp(const float xi[6], float T[4][4]) {
  const float phi[3] = {xi[3], xi[4], xi[5]};
  const float t2 = phi[0] * phi[0] + phi[1] * phi[1] + phi[2] * phi[2];
  const float theta = sqrtf(t2 + 1e-16f);
  const bool small = t2 < 1e-8f;
  const float A = small ? 1.f - t2 / 6.f : sinf(theta) / theta;
  const float B = small ? 0.5f - t2 / 24.f : (1.f - cosf(theta)) / t2;
  const float C = small ? 1.f / 6.f - t2 / 120.f
                        : (theta - sinf(theta)) / (t2 * theta);
  float W[3][3], W2[3][3];
  se3s::hat2(phi, W, W2);
  float V[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float e = i == j ? 1.f : 0.f;
      T[i][j] = e + A * W[i][j] + B * W2[i][j];
      V[i][j] = e + B * W[i][j] + C * W2[i][j];
    }
#pragma unroll
  for (int i = 0; i < 3; ++i)
    T[i][3] = V[i][0] * xi[0] + V[i][1] * xi[1] + V[i][2] * xi[2];
  T[3][0] = T[3][1] = T[3][2] = 0.f;
  T[3][3] = 1.f;
}

// se3.so3_log: R -> phi; near pi the axis is read off the dominant
// diagonal row of (R + Rᵀ)/2 - cos I, oriented along vee(R - Rᵀ).
__device__ inline void so3_log(const float R[4][4], float phi[3]) {
  const float trace = R[0][0] + R[1][1] + R[2][2];
  const float c = fminf(fmaxf((trace - 1.f) * 0.5f, -1.f), 1.f);
  const float theta = acosf(c);
  const float s = sinf(theta);
  const float vec[3] = {R[2][1] - R[1][2], R[0][2] - R[2][0],
                        R[1][0] - R[0][1]};
  if (theta > (float)(3.14159265358979323846 - 1e-3)) {
    float M[3][3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j)
        M[i][j] = 0.5f * (R[i][j] + R[j][i]) - (i == j ? c : 0.f);
    int k = 0;  // the first largest diagonal entry, as argmax picks it
    if (M[1][1] > M[k][k]) k = 1;
    if (M[2][2] > M[k][k]) k = 2;
    float row[3] = {M[k][0], M[k][1], M[k][2]};
    const float nr = sqrtf(row[0] * row[0] + row[1] * row[1] +
                           row[2] * row[2]);
    const float den = nr < 1e-12f ? 1e-12f : nr;
    float dot = 0.f;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      row[i] = row[i] / den;
      dot += row[i] * vec[i];
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) phi[i] = theta * (dot < 0.f ? -row[i] : row[i]);
    return;
  }
  const float factor = theta < 1e-4f
                           ? 0.5f + theta * theta / 12.f
                           : theta / (s < 1e-12f ? 1.f : 2.f * s);
#pragma unroll
  for (int i = 0; i < 3; ++i) phi[i] = factor * vec[i];
}

// se3.log: T -> xi = [rho, phi], rho = V⁻¹ t with
// V⁻¹ = I - W/2 + D W², D = 1/t² - (1 + cos t)/(2 t sin t).
__device__ inline void log(const float T[4][4], float xi[6]) {
  float phi[3];
  so3_log(T, phi);
  const float t2 = phi[0] * phi[0] + phi[1] * phi[1] + phi[2] * phi[2];
  const float theta = sqrtf(t2 + 1e-16f);
  const float D = t2 < 1e-8f
                      ? 1.f / 12.f + t2 / 720.f
                      : 1.f / t2 - (1.f + cosf(theta)) /
                                       (2.f * theta * sinf(theta));
  float W[3][3], W2[3][3];
  se3s::hat2(phi, W, W2);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    float r = 0.f;
#pragma unroll
    for (int j = 0; j < 3; ++j)
      r += ((i == j ? 1.f : 0.f) - 0.5f * W[i][j] + D * W2[i][j]) * T[j][3];
    xi[i] = r;
    xi[3 + i] = phi[i];
  }
}

}  // namespace se3t
