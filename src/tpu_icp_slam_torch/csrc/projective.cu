// PJ: the projective correspondence of RGB-D ICP, float32, for sm_90a.
//
// Replaces the reference's projective lookup, tpu_icp_slam/icp/
// projective.py (`projective_correspondence`'s corr: XLA gathers and
// elementwise ops, no Pallas kernel), whose port as torch ops
// (icp/projective.py::_lookup_ref) was ~30 small kernels every ICP trip of
// RGB-D odometry. Each source point, already in the target camera's frame,
// is projected through the intrinsics; its correspondence is read off the
// target's vertex and normal maps at the nearest pixel; the gate is the
// pixel's validity, the image bounds, the distance gate and (with source
// normals) the normal gate.
//
// What bounds it on an H100: its bytes. At 640x480, M = 307,200 rows read
// 3.7 MB (cur, and q, n and the valid flag gathered) and write 9.8 MB (q,
// n, gate, d2): 4.0 us at 3.35 TB/s.
//
// Design: one thread a row, no shared memory. The projection rounds as
// the plain version's torch ops do, one operation at a time (x / z, · fx,
// + cx, no fused multiply-add), so the pixel, and so q and n, are the
// plain version's bit for bit; d2 sums the squared differences in x, y, z
// order, and may differ from torch's sum by an ulp.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
projective_kernel(const float* __restrict__ cur, int m,
                  const float* __restrict__ vertex,
                  const float* __restrict__ normal,
                  const bool* __restrict__ valid,
                  const float* __restrict__ fxy, float cx, float cy, int h,
                  int w, float max_d2, const float* __restrict__ src_normals,
                  float normal_gate_cos, float* __restrict__ q,
                  float* __restrict__ n, float* __restrict__ gate,
                  float* __restrict__ d2) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= m) return;
  const float x = cur[3 * i], y = cur[3 * i + 1], z = cur[3 * i + 2];
  const bool front = z > 1e-6f;
  const float sz = front ? z : 1.f;
  const float u = __fadd_rn(__fmul_rn(__fdiv_rn(x, sz), fxy[0]), cx);
  const float v = __fadd_rn(__fmul_rn(__fdiv_rn(y, sz), fxy[1]), cy);
  // round half to even, then clamp to the image (a NaN reads pixel 0)
  const float uc = fminf(fmaxf(rintf(u), 0.f), (float)(w - 1));
  const float vc = fminf(fmaxf(rintf(v), 0.f), (float)(h - 1));
  const int j = (int)vc * w + (int)uc;
  const bool inb = front && u >= -0.5f && u <= (float)w - 0.5f &&
                   v >= -0.5f && v <= (float)h - 0.5f;
  const float qx = vertex[3 * j], qy = vertex[3 * j + 1],
              qz = vertex[3 * j + 2];
  const float nx = normal[3 * j], ny = normal[3 * j + 1],
              nz = normal[3 * j + 2];
  const float dx = x - qx, dy = y - qy, dz = z - qz;
  const float dd = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                             __fmul_rn(dz, dz));
  bool ok = inb && valid[j] && dd <= max_d2;
  if (src_normals != nullptr) {
    const float* s = src_normals + 3 * i;
    const float dot = __fadd_rn(
        __fadd_rn(__fmul_rn(s[0], nx), __fmul_rn(s[1], ny)),
        __fmul_rn(s[2], nz));
    ok = ok && dot >= normal_gate_cos;
  }
  q[3 * i] = qx;
  q[3 * i + 1] = qy;
  q[3 * i + 2] = qz;
  n[3 * i] = nx;
  n[3 * i + 1] = ny;
  n[3 * i + 2] = nz;
  gate[i] = ok ? 1.f : 0.f;
  d2[i] = dd;
}

}  // namespace

// cur (m, 3), vertex and normal (h, w, 3) float32, valid (h, w) bool, fxy
// (2,) float32 (fx, fy) on the device; src_normals (m, 3) or null (no
// normal gate); outputs q, n (m, 3), gate, d2 (m,) float32.
extern "C" cudaError_t projective_f32(const float* cur, int m,
                                      const float* vertex,
                                      const float* normal,
                                      const bool* valid, const float* fxy,
                                      float cx, float cy, int h, int w,
                                      float max_d2, const float* src_normals,
                                      float normal_gate_cos, float* q,
                                      float* n, float* gate, float* d2,
                                      cudaStream_t stream) {
  if (m <= 0 || h <= 0 || w <= 0) return cudaErrorInvalidValue;
  projective_kernel<<<(m + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      cur, m, vertex, normal, valid, fxy, cx, cy, h, w, max_d2, src_normals,
      normal_gate_cos, q, n, gate, d2);
  return cudaGetLastError();
}
