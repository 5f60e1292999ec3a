// KN: k nearest neighbours and the local plane fit of normal estimation,
// float32, for sm_90a.
//
// Replaces the reference's k-NN plane fit,
// tpu_icp_slam/mapping/normals.py::normals_knn (:98-139): the k-NN of
// kernels/nn_xla.py::knn_bruteforce_xla (:57-104; a factored distance
// matrix a chunk and lax.top_k, XLA ops, no Pallas kernel), the gather of
// the neighbours, the centring and covariance, smallest_eigvec_sym3
// (:49-95), the flip toward the viewpoint and the zero normal of a masked
// row. The port's torch form of it (kernels/nn_plain.py and
// mapping/normals.py) writes a (1,024 x N) float32 matrix a chunk to
// device memory, reads it several times, runs a top-k, then ~60 small ops:
// hundreds of kernels on every map insert.
//
// What bounds it on an H100: FP32 issue rate. The main path calls it with
// M = 16,384 rows against N = 4,096 targets (normal_ref_stride 4) or N =
// 16,384 (kitti_full_res.json): 6.7e7 or 2.7e8 pairs of 9 operations, 0.60
// or 2.42 GFLOP, 0.009 or 0.036 ms at 67 TFLOP/s. Its bytes are small
// (0.2 MB in, 0.2 MB of normals out).
//
// Design:
//  - Two launches. knn_select_kernel: a block of kThreads threads owns
//    kThreads * R rows (R a thread, rows threadIdx.x + r * kThreads) and
//    one contiguous range of the targets (gridDim.y ranges, so that rows x
//    ranges fill the SMs); targets arrive in tiles of kTile in shared
//    memory, each as (x, y, z, |b|²), and every thread scores the staged
//    tile against its rows from broadcast reads. knn_fit_kernel, a thread
//    a row, merges the ranges' lists and fits the plane.
//  - The score is the reference's factored form d = (|a|² + |b|²) - 2 a.b
//    in one fixed order of rounded operations: |p|² = (x*x + y*y) + z*z,
//    one rounding a step (torch.sum(p * p, -1)), and a.b = fma(az, bz,
//    fma(ay, by, ax*bx)), the chain that the reference's XLA dot and
//    torch's CPU matrix product compute (kernels/nn_plain.py); then d =
//    fma(-2, a.b, |a|² + |b|²), which equals the plain version's
//    subtraction of the exact 2 a.b. Written with __fmul_rn/__fmaf_rn/
//    __fadd_rn so that nothing contracts it otherwise.
//  - Selection: each row keeps a k-best list of (score, index) in
//    registers, ascending. Targets are scanned in index order; a target
//    enters with a strict `<` against the k-th entry and goes after the
//    entries whose score equals its own: the list is the k first targets
//    by (score, index), the reference's lax.top_k rule (ties to the lower
//    index). The list has KMAX slots (a template parameter, 8, 16 or 32)
//    and the k in use are its last k; the first KMAX - k hold -inf, which
//    nothing displaces, so the k-th entry sits in a fixed register.
//  - The fold inserts the ranges' lists in range order with the same
//    strict rule, which keeps (score, index) order across ranges.
//  - The fit sums the k neighbours in the list's order (the reference's
//    gather order): the mean as a running sum over k, the covariance as a
//    running fma over k, / k; the eigenvector in the closed form of
//    mapping/normals.py::smallest_eigvec_sym3 (+z where the cross products
//    vanish); flip toward the viewpoint; zero where the mask is false.
//  - The reference set is points[::stride], read through the stride: no
//    copy of it is made.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 256;  // targets a staged tile
constexpr int kFitThreads = 128;

__device__ __forceinline__ float sq3(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                   __fmul_rn(z, z));
}

// Insert (d, j) into the ascending list (strict `<`: after equal scores).
// The caller has checked d < best[KMAX - 1].
template <int KMAX>
__device__ __forceinline__ void insert(float (&best)[KMAX],
                                       int (&idx)[KMAX], float d, int j) {
#pragma unroll
  for (int p = KMAX - 1; p > 0; --p) {
    const bool shift = d < best[p - 1];
    const bool here = !shift && d < best[p];
    best[p] = shift ? best[p - 1] : (here ? d : best[p]);
    idx[p] = shift ? idx[p - 1] : (here ? j : idx[p]);
  }
  if (d < best[0]) {
    best[0] = d;
    idx[0] = j;
  }
}

template <int KMAX>
__device__ __forceinline__ void init_list(float (&best)[KMAX],
                                          int (&idx)[KMAX], int k) {
#pragma unroll
  for (int p = 0; p < KMAX; ++p) {
    best[p] = p < KMAX - k ? -INFINITY : INFINITY;
    idx[p] = 0;
  }
}

// Partial lists: part_d/part_i (n_split, m, k), each ascending.
template <int KMAX, int R>
__global__ void __launch_bounds__(kThreads)
knn_select_kernel(const float* __restrict__ pts, int m, int stride, int n,
                  int k, int split_len, float* __restrict__ part_d,
                  int* __restrict__ part_i) {
  __shared__ float4 tile[kTile];
  const int row0 = blockIdx.x * (kThreads * R) + threadIdx.x;
  const int split = blockIdx.y;
  const int begin = split * split_len;
  const int end = min(n, begin + split_len);
  float ax[R], ay[R], az[R], asq[R];
  float best[R][KMAX];
  int idx[R][KMAX];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = row0 + r * kThreads;
    ax[r] = ay[r] = az[r] = 0.f;
    if (row < m) {
      ax[r] = pts[3 * (size_t)row];
      ay[r] = pts[3 * (size_t)row + 1];
      az[r] = pts[3 * (size_t)row + 2];
    }
    asq[r] = sq3(ax[r], ay[r], az[r]);
    init_list<KMAX>(best[r], idx[r], k);
  }
  for (int t0 = begin; t0 < end; t0 += kTile) {
    const int len = min(kTile, end - t0);
    __syncthreads();  // every thread is done with the last tile
    for (int i = threadIdx.x; i < len; i += kThreads) {
      const float* b = pts + 3 * (size_t)(t0 + i) * stride;
      const float bx = b[0], by = b[1], bz = b[2];
      tile[i] = make_float4(bx, by, bz, sq3(bx, by, bz));
    }
    __syncthreads();
    for (int j = 0; j < len; ++j) {
      const float4 b = tile[j];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float g =
            __fmaf_rn(az[r], b.z, __fmaf_rn(ay[r], b.y, __fmul_rn(ax[r], b.x)));
        // (|a|² + |b|²) - 2g rounded once: 2g is exact, so this is the
        // plain version's subtraction of the doubled product
        const float d = __fmaf_rn(-2.f, g, __fadd_rn(asq[r], b.w));
        if (d < best[r][KMAX - 1]) insert<KMAX>(best[r], idx[r], d, t0 + j);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = row0 + r * kThreads;
    if (row >= m) continue;
    const size_t at = ((size_t)split * m + row) * k;
#pragma unroll
    for (int p = 0; p < KMAX; ++p) {
      if (p >= KMAX - k) {
        part_d[at + (p - (KMAX - k))] = best[r][p];
        part_i[at + (p - (KMAX - k))] = idx[r][p];
      }
    }
  }
}

// The smallest eigenvector of the symmetric 3x3 matrix c (c00, c01, c02,
// c11, c12, c22), mapping/normals.py::smallest_eigvec_sym3's closed form.
__device__ __forceinline__ void smallest_eigvec(const float c[6], float v[3]) {
  const float c00 = c[0], c01 = c[1], c02 = c[2], c11 = c[3], c12 = c[4],
              c22 = c[5];
  const float q = (c00 + c11 + c22) / 3.f;
  const float p1 = c01 * c01 + c02 * c02 + c12 * c12;
  const float e0 = c00 - q, e1 = c11 - q, e2 = c22 - q;
  const float p2 = e0 * e0 + e1 * e1 + e2 * e2 + 2.f * p1;
  const float p = sqrtf(fmaxf(p2 / 6.f, 1e-30f));
  const float b00 = e0 / p, b11 = e1 / p, b22 = e2 / p;
  const float b01 = c01 / p, b02 = c02 / p, b12 = c12 / p;
  const float det = b00 * (b11 * b22 - b12 * b12) -
                    b01 * (b01 * b22 - b12 * b02) +
                    b02 * (b01 * b12 - b11 * b02);
  const float r = fminf(fmaxf(det / 2.f, -1.f), 1.f);
  const float phi = acosf(r) / 3.f;
  const float lam = q + 2.f * p * cosf(phi + 2.0943951023931953f);
  // rows of C - lam I
  const float a[3][3] = {{c00 - lam, c01, c02},
                         {c01, c11 - lam, c12},
                         {c02, c12, c22 - lam}};
  const int pairs[3][2] = {{0, 1}, {0, 2}, {1, 2}};
  float bestn = -1.f;
  v[0] = v[1] = v[2] = 0.f;
#pragma unroll
  for (int t = 0; t < 3; ++t) {
    const float* u = a[pairs[t][0]];
    const float* w = a[pairs[t][1]];
    const float x = u[1] * w[2] - u[2] * w[1];
    const float y = u[2] * w[0] - u[0] * w[2];
    const float z = u[0] * w[1] - u[1] * w[0];
    const float nn = x * x + y * y + z * z;
    if (nn > bestn) {  // the first largest, as argmax
      bestn = nn;
      v[0] = x;
      v[1] = y;
      v[2] = z;
    }
  }
  const float vn = sqrtf(v[0] * v[0] + v[1] * v[1] + v[2] * v[2]);
  if (vn > 1e-20f) {
    const float s = fmaxf(vn, 1e-30f);
    v[0] /= s;
    v[1] /= s;
    v[2] /= s;
  } else {
    v[0] = v[1] = 0.f;
    v[2] = 1.f;
  }
}

template <int KMAX>
__global__ void __launch_bounds__(kFitThreads)
knn_fit_kernel(const float* __restrict__ pts, const bool* __restrict__ mask,
               int m, int stride, int k, int n_split,
               const float* __restrict__ part_d,
               const int* __restrict__ part_i,
               const float* __restrict__ viewpoint,
               float* __restrict__ normals, int* __restrict__ idx_out) {
  const int row = blockIdx.x * kFitThreads + threadIdx.x;
  if (row >= m) return;
  float best[KMAX];
  int idx[KMAX];
  init_list<KMAX>(best, idx, k);
  for (int s = 0; s < n_split; ++s) {
    const size_t at = ((size_t)s * m + row) * k;
    for (int p = 0; p < k; ++p) {
      const float d = part_d[at + p];
      if (!(d < best[KMAX - 1])) break;  // the rest of this list is larger
      insert<KMAX>(best, idx, d, part_i[at + p]);
    }
  }
  float sx = 0.f, sy = 0.f, sz = 0.f;
#pragma unroll
  for (int p = 0; p < KMAX; ++p) {
    if (p >= KMAX - k) {
      idx_out[(size_t)row * k + p - (KMAX - k)] = idx[p];
      const float* q = pts + 3 * (size_t)idx[p] * stride;
      sx = __fadd_rn(sx, q[0]);
      sy = __fadd_rn(sy, q[1]);
      sz = __fadd_rn(sz, q[2]);
    }
  }
  const float fk = (float)k;
  const float mx = __fdiv_rn(sx, fk), my = __fdiv_rn(sy, fk),
              mz = __fdiv_rn(sz, fk);
  float c[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int p = 0; p < KMAX; ++p) {
    if (p >= KMAX - k) {
      const float* q = pts + 3 * (size_t)idx[p] * stride;
      const float x = __fsub_rn(q[0], mx), y = __fsub_rn(q[1], my),
                  z = __fsub_rn(q[2], mz);
      c[0] = __fmaf_rn(x, x, c[0]);
      c[1] = __fmaf_rn(x, y, c[1]);
      c[2] = __fmaf_rn(x, z, c[2]);
      c[3] = __fmaf_rn(y, y, c[3]);
      c[4] = __fmaf_rn(y, z, c[4]);
      c[5] = __fmaf_rn(z, z, c[5]);
    }
  }
#pragma unroll
  for (int t = 0; t < 6; ++t) c[t] = __fdiv_rn(c[t], fk);
  float v[3];
  smallest_eigvec(c, v);
  const float px = pts[3 * (size_t)row], py = pts[3 * (size_t)row + 1],
              pz = pts[3 * (size_t)row + 2];
  const float vx = viewpoint ? viewpoint[0] : 0.f;
  const float vy = viewpoint ? viewpoint[1] : 0.f;
  const float vz = viewpoint ? viewpoint[2] : 0.f;
  const float facing = v[0] * (vx - px) + v[1] * (vy - py) + v[2] * (vz - pz);
  const float sign = facing < 0.f ? -1.f : 1.f;
  const bool on = mask[row];
  normals[3 * (size_t)row] = on ? sign * v[0] : 0.f;
  normals[3 * (size_t)row + 1] = on ? sign * v[1] : 0.f;
  normals[3 * (size_t)row + 2] = on ? sign * v[2] : 0.f;
}

template <int KMAX, int R>
cudaError_t launch(const float* pts, const bool* mask, int m, int stride,
                   int n, int k, int n_split, const float* viewpoint,
                   float* part_d, int* part_i, float* normals, int* idx,
                   cudaStream_t stream) {
  const int split_len = (n + n_split - 1) / n_split;
  if ((long long)(n_split - 1) * split_len >= n) return cudaErrorInvalidValue;
  const dim3 grid((m + kThreads * R - 1) / (kThreads * R), n_split);
  knn_select_kernel<KMAX, R><<<grid, kThreads, 0, stream>>>(
      pts, m, stride, n, k, split_len, part_d, part_i);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  knn_fit_kernel<KMAX><<<(m + kFitThreads - 1) / kFitThreads, kFitThreads, 0,
                         stream>>>(pts, mask, m, stride, k, n_split, part_d,
                                   part_i, viewpoint, normals, idx);
  return cudaGetLastError();
}

}  // namespace

// points (m, 3) float32 and mask (m,) bool, contiguous; the reference set
// is points[::stride], n = ceil(m / stride) >= k targets; 1 <= k <= 32;
// viewpoint (3,) float32 or null (the origin). Scratch part_d/part_i
// (n_split, m, k); outputs normals (m, 3) float32 and idx (m, k) int32 (the
// neighbours in (score, index) order, indices into the reference set).
// Split s covers targets [s * L, min(n, (s + 1) * L)), L = ceil(n /
// n_split); no split may be empty.
extern "C" cudaError_t knn_normals_f32(const float* pts, const bool* mask,
                                       int m, int stride, int k, int n_split,
                                       const float* viewpoint, float* part_d,
                                       int* part_i, float* normals, int* idx,
                                       cudaStream_t stream) {
  if (m <= 0 || stride <= 0 || k <= 0 || k > 32 || n_split <= 0 ||
      n_split > 65535)
    return cudaErrorInvalidValue;
  const int n = (m + stride - 1) / stride;
  if (n < k) return cudaErrorInvalidValue;
  // rows a select block owns: kernels/knn_cuda.py::rows_per_block
  if (k <= 8)
    return launch<8, 2>(pts, mask, m, stride, n, k, n_split, viewpoint,
                        part_d, part_i, normals, idx, stream);
  if (k <= 16)
    return launch<16, 1>(pts, mask, m, stride, n, k, n_split, viewpoint,
                         part_d, part_i, normals, idx, stream);
  return launch<32, 1>(pts, mask, m, stride, n, k, n_split, viewpoint,
                       part_d, part_i, normals, idx, stream);
}
