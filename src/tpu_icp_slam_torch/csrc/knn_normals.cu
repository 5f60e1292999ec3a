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
// The score is the reference's factored form d = (|a|² + |b|²) - 2 a.b in
// one fixed order of rounded operations: |p|² = (x*x + y*y) + z*z, one
// rounding a step (torch.sum(p * p, -1)), and a.b = fma(az, bz, fma(ay,
// by, ax*bx)), the chain that the reference's XLA dot and torch's CPU
// matrix product compute (kernels/nn_plain.py); then d = fma(-2, a.b, |a|²
// + |b|²), which equals the plain version's subtraction of the exact
// 2 a.b. Written with __fmul_rn/__fmaf_rn/__fadd_rn so that nothing
// contracts it otherwise. The picks are the k first targets by (score,
// index), the reference's lax.top_k rule (ties to the lower index).
//
// Design (redesigned for the H100; the first form kept a sorted list a row
// in registers and inserted into it under a per-lane branch at every
// target that beat the row's k-th score, from +inf in each of nine target
// ranges: the warp ran the insertion on most steps):
//  - Two launches. knn_probe_kernel packs the targets as (x, y, z, |b|²)
//    and gives each row a threshold τ: the k-th score of a probe window of
//    4k targets around the row's own position in the reference set (the
//    scans are stored in sweep order, so these are near neighbours). At
//    least k targets score <= τ, so no target above τ is a pick: accepting
//    d <= τ loses no true member. knn_select_kernel does the rest.
//  - knn_select_kernel: a block of kWarps warps owns 32 R rows (R a lane,
//    rows lane + 32 r); warp w scans target range w of kWarps, contiguous
//    and in index order, in tiles of kTile that cp.async stages into the
//    warp's double buffer while it scores the tile before (warp-private:
//    no block barrier in the scan).
//  - The hot loop scores kGroup targets against the lane's R rows (from
//    registers and one broadcast float4 read a target), tests each against
//    the row's threshold and, only where one passes, appends (score,
//    index) to the lane's short queue for that row in shared memory. After
//    each group one vote asks whether some lane's queue could overflow in
//    the next group; then the whole warp merges (warp-uniform): each lane
//    inserts its queued entries, in index order, into its rows' sorted
//    lists (strict `<`, after equal scores: (score, index) order) and
//    lowers each threshold to its list's k-th score. A list starts full of
//    a sentinel just above τ, so nothing above τ is queued and the lists
//    never refill from +inf.
//  - The list has KMAX slots (a template parameter, 8, 16 or 32) and the k
//    in use are its last k; the first KMAX - k hold -inf, which nothing
//    displaces, so the k-th entry sits in a fixed register.
//  - At the end the warps' lists meet in shared memory; a thread a row
//    inserts them in range order with the same strict rule (which keeps
//    (score, index) order across ranges), then fits the plane: the k
//    neighbours summed in the list's order (the reference's gather order),
//    the mean as a running sum over k, the covariance as a running fma
//    over k, / k; the eigenvector in the closed form of
//    mapping/normals.py::smallest_eigvec_sym3 (+z where the cross products
//    vanish); flip toward the viewpoint; zero where the mask is false.
//  - The reference set is points[::stride], read through the stride: the
//    probe launch packs it once into the scratch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace {

constexpr int kWarps = 8;  // target ranges a block, one a warp
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 128;  // targets a staged tile
constexpr int kGroup = 8;   // targets scored between two queue checks
constexpr int kQueue = 16;  // a lane's queue slots a row
constexpr int kProbeThreads = 256;

__device__ __forceinline__ float sq3(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                   __fmul_rn(z, z));
}

// (|a|² + |b|²) - 2 a.b rounded once after the product chain: 2g is
// exact, so this is the plain version's subtraction of the doubled product
__device__ __forceinline__ float score(float ax, float ay, float az,
                                       float asq, float4 b) {
  const float g =
      __fmaf_rn(az, b.z, __fmaf_rn(ay, b.y, __fmul_rn(ax, b.x)));
  return __fmaf_rn(-2.f, g, __fadd_rn(asq, b.w));
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

// The list empty: -inf in the KMAX - k unused slots, `top` in the k used.
template <int KMAX>
__device__ __forceinline__ void init_list(float (&best)[KMAX],
                                          int (&idx)[KMAX], int k,
                                          float top) {
#pragma unroll
  for (int p = 0; p < KMAX; ++p) {
    best[p] = p < KMAX - k ? -INFINITY : top;
    idx[p] = 0;
  }
}

// Launch 1: thread i packs target i (points[i * stride]) as (x, y, z,
// |b|²) and gives row i its threshold: the k-th score of the probe window
// of min(probe, n) targets around i / stride (+inf where no score is
// finite).
template <int KMAX>
__global__ void __launch_bounds__(kProbeThreads)
knn_probe_kernel(const float* __restrict__ pts, int m, int stride, int n,
                 int k, int probe, float4* __restrict__ tgt,
                 float* __restrict__ tau) {
  const int i = blockIdx.x * kProbeThreads + threadIdx.x;
  if (i < n) {
    const float* b = pts + 3 * (size_t)i * stride;
    tgt[i] = make_float4(b[0], b[1], b[2], sq3(b[0], b[1], b[2]));
  }
  if (i >= m) return;
  const float ax = pts[3 * (size_t)i], ay = pts[3 * (size_t)i + 1],
              az = pts[3 * (size_t)i + 2];
  const float asq = sq3(ax, ay, az);
  const int p = min(probe, n);
  const int lo = min(max(i / stride - p / 2, 0), n - p);
  float best[KMAX];
  int idx[KMAX];
  init_list<KMAX>(best, idx, k, INFINITY);
  constexpr int kChunk = 8;  // window targets loaded before any is scored
  for (int j0 = lo; j0 < lo + p; j0 += kChunk) {
    float4 b[kChunk];
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      const float* q = pts + 3 * (size_t)min(j0 + u, n - 1) * stride;
      b[u] = make_float4(q[0], q[1], q[2], 0.f);
    }
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      if (j0 + u >= lo + p) break;
      b[u].w = sq3(b[u].x, b[u].y, b[u].z);
      const float d = score(ax, ay, az, asq, b[u]);
      if (d < best[KMAX - 1]) insert<KMAX>(best, idx, d, j0 + u);
    }
  }
  tau[i] = best[KMAX - 1];
}

template <int KMAX, int R>
struct Select {
  static constexpr int kRows = 32 * R;  // rows a block
  static constexpr size_t kTileBytes = sizeof(float4) * kWarps * 2 * kTile;
  static constexpr size_t kQueueWords = (size_t)kWarps * R * kQueue * 32;
  static constexpr size_t kScanBytes = kTileBytes + 8 * kQueueWords;
  static constexpr size_t kListBytes = (size_t)8 * kWarps * kRows * KMAX;
  static constexpr size_t kSmem =
      kScanBytes > kListBytes ? kScanBytes : kListBytes;
};

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


// The plane of row's k neighbours (fi, in (score, index) order): idx_out,
// the normal facing the viewpoint, zero where the mask is false.
template <int KMAX>
__device__ __forceinline__ void fit(const float* __restrict__ pts,
                                   const bool* __restrict__ mask, int row,
                                   int stride, int k, const int (&fi)[KMAX],
                                   const float* __restrict__ viewpoint,
                                   float* __restrict__ normals,
                                   int* __restrict__ idx_out) {
  float sx = 0.f, sy = 0.f, sz = 0.f;
#pragma unroll
  for (int p = 0; p < KMAX; ++p) {
    if (p >= KMAX - k) {
      idx_out[(size_t)row * k + p - (KMAX - k)] = fi[p];
      const float* q = pts + 3 * (size_t)fi[p] * stride;
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
      const float* q = pts + 3 * (size_t)fi[p] * stride;
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

// Targets [t0, min(t0 + kTile, hi)) into a warp's tile buffer by
// cp.async, one commit group.
__device__ __forceinline__ void stage(float4* buf,
                                      const float4* __restrict__ tgt, int t0,
                                      int hi, int lane) {
  const int len = min(kTile, hi - t0);
  for (int i = lane; i < len; i += 32)
    cp_async::copy16(cp_async::smem_addr(buf + i), tgt + t0 + i);
  cp_async::commit();
}

// A lane's queued entries, in index order, into its rows' lists; each
// threshold lowered to its list's k-th score. Called by the whole warp.
template <int KMAX, int R>
__device__ __forceinline__ void merge(float (&best)[R][KMAX],
                                      int (&idx)[R][KMAX], int (&cnt)[R],
                                      float (&thr)[R],
                                      const float* __restrict__ qd,
                                      const int* __restrict__ qi, int lane) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    for (int s = 0; s < cnt[r]; ++s) {
      const int at = (r * kQueue + s) * 32 + lane;
      const float d = qd[at];
      if (d < best[r][KMAX - 1]) insert<KMAX>(best[r], idx[r], d, qi[at]);
    }
    cnt[r] = 0;
    thr[r] = best[r][KMAX - 1];
  }
}

// Scores targets [j, j + len) of the staged tile (first index t0) against
// the lane's rows; queues those under their row's threshold; merges the
// warp's queues when one could overflow in the next group.
template <int KMAX, int R>
__device__ __forceinline__ void group(
    const float (&ax)[R], const float (&ay)[R], const float (&az)[R],
    const float (&asq)[R], float (&best)[R][KMAX], int (&idx)[R][KMAX],
    int (&cnt)[R], float (&thr)[R], float* __restrict__ qd,
    int* __restrict__ qi, int lane, const float4* tile, int j, int len,
    int t0) {
  float d[kGroup][R];
  bool any = false;
#pragma unroll
  for (int u = 0; u < kGroup; ++u) {
    const float4 b =
        u < len ? tile[j + u] : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      d[u][r] = u < len ? score(ax[r], ay[r], az[r], asq[r], b) : INFINITY;
      any |= d[u][r] < thr[r];
    }
  }
  if (any) {
#pragma unroll
    for (int u = 0; u < kGroup; ++u)
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (d[u][r] < thr[r]) {
          const int at = (r * kQueue + cnt[r]) * 32 + lane;
          qd[at] = d[u][r];
          qi[at] = t0 + j + u;
          ++cnt[r];
        }
  }
  int most = 0;
#pragma unroll
  for (int r = 0; r < R; ++r) most = max(most, cnt[r]);
  if (__any_sync(0xffffffffu, most > kQueue - kGroup))
    merge<KMAX, R>(best, idx, cnt, thr, qd, qi, lane);
}

// Launch 2: the select, the fold of the warps' lists and the fit.
template <int KMAX, int R>
__global__ void __launch_bounds__(kThreads, 2)
knn_select_kernel(const float* __restrict__ pts,
                  const bool* __restrict__ mask, int m, int stride, int n,
                  int k, const float4* __restrict__ tgt,
                  const float* __restrict__ tau,
                  const float* __restrict__ viewpoint,
                  float* __restrict__ normals, int* __restrict__ idx_out) {
  using S = Select<KMAX, R>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float4* tiles = reinterpret_cast<float4*>(smem) + warp * 2 * kTile;
  float* qd = reinterpret_cast<float*>(smem + S::kTileBytes) +
              (size_t)warp * R * kQueue * 32;
  int* qi = reinterpret_cast<int*>(smem + S::kTileBytes +
                                   4 * S::kQueueWords) +
            (size_t)warp * R * kQueue * 32;
  const int row0 = blockIdx.x * S::kRows;
  const int len_w = (n + kWarps - 1) / kWarps;
  const int lo = min(n, warp * len_w), hi = min(n, lo + len_w);

  float ax[R], ay[R], az[R], asq[R], thr[R];
  float best[R][KMAX];
  int idx[R][KMAX], cnt[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = row0 + lane + 32 * r;
    ax[r] = ay[r] = az[r] = 0.f;
    float top = INFINITY;
    if (row < m) {
      ax[r] = pts[3 * (size_t)row];
      ay[r] = pts[3 * (size_t)row + 1];
      az[r] = pts[3 * (size_t)row + 2];
      top = nextafterf(tau[row], INFINITY);  // d <= τ  <=>  d < top
    }
    asq[r] = sq3(ax[r], ay[r], az[r]);
    init_list<KMAX>(best[r], idx[r], k, top);
    thr[r] = top;
    cnt[r] = 0;
  }

  // the warp's range, tile by tile, the next tile in flight
  int buf = 0;
  if (lo < hi) stage(tiles, tgt, lo, hi, lane);
  for (int t0 = lo; t0 < hi; t0 += kTile) {
    if (t0 + kTile < hi)
      stage(tiles + (buf ^ 1) * kTile, tgt, t0 + kTile, hi, lane);
    else
      cp_async::commit();  // an empty group: the wait below stays uniform
    cp_async::wait_prior();
    __syncwarp();
    const float4* tile = tiles + buf * kTile;
    const int len = min(kTile, hi - t0);
    int j = 0;
    for (; j + kGroup <= len; j += kGroup)
      group<KMAX, R>(ax, ay, az, asq, best, idx, cnt, thr, qd, qi, lane,
                     tile, j, kGroup, t0);
    if (j < len)
      group<KMAX, R>(ax, ay, az, asq, best, idx, cnt, thr, qd, qi, lane,
                     tile, j, len - j, t0);
    __syncwarp();  // the tile is read before its buffer is refilled
    buf ^= 1;
  }
  merge<KMAX, R>(best, idx, cnt, thr, qd, qi, lane);

  // the warps' lists, range by range, into shared memory (over the tiles
  // and queues, once every warp is done with them)
  __syncthreads();
  float* ld = reinterpret_cast<float*>(smem);
  int* li = reinterpret_cast<int*>(smem + 4 * (size_t)kWarps * S::kRows *
                                              KMAX);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const size_t at = ((size_t)warp * S::kRows + lane + 32 * r) * KMAX;
#pragma unroll
    for (int p = 0; p < KMAX; ++p) {
      if (p >= KMAX - k) {
        ld[at + p - (KMAX - k)] = best[r][p];
        li[at + p - (KMAX - k)] = idx[r][p];
      }
    }
  }
  __syncthreads();
  const int t = threadIdx.x;
  const int row = row0 + t;
  if (t >= S::kRows || row >= m) return;
  float fb[KMAX];
  int fi[KMAX];
  init_list<KMAX>(fb, fi, k, INFINITY);
  for (int w = 0; w < kWarps; ++w) {
    const size_t at = ((size_t)w * S::kRows + t) * KMAX;
    for (int p = 0; p < k; ++p) {
      const float d = ld[at + p];
      if (!(d < fb[KMAX - 1])) break;  // the rest of this list is larger
      insert<KMAX>(fb, fi, d, li[at + p]);
    }
  }
  fit<KMAX>(pts, mask, row, stride, k, fi, viewpoint, normals, idx_out);
}

template <int KMAX, int R>
cudaError_t launch(const float* pts, const bool* mask, int m, int stride,
                   int n, int k, const float* viewpoint, float4* tgt,
                   float* tau, float* normals, int* idx,
                   cudaStream_t stream) {
  const int rows = max(m, n);
  knn_probe_kernel<KMAX>
      <<<(rows + kProbeThreads - 1) / kProbeThreads, kProbeThreads, 0,
         stream>>>(pts, m, stride, n, k, 4 * k, tgt, tau);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  using S = Select<KMAX, R>;
  static bool sized = false;  // the dynamic shared memory, once a process
  if (!sized) {
    err = cudaFuncSetAttribute(knn_select_kernel<KMAX, R>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)S::kSmem);
    if (err != cudaSuccess) return err;
    sized = true;
  }
  knn_select_kernel<KMAX, R>
      <<<(m + S::kRows - 1) / S::kRows, kThreads, S::kSmem, stream>>>(
          pts, mask, m, stride, n, k, tgt, tau, viewpoint, normals, idx);
  return cudaGetLastError();
}

}  // namespace

// points (m, 3) float32 and mask (m,) bool, contiguous; the reference set
// is points[::stride], n = ceil(m / stride) >= k targets; 1 <= k <= 32;
// viewpoint (3,) float32 or null (the origin). Scratch tgt (n, 4) float32
// (16-byte aligned) and tau (m,) float32; outputs normals (m, 3) float32
// and idx (m, k) int32 (the neighbours in (score, index) order, indices
// into the reference set).
extern "C" cudaError_t knn_normals_f32(const float* pts, const bool* mask,
                                       int m, int stride, int k,
                                       const float* viewpoint, float* tgt,
                                       float* tau, float* normals, int* idx,
                                       cudaStream_t stream) {
  if (m <= 0 || stride <= 0 || k <= 0 || k > 32) return cudaErrorInvalidValue;
  const int n = (m + stride - 1) / stride;
  if (n < k) return cudaErrorInvalidValue;
  float4* t4 = reinterpret_cast<float4*>(tgt);
  if (k <= 8)
    return launch<8, 2>(pts, mask, m, stride, n, k, viewpoint, t4, tau,
                        normals, idx, stream);
  if (k <= 16)
    return launch<16, 1>(pts, mask, m, stride, n, k, viewpoint, t4, tau,
                         normals, idx, stream);
  return launch<32, 1>(pts, mask, m, stride, n, k, viewpoint, t4, tau,
                       normals, idx, stream);
}
