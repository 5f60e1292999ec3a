// Capability probe for K5 (icp_fused.cu), for sm_90a.
//
// Hopper counterpart of the Mosaic probes P1-P6 of
// scripts/probe_mosaic_caps.py, which asked whether the TPU compiler lowers
// what the fused ICP kernel needs. Here the question is whether the card and
// the toolkit run what K5 needs, checked against known answers, so that a
// refused cooperative launch reads as such and not as a K5 mismatch:
//  - a cooperative launch of K5's co-resident grid with grid.sync() inside
//    an in-kernel loop whose trip count is decided on the device (P3, P4):
//    every iteration each block posts a value, and after the grid sync every
//    block sums all posts in block order (K5's partials pattern, double
//    buffered by iteration parity);
//  - a dynamic gather by device-side indices (P1);
//  - a running argmin with the lowest-index tie rule (P2, P6);
//  - scalar sqrtf, division, sinf and cosf (P5).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;

// x = [step, scalar]; table (64, 8); idx (8,); e (16, 128);
// scratch (2, 2 * gridDim.x); out (88,): [sum, trips, blocks seen,
// sqrt, 1/x, sin, cos, 0, gather (64), argmin (16)].
__global__ void __launch_bounds__(kThreads)
coop_probe_kernel(const float* __restrict__ table, const int* __restrict__ idx,
                  const float* __restrict__ e, const float* __restrict__ x,
                  float* __restrict__ scratch, float* __restrict__ out) {
  cg::grid_group grid = cg::this_grid();
  __shared__ float s_tot[2];
  float s = 0.f, seen = 0.f;
  int it = 0;
  while (it < 10 && s < 100.f) {
    float* buf = scratch + (size_t)(it & 1) * 2 * gridDim.x;
    if (threadIdx.x == 0) {
      buf[2 * blockIdx.x] = blockIdx.x == 0 ? x[0] : 0.f;
      buf[2 * blockIdx.x + 1] = 1.f;
    }
    grid.sync();
    if (threadIdx.x == 0) {
      float tot = 0.f, cnt = 0.f;
      for (int b = 0; b < (int)gridDim.x; ++b) {
        tot += __ldcg(buf + 2 * b);
        cnt += __ldcg(buf + 2 * b + 1);
      }
      s_tot[0] = tot;
      s_tot[1] = cnt;
    }
    __syncthreads();
    s += s_tot[0];
    seen = s_tot[1];
    __syncthreads();
    ++it;
  }
  if (blockIdx.x != 0) return;
  const int t = threadIdx.x;
  if (t == 0) {
    const float a = x[1];
    out[0] = s;
    out[1] = (float)it;
    out[2] = seen;
    out[3] = sqrtf(a);
    out[4] = 1.f / a;
    out[5] = sinf(a);
    out[6] = cosf(a);
    out[7] = 0.f;
  }
  if (t < 64) out[8 + t] = table[idx[t / 8] * 8 + t % 8];
  if (t < 16) {
    float best = INFINITY;
    int arg = 0;
    for (int j = 0; j < 128; ++j) {
      const float v = e[t * 128 + j];
      if (v < best) {
        best = v;
        arg = j;
      }
    }
    out[72 + t] = (float)arg;
  }
}

}  // namespace

// A cooperative launch of `grid` blocks of 256 threads; a grid larger than
// what can be co-resident is refused with cudaErrorCooperativeLaunchTooLarge.
extern "C" cudaError_t coop_probe_f32(const float* table, const int* idx,
                                      const float* e, const float* x,
                                      int grid, float* scratch, float* out,
                                      cudaStream_t stream) {
  if (grid <= 0) return cudaErrorInvalidValue;
  void* args[] = {&table, &idx, &e, &x, &scratch, &out};
  cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)coop_probe_kernel, dim3(grid), dim3(kThreads), args, 0,
      stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
