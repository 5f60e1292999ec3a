// cp.async primitives shared by the kernels that stage tiles through shared
// memory (nn_exact.cuh, packed_mma.cuh): asynchronous global -> shared
// copies, committed in groups, with a wait that leaves the newest group in
// flight (double buffering).

#pragma once

#include <cuda_runtime.h>

namespace cp_async {

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void copy16(unsigned dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src));
}

__device__ __forceinline__ void copy4(unsigned dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(src));
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until every group but the newest has landed.
__device__ __forceinline__ void wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

}  // namespace cp_async
