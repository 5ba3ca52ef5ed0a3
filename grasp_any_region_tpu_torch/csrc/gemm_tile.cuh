// The cp.async helpers of the decode kernels' weight tiles (weight_tile.cuh):
// 16-byte asynchronous copies from global into shared memory, and the pad
// of a shared-memory row.
//
// Shared-memory rows are padded by 8 bf16 (16 bytes): with a row pitch of
// 16 mod 128 bytes the 8 row addresses of each ldmatrix fall in distinct
// bank groups.
#pragma once

#include "common.cuh"

namespace gar {

constexpr int kGemmPad = 8;

// 16-byte async copy global -> shared; src_bytes 0 fills the 16 bytes with zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes = 16) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

}  // namespace gar
