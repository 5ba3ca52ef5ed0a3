// The building blocks of the decode kernels that stream weights: the
// fragment helpers of the TMA-fed H-J8, 19-23 (layer_matmul_sm90.cu,
// decode_mlp_sm90.cu, decode_attn_wo_sm90.cu), and the cp.async ring and
// launch helpers of the split-KV body (decode_split.cuh).
//
// A weight box is 128 weight rows of one 128-byte row each (64 bf16 or 128
// int8 columns), 128-byte swizzled; four warps split its columns, and each
// takes its B fragments of mma.sync m16n8k16 with one ldmatrix.x4.trans per
// 16 rows (`box_frags`); int8 bytes are widened to bf16 in registers
// (exact, `b_frags`).
#pragma once

#include "common.cuh"

namespace gar {

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

// Four int8 weights, as ldmatrix.trans hands them to a thread: bytes
// (W[k][n], W[k][n+1], W[k+1][n], W[k+1][n+1]). Returns the bf16 pairs
// (W[k][n], W[k+1][n]) in `even` and (W[k][n+1], W[k+1][n+1]) in `odd`,
// each a B-fragment register. Exact: x + 128 as the low byte of the float
// 2^23 + (x + 128), minus 2^23 + 128, is x; and an integer of at most 8
// significant bits is its own bf16, the top half of its float.
__device__ __forceinline__ void widen_i8x4(uint32_t r, uint32_t& even, uint32_t& odd) {
  const uint32_t u = r ^ 0x80808080u;
  constexpr float kMagic = 8388736.0f;  // 2^23 + 128
  const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650)) - kMagic;
  const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7651)) - kMagic;
  const float f2 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7652)) - kMagic;
  const float f3 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7653)) - kMagic;
  even = __byte_perm(__float_as_uint(f0), __float_as_uint(f2), 0x7632);
  odd = __byte_perm(__float_as_uint(f1), __float_as_uint(f3), 0x7632);
}

// The column of the tile that the sum acc[j][2 * hf + e] (e = 0, 1) of
// n-tile j holds, for lane t = lane % 4: bf16 wn + 8j + 2t + e; int8 (tile
// 2h the even columns of 16, 2h + 1 the odd) wn + 16h + 4t + 2e + (j % 2).
template <typename W>
__device__ __forceinline__ int frag_col(int j, int e, int wn, int t) {
  if constexpr (sizeof(W) == 1) return wn + 16 * (j >> 1) + 4 * t + 2 * e + (j & 1);
  return wn + 8 * j + 2 * t + e;
}

// The TMA-fed bodies (H-J8, 19-23):
// ldmatrix.x4.trans of rows r0 .. r0 + 15 and 16-byte chunks c, c + 1 of a
// 128-byte-swizzled box (chunk c of row r at c ^ (r % 8)): raw[0], raw[1]
// rows 0-7 and 8-15 of chunk c, raw[2], raw[3] those of chunk c + 1.
__device__ __forceinline__ void box_frags(uint32_t (&raw)[4], const uint8_t* box, int r0, int c,
                                          int lane) {
  const int r = r0 + (lane & 15), ch = c + (lane >> 4);
  ldmatrix_x4_trans(raw, reinterpret_cast<const bf16*>(box + r * 128 + ((ch ^ (r & 7)) << 4)));
}

// B fragments of NT n-tiles from box_frags' raw: bf16 (NT 2) the two chunks'
// 8 columns each; int8 (NT 4) the even and odd columns of each chunk's 16,
// widened (frag_col says where each sum lands).
template <typename W, int NT>
__device__ __forceinline__ void b_frags(uint32_t (&bfr)[NT][2], const uint32_t (&raw)[4]) {
  if constexpr (sizeof(W) == 1) {
    static_assert(NT == 4, "two chunks of 16 int8 columns");
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      widen_i8x4(raw[2 * h], bfr[2 * h][0], bfr[2 * h + 1][0]);
      widen_i8x4(raw[2 * h + 1], bfr[2 * h][1], bfr[2 * h + 1][1]);
    }
  } else {
    static_assert(NT == 2, "two chunks of 8 bf16 columns");
    bfr[0][0] = raw[0], bfr[0][1] = raw[1], bfr[1][0] = raw[2], bfr[1][1] = raw[3];
  }
}

// The cp.async ring: load(kt) issues slab kt's copies into stage
// kt % STAGES, use(kt) runs once every thread's copies of slab kt have
// landed; STAGES - 1 loads stay in flight. Returns after a barrier, the
// ring free.
template <int STAGES, typename Load, typename Use>
__device__ __forceinline__ void ring(int n, Load load, Use use) {
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n) load(s);
    cp_async_commit();
  }
  for (int kt = 0; kt < n; ++kt) {
    cp_async_wait<STAGES - 2>();  // slab kt has landed (this thread's part)
    __syncthreads();              // ... every thread's part; slab kt-1 is free
    if (kt + STAGES - 1 < n) load(kt + STAGES - 1);
    cp_async_commit();
    use(kt);
  }
  cp_async_wait<0>();
  __syncthreads();
}

// Launch with a cluster of cluster_x blocks along x; with pdl, as a
// programmatic dependent of the kernel before it on the stream (the kernel's
// griddepcontrol.wait waits for that one to finish). Returns the CUDA error.
template <typename... Params, typename... Args>
int launch_ex(void (*kernel)(Params...), dim3 grid, int threads, int smem, int cluster_x,
              bool pdl, cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster_x;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = pdl ? 2 : 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The SM count of the current card (132, an H100's, where the query fails),
// read once.
inline int card_sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
        sms <= 0)
      sms = 132;
  }
  return sms;
}

// Opt a kernel in to `smem` bytes of dynamic shared memory (and, with
// big_clusters, to Hopper's clusters of 16), once per kernel.
template <typename K>
int opt_in(K kernel, int smem, bool big_clusters, bool& done) {
  if (done) return 0;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess && big_clusters)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  done = err == cudaSuccess;
  return static_cast<int>(err);
}

}  // namespace gar
