// The building blocks of the kernels that stream decode weights: kernels J
// and J8 (layer_matmul.cu), and the fragment helpers of the TMA-fed H-I8,
// 19-23 (layer_matmul_sm90.cu, decode_mlp_sm90.cu, decode_attn_wo_sm90.cu).
//
// A slab is kWBK weight rows x WTile<W>::BN columns: 64 bf16 or 128 int8
// columns, 128-byte rows either way, in shared memory at a pitch of 144
// bytes. Four warps split the columns, and each takes its B fragments of
// mma.sync m16n8k16 from the slab with one ldmatrix.x4.trans per 16 rows;
// int8 bytes are widened to bf16 in registers (exact). Slabs stream
// through a cp.async ring (`ring`), beside the matching x slab, and each
// warp keeps its (16 MT, WN) tile of fp32 sums in registers (`mma_slab`).
#pragma once

#include "gemm_tile.cuh"

namespace gar {

constexpr int kWBK = 64;  // weight rows per slab
constexpr int kXLd = kWBK + kGemmPad;  // pitch of an x slab (ROWS x kWBK bf16)

template <typename W>
struct WTile {
  static constexpr bool Q8 = sizeof(W) == 1;
  static constexpr int BN = 128 / sizeof(W);   // 64 bf16 or 128 int8 columns
  static constexpr int WN = BN / 4;            // columns per warp (four warps)
  static constexpr int NT = WN / 8;            // mma n-tiles per warp: 2 bf16, 4 int8
  static constexpr int CHUNK = 16 / sizeof(W);  // weight elements per 16-byte chunk
  static constexpr int LDB = BN + CHUNK;        // slab pitch: 144 bytes either way
  static constexpr int BYTES = kWBK * LDB * sizeof(W);
};

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

// b0, b1 of the warp's NT n-tiles at rows kk..kk+15 of a slab, from one
// ldmatrix.x4.trans of its 32 bytes. bf16: columns wn..wn+7, then
// wn+8..wn+15. int8: the even columns of wn..wn+15, the odd ones, then the
// same of wn+16..wn+31 (`frag_col` says where each sum lands).
template <typename W>
__device__ __forceinline__ void weight_frags(uint32_t (&bfr)[WTile<W>::NT][2], const W* slab,
                                             int kk, int wn, int lane) {
  using T = WTile<W>;
  uint32_t raw[4];
  ldmatrix_x4_trans(raw, reinterpret_cast<const bf16*>(slab + (kk + (lane & 15)) * T::LDB + wn +
                                                       (lane >> 4) * T::CHUNK));
  if constexpr (T::Q8) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      widen_i8x4(raw[2 * h], bfr[2 * h][0], bfr[2 * h + 1][0]);
      widen_i8x4(raw[2 * h + 1], bfr[2 * h][1], bfr[2 * h + 1][1]);
    }
  } else {
#pragma unroll
    for (int j = 0; j < T::NT; ++j) bfr[j][0] = raw[2 * j], bfr[j][1] = raw[2 * j + 1];
  }
}

// The column of the tile that the sum acc[j][2 * hf + e] (e = 0, 1) of
// n-tile j holds, for lane t = lane % 4: bf16 wn + 8j + 2t + e; int8 (tile
// 2h the even columns of 16, 2h + 1 the odd) wn + 16h + 4t + 2e + (j % 2).
template <typename W>
__device__ __forceinline__ int frag_col(int j, int e, int wn, int t) {
  if constexpr (WTile<W>::Q8) return wn + 16 * (j >> 1) + 4 * t + 2 * e + (j & 1);
  return wn + 8 * j + 2 * t + e;
}

// TMA-fed bodies (21-23, decode_mlp_sm90.cu and decode_attn_wo_sm90.cu):
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

// cp.async slab kt's rows: rows [0, kWBK) of `src` (row pitch ld, already
// at the slab's first row and column) to dst; rows past `rows` and columns
// past `cols` land as zeros (cols a multiple of CHUNK, so a chunk is in or
// out). The caller commits.
template <typename W, int NTHREADS>
__device__ __forceinline__ void load_weight_slab(W* dst, const W* src, long long ld, int rows,
                                                 int cols, int tid) {
  using T = WTile<W>;
  constexpr int CPR = T::BN / T::CHUNK;  // chunks a row: 8
  for (int c = tid; c < kWBK * CPR; c += NTHREADS) {
    const int r = c / CPR, cc = (c % CPR) * T::CHUNK;
    const bool ok = r < rows && cc < cols;
    cp_async16(dst + r * T::LDB + cc, src + (ok ? r * ld + cc : 0), ok ? 16 : 0);
  }
}

// cp.async the ROWS x kWBK block of x (row pitch d) at K offset kb; rows
// past `rows` and columns past k_end land as zeros. The caller commits.
template <int ROWS, int NTHREADS>
__device__ __forceinline__ void load_x_slab(bf16* sx, const bf16* x, int rows, int d, int kb,
                                            int k_end) {
  for (int c = threadIdx.x; c < ROWS * (kWBK / 8); c += NTHREADS) {
    const int r = c / (kWBK / 8), cc = (c % (kWBK / 8)) * 8;
    const bool ok = r < rows && kb + cc < k_end;
    cp_async16(sx + r * kXLd + cc, x + (ok ? static_cast<long long>(r) * d + kb + cc : 0),
               ok ? 16 : 0);
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

// acc += A[0:16 MT, 0:kWBK] @ slab for this warp's columns; A bf16 at pitch
// lda.
template <typename W, int MT>
__device__ __forceinline__ void mma_slab(float (&acc)[MT][WTile<W>::NT][4], const bf16* a,
                                         int lda, const W* slab, int wn, int lane) {
  constexpr int NT = WTile<W>::NT;
#pragma unroll
  for (int kk = 0; kk < kWBK; kk += 16) {
    uint32_t bfr[NT][2];
    weight_frags<W>(bfr, slab, kk, wn, lane);
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      uint32_t af[4];
      ldmatrix_x4(af, a + (i * 16 + (lane & 15)) * lda + kk + (lane >> 4) * 8);
#pragma unroll
      for (int j = 0; j < NT; ++j) mma_bf16_16816(acc[i][j], af, bfr[j][0], bfr[j][1]);
    }
  }
}

template <int MT, int NT>
__device__ __forceinline__ void zero(float (&acc)[MT][NT][4]) {
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;
}

// fn(row, col, value) for each of this warp's sums: row i*16 + g + 8 hf,
// col frag_col (the tile's column order).
template <typename W, int MT, typename Fn>
__device__ __forceinline__ void each_sum(const float (&acc)[MT][WTile<W>::NT][4], int wn, int lane,
                                         Fn fn) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < WTile<W>::NT; ++j)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          fn(i * 16 + g + 8 * hf, frag_col<W>(j, e, wn, t), acc[i][j][2 * hf + e]);
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
