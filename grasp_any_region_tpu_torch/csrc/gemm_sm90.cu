// The GEMMs of the fused ViT block on the Hopper main loop of
// gemm_sm90.cuh, one kernel with four epilogues (gemm90::Epilogue):
//
// F  out = bf16(x + ls * (attn @ wo + bo)), the output projection with
//    LayerScale and the residual add. Replaces
//    grasp_any_region_tpu/ops/vit_block.py:vit_wo_residual (_wo_kernel):
//    fp32 sums, the branch and the residual add in fp32, one rounding.
// D's qkv (vit_block.cu): bf16(xn @ wqkv + bqkv).
// G's fc1 and fc2 (vit_block.cu): bf16(gelu(xn @ fc1 + b1)), then F's
//    epilogue on h @ fc2 with K = M.
//
// The product runs on the TMA + wgmma main loop of gemm_sm90.cuh: a
// persistent CTA an SM over 128 x 128 output tiles (128 x 256 for D's qkv
// and G's fc1, whose N allows it), a producer thread keeping (A, B)
// K-slabs in flight, two consumer warpgroups on wgmma m64n128k16 with B
// read MN-major as it is stored (K, N). The epilogue's global traffic is
// off the consumers' path: a second producer thread loads the tile's x
// rows (kResidual) by TMA into a shared-memory tile of the output's shape
// while the products run; the consumers add the bias, apply the epilogue
// (for F: multiply by ls, ones when the layer has no LayerScale, and add
// x from that tile) and write the bf16 result into the tile; the second
// thread stores the tile by TMA (rows past `rows` are zero-filled on the
// way in and clipped on the way out) while the consumers start the next
// tile, and hands the tile back (loading the next x) once the store has
// read it. (Loads of x and stores of out straight from the accumulator
// registers, 4 bytes a thread, kept the tensor cores idle for about as
// long as the products took. Consumer warpgroups in ping-pong, each taking
// alternate tiles whole so that one's epilogue runs under the other's
// products, were no faster for D and G and 2.5% slower for F.)
//
// Bound: at gar_1b (rows 17 x 1025, K = N = 1024) kernel F is 36.5 GFLOP,
// 0.0369 ms on the tensor cores, against 0.0326 ms for the bytes (attn, x,
// out, wo): nearly balanced. D's qkv (N = 3072) and G's fc1 and fc2 (N or
// K = 4096) do 3 and 4 times F's products on at most 2.5 times its bytes:
// bound by the tensor cores.
#include <algorithm>

#include "gemm_sm90.cuh"

namespace gar {

// the ring, the epilogue tile, its two barriers, the alignment slack
template <int BN>
constexpr int kGemmSmem = gemm90::Tile<BN>::kRingBytes + gemm90::Tile<BN>::kOut + 2 * 8 + 1024;

struct EpiArgs {
  const float* bias;  // (N,) fp32
  const float* ls;    // (N,) fp32, kResidual only
};

// The GELU of the JAX kernels on fp32: the tanh form as h * sigmoid(2 u),
// which is 0.5 h (1 + tanh(u)) (no cancellation where tanh(u) nears -1;
// __expf overflows to inf for very negative h, and h / inf is 0), or the
// exact erf form.
template <int EPI>
__device__ __forceinline__ float activate(float h) {
  if constexpr (EPI == gemm90::kBiasGelu) {
    const float u = 0.7978845608028654f * (h + 0.044715f * h * h * h);
    return __fdividef(h, 1.f + __expf(-2.f * u));
  } else if constexpr (EPI == gemm90::kBiasGeluErf) {
    return 0.5f * h * (1.f + erff(h * 0.7071067811865476f));
  } else {
    return h;
  }
}

template <int EPI, int BN>
__global__ void __launch_bounds__(gemm90::kThreads, 1)
    gemm_sm90_kernel(const __grid_constant__ gemm90::Maps maps, const EpiArgs p,
                     const gemm90::Walk walk) {
  using namespace sm90;
  using gemm90::kBM;
  constexpr int kOut = gemm90::Tile<BN>::kOut;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const gemm90::Ring<BN> ring(sm);
  uint8_t* tile_buf = sm + gemm90::Tile<BN>::kRingBytes;
  uint64_t* x_full = reinterpret_cast<uint64_t*>(tile_buf + kOut);
  uint64_t* out_ready = x_full + 1;
  if (threadIdx.x == 0) {
    ring.init();
    mbar_init(x_full, 1);       // the tile is free (and holds x's TMA bytes)
    mbar_init(out_ready, 256);  // every consumer thread has written its outputs
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {  // producer warpgroup
    regs_dealloc<40>();
    if (threadIdx.x == 256) {
      gemm90::produce(maps, ring, walk);
    } else if (threadIdx.x == 288) {  // the epilogue's copies, one tile at a time
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < walk.tiles(); tile += gridDim.x) {
        const int m0 = tile / walk.n_tiles * kBM, atom0 = tile % walk.n_tiles * (BN / 64);
        bulk_wait_read<0>();  // the previous tile's store has read the buffer
        if constexpr (EPI == gemm90::kResidual) {
          mbar_arrive_expect_tx(x_full, kOut);
          tma_load_4d(tile_buf, &maps.c, x_full, 0, m0, atom0, 0);
        } else {
          mbar_arrive(x_full);
        }
        mbar_wait(out_ready, phase);
        phase ^= 1;
        tma_store_4d(&maps.out, tile_buf, 0, m0, atom0, 0);
        bulk_commit();
      }
      bulk_wait<0>();  // the stores are done before the CTA exits
    }
    return;
  }

  regs_alloc<232>();
  const int w = threadIdx.x >> 7, wi = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  // this thread's rows 64 w + 16 wi + g + 8 r of the tile, 4 bytes at column
  // pair 8 j + 2 t: atom j / 8, chunk j % 8 swizzled by the row (g mod 8)
  uint8_t* mine = tile_buf + (64 * w + 16 * wi + g) * 128 + 4 * t;
  int stage = 0;
  uint32_t phase = 0, x_phase = 0;
  float acc[BN / 128][64];
  for (int tile = blockIdx.x; tile < walk.tiles(); tile += gridDim.x) {
    gemm90::consume(acc, ring, walk.k_slabs, w, stage, phase);
    const int n0 = tile % walk.n_tiles * BN + 2 * t;
    mbar_wait(x_full, x_phase);
    x_phase ^= 1;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {  // columns 8 j .. 8 j + 7: acc[j / 16][4 (j % 16) ..]
      const float2 b2 = *reinterpret_cast<const float2*>(p.bias + n0 + 8 * j);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float* c = &acc[j >> 4][4 * (j & 15) + 2 * r];
        __nv_bfloat162* at = reinterpret_cast<__nv_bfloat162*>(
            mine + (j >> 3) * (kBM * 128) + r * 8 * 128 + (((j & 7) ^ g) << 4));
        if constexpr (EPI == gemm90::kResidual) {
          const float2 l2 = *reinterpret_cast<const float2*>(p.ls + n0 + 8 * j);
          const float2 x = __bfloat1622float2(*at);
          *at = __floats2bfloat162_rn(x.x + l2.x * (c[0] + b2.x), x.y + l2.y * (c[1] + b2.y));
        } else {
          *at = __floats2bfloat162_rn(activate<EPI>(c[0] + b2.x), activate<EPI>(c[1] + b2.y));
        }
      }
    }
    fence_proxy_async();  // the writes, to the TMA store
    mbar_arrive(out_ready);
  }
}

template <int EPI, int BN>
int launch_gemm(const gemm90::Maps& maps, const EpiArgs& p, int rows, int n, int k,
                cudaStream_t stream) {
  auto kernel = gemm_sm90_kernel<EPI, BN>;
  constexpr int smem = kGemmSmem<BN>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const gemm90::Walk walk{(rows + gemm90::kBM - 1) / gemm90::kBM, n / BN, k / gemm90::kBK};
  const int grid = std::min(walk.m_tiles * walk.n_tiles, sms);
  kernel<<<grid, gemm90::kThreads, smem, stream>>>(maps, p, walk);
  return static_cast<int>(cudaGetLastError());
}

namespace gemm90 {

int gemm(int epi, const void* a, const void* b, const void* c, const float* bias,
         const float* ls, void* out, int rows, int n, int k, cudaStream_t stream) {
  if (rows <= 0 || n <= 0 || k <= 0 || n % 128 || k % kBK)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool wide = epi != kResidual && n % 256 == 0;
  const int tile_atoms = wide ? 4 : 2;  // 64-column blocks a tile
  Maps maps{};
  int err = encode_matrix(&maps.a, a, rows, k, kBM, 1);
  if (!err) err = encode_matrix(&maps.b, b, k, n, kBK, tile_atoms);
  if (!err && epi == kResidual) err = encode_matrix(&maps.c, c, rows, n, kBM, tile_atoms);
  if (!err) err = encode_matrix(&maps.out, out, rows, n, kBM, tile_atoms);
  if (err) return err;
  const EpiArgs p{bias, ls};
  switch (epi) {
    case kResidual: return launch_gemm<kResidual, 128>(maps, p, rows, n, k, stream);
    case kBias:
      return wide ? launch_gemm<kBias, 256>(maps, p, rows, n, k, stream)
                  : launch_gemm<kBias, 128>(maps, p, rows, n, k, stream);
    case kBiasGelu:
      return wide ? launch_gemm<kBiasGelu, 256>(maps, p, rows, n, k, stream)
                  : launch_gemm<kBiasGelu, 128>(maps, p, rows, n, k, stream);
    case kBiasGeluErf:
      return wide ? launch_gemm<kBiasGeluErf, 256>(maps, p, rows, n, k, stream)
                  : launch_gemm<kBiasGeluErf, 128>(maps, p, rows, n, k, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace gemm90
}  // namespace gar

// Kernel F. attn, x, out (rows, d) bf16 contiguous; w (d, d) bf16 row-major
// (K, N); bias, ls (d,) fp32. d a multiple of 128; all bases 16-byte aligned.
extern "C" int gar_vit_wo_residual(const void* attn, const void* x, const void* w,
                                   const void* bias, const void* ls, void* out, int rows, int d,
                                   void* stream) {
  return gar::gemm90::gemm(gar::gemm90::kResidual, attn, w, x, static_cast<const float*>(bias),
                           static_cast<const float*>(ls), out, rows, d, d,
                           static_cast<cudaStream_t>(stream));
}

// One GEMM of the ViT block with epilogue `epi` (gemm90::Epilogue), as
// gemm90::gemm takes it: D's and G's parts on their own, for timing them.
extern "C" int gar_vit_gemm(int epi, const void* a, const void* b, const void* c,
                            const void* bias, const void* ls, void* out, int rows, int n, int k,
                            void* stream) {
  return gar::gemm90::gemm(epi, a, b, c, static_cast<const float*>(bias),
                           static_cast<const float*>(ls), out, rows, n, k,
                           static_cast<cudaStream_t>(stream));
}
