// Kernel F: out = bf16(x + ls * (attn @ wo + bo)), the ViT block's output
// projection with LayerScale and the residual add, for Hopper. Replaces
// grasp_any_region_tpu/ops/vit_block.py:vit_wo_residual (_wo_kernel): fp32
// sums, the branch and the residual add in fp32, one rounding.
//
// The product runs on the TMA + wgmma main loop of gemm_sm90.cuh: a
// persistent CTA an SM over 128 x 128 output tiles, a producer thread
// keeping five (attn, wo) K-slabs in flight, two consumer warpgroups on
// wgmma m64n128k16 with wo read MN-major as it is stored (K, N). The
// epilogue's global traffic is off the consumers' path: a second producer
// thread loads the tile's x rows by TMA into a 128 x 128 shared-memory
// tile while the products run; the
// consumers add bo, multiply by ls (ones when the layer has no
// LayerScale), add x from that tile and write the bf16 result over it in
// place; the second thread stores the tile by TMA (rows past `rows` are
// zero-filled on the way in and clipped on the way out) while the
// consumers start the next tile, and loads the next x once the store has
// read the tile. (Loads of x and stores of out straight from the
// accumulator registers, 4 bytes a thread, kept the tensor cores idle for
// about as long as the products took.)
//
// Bound: at gar_1b (rows 17 x 1025, K = N = 1024) 36.5 GFLOP, 0.0369 ms on
// the tensor cores, against 0.0326 ms for the bytes (attn, x, out, wo):
// nearly balanced.
#include <algorithm>

#include "gemm_sm90.cuh"

namespace gar {

constexpr int kWoTile = gemm90::kBM * gemm90::kBN * 2;  // two atoms of 128 rows x 128 bytes
// the ring, the epilogue tile, its two barriers, the alignment slack
constexpr int kWoSmem = gemm90::kRingBytes + kWoTile + 2 * 8 + 1024;

struct WoArgs {
  const float* bias;  // (N,) fp32
  const float* ls;    // (N,) fp32
};

__global__ void __launch_bounds__(gemm90::kThreads, 1)
    wo_residual_sm90_kernel(const __grid_constant__ gemm90::Maps maps, const WoArgs p,
                            const gemm90::Walk walk) {
  using namespace sm90;
  using gemm90::kBM;
  using gemm90::kBN;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const gemm90::Ring ring(sm);
  uint8_t* tile_buf = sm + gemm90::kRingBytes;
  uint64_t* x_full = reinterpret_cast<uint64_t*>(tile_buf + kWoTile);
  uint64_t* out_ready = x_full + 1;
  if (threadIdx.x == 0) {
    ring.init();
    mbar_init(x_full, 1);       // the x tile's TMA bytes
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
        const int m0 = tile / walk.n_tiles * kBM, atom0 = tile % walk.n_tiles * (kBN / 64);
        bulk_wait_read<0>();  // the previous tile's store has read the buffer
        mbar_arrive_expect_tx(x_full, kWoTile);
        tma_load_4d(tile_buf, &maps.c, x_full, 0, m0, atom0, 0);
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
  float acc[kBN / 2];
  for (int tile = blockIdx.x; tile < walk.tiles(); tile += gridDim.x) {
    gemm90::consume(acc, ring, walk.k_slabs, w, stage, phase);
    const int n0 = tile % walk.n_tiles * kBN + 2 * t;
    mbar_wait(x_full, x_phase);
    x_phase ^= 1;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      const float2 b2 = *reinterpret_cast<const float2*>(p.bias + n0 + 8 * j);
      const float2 l2 = *reinterpret_cast<const float2*>(p.ls + n0 + 8 * j);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        __nv_bfloat162* at = reinterpret_cast<__nv_bfloat162*>(
            mine + (j >> 3) * (kBM * 128) + r * 8 * 128 + (((j & 7) ^ g) << 4));
        const float2 x = __bfloat1622float2(*at);
        *at = __floats2bfloat162_rn(x.x + l2.x * (acc[4 * j + 2 * r] + b2.x),
                                    x.y + l2.y * (acc[4 * j + 2 * r + 1] + b2.y));
      }
    }
    fence_proxy_async();  // the writes, to the TMA store
    mbar_arrive(out_ready);
  }
}

int launch_wo_residual(const gemm90::Maps& maps, const WoArgs& p, int rows, int n, int k,
                       cudaStream_t stream) {
  auto kernel = wo_residual_sm90_kernel;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kWoSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const gemm90::Walk walk{(rows + gemm90::kBM - 1) / gemm90::kBM, n / gemm90::kBN,
                          k / gemm90::kBK};
  const int grid = std::min(walk.m_tiles * walk.n_tiles, sms);
  kernel<<<grid, gemm90::kThreads, kWoSmem, stream>>>(maps, p, walk);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace gar

// attn, x, out (rows, d) bf16 contiguous; w (d, d) bf16 row-major (K, N);
// bias, ls (d,) fp32. d a multiple of 128; all bases 16-byte aligned.
extern "C" int gar_vit_wo_residual(const void* attn, const void* x, const void* w,
                                   const void* bias, const void* ls, void* out, int rows, int d,
                                   void* stream) {
  if (rows <= 0 || d <= 0 || d % gar::gemm90::kBN)
    return static_cast<int>(cudaErrorInvalidValue);
  const cuuint64_t row_bytes = static_cast<cuuint64_t>(d) * 2;
  const cuuint64_t atoms = static_cast<cuuint64_t>(d / 64);
  // a (rows, d) or (d, d) matrix as (64 columns, rows, d / 64 column blocks
  // 128 bytes apart): a box of `box_rows` rows and `box_atoms` blocks
  auto encode = [&](CUtensorMap* map, const void* base, int n_rows, int box_rows,
                    int box_atoms) {
    const cuuint64_t dims[4] = {64, static_cast<cuuint64_t>(n_rows), atoms, 1};
    const cuuint64_t strides[3] = {row_bytes, 128, row_bytes * n_rows};
    const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(box_rows),
                               static_cast<cuuint32_t>(box_atoms), 1};
    return gar::encode_4d(map, base, false, dims, strides, box);
  };
  gar::gemm90::Maps maps;
  constexpr int tile_atoms = gar::gemm90::kBN / 64;  // 64-column blocks a tile
  int err = encode(&maps.a, attn, rows, gar::gemm90::kBM, 1);
  if (!err) err = encode(&maps.b, w, d, gar::gemm90::kBK, tile_atoms);
  if (!err) err = encode(&maps.c, x, rows, gar::gemm90::kBM, tile_atoms);
  if (!err) err = encode(&maps.out, out, rows, gar::gemm90::kBM, tile_atoms);
  if (err) return err;
  const gar::WoArgs p{static_cast<const float*>(bias), static_cast<const float*>(ls)};
  return gar::launch_wo_residual(maps, p, rows, d, d, static_cast<cudaStream_t>(stream));
}
