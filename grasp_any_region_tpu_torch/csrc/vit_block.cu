// Kernels D and G: the GEMMs of the fused ViT block that run on the shared
// tile of gemm_tile.cuh (F, the output projection, is the Hopper GEMM of
// gemm_sm90.cu). Activations are bf16 rows (T * S of them, the tiles of
// the batch flattened; the ragged edge is masked, nothing is padded), every
// sum is fp32, and the epilogues keep the JAX kernels' rounding points.
//
// D  replaces grasp_any_region_tpu/ops/vit_block.py:vit_ln_qkv (_ln_qkv_kernel):
//    LayerNorm(x) @ wqkv + bqkv. A block owns 64 rows x 256 output columns
//    (128 where N is not a multiple of 256); its prologue stages the 64 rows
//    (64 x D bf16: 129 KB at D = 1024, in dynamic shared memory) and
//    rewrites them as LayerNorm(x) rounded to bf16, which then stays
//    resident as the A operand while wqkv streams through. Each row's
//    LayerNorm is recomputed once per column block (3D / 256 = 12 times at
//    D = 1024), which is small next to the product.
// G  replaces vit_block.py:vit_mlp_residual (_mlp_kernel):
//    x + ls * (gelu(LayerNorm(x) @ fc1 + b1) @ fc2 + b2). The (rows, M)
//    hidden never reaches device memory. A cluster of two blocks owns 64
//    rows; each block keeps LayerNorm(x) of all 64 rows resident and walks
//    M in chunks of 256: fc1 for its half of the chunk's hidden columns,
//    GELU in fp32 rounded to bf16, written to its own and its peer's shared
//    memory (distributed shared memory), then fc2 of the whole chunk for
//    its half of the D output columns, into an fp32 accumulator of
//    64 x D/2 in registers (8 warps x 32 rows x D/8 columns: 128 floats a
//    thread at D = 1024; ptxas fits the kernel in 255 registers without
//    spills). So every weight byte read from L2 serves 64 rows, where one
//    block alone could hold the accumulator of 32 rows only (64 x 1024
//    fp32 is 256 KB, over a block's shared memory and register file).
//    Each cluster starts its walk over M at its own chunk, so the clusters
//    in flight read different weight slabs from L2 instead of all the same.
//
// At the main path's shapes both are bound by L2 bandwidth more than by
// the tensor cores: every 64-row block (cluster, for G) re-reads the whole
// weight from L2, 64 FLOP per byte read for G and 52 for D. This form uses
// mma.sync with a cp.async ring; the TMA + wgmma main loop of
// gemm_sm90.cuh, with their prologues, is the way to the card's rate.
#include <cooperative_groups.h>

#include "gemm_tile.cuh"

namespace cg = cooperative_groups;

namespace gar {

constexpr int kProjBM = 64;      // rows per block; 256 or 128 output columns
constexpr int kProjBK = 64;      // rows of a weight slab: fewer barriers than 32
constexpr int kProjStages = 2;   // a third 64-row slab would not fit beside the rows
constexpr int kProjThreads = 512;  // 16 warps: 2 (rows) x 8 (columns), 32 x BN/8 each

constexpr int kMlpBM = 64;       // rows per cluster of two blocks
constexpr int kMlpBH = 256;      // hidden columns per chunk; each block computes half
constexpr int kMlpBK1 = 64;      // fc1 slab rows
constexpr int kMlpBK2 = 16;      // fc2 slab rows
constexpr int kMlpStages = 3;
constexpr int kMlpThreads = 256;  // 8 warps: 2 (rows, 32 each) x 4 (columns)

struct ProjParams {
  const bf16* a;      // x, (rows, K)
  const float* ln_w;  // (K,)
  const float* ln_b;
  const bf16* w;      // (K, N)
  const float* bias;  // (N,)
  bf16* out;          // (rows, N)
  int rows, K, N;
  float eps;
};

template <int BN>
__global__ void __launch_bounds__(kProjThreads) proj_kernel(const ProjParams p) {
  constexpr int WN = BN / 8;  // columns per warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sA = reinterpret_cast<bf16*>(smem_raw);
  const int lda = p.K + kGemmPad;
  bf16* ring = sA + kProjBM * lda;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int r0 = blockIdx.y * kProjBM, n0 = blockIdx.x * BN;

  load_rows_async<kProjThreads>(sA, lda, p.a, p.K, r0, kProjBM, p.rows, tid);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  layer_norm_rows<kProjThreads>(sA, lda, p.K, kProjBM, p.ln_w, p.ln_b, p.eps, warp, lane);
  __syncthreads();

  const int wm = (warp >> 3) * 32, wn = (warp & 7) * WN;
  float acc[2][WN / 8][4];
  zero_acc<32, WN>(acc);
  gemm_resident_a<kProjBK, BN, kProjStages, 32, WN, kProjThreads>(
      acc, sA, lda, wm, p.w, p.N, p.K, n0, wn, ring, tid, lane);

  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = r0 + wm + i * 16 + g + hf * 8;
      if (row >= p.rows) continue;
#pragma unroll
      for (int j = 0; j < WN / 8; ++j) {
        const int col = n0 + wn + j * 8 + 2 * t;
        const long long at = static_cast<long long>(row) * p.N + col;
        *reinterpret_cast<uint32_t*>(p.out + at) =
            pack_bf16x2(acc[i][j][2 * hf] + p.bias[col], acc[i][j][2 * hf + 1] + p.bias[col + 1]);
      }
    }
  }
}

struct MlpParams {
  const bf16* x;      // (rows, D)
  const float* ln_w;  // (D,)
  const float* ln_b;
  const bf16* fc1;    // (D, M)
  const float* b1;    // (M,)
  const bf16* fc2;    // (M, D)
  const float* b2;    // (D,)
  const float* ls;    // (D,)
  bf16* out;          // (rows, D)
  int rows, M;
  float eps;
};

__device__ __forceinline__ float gelu_f32(float h, bool fast) {
  if (fast) return 0.5f * h * (1.f + tanhf(0.7978845608028654f * (h + 0.044715f * h * h * h)));
  return 0.5f * h * (1.f + erff(h * 0.7071067811865476f));
}

template <int D>
constexpr int mlp_ring_elems() {
  constexpr int a = kMlpStages * kMlpBK1 * (kMlpBH / 2 + kGemmPad);
  constexpr int b = kMlpStages * kMlpBK2 * (D / 2 + kGemmPad);
  return a > b ? a : b;
}

template <int D>
constexpr int mlp_smem_bytes() {
  return (kMlpBM * (D + kGemmPad) + kMlpBM * (kMlpBH + kGemmPad) + mlp_ring_elems<D>()) * 2;
}

// Block `rank` of the cluster: hidden columns [rank * BH/2, +BH/2) of each
// chunk, output columns [rank * D/2, +D/2).
template <int D, bool FAST_GELU>
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(kMlpThreads, 1)
mlp_kernel(const MlpParams p) {
  constexpr int HH = kMlpBH / 2, DN = D / 2;     // hidden and output columns per block
  constexpr int LDX = D + kGemmPad, LDH = kMlpBH + kGemmPad;
  constexpr int WN1 = HH / 4, WN2 = DN / 4;      // columns per warp: fc1, fc2
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sX = reinterpret_cast<bf16*>(smem_raw);
  bf16* sH = sX + kMlpBM * LDX;
  bf16* ring = sH + kMlpBM * LDH;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  bf16* sH_peer = cluster.map_shared_rank(sH, rank ^ 1);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp >> 2) * 32, wc = warp & 3;
  const int rb = blockIdx.x / 2, r0 = rb * kMlpBM;

  load_rows_async<kMlpThreads>(sX, LDX, p.x, D, r0, kMlpBM, p.rows, tid);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  layer_norm_rows<kMlpThreads>(sX, LDX, D, kMlpBM, p.ln_w, p.ln_b, p.eps, warp, lane);
  __syncthreads();

  float acc2[2][WN2 / 8][4];
  zero_acc<32, WN2>(acc2);
  const int chunks = p.M / kMlpBH;
  for (int c = 0; c < chunks; ++c) {
    const int m0 = ((c + rb) % chunks) * kMlpBH;
    float acc1[2][WN1 / 8][4];
    zero_acc<32, WN1>(acc1);
    gemm_resident_a<kMlpBK1, HH, kMlpStages, 32, WN1, kMlpThreads>(
        acc1, sX, LDX, wm, p.fc1, p.M, D, m0 + rank * HH, wc * WN1, ring, tid, lane);
    cluster.sync();  // the peer is done reading sH (its previous fc2)
    // GELU in fp32, rounded to bf16 before fc2, as the TPU kernel does
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
#pragma unroll
        for (int j = 0; j < WN1 / 8; ++j) {
          const int row = wm + i * 16 + g + hf * 8, col = rank * HH + wc * WN1 + j * 8 + 2 * t;
          const float v0 = gelu_f32(acc1[i][j][2 * hf] + p.b1[m0 + col], FAST_GELU);
          const float v1 = gelu_f32(acc1[i][j][2 * hf + 1] + p.b1[m0 + col + 1], FAST_GELU);
          const uint32_t h2 = pack_bf16x2(v0, v1);
          *reinterpret_cast<uint32_t*>(sH + row * LDH + col) = h2;
          *reinterpret_cast<uint32_t*>(sH_peer + row * LDH + col) = h2;
        }
    cluster.sync();  // both halves of the chunk's hidden are in both blocks
    gemm_resident_a<kMlpBK2, DN, kMlpStages, 32, WN2, kMlpThreads>(
        acc2, sH, LDH, wm, p.fc2 + static_cast<long long>(m0) * D, D, kMlpBH, rank * DN,
        wc * WN2, ring, tid, lane);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = r0 + wm + i * 16 + g + hf * 8;
      if (row >= p.rows) continue;
#pragma unroll
      for (int j = 0; j < WN2 / 8; ++j) {
        const int col = rank * DN + wc * WN2 + j * 8 + 2 * t;
        const long long at = static_cast<long long>(row) * D + col;
        const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p.x + at));
        const float v0 = x.x + p.ls[col] * (acc2[i][j][2 * hf] + p.b2[col]);
        const float v1 = x.y + p.ls[col + 1] * (acc2[i][j][2 * hf + 1] + p.b2[col + 1]);
        *reinterpret_cast<uint32_t*>(p.out + at) = pack_bf16x2(v0, v1);
      }
    }
}

// Opt in to more than 48 KB of dynamic shared memory, then launch.
template <typename Kernel, typename Params>
int launch_big_smem(Kernel kernel, dim3 grid, int threads, int smem, const Params& p,
                    cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, threads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int BN>
int launch_proj_bn(const ProjParams& p, cudaStream_t stream) {
  const int smem = (kProjBM * (p.K + kGemmPad) + kProjStages * kProjBK * (BN + kGemmPad)) * 2;
  const dim3 grid(p.N / BN, (p.rows + kProjBM - 1) / kProjBM);
  return launch_big_smem(proj_kernel<BN>, grid, kProjThreads, smem, p, stream);
}

// 256 columns a block where N allows (half the weight traffic per output
// and half the LayerNorm recomputation of 128), else 128.
int launch_proj(const ProjParams& p, cudaStream_t stream) {
  if (p.K % kProjBK || p.N % 128) return static_cast<int>(cudaErrorInvalidValue);
  if (p.N % 256 == 0) return launch_proj_bn<256>(p, stream);
  return launch_proj_bn<128>(p, stream);
}

template <int D>
int launch_mlp(const MlpParams& p, bool fast_gelu, cudaStream_t stream) {
  if (p.M % kMlpBH) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(2 * ((p.rows + kMlpBM - 1) / kMlpBM));  // two blocks a cluster
  if (fast_gelu)
    return launch_big_smem(mlp_kernel<D, true>, grid, kMlpThreads, mlp_smem_bytes<D>(), p, stream);
  return launch_big_smem(mlp_kernel<D, false>, grid, kMlpThreads, mlp_smem_bytes<D>(), p, stream);
}

}  // namespace gar

using gar::bf16;

extern "C" int gar_vit_ln_qkv(const void* x, const void* ln_w, const void* ln_b, const void* w,
                              const void* bias, void* out, int rows, int d, int n, float eps,
                              void* stream) {
  gar::ProjParams p{};
  p.a = static_cast<const bf16*>(x);
  p.ln_w = static_cast<const float*>(ln_w);
  p.ln_b = static_cast<const float*>(ln_b);
  p.w = static_cast<const bf16*>(w);
  p.bias = static_cast<const float*>(bias);
  p.out = static_cast<bf16*>(out);
  p.rows = rows;
  p.K = d;
  p.N = n;
  p.eps = eps;
  return gar::launch_proj(p, static_cast<cudaStream_t>(stream));
}

extern "C" int gar_vit_mlp_residual(const void* x, const void* ln_w, const void* ln_b,
                                    const void* fc1, const void* b1, const void* fc2,
                                    const void* b2, const void* ls, void* out, int rows, int d,
                                    int m, float eps, int fast_gelu, void* stream) {
  gar::MlpParams p{};
  p.x = static_cast<const bf16*>(x);
  p.ln_w = static_cast<const float*>(ln_w);
  p.ln_b = static_cast<const float*>(ln_b);
  p.fc1 = static_cast<const bf16*>(fc1);
  p.b1 = static_cast<const float*>(b1);
  p.fc2 = static_cast<const bf16*>(fc2);
  p.b2 = static_cast<const float*>(b2);
  p.ls = static_cast<const float*>(ls);
  p.out = static_cast<bf16*>(out);
  p.rows = rows;
  p.M = m;
  p.eps = eps;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {  // the fc2 accumulator's width is a compile-time register tile
    case 128: return gar::launch_mlp<128>(p, fast_gelu != 0, s);
    case 256: return gar::launch_mlp<256>(p, fast_gelu != 0, s);
    case 1024: return gar::launch_mlp<1024>(p, fast_gelu != 0, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
