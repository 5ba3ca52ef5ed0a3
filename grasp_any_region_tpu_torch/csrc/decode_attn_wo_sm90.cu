// Kernel 22 for Hopper: the mega decode step's attention, wo and residual in
// one launch. Replaces grasp_any_region_tpu/ops/decode_megakernel.py:
// decode_attention_wo (_attn_wo_kernel): write k_new / v_new at column
// write_pos of the layer's (B, K, S, 64) bf16 cache slab, attend one query
// token over [0, prompt_len) and [prompt_pad, write_pos] (the current token
// folded in from k_new / v_new), round a to bf16, multiply it by the kv
// head's G * 64 rows of wo[layer] (bf16, or int8 with the fp32 column scale
// on the fp32 partial), sum the K kv heads in head order, add x and round
// once.
//
// What bounds it: the valid cache columns (read once for the G query heads)
// and wo (GAR-1B: 9.5 MB of cache at B = 1 and 8.4 MB of wo, 5.4 us at
// 3.35 TB/s). The design:
//
//  * The attention is kernel C's split-KV cluster body (decode_split.cuh,
//    Append): a cluster of S CTAs per (kv head, batch row), S from
//    ops/decode_attention.py:decode_splits (8 at B = 1-4, 2 at B = 24 with
//    8 kv heads; 64 CTAs at B = 1). Its merge hands each output of the
//    (G x 64) a to this kernel's epilogue, which rounds it to bf16 and
//    stores it into every CTA of the cluster (distributed shared memory);
//    the body's last cluster barrier makes a whole everywhere.
//  * wo is tiled over the cluster: CTA r owns the column slice [r dm / S,
//    (r + 1) dm / S) (whole 128-byte column chunks) of the kv head's G * 64
//    rows, read by TMA from one cached tensor map over the (L, H 64, dm)
//    stack in boxes of one query head's 64 rows x 128 bytes. Where the slice
//    fits (at most 128 KB) and the grid fits the card at one CTA an SM (B =
//    1-2 at GAR-1B), the CTA asks for the whole slice at its start, so it
//    lands while the attention streams the cache; otherwise the boxes stream
//    through C's ring once the attention is done. wo is loaded with an L2
//    evict-last policy: the B clusters of a kv head read the same boxes.
//  * a @ the slice on the tensor cores: mma.sync m16n8k16 with a as row 0
//    of the A operand, the box as B through ldmatrix.trans (int8 widened
//    exactly), four warps a quarter of a chunk's columns each; the chunk's
//    (1, columns) fp32 partial goes to the (row, kv head) slot of a
//    workspace.
//  * The K kv heads' partials of a column slice meet in its ordered
//    last-arriver sum (ordered_sum.cuh): in head order, plus x, rounded
//    once; no atomics on the data, the counters 0 between launches.
//  * It launches as a programmatic dependent: the resident wo boxes are
//    asked for before griddepcontrol.wait; the cache, q, k_new / v_new and x
//    are read after it.
//
// Limits: head_dim 64, 1, 2, 4 or 8 query heads per kv head, at most 8 kv
// heads, B <= 32, dm a multiple of 16, clusters of 1-16.
#include <cooperative_groups.h>

#include "decode_split.cuh"
#include "ordered_sum.cuh"
#include "sm90.cuh"

namespace gar {

constexpr int kWoBox = 64 * 128;                   // bytes of a box: 64 rows x 128 bytes
constexpr int kWoRingSlots = kSplitSmem / kWoBox;  // boxes in C's ring once it is free: 8
constexpr int kWoResidentSlots = 16;               // a slice of up to 128 KB asked for at the start
constexpr int kWoSmemCap = 1024 + kSplitSmem + kWoResidentSlots * kWoBox;
constexpr int kWoMaxRows = 32;
constexpr int kWoMaxCounters = 1024;               // B x S slices, two counters each

struct AttnWoArgs {
  SplitArgs s;            // C's attention (s.out unused)
  const float* wo_scale;  // int8: (dm,) at the layer
  const bf16* x;          // (B, dm)
  bf16* out;              // (B, dm)
  float* ws;              // (B, K, dm): the slot of a (row, kv head)
  unsigned* counters;     // (B, S) slices x 2, 0 between launches
  int dm;
  int resident;  // 1: each CTA's wo slice asked for whole at the start
};

// Grid (S, K, B), cluster (S, 1, 1).
template <typename W, int G>
__global__ void __launch_bounds__(kSplitThreads)
    attention_wo_kernel(const __grid_constant__ CUtensorMap wo_map, const AttnWoArgs a) {
  using namespace sm90;
  constexpr int D = 64, CPB = 128 / sizeof(W), NT = CPB / 32;
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t full[kWoResidentSlots], empty[kWoRingSlots];
  __shared__ __align__(16) bf16 abuf[G * D];  // a, rounded: every CTA of the cluster holds it
  __shared__ int list[1], last;
  uint8_t* sm = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* wo_smem = a.resident ? sm + kSplitSmem : sm;  // the slice, or C's ring once free
  const int slots = a.resident ? kWoResidentSlots : kWoRingSlots;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int splits = static_cast<int>(cluster.num_blocks());
  const int kh = blockIdx.y, kv = gridDim.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int chunks = (a.dm + CPB - 1) / CPB, per = (chunks + splits - 1) / splits;
  const int ch0 = min(chunks, rank * per), n_ch = min(chunks, ch0 + per) - ch0;
  const int n_box = n_ch * G;  // box j: column chunk ch0 + j / G, query head j % G
  const int row0 = kh * G * D;  // the kv head's first row of wo[layer]
  auto issue = [&](int j, int slot) {  // B clusters read each box: keep it in the L2
    mbar_arrive_expect_tx(&full[slot], kWoBox);
    tma_load_4d_hint(wo_smem + slot * kWoBox, &wo_map, &full[slot], (ch0 + j / G) * CPB,
                     row0 + (j % G) * D, a.s.layer, 0, l2_evict_last());
  };
  if (tid == 0) {
    for (int i = 0; i < kWoResidentSlots; ++i) mbar_init(&full[i], 1);
    for (int i = 0; i < kWoRingSlots; ++i) mbar_init(&empty[i], kSplitThreads / 32);
    mbar_fence_init();
    list[0] = b * splits + rank;  // the ordered sum's slice
    last = 0;
    if (a.resident)  // wo never depends on the kernels before
      for (int j = 0; j < n_box; ++j) issue(j, j);
  }
  __syncthreads();
  grid_dependency_wait();  // the cache, q, k_new / v_new and x are the kernels before's

  decode_split_body<bf16, G, true>(a.s, sm, [&](int i, float v) {
    const bf16 h = __float2bfloat16(v);  // a rounded to bf16 before wo, as the TPU kernel
    for (int r = 0; r < splits; ++r) *cluster.map_shared_rank(abuf + i, r) = h;
  });
  // a is whole in every CTA of the cluster, and C's ring is free
  if (!a.resident) {
    fence_proxy_async();  // the ring's generic reads and writes before TMA refills it
    __syncthreads();
    if (tid == 0)
      for (int j = 0; j < min(slots, n_box); ++j) issue(j, j);
  }

  const int wn = warp * (CPB / 4);
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  for (int j = 0; j < n_box; ++j) {
    const int slot = j % slots, gg = j % G;
    mbar_wait(&full[slot], (j / slots) & 1);
    const uint8_t* box = wo_smem + slot * kWoBox;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      // a as row 0 of the A operand (rows 1-15 zero): a[0] = a[16 kk + 2t ..], a[2] = + 8
      const bf16* ap = abuf + gg * D + 16 * kk + 2 * t;
      const uint32_t af[4] = {g == 0 ? ld_u32(ap) : 0u, 0u, g == 0 ? ld_u32(ap + 8) : 0u, 0u};
      uint32_t raw[4], bfr[NT][2];
      box_frags(raw, box, 16 * kk, 2 * warp, lane);
      b_frags<W, NT>(bfr, raw);
#pragma unroll
      for (int n = 0; n < NT; ++n) mma_bf16_16816(acc[n], af, bfr[n][0], bfr[n][1]);
    }
    if (!a.resident) {  // hand the slot back; thread 0 refills it
      fence_proxy_async();
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[slot]);
      if (tid == 0 && j + slots < n_box) {
        mbar_wait(&empty[slot], (j / slots) & 1);
        issue(j + slots, slot);
      }
      __syncwarp();
    }
    if (gg == G - 1) {  // the chunk's columns have all G * 64 rows: row 0's sums to the slot
      const int c0 = (ch0 + j / G) * CPB;
      if (g == 0) {
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = c0 + frag_col<W>(n, e, wn, t);
            if (col < a.dm) {
              float v = acc[n][e];
              if constexpr (sizeof(W) == 1) v *= a.wo_scale[col];
              a.ws[(static_cast<size_t>(b) * kv + kh) * a.dm + col] = v;
            }
          }
      }
#pragma unroll
      for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
    }
  }
  // the K kv heads' partials of this column slice, in head order, plus x
  // (K <= 8: one group of the ordered sum)
  if (n_ch > 0) {
    const int c0 = ch0 * CPB, slice = b * splits + rank;
    const SumPlan plan{a.ws + static_cast<size_t>(b) * kv * a.dm, a.dm, 0, kv, 1,
                       a.x + static_cast<size_t>(b) * a.dm, a.out + static_cast<size_t>(b) * a.dm,
                       0, a.counters};
    __syncthreads();  // every warp's stores of the slot are issued
    if (tid == 0) last = sum_completed(plan, slice, kh, sum_arrive(plan, slice, kh));
    __syncthreads();
    if (last)
      sum_finish<kSplitThreads, 2>(plan, kh, min(a.dm, (ch0 + n_ch) * CPB) - c0, list, 1, &last,
                                [&](int) { return c0; }, tid, [] { __syncthreads(); });
  }
}

// The SM count of the current card.
static int sm_count() {
  static int n[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (n[dev] == 0) cudaDeviceGetAttribute(&n[dev], cudaDevAttrMultiProcessorCount, dev);
  return n[dev];
}

template <typename W, int G>
int launch_attention_wo(const CUtensorMap& map, AttnWoArgs a, int splits, cudaStream_t stream) {
  constexpr int CPB = 128 / sizeof(W);
  const auto kernel = attention_wo_kernel<W, G>;
  static bool opted_in = false;
  if (const int err = opt_in(kernel, kWoSmemCap, true, opted_in)) return err;
  const int chunks = (a.dm + CPB - 1) / CPB, per = (chunks + splits - 1) / splits;
  a.resident = per * G <= kWoResidentSlots && a.s.batch * a.s.kv_heads * splits <= sm_count();
  const int smem = 1024 + kSplitSmem + (a.resident ? kWoResidentSlots * kWoBox : 0);
  return launch_ex(kernel, dim3(splits, a.s.kv_heads, a.s.batch), kSplitThreads, smem, splits,
                   true, stream, map, a);
}

template <typename W>
int attention_wo(const CUtensorMap& map, const AttnWoArgs& a, int heads, int splits,
                 cudaStream_t stream) {
  switch (heads / a.s.kv_heads) {
    case 1: return launch_attention_wo<W, 1>(map, a, splits, stream);
    case 2: return launch_attention_wo<W, 2>(map, a, splits, stream);
    case 4: return launch_attention_wo<W, 4>(map, a, splits, stream);
    case 8: return launch_attention_wo<W, 8>(map, a, splits, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace gar

using gar::bf16;

// Kernel 22 over layer `layer` of the (n_layers, B, K, S, 64) bf16 cache
// (written at write_pos) and of wo (n_layers, heads * 64, dm), bf16 or
// (wo_int8) int8 with wo_scale (n_layers, 1, dm); clusters of `splits`
// CTAs (1-16) a (kv head, row). ws: (B, K, dm) fp32; counters: 2 B splits
// unsigned, 0 (and left at 0).
extern "C" int gar_decode_attention_wo(const void* q, void* k_all, void* v_all, const void* k_new,
                                       const void* v_new, const void* wo, const void* wo_scale,
                                       const void* x, void* out, void* ws, void* counters,
                                       const void* prompt_lens, const void* write_pos, int layer,
                                       int n_layers, int batch, int heads, int kv_heads, int seq,
                                       int head_dim, int dm, int prompt_pad, int wo_int8,
                                       int splits, float scale, void* stream) {
  using namespace gar;
  if (head_dim != 64 || kv_heads <= 0 || kv_heads > 8 || heads % kv_heads || batch < 1 ||
      batch > kWoMaxRows || dm <= 0 || dm % 16 || layer < 0 || layer >= n_layers || splits < 1 ||
      splits > kSplitMaxCluster || 2 * batch * splits > kWoMaxCounters)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map;
  const int eb = wo_int8 ? 1 : 2;
  if (const int err = stacked_weight_map(&map, wo, eb, n_layers, heads * 64, dm, 128 / eb, 64))
    return err;
  AttnWoArgs a{};
  a.s = SplitArgs{static_cast<const bf16*>(q), k_all, v_all, static_cast<const bf16*>(k_new),
                  static_cast<const bf16*>(v_new), nullptr, static_cast<const int*>(prompt_lens),
                  static_cast<const int*>(write_pos), nullptr, layer, n_layers, batch, kv_heads,
                  seq, prompt_pad, 0, scale};
  a.wo_scale = wo_int8 ? static_cast<const float*>(wo_scale) + static_cast<size_t>(layer) * dm
                       : nullptr;
  a.x = static_cast<const bf16*>(x);
  a.out = static_cast<bf16*>(out);
  a.ws = static_cast<float*>(ws);
  a.counters = static_cast<unsigned*>(counters);
  a.dm = dm;
  const auto st = static_cast<cudaStream_t>(stream);
  return wo_int8 ? attention_wo<int8_t>(map, a, heads, splits, st)
                 : attention_wo<bf16>(map, a, heads, splits, st);
}
