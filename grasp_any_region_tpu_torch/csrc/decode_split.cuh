// Kernels C and 16 for Hopper: one query token of GQA attention over one
// (layer, batch row, kv head) slab of the stacked (L, B, K, S, 64) cache,
// split over the CTAs of a thread-block cluster (split-KV in one launch).
// C (Append) writes the current token's K/V at column write_pos in place;
// 16 (read only) finds the current token already in the cache there.
//
// C's valid columns are [0, min(prompt_len, prompt_pad)) and [prompt_pad,
// write_pos), read as one flat index, so the gap [prompt_len, prompt_pad)
// is never loaded. A cluster of `splits` CTAs serves one (kv head, batch
// row), and CTA r takes the equal, contiguous chunk [r c, (r + 1) c) of the
// flat index, c = ceil(total / splits); a chunk may be empty (total <
// splits), and in C never holds write_pos (the history ends before it). The
// step reads each valid K and V row once for all G = H / K query heads and
// does ~2 flops a byte, so it is bound by how fast the rows stream in; one
// block per (kv head, row) gave 8-16 busy SMs at B = 1-2, and the splits
// fill the card (ops/decode_attention.py:decode_splits picks them: 8 at
// B = 1-4 with 8 kv heads, which measured faster than 16).
//
// Each CTA (four warps) streams its chunk's rows through a ring of four
// 64-row stages with cp.async (16-byte copies, three stages in flight),
// every copy computing its own column from the flat index, so a stage can
// straddle the interval edge and rows past the chunk land as zeros. Rows
// are stored 128-byte swizzled (16-byte chunk c of row r at c ^ (r % 8)), so
// ldmatrix reads them without bank conflicts. Warp w scores rows 16 w ..
// 16 w + 15 of each stage on the tensor cores: S = Q K^T with the G query
// heads as the rows of an m16n8k16 A operand (rows past G are zeros), its
// own fp32 online softmax (exp2 of the scaled logits; a group of keys
// wholly masked leaves the sums untouched), p rounded to bf16 before O += P
// V (ldmatrix.trans on V). The warps merge in shared memory; the cluster
// syncs; CTA r then finishes the outputs r, r + splits, ... of the G x 64,
// reading every CTA's (m, l, acc) over distributed shared memory in rank
// order and, in C, folding in the current token from k_new / v_new (so no
// CTA reads the column that CTA 0 writes). An empty chunk's m = -inf weighs
// 0 by test, never by exp(-inf - -inf). No workspace, no atomics, one
// launch, and the result does not depend on timing.
//
// Kernel 16 (read only) takes the layer from a device int32 and the same
// flat index over [0, n1) and [max(prompt_pad, n1), write_pos]: write_pos
// inclusive, n1 = prompt_len cut at the end of the block_s block that holds
// write_pos (the TPU kernel visits blocks 0 .. write_pos / block_s, so a
// prompt column past that block is left out as there), and each column
// counted once where the prompt runs past prompt_pad. Nothing is written
// and nothing folded in: the merge's m comes from the chunks alone, and
// under the layout contract (prompt_pad <= write_pos < S) chunk 0 holds a
// column; a row with no valid column gives 0, not NaN. A layer outside
// [0, L) writes NaN rows: every CTA of a cluster reads the same layer, so
// all of them leave before the first cluster barrier.
//
// The cache element type is a template parameter, as decode_attend has it,
// so the int8 cache (C8) can move onto this body once its stages are
// widened; the bf16 cache is instantiated, with the append (C, and kernel 22
// in decode_attn_wo_sm90.cu, which takes the body with its own epilogue)
// and read only (16).
#pragma once

#include <cooperative_groups.h>

#include "weight_tile.cuh"  // cp_async16, the cp.async ring, launch_ex, opt_in

namespace gar {

namespace cg = cooperative_groups;

constexpr int kSplitRows = 64;     // cache rows a stage, 16 a warp
constexpr int kSplitStages = 4;
constexpr int kSplitThreads = 128;
constexpr int kSplitMaxCluster = 16;  // Hopper's largest (non-portable) cluster
constexpr int kSplitTile = kSplitRows * 64 * 2;  // bytes of a stage's K (or V) rows
constexpr int kSplitSmem = kSplitStages * 2 * kSplitTile;  // the ring, reused by the merge
static_assert(4 * 8 * 66 * 4 + 8 * 66 * 4 <= kSplitSmem, "the partials fit in the ring");

struct SplitArgs {
  const bf16* q;  // (B, H, 64)
  void* k_all;    // (L, B, K, S, 64), C: updated at column write_pos
  void* v_all;
  const bf16* k_new;  // C: (B, K, 64)
  const bf16* v_new;
  bf16* out;  // (B, H, 64)
  const int* prompt_lens;  // (B,)
  const int* write_pos;    // ()
  const int* layer_index;  // 16: () on the card; C takes `layer`
  int layer, n_layers, batch, kv_heads, seq, prompt_pad;
  int block_s;  // 16: the TPU kernel's block of columns
  float scale;
};

// The body of a CTA of grid (splits, kv heads, batch), cluster (splits, 1,
// 1), over kSplitSmem bytes of shared memory at `smem` (128-byte aligned):
// out(i, v) takes output i (query head i / 64 of the kv head, dim i % 64) of
// the (kv head, row) in fp32, once for each i, in the CTA of rank i % splits.
// Returns after a cluster barrier that follows every out() and every remote
// read of the cluster, so shared memory is the caller's again (kernel 22
// stores each output into every CTA of the cluster from out()); 16's
// cluster returns before any barrier on a layer out of range.
template <typename T, int G, bool Append, typename Out>
__device__ __forceinline__ void decode_split_body(const SplitArgs& a, uint8_t* smem, Out out) {
  static_assert(sizeof(T) == 2, "bf16 rows: an int8 cache needs its stages widened first");
  static_assert(G >= 1 && G <= 8, "the query heads of a kv head are the rows of one m16 tile");
  constexpr int D = 64;
  constexpr float kLog2e = 1.4426950408889634f;
  __shared__ float s_cur[G];  // C: the current token's logit, log2 units
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int splits = static_cast<int>(cluster.num_blocks());
  const int kh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const size_t row = static_cast<size_t>(b) * a.kv_heads + kh;
  int layer = a.layer;
  if constexpr (!Append) {
    layer = a.layer_index[0];
    if (layer < 0 || layer >= a.n_layers) {  // the whole cluster leaves here
      for (int i = rank + splits * tid; i < G * D; i += splits * kSplitThreads)
        out(i, __int_as_float(0x7fc00000));
      return;
    }
  }
  const size_t slab = (static_cast<size_t>(layer) * a.batch * a.kv_heads + row) *
                      static_cast<size_t>(a.seq) * D;
  T* kc = static_cast<T*>(a.k_all) + slab;
  T* vc = static_cast<T*>(a.v_all) + slab;
  const bf16* qp = a.q + row * G * D;
  const float sl2 = a.scale * kLog2e;

  // the valid columns [0, n1) and [lo2, hi) as one flat index, and this CTA's chunk
  const int wpos = a.write_pos[0];
  int hi, n1, lo2;
  if constexpr (Append) {
    hi = min(wpos, a.seq);
    n1 = max(min(min(a.prompt_lens[b], a.prompt_pad), hi), 0);
    lo2 = a.prompt_pad;
  } else {
    hi = min(wpos + 1, a.seq);
    n1 = max(min(min(a.prompt_lens[b], (wpos / a.block_s + 1) * a.block_s), a.seq), 0);
    lo2 = max(a.prompt_pad, n1);
  }
  const int total = n1 + max(hi - lo2, 0);
  const int chunk = (total + splits - 1) / splits;
  const int f0 = min(total, rank * chunk), f1 = min(total, f0 + chunk);
  const int n_tiles = (f1 - f0 + kSplitRows - 1) / kSplitRows;

  if constexpr (Append) {
    const bf16* kn = a.k_new + row * D;
    const bf16* vn = a.v_new + row * D;
    if (rank == 0 && tid < D && wpos >= 0 && wpos < a.seq) {
      kc[static_cast<size_t>(wpos) * D + tid] = kn[tid];
      vc[static_cast<size_t>(wpos) * D + tid] = vn[tid];
    }
    for (int gg = warp; gg < G; gg += kSplitThreads / 32) {  // q . k_new, each head once
      const float2 qf = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(qp + gg * D + 2 * lane));
      const float2 kf =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(kn + 2 * lane));
      const float dot = warp_sum(qf.x * kf.x + qf.y * kf.y);
      if (lane == 0) s_cur[gg] = dot * sl2;
    }
  }
  // Q as A fragments: a[0] = Q[g][16 kk + 2t ..], a[2] = Q[g][16 kk + 8 + 2t ..];
  // rows g + 8 (a[1], a[3]) and g >= G are zero
  uint32_t qa[4][2];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    qa[kk][0] = g < G ? ld_u32(qp + g * D + 16 * kk + 2 * t) : 0u;
    qa[kk][1] = g < G ? ld_u32(qp + g * D + 16 * kk + 8 + 2 * t) : 0u;
  }

  auto k_stage = [&](int st) { return reinterpret_cast<bf16*>(smem + st * 2 * kSplitTile); };
  auto v_stage = [&](int st) { return k_stage(st) + kSplitRows * D; };
  // tile j: flat rows f0 + 64 j + [0, 64) of K and V, swizzled; past f1 as zeros
  auto load = [&](int j) {
    bf16* sk = k_stage(j % kSplitStages);
    bf16* sv = v_stage(j % kSplitStages);
#pragma unroll
    for (int i = 0; i < kSplitRows * 8 / kSplitThreads; ++i) {
      const int idx = tid + kSplitThreads * i, r = idx >> 3, c = idx & 7;
      const int f = f0 + kSplitRows * j + r;
      const bool ok = f < f1;
      const size_t off = ok ? static_cast<size_t>(f < n1 ? f : lo2 + (f - n1)) * D + 8 * c : 0;
      const int dst = r * D + ((c ^ (r & 7)) << 3);
      cp_async16(sk + dst, kc + off, ok ? 16 : 0);
      cp_async16(sv + dst, vc + off, ok ? 16 : 0);
    }
  };

  float o[8][4], m_run = -INFINITY, l_run = 0.f;  // O's rows g (o[n][0..1]) and g + 8 (unused)
#pragma unroll
  for (int n = 0; n < 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  const int mi = lane >> 3, mr = lane & 7;  // ldmatrix: this lane's matrix and row in it

  auto use = [&](int j) {
    const bf16* sk = k_stage(j % kSplitStages);
    const bf16* sv = v_stage(j % kSplitStages);
    // S = Q K^T over keys 16 w .. 16 w + 15: n-tiles of 8 keys
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      // matrices: keys 0-7 dims 16 kk + [0, 8), + [8, 16); keys 8-15 the same
      const int key = 16 * warp + mr + 8 * (mi >> 1), c = 2 * kk + (mi & 1);
      uint32_t kb[4];
      ldmatrix_x4(kb, sk + key * D + ((c ^ (key & 7)) << 3));
      const uint32_t af[4] = {qa[kk][0], 0u, qa[kk][1], 0u};
      mma_bf16_16816(s[0], af, kb[0], kb[1]);
      mma_bf16_16816(s[1], af, kb[2], kb[3]);
    }
    // online softmax of row g over this warp's 16 keys (flat f0 + 64 j + 16 w + 8 n + 2 t + e)
    const int fk = f0 + kSplitRows * j + 16 * warp + 2 * t;
    float mx = -INFINITY;
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (fk + 8 * n + e >= f1) s[n][e] = -INFINITY;
        mx = fmaxf(mx, s[n][e]);
      }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m_run, mx * sl2);
    const float base = m_new == -INFINITY ? 0.f : m_new;
    const float alpha = exp2f(m_run - base);
    float p[2][2], rsum = 0.f;
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        p[n][e] = exp2f(fmaf(s[n][e], sl2, -base));
        rsum += p[n][e];
      }
    l_run = l_run * alpha + rsum;
    m_run = m_new;
    // P (16 x 16 keys) as an A fragment, rounded to bf16: row g only
    const uint32_t pa[4] = {pack_bf16x2(p[0][0], p[0][1]), 0u, pack_bf16x2(p[1][0], p[1][1]), 0u};
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      // matrices (transposed): keys 0-7 and 8-15 of dims 16 np + [0, 8), then of + [8, 16)
      const int key = 16 * warp + mr + 8 * (mi & 1), c = 2 * np + (mi >> 1);
      uint32_t vb[4];
      ldmatrix_x4_trans(vb, sv + key * D + ((c ^ (key & 7)) << 3));
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        o[2 * np + h][0] *= alpha;
        o[2 * np + h][1] *= alpha;
        mma_bf16_16816(o[2 * np + h], pa, vb[2 * h], vb[2 * h + 1]);
      }
    }
  };
  ring<kSplitStages>(n_tiles, load, use);  // ends with a barrier: the ring is free

  // the warps' partials, then the CTA's (the warps merged), in the ring's memory
  float* wm = reinterpret_cast<float*>(smem);  // [4][G] row maxima, log2 units
  float* wl = wm + 4 * G;                      // [4][G] sums
  float* wacc = wl + 4 * G;                    // [4][G][64]
  float* cm = wacc + 4 * G * D;                // [G]
  float* cl = cm + G;                          // [G]
  float* cacc = cl + G;                        // [G][64]
  l_run += __shfl_xor_sync(0xffffffffu, l_run, 1);
  l_run += __shfl_xor_sync(0xffffffffu, l_run, 2);
  if (g < G) {
    if (t == 0) {
      wm[warp * G + g] = m_run;
      wl[warp * G + g] = l_run;
    }
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      wacc[(warp * G + g) * D + 8 * n + 2 * t] = o[n][0];
      wacc[(warp * G + g) * D + 8 * n + 2 * t + 1] = o[n][1];
    }
  }
  __syncthreads();
  for (int i = tid; i < G * D; i += kSplitThreads) {
    const int gg = i / D;
    float m = -INFINITY;
#pragma unroll
    for (int w = 0; w < 4; ++w) m = fmaxf(m, wm[w * G + gg]);
    float l = 0.f, acc = 0.f;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const float mw = wm[w * G + gg];
      const float f = mw == -INFINITY ? 0.f : exp2f(mw - m);
      l += f * wl[w * G + gg];
      acc += f * wacc[(w * G + gg) * D + i % D];
    }
    cacc[i] = acc;
    if (i % D == 0) {
      cm[gg] = m;
      cl[gg] = l;
    }
  }
  cluster.sync();  // every CTA's partial written and visible to the cluster

  // outputs rank, rank + splits, ...: the CTAs in rank order, then (C) the
  // current token; every remote load issued before the first is used
  for (int i = rank + splits * tid; i < G * D; i += splits * kSplitThreads) {
    const int gg = i / D;
    float m_r[kSplitMaxCluster], l_r[kSplitMaxCluster], acc_r[kSplitMaxCluster];
#pragma unroll
    for (int r = 0; r < kSplitMaxCluster; ++r) {
      if (r < splits) {
        m_r[r] = *cluster.map_shared_rank(cm + gg, r);
        l_r[r] = *cluster.map_shared_rank(cl + gg, r);
        acc_r[r] = *cluster.map_shared_rank(cacc + i, r);
      }
    }
    float m = Append ? s_cur[gg] : -INFINITY;
#pragma unroll
    for (int r = 0; r < kSplitMaxCluster; ++r)
      if (r < splits) m = fmaxf(m, m_r[r]);
    float l = 0.f, acc = 0.f;
    if constexpr (Append) {
      const float p_cur = exp2f(s_cur[gg] - m);
      l = p_cur;
      acc = p_cur * __bfloat162float(a.v_new[row * D + i % D]);
    }
#pragma unroll
    for (int r = 0; r < kSplitMaxCluster; ++r) {
      if (r < splits) {
        const float f = m_r[r] == -INFINITY ? 0.f : exp2f(m_r[r] - m);
        l += f * l_r[r];
        acc += f * acc_r[r];
      }
    }
    out(i, acc / fmaxf(l, 1e-30f));
  }
  cluster.sync();  // no CTA leaves while another reads its shared memory
}

// Kernels C and 16: grid (splits, kv heads, batch), cluster (splits, 1, 1).
template <typename T, int G, bool Append>
__global__ void __launch_bounds__(kSplitThreads) decode_split_kernel(const SplitArgs a) {
  extern __shared__ __align__(128) uint8_t smem[];
  bf16* out = a.out + (static_cast<size_t>(blockIdx.z) * a.kv_heads + blockIdx.y) * G * 64;
  decode_split_body<T, G, Append>(a, smem, [&](int i, float v) { out[i] = __float2bfloat16(v); });
}

// One launch; the first opts the kernel in to its shared memory and to
// clusters of up to 16.
template <typename T, int G, bool Append>
int launch_split(const SplitArgs& a, int splits, cudaStream_t stream) {
  static bool opted_in = false;
  const auto kernel = decode_split_kernel<T, G, Append>;
  const int err = opt_in(kernel, kSplitSmem, true, opted_in);
  if (err) return err;
  return launch_ex(kernel, dim3(splits, a.kv_heads, a.batch), kSplitThreads, kSplitSmem, splits,
                   false, stream, a);
}

}  // namespace gar
