// Kernels C, C8 and 16 for Hopper: one query token of GQA attention over
// one (layer, batch row, kv head) slab of the stacked (L, B, K, S, D)
// cache, split over the CTAs of a thread-block cluster (split-KV in one
// launch). C and C8 (Append) write the current token's K/V at column
// write_pos in place, C8 into an int8 cache; 16 (read only) finds the
// current token already in the cache there.
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
// The cache element type is a template parameter: bf16 with the append (C,
// and kernel 22 in decode_attn_wo_sm90.cu, which takes the body with its
// own epilogue) and read only (16); int8 with the append (C8).
//
// So is the head dim D: 64 for all four (GAR-1B), 128 for C (GAR-8B's
// decoder). At 128 a cache row is 256 bytes, sixteen 16-byte chunks, stored
// with the same swizzle (chunk c of row r at c ^ (r % 8): the XOR moves
// chunks within their 128-byte half, so ldmatrix's eight rows still hit
// eight different bank groups); S takes 8 k-steps, O is 16 n-tiles, a
// stage's 64 rows are 32 KB, and the partials merged over distributed
// shared memory are twice as wide. C8, 16 and 22 stay at 64.
//
// C8's cache holds 64-byte int8 rows with one fp32 scale per (layer, batch
// row, kv-head pair), loaded once a CTA. Its stages land as int8 through
// the same ring and flat index, unswizzled (a warp's 16-byte reads of its
// rows are contiguous), half of C's bytes a stage. Warp w reads only rows
// 16 w .. 16 w + 15 of a stage, so it widens those 16 K and 16 V rows
// itself to bf16(int8 * scale), as the TPU kernel dequantizes its blocks,
// into its own bf16 tile with C's swizzle, and after a __syncwarp runs
// C's ldmatrix / mma.sync code on that tile: no block barrier is added.
// Rank 0 writes the new column quantized with the static pair scale,
// clip(rint(x / s), -127, 127) (rint rounds half to even, as jnp.round
// does; a division, since a multiply by 1 / s can move a tie), and the
// current token enters as its dequantized fp32 value q * s, so this step
// sees what later steps read back.
#pragma once

#include <cooperative_groups.h>

#include "weight_tile.cuh"  // cp_async16, the cp.async ring, launch_ex, opt_in

namespace gar {

namespace cg = cooperative_groups;

constexpr int kSplitRows = 64;     // cache rows a stage, 16 a warp
constexpr int kSplitStages = 4;  // for C8 too: 6 and 8 int8 stages measured slower
constexpr int kSplitThreads = 128;
constexpr int kSplitMaxCluster = 16;  // Hopper's largest (non-portable) cluster
constexpr int kSplitWide = 16 * 64 * 2;  // bytes of a warp's 16 K (or V) rows widened to bf16

// Bytes of a stage's K (or V) rows, and of the kernel's shared memory: the
// ring (reused by the merge) and, for an int8 cache, each warp's widened K
// and V rows.
template <typename T, int D = 64>
__host__ __device__ constexpr int split_tile() {
  return kSplitRows * D * static_cast<int>(sizeof(T));
}
template <typename T, int D = 64>
__host__ __device__ constexpr int split_smem() {
  return kSplitStages * 2 * split_tile<T, D>() + (sizeof(T) == 1 ? 4 * 2 * kSplitWide : 0);
}
constexpr int kSplitSmem = split_smem<bf16>();
static_assert(4 * 8 * 66 * 4 + 8 * 66 * 4 <= kSplitStages * 2 * split_tile<int8_t>(),
              "the partials fit in the ring");
static_assert(4 * 8 * 130 * 4 + 8 * 130 * 4 <= kSplitStages * 2 * split_tile<bf16, 128>(),
              "the partials fit in the ring at D = 128");

// C8: x quantized with a pair's static scale s, as the TPU kernel does it.
__device__ __forceinline__ float quantize_q8(float x, float s) {
  return fminf(fmaxf(rintf(x / s), -127.f), 127.f);
}

// 16 int8 values widened to bf16(x * s), in order: the first 8 in lo, the
// last 8 in hi. x + 128 as the low byte of the float 2^23 + (x + 128),
// minus 2^23 + 128, is x exactly; the product rounds once, to fp32, then
// to bf16, as bf16(float(x) * s) does.
__device__ __forceinline__ void widen_scaled(const uint4& raw, float s, uint4& lo, uint4& hi) {
  constexpr float kMagic = 8388736.0f;  // 2^23 + 128
  const uint32_t in[4] = {raw.x, raw.y, raw.z, raw.w};
  uint32_t out[8];
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    const uint32_t u = in[w] ^ 0x80808080u;
    float f[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      f[e] = (__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650 + e)) - kMagic) * s;
    out[2 * w] = pack_bf16x2(f[0], f[1]);
    out[2 * w + 1] = pack_bf16x2(f[2], f[3]);
  }
  lo = make_uint4(out[0], out[1], out[2], out[3]);
  hi = make_uint4(out[4], out[5], out[6], out[7]);
}

struct SplitArgs {
  const bf16* q;  // (B, H, D)
  void* k_all;    // (L, B, K, S, D), C: updated at column write_pos
  void* v_all;
  const bf16* k_new;  // C: (B, K, D)
  const bf16* v_new;
  bf16* out;  // (B, H, D)
  const int* prompt_lens;  // (B,)
  const int* write_pos;    // ()
  const int* layer_index;  // 16: () on the card; C takes `layer`
  int layer, n_layers, batch, kv_heads, seq, prompt_pad;
  int block_s;  // 16: the TPU kernel's block of columns
  float scale;
  const float* k_scale;  // C8: (L, B, K / 2), one per (layer, batch row, kv-head pair)
  const float* v_scale;
};

// The body of a CTA of grid (splits, kv heads, batch), cluster (splits, 1,
// 1), over split_smem<T, D>() bytes of shared memory at `smem` (128-byte aligned):
// out(i, v) takes output i (query head i / D of the kv head, dim i % D) of
// the (kv head, row) in fp32, once for each i, in the CTA of rank i % splits.
// Returns after a cluster barrier that follows every out() and every remote
// read of the cluster, so shared memory is the caller's again (kernel 22
// stores each output into every CTA of the cluster from out()); 16's
// cluster returns before any barrier on a layer out of range.
template <typename T, int G, bool Append, int D = 64, typename Out>
__device__ __forceinline__ void decode_split_body(const SplitArgs& a, uint8_t* smem, Out out) {
  constexpr bool Q8 = sizeof(T) == 1;
  static_assert(sizeof(T) == 2 || (Q8 && Append), "bf16 rows, or C8's int8 rows");
  static_assert(G >= 1 && G <= 8, "the query heads of a kv head are the rows of one m16 tile");
  static_assert(D == 64 || (D == 128 && !Q8 && Append), "head dim 64, or 128 for C");
  constexpr int CPR = D * static_cast<int>(sizeof(T)) / 16;  // 16-byte chunks a row: 4, 8 or 16
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
  float ksc = 1.f, vsc = 1.f;  // C8: the pair's scales
  if constexpr (Q8) {
    const size_t si = (static_cast<size_t>(layer) * a.batch + b) * (a.kv_heads / 2) + kh / 2;
    ksc = a.k_scale[si];
    vsc = a.v_scale[si];
  }

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
      if constexpr (Q8) {
        kc[static_cast<size_t>(wpos) * D + tid] =
            static_cast<int8_t>(quantize_q8(__bfloat162float(kn[tid]), ksc));
        vc[static_cast<size_t>(wpos) * D + tid] =
            static_cast<int8_t>(quantize_q8(__bfloat162float(vn[tid]), vsc));
      } else {
        kc[static_cast<size_t>(wpos) * D + tid] = kn[tid];
        vc[static_cast<size_t>(wpos) * D + tid] = vn[tid];
      }
    }
    for (int gg = warp; gg < G; gg += kSplitThreads / 32) {  // q . k_new, each head once
      float part = 0.f;
#pragma unroll
      for (int c = 0; c < D / 64; ++c) {  // dims e, e + 1 of each 64
        const int e = 64 * c + 2 * lane;
        const float2 qf =
            __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(qp + gg * D + e));
        float2 kf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(kn + e));
        if constexpr (Q8)  // the dequantized value, as later steps read it back
          kf = make_float2(quantize_q8(kf.x, ksc) * ksc, quantize_q8(kf.y, ksc) * ksc);
        const float pair = qf.x * kf.x + qf.y * kf.y;
        part = c == 0 ? pair : part + pair;
      }
      const float dot = warp_sum(part);
      if (lane == 0) s_cur[gg] = dot * sl2;
    }
  }
  // Q as A fragments: a[0] = Q[g][16 kk + 2t ..], a[2] = Q[g][16 kk + 8 + 2t ..];
  // rows g + 8 (a[1], a[3]) and g >= G are zero
  uint32_t qa[D / 16][2];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    qa[kk][0] = g < G ? ld_u32(qp + g * D + 16 * kk + 2 * t) : 0u;
    qa[kk][1] = g < G ? ld_u32(qp + g * D + 16 * kk + 8 + 2 * t) : 0u;
  }

  constexpr int tile_bytes = split_tile<T, D>();
  auto k_stage = [&](int st) { return smem + st * 2 * tile_bytes; };
  auto v_stage = [&](int st) { return k_stage(st) + tile_bytes; };
  // tile j: flat rows f0 + 64 j + [0, 64) of K and V (bf16 swizzled, int8
  // as they are); past f1 as zeros
  auto load = [&](int j) {
    uint8_t* sk = k_stage(j % kSplitStages);
    uint8_t* sv = v_stage(j % kSplitStages);
#pragma unroll
    for (int i = 0; i < kSplitRows * CPR / kSplitThreads; ++i) {
      const int idx = tid + kSplitThreads * i, r = idx / CPR, c = idx % CPR;
      const int f = f0 + kSplitRows * j + r;
      const bool ok = f < f1;
      const size_t off =
          ok ? static_cast<size_t>(f < n1 ? f : lo2 + (f - n1)) * D + c * (16 / sizeof(T)) : 0;
      const int dst = 16 * (Q8 ? r * CPR + c : r * CPR + (c ^ (r & 7)));
      cp_async16(sk + dst, kc + off, ok ? 16 : 0);
      cp_async16(sv + dst, vc + off, ok ? 16 : 0);
    }
  };

  float o[D / 8][4], m_run = -INFINITY, l_run = 0.f;  // O's rows g (o[n][0..1]), g + 8 (unused)
#pragma unroll
  for (int n = 0; n < D / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  const int mi = lane >> 3, mr = lane & 7;  // ldmatrix: this lane's matrix and row in it

  auto use = [&](int j) {
    // this warp's keys 16 w .. 16 w + 15 of K and V as bf16 rows, swizzled
    const bf16* sk;
    const bf16* sv;
    if constexpr (Q8) {
      // the warp's widened rows, K then V (16 x 64 bf16 each), past the ring
      bf16* wide =
          reinterpret_cast<bf16*>(smem + kSplitStages * 2 * tile_bytes + warp * 2 * kSplitWide);
      const uint8_t* qk = k_stage(j % kSplitStages) + warp * 16 * 64;
      const uint8_t* qv = v_stage(j % kSplitStages) + warp * 16 * 64;
      __syncwarp();  // every lane is done reading the last stage's widened rows
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int idx = lane + 32 * h, r = idx >> 2, c = idx & 3;  // 16 dims 16 c .. of row r
        uint4 lo, hi;
        widen_scaled(*reinterpret_cast<const uint4*>(qk + 16 * idx), ksc, lo, hi);
        *reinterpret_cast<uint4*>(wide + r * D + (((2 * c) ^ (r & 7)) << 3)) = lo;
        *reinterpret_cast<uint4*>(wide + r * D + (((2 * c + 1) ^ (r & 7)) << 3)) = hi;
        widen_scaled(*reinterpret_cast<const uint4*>(qv + 16 * idx), vsc, lo, hi);
        *reinterpret_cast<uint4*>(wide + 16 * D + r * D + (((2 * c) ^ (r & 7)) << 3)) = lo;
        *reinterpret_cast<uint4*>(wide + 16 * D + r * D + (((2 * c + 1) ^ (r & 7)) << 3)) = hi;
      }
      __syncwarp();
      sk = wide;
      sv = wide + 16 * D;
    } else {
      sk = reinterpret_cast<const bf16*>(k_stage(j % kSplitStages)) + 16 * warp * D;
      sv = reinterpret_cast<const bf16*>(v_stage(j % kSplitStages)) + 16 * warp * D;
    }
    // S = Q K^T over keys 16 w .. 16 w + 15: n-tiles of 8 keys
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      // matrices: keys 0-7 dims 16 kk + [0, 8), + [8, 16); keys 8-15 the same
      const int key = mr + 8 * (mi >> 1), c = 2 * kk + (mi & 1);
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
    for (int np = 0; np < D / 16; ++np) {
      // matrices (transposed): keys 0-7 and 8-15 of dims 16 np + [0, 8), then of + [8, 16)
      const int key = mr + 8 * (mi & 1), c = 2 * np + (mi >> 1);
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
  float* wacc = wl + 4 * G;                    // [4][G][D]
  float* cm = wacc + 4 * G * D;                // [G]
  float* cl = cm + G;                          // [G]
  float* cacc = cl + G;                        // [G][D]
  l_run += __shfl_xor_sync(0xffffffffu, l_run, 1);
  l_run += __shfl_xor_sync(0xffffffffu, l_run, 2);
  if (g < G) {
    if (t == 0) {
      wm[warp * G + g] = m_run;
      wl[warp * G + g] = l_run;
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
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
      float v_cur = __bfloat162float(a.v_new[row * D + i % D]);
      if constexpr (Q8) v_cur = quantize_q8(v_cur, vsc) * vsc;
      l = p_cur;
      acc = p_cur * v_cur;
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

// Kernels C, C8 and 16: grid (splits, kv heads, batch), cluster (splits, 1, 1).
template <typename T, int G, bool Append, int D>
__global__ void __launch_bounds__(kSplitThreads) decode_split_kernel(const SplitArgs a) {
  extern __shared__ __align__(128) uint8_t smem[];
  bf16* out = a.out + (static_cast<size_t>(blockIdx.z) * a.kv_heads + blockIdx.y) * G * D;
  decode_split_body<T, G, Append, D>(a, smem,
                                     [&](int i, float v) { out[i] = __float2bfloat16(v); });
}

// One launch; the first opts the kernel in to its shared memory and to
// clusters of up to 16.
template <typename T, int G, bool Append, int D>
int launch_split(const SplitArgs& a, int splits, cudaStream_t stream) {
  static bool opted_in = false;
  const auto kernel = decode_split_kernel<T, G, Append, D>;
  constexpr int smem = split_smem<T, D>();
  const int err = opt_in(kernel, smem, true, opted_in);
  if (err) return err;
  return launch_ex(kernel, dim3(splits, a.kv_heads, a.batch), kSplitThreads, smem, splits, false,
                   stream, a);
}

}  // namespace gar
