// Kernels A, B and E: the flash attention forward (FA-2 recurrences, FA-3's
// schedule) for Hopper.
//
// B replaces grasp_any_region_tpu/ops/flash_attention.py:flash_attention
// (_flash_kernel): q (B, Sq, H, D), k/v (B, Sk, K, D) bf16 through
// strides, causal (right-aligned by q_offset = Sk - Sq) or full, GQA by
// index (kv head = h / (H / K), no repeated K/V), optional fp32 (B, H, Sq)
// log-sum-exp for the backward and (B, S) int32 segment ids for packed
// self-attention (Sq == Sk; equal ids only).
// A replaces grasp_any_region_tpu/ops/vit_attention.py:vit_attention
// (_vit_attn_kernel), which keeps a whole (S, S) logits block of a (tile,
// head) in VMEM (4.2 MB of fp32 at S = 1025, far over a Hopper block's 227
// KB): B's kernel, non-causal, one head per kv head, over (T, S, H, D)
// strided views of the unfused block's qkv buffer, with the (T, H, S) LSE
// that kernel 5 reads.
// Head dims: B takes 64 (GAR-1B) and 128 (GAR-8B's decoder), A 64 and 96
// (GAR-8B's PE-G tower). A key row is D / 64, rounded up, 128-byte swizzle
// atoms, each loaded as its own 64-column TMA box (FwdShape): S = Q K^T
// takes D / 16 k-steps across the atoms, O += P V reads V MN-major with the
// descriptor's LBO stepping from atom to atom (m64n128k16 at two atoms).
// A at 96 rides on the two-atom layout of 128: the maps' inner dim is 96,
// so TMA zero-fills columns 96-127 of every Q, K and V box, S takes 6
// k-steps (exact), and PV runs at n128 over a V whose last 32 columns are
// zero, 4/3 of PV's products (7/6 of the pair's), whose O columns 96-127
// are never stored. Above 64 a consumer thread holds 64 fp32 O registers;
// with S's 64 and P's 32 beside them, ptxas kept the kernel's 168 a thread
// only by spilling, and then serialised every wgmma (its first build), so a
// 128-key tile is consumed as two units of 64 keys (S m64n64, 32 fp32; P
// 16 registers; PV four k-steps), S of one unit still issued under the PV
// of the one before. Its 32 KB K and V tiles still take three stages
// (FwdShape::kStages).
// E replaces grasp_any_region_tpu/ops/vit_attention.py:
// vit_attention_fused_qkv (_fused_qkv_kernel): non-causal ViT attention
// with q, k and v read straight out of the fused (T, S, 3D) buffer through
// one TMA map (64, S, 3H, T) and 2D rope (fp32 (H, S, 64) cos/sin tables,
// rotate_half pairs i and i + 32) applied on the card's tiles; the output
// is token-major (T, S, D).
//
// All three run three warpgroups a CTA over 128-row query tiles:
// - the producer: warp 0 issues the TMA loads (128-byte swizzle: a 64-wide
//   bf16 row is one swizzle row) and hands its registers to the consumers
//   (setmaxnreg);
// - consumer warpgroup w owns query rows 64 w .. 64 w + 63 of the tile
//   (the m64 of every wgmma). Per 128-key tile j it issues S(j) = Q K^T
//   (wgmma m64n128k16, both operands in shared memory, K-major) and
//   O += P(j-1) V(j-1) (wgmma m64n64k16, P from registers, V read
//   MN-major), then runs the online softmax of S(j) in fp32 registers
//   (exp2 of scale * log2e, row max across the quad) while the PV product
//   runs, rescales O and rounds P to bf16 A fragments (the accumulator is
//   the mma.m16n8k16 C layout, so no shuffle). The two consumers do not
//   take turns (FA-3's ping-pong): each already runs its softmax under its
//   own PV product, and turns measured no faster.
// A, B: one CTA per (query tile, head, batch), launched heaviest first (the
//   causal band's longest query tiles get the lowest block indices); Q is
//   loaded once, K and V stream through a three-stage ring, with each key
//   tile's segment ids by plain loads. Masks are applied only on diagonal,
//   ragged (keys past Sk, which TMA zero-fills) and segment tiles; causal
//   key tiles wholly above the diagonal are never loaded, and (query tile,
//   key tile) pairs of disjoint [min, max] segment-id ranges (128-row
//   table) are skipped, which is exact. Full attention with at most 16
//   keys past the last full key tile (A at S = 1025 = 8 x 128 + 1) takes
//   E's n16 S product and one PV k-step there instead of a whole tile's.
// E: rope needs the tables' 64 KB of fp32 a 128-key tile, twice the tile's
//   own bytes, so K is roped once a CTA and kept: one CTA per (five query
//   tiles, head, tile) loads the head's whole K (S <= 1152: 9 tiles, 144
//   KB), which both consumers rope in place before their first product
//   (each thread with three rows' table loads in flight); V streams
//   through a three-stage ring and Q through two buffers, and each
//   consumer ropes its 64 rows of Q in place. K is roped twice a (tile,
//   head) at S = 1025, against 9 with one query tile a CTA. S = 1025 is 8
//   x 128 + 1: a last key tile of at most 16 keys takes an n16 S product
//   and one PV k-step.
// Rows past Sq are never written.
//
// Bound: the two products, 4 D flops per kept (query, key) pair and head;
// K/V are re-read per query tile from L2.
#include <type_traits>

#include "sm90.cuh"

namespace gar {

constexpr int kFwdM = 128;  // query rows a tile, 64 per consumer warpgroup
constexpr int kFwdN = 128;  // keys a tile
constexpr int kFwdThreads = 384;  // consumer warpgroups 0, 1; producer warpgroup 2
constexpr uint32_t kFwdTile = kFwdN * 64 * 2;  // bytes of a 128-row, 64-column bf16 atom
constexpr uint32_t kStageDesc = kFwdTile >> 4;  // an atom's step in descriptor units
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// A's and B's tiles and shared memory at head dim D, from a 1024-byte-aligned
// base: Q, then the K and V stages, each tile kAtoms 64-column atoms one
// after another (atom a holds columns 64 a .. 64 a + 63 of its 128 rows).
template <int D>
struct FwdShape {
  static_assert(D == 64 || D == 96 || D == 128, "an instance for head dims 64, 96 and 128");
  static constexpr int kAtoms = (D + 63) / 64;
  static constexpr int kDP = 64 * kAtoms;  // columns of a tile and of O (96 -> 128)
  static constexpr int kKSteps = D / 16;   // of S = Q K^T
  static constexpr uint32_t kTile = kAtoms * kFwdTile;
  static constexpr uint32_t kTileDesc = kTile >> 4;
  // three K/V stages at every head dim: at 96 and 128 (32 KB tiles) they
  // take 224 KB with Q, 432 bytes under the limit; two measured 8% slower
  // for A at 96 and the same for B at 128 (ab_kernels.py g8_two_stages)
  static constexpr int kStages = 3;
  static constexpr int kOffQ = 0;
  static constexpr int kOffK = kOffQ + kTile;
  static constexpr int kOffV = kOffK + kStages * kTile;
  static constexpr int kOffSeg = kOffV + kStages * kTile;  // stages x 128 key ids
  static constexpr int kOffBar = kOffSeg + kStages * kFwdN * 4;
  static constexpr int kBars = 1 + 3 * kStages;  // q, full_k, full_v, empty
  static constexpr int kSmem = kOffBar + kBars * 8 + 1024;  // + alignment slack
  static_assert(kSmem <= 232448, "over the 227 KB a Hopper block can use");
};

// E's: the whole roped K, two Q buffers, a V ring.
constexpr int kVitMaxKT = 9;      // key tiles kept: S <= 1152
constexpr int kVitQPerCta = 5;    // query tiles a CTA (S = 1025: 2 CTAs a (tile, head))
constexpr int kVitStagesV = 3;
constexpr int kVOffK = 0;
constexpr int kVOffQ = kVOffK + kVitMaxKT * kFwdTile;
constexpr int kVOffV = kVOffQ + 2 * kFwdTile;
constexpr int kVOffBar = kVOffV + kVitStagesV * kFwdTile;
constexpr int kVitBars = kVitMaxKT + 4 + 2 * kVitStagesV;
constexpr int kVitSmem = kVOffBar + kVitBars * 8 + 1024;
static_assert(kVitSmem <= 232448, "over the 227 KB a Hopper block can use");

struct FwdMaps {
  CUtensorMap q, k, v;  // bf16 4D (64, rows, head, batch), boxes of 128 rows
};

struct FwdArgs {
  const int* seg;        // B: (batch, s) int32, or nullptr
  const int* seg_tiles;  // with seg: (batch, ceil(s / 128), 2) [min, max] ids
  const float* cos;      // E: (heads, s, 64) fp32
  const float* sin;
  bf16* o;
  float* lse;  // A, B: (batch, heads, sq) fp32, or nullptr
  long long o_sb, o_ss, o_sh;
  int batch, sq, sk, heads, group, q_offset;  // q_offset = Sk - Sq
  float scale;
};

// Rope of one chunk pair (c, c + 4) (elements 8c .. 8c + 7 and 32 + 8c ..)
// of a row, in two steps so a thread can have several pairs' table loads
// in flight: rope_tables reads the tables' row `pos` (fp32) for the pair,
// rope_apply rotates row r of a 128B-swizzled [rows][64] bf16 tile in place
// (x cos + rotate_half(x) sin in fp32, rounded to bf16). Under the swizzle
// chunk c of row r sits at c ^ (r % 8), so the pair stays 4 chunks apart.
struct RopeRow {
  float4 cos[4], sin[4];  // elements 8c + [0, 4), 8c + [4, 8), then 32 + the same
};

__device__ __forceinline__ void rope_tables(RopeRow& t, const float* cos, const float* sin,
                                            int pos, int c) {
  const long long off = static_cast<long long>(pos) * 64 + 8 * c;
  const float4* c4 = reinterpret_cast<const float4*>(cos + off);
  const float4* s4 = reinterpret_cast<const float4*>(sin + off);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    t.cos[i] = __ldg(c4 + i);
    t.cos[2 + i] = __ldg(c4 + 8 + i);
    t.sin[i] = __ldg(s4 + i);
    t.sin[2 + i] = __ldg(s4 + 8 + i);
  }
}

__device__ __forceinline__ void rope_apply(uint8_t* tile, int r, int c, const RopeRow& t) {
  uint4* lo = reinterpret_cast<uint4*>(tile + r * 128 + ((c ^ (r & 7)) << 4));
  uint4* hi = reinterpret_cast<uint4*>(tile + r * 128 + (((c + 4) ^ (r & 7)) << 4));
  const uint4 in1 = *lo, in2 = *hi;
  const bf16* x1 = reinterpret_cast<const bf16*>(&in1);
  const bf16* x2 = reinterpret_cast<const bf16*>(&in2);
  const float* cl = reinterpret_cast<const float*>(&t.cos[0]);
  const float* ch = reinterpret_cast<const float*>(&t.cos[2]);
  const float* sl = reinterpret_cast<const float*>(&t.sin[0]);
  const float* sh = reinterpret_cast<const float*>(&t.sin[2]);
  uint4 out1, out2;
  uint32_t* w1 = reinterpret_cast<uint32_t*>(&out1);
  uint32_t* w2 = reinterpret_cast<uint32_t*>(&out2);
#pragma unroll
  for (int e = 0; e < 8; e += 2) {
    const float a0 = __bfloat162float(x1[e]), a1 = __bfloat162float(x1[e + 1]);
    const float b0 = __bfloat162float(x2[e]), b1 = __bfloat162float(x2[e + 1]);
    // first half: x1 cos - x2 sin; second half: x2 cos + x1 sin
    w1[e / 2] = pack_bf16x2(a0 * cl[e] - b0 * sl[e], a1 * cl[e + 1] - b1 * sl[e + 1]);
    w2[e / 2] = pack_bf16x2(b0 * ch[e] + a0 * sh[e], b1 * ch[e + 1] + a1 * sh[e + 1]);
  }
  *lo = out1;
  *hi = out2;
}

// Rope rows [0, n_rows) of tiles laid one after another (row p at tile p /
// 128, row p % 128), table rows pos0 + p: task g = 4 p + c, tasks tid,
// tid + threads, ..., BATCH pairs' tables in flight a thread. `ready(p)`
// is called before row p's tile is touched (a TMA wait).
template <int BATCH, typename Ready>
__device__ __forceinline__ void rope_rows(uint8_t* tiles, int n_rows, int pos0, const float* cos,
                                          const float* sin, int tid, int threads, Ready ready) {
  for (int g0 = tid; g0 < 4 * n_rows; g0 += BATCH * threads) {
    RopeRow t[BATCH];
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int g = g0 + u * threads;
      if (g < 4 * n_rows) rope_tables(t[u], cos, sin, pos0 + (g >> 2), g & 3);
    }
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int g = g0 + u * threads, p = g >> 2;
      if (g < 4 * n_rows) {
        ready(p);
        rope_apply(tiles + (p >> 7) * kFwdTile, p & 127, g & 3, t[u]);
      }
    }
  }
}

// True when 128-row query tile qt and 128-key tile kt share no segment id.
__device__ __forceinline__ bool fwd_pair_skipped(const int* tiles, int qt, int kt) {
  return tiles[2 * kt + 1] < tiles[2 * qt] || tiles[2 * kt] > tiles[2 * qt + 1];
}

// Online softmax of one (64 rows x 8 NJ keys) S tile in place: s becomes p
// (fp32), m2 the running row max in log2 units of the scaled logits;
// returns each row's rescale of the earlier sums in alpha and this
// thread's share of the tile's row sums in rsum. Masked entries are -inf
// and give p = 0; a row with no key kept so far has m2 = -inf and p = 0.
template <bool CAUSAL, bool SEG, int NJ = 16>
__device__ __forceinline__ void online_softmax(float (&s)[4 * NJ], float (&m2)[2],
                                               float (&alpha)[2], float (&rsum)[2], bool masked,
                                               int k0, int t, int pos0, int sk, const int* kseg,
                                               const int (&qseg)[2], float sl2) {
  if (masked) {
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = k0 + 8 * j + 2 * t + (i & 1), r = i >> 1;
        bool ok = key < sk;
        if (CAUSAL) ok = ok && pos0 + 8 * r >= key;
        if (SEG) ok = ok && kseg[key - k0] == qseg[r];
        if (!ok) s[4 * j + i] = -INFINITY;
      }
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    mx[0] = fmaxf(mx[0], fmaxf(s[4 * j], s[4 * j + 1]));
    mx[1] = fmaxf(mx[1], fmaxf(s[4 * j + 2], s[4 * j + 3]));
  }
  float base[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float mnew = fmaxf(m2[r], mx[r] * sl2);
    base[r] = mnew == -INFINITY ? 0.f : mnew;
    alpha[r] = sm90::exp2_approx(m2[r] - base[r]);
    m2[r] = mnew;
    rsum[r] = 0.f;
  }
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float p = sm90::exp2_approx(fmaf(s[4 * j + i], sl2, -base[i >> 1]));
      s[4 * j + i] = p;
      rsum[i >> 1] += p;
    }
}

// P (fp32, the S accumulator) as bf16 A fragments: k-step kk (keys 16 kk ..
// 16 kk + 15) is the C fragment of accumulator columns 16 kk .. + 15.
template <int NJ = 16, int NP = 8>
__device__ __forceinline__ void pack_p(const float (&s)[4 * NJ], uint32_t (&pa)[NP][4]) {
  static_assert(NJ <= 2 * NP, "P's k-steps fit the fragments");
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    pa[j >> 1][(j & 1) * 2 + 0] = pack_bf16x2(s[4 * j], s[4 * j + 1]);
    pa[j >> 1][(j & 1) * 2 + 1] = pack_bf16x2(s[4 * j + 2], s[4 * j + 3]);
  }
}

// Issue S = Q K^T (64 x 8 NJ: a 128-key tile, a 64-key unit, or 16 keys) over
// QK k-steps of 16 dims (k-step kk in atom kk / 4, 32 bytes a step into its
// rows) and O += P V (64 x DP, over the first 16 KS keys of the tile) for
// one warpgroup.
template <int NJ = 16, int QK = 4>
__device__ __forceinline__ void issue_s(float (&s)[4 * NJ], uint64_t dq, uint64_t dk) {
  static_assert(NJ == 16 || NJ == 8 || NJ == 2, "128, 64 or 16 keys");
#pragma unroll
  for (int kk = 0; kk < QK; ++kk) {
    const uint64_t off = (kk >> 2) * kStageDesc + 2 * (kk & 3);
    if constexpr (NJ == 16) sm90::wgmma_m64n128k16_ss<0, 0>(s, dq + off, dk + off, kk);
    else if constexpr (NJ == 8) sm90::wgmma_m64n64k16_ss<0, 0>(s, dq + off, dk + off, kk);
    else sm90::wgmma_m64n16k16_ss<0, 0>(s, dq + off, dk + off, kk);
  }
}

template <int KS = 8, int DP = 64, int NP = 8>
__device__ __forceinline__ void issue_pv(float (&o)[DP / 2], const uint32_t (&pa)[NP][4],
                                         uint64_t dv) {
  static_assert(KS <= NP, "P's k-steps");
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    if constexpr (DP == 64) sm90::wgmma_m64n64k16_rs<1>(o, pa[kk], dv + 128 * kk);
    else sm90::wgmma_m64n128k16_rs<1>(o, pa[kk], dv + 128 * kk);
  }
}

// O and l rescaled to the new row maxima, this tile's sums added.
template <int DP = 64>
__device__ __forceinline__ void rescale(float (&o)[DP / 2], float (&l)[2],
                                        const float (&alpha)[2], const float (&rsum)[2]) {
#pragma unroll
  for (int j = 0; j < DP / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[4 * j + i] *= alpha[i >> 1];
  l[0] = l[0] * alpha[0] + rsum[0];
  l[1] = l[1] * alpha[1] + rsum[1];
}

// O / l as bf16 and, with lse, each row's log-sum-exp (natural log of the
// scaled logits), rows row_lo + 8 r < sq only; columns 8 j + 2 t + c < D.
template <int D = 64, int DP = 64>
__device__ __forceinline__ void store_rows(const float (&o)[DP / 2], float (&l)[2],
                                           const float (&m2)[2], bf16* ob, long long o_ss,
                                           float* lse_row, int row_lo, int sq, int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_lo + 8 * r;
    if (row >= sq) continue;
    const float inv = l[r] > 0.f ? 1.f / l[r] : 0.f;
    bf16* orow = ob + row * o_ss + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(orow + 8 * j) =
          pack_bf16x2(o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
    if (lse_row != nullptr && t == 0) lse_row[row] = (m2[r] + log2f(l[r])) * kLn2;
  }
}

template <int D, bool CAUSAL, bool SEG>
__global__ void __launch_bounds__(kFwdThreads, 1)
    flash_fwd_sm90_kernel(const __grid_constant__ FwdMaps maps, const FwdArgs a) {
  using namespace sm90;
  using Sh = FwdShape<D>;
  constexpr int kStages = Sh::kStages, kAtoms = Sh::kAtoms, DP = Sh::kDP;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* sQ = sm + Sh::kOffQ;
  uint8_t* sK = sm + Sh::kOffK;
  uint8_t* sV = sm + Sh::kOffV;
  int* sSeg = reinterpret_cast<int*>(sm + Sh::kOffSeg);
  uint64_t* q_bar = reinterpret_cast<uint64_t*>(sm + Sh::kOffBar);
  uint64_t* full_k = q_bar + 1;         // K landed (and the tile's ids stored)
  uint64_t* full_v = full_k + kStages;  // V landed
  uint64_t* empty = full_v + kStages;   // both consumers done with the stage

  // heaviest first: the query tile is the slowest-varying part of the index
  const int pairs = a.heads * a.batch;
  const int n_qt = (a.sq + kFwdM - 1) / kFwdM;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x) / pairs;
  const int h = blockIdx.x % pairs % a.heads, b = blockIdx.x % pairs / a.heads;
  const int kvh = h / a.group;
  const int q0 = qt * kFwdM;
  const int n_kt_all = (a.sk + kFwdN - 1) / kFwdN;
  const int n_kt = CAUSAL ? min(n_kt_all, (a.q_offset + q0 + kFwdM - 1) / kFwdN + 1) : n_kt_all;
  const int* tiles = SEG ? a.seg_tiles + 2LL * b * n_kt_all : nullptr;

  if (threadIdx.x == 0) {
    mbar_init(q_bar, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full_k[s], 32);  // the producer warp's lanes (one with the TMA bytes)
      mbar_init(&full_v[s], 1);
      mbar_init(&empty[s], 256);  // every consumer thread
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {  // producer warpgroup: warp 0 works
    regs_dealloc<40>();
    if (threadIdx.x >= 288) return;
    const int lane = threadIdx.x & 31;
    if (lane == 0) {  // one 64-column box an atom (zero-filled past D)
      mbar_arrive_expect_tx(q_bar, Sh::kTile);
#pragma unroll
      for (int at = 0; at < kAtoms; ++at)
        tma_load_4d(sQ + at * kFwdTile, &maps.q, q_bar, 64 * at, q0, h, b);
    }
    int stage = 0;
    uint32_t phase = 0;
    for (int kt = 0; kt < n_kt; ++kt) {
      if (SEG && fwd_pair_skipped(tiles, qt, kt)) continue;
      const int k0 = kt * kFwdN;
      int sg[4];
      if (SEG) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int key = k0 + lane + 32 * r;
          sg[r] = key < a.sk ? a.seg[static_cast<long long>(b) * a.sk + key] : -2;
        }
      }
      mbar_wait(&empty[stage], phase ^ 1);
      if (SEG) {
#pragma unroll
        for (int r = 0; r < 4; ++r) sSeg[stage * kFwdN + lane + 32 * r] = sg[r];
      }
      if (lane == 0) {
        mbar_arrive_expect_tx(&full_k[stage], Sh::kTile);
#pragma unroll
        for (int at = 0; at < kAtoms; ++at)
          tma_load_4d(sK + stage * Sh::kTile + at * kFwdTile, &maps.k, &full_k[stage], 64 * at,
                      k0, kvh, b);
        mbar_arrive_expect_tx(&full_v[stage], Sh::kTile);
#pragma unroll
        for (int at = 0; at < kAtoms; ++at)
          tma_load_4d(sV + stage * Sh::kTile + at * kFwdTile, &maps.v, &full_v[stage], 64 * at,
                      k0, kvh, b);
      } else {
        mbar_arrive(&full_k[stage]);
      }
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    return;
  }

  // consumers: warpgroup w owns query rows q0 + 64 w + [0, 64)
  regs_alloc<232>();
  const int w = threadIdx.x >> 7, wi = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row_lo = q0 + 64 * w + 16 * wi + g;  // this thread's rows: row_lo, row_lo + 8
  const int pos0 = row_lo + a.q_offset;
  const float sl2 = a.scale * kLog2e;
  int qseg[2] = {-1, -1};
  if (SEG) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (row_lo + 8 * r < a.sq) qseg[r] = a.seg[static_cast<long long>(b) * a.sq + row_lo + 8 * r];
  }
  // Q's rows 64 w .. in each atom; V MN-major, its atoms LBO = one atom apart
  const uint64_t dQ = desc_sw128(sQ + 64 * w * 128, 16, 1024);
  const uint64_t dK = desc_sw128(sK, 16, 1024);
  const uint64_t dV = desc_sw128(sV, kFwdTile, 1024);
  const int wg_pos = q0 + 64 * w + a.q_offset;  // position of the warpgroup's first row
  // A 128-key tile is consumed in kUnits units of kUnitN keys: one at head
  // dim 64; two of 64 above it, so S (32 fp32) and P (16) fit beside O's 64
  // registers with S(unit) still issued under PV(unit - 1).
  constexpr int kUnits = kAtoms == 1 ? 1 : 2;
  constexpr int kUnitN = kFwdN / kUnits;
  constexpr int NJ = kUnitN / 8;  // S's 8-key column groups a unit
  constexpr int KS = kUnitN / 16;  // PV's k-steps a unit
  constexpr uint32_t kUnitDesc = kUnitN * 128 >> 4;  // a unit's rows of an atom
  auto is_masked = [&](int k0) {  // a key of the unit lies past Sk or the diagonal, or SEG
    return k0 + kUnitN > a.sk || SEG || (CAUSAL && k0 + kUnitN - 1 > wg_pos);
  };

  float o[DP / 2], m2[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
  uint32_t pa[KS][4];

  // the first key tile this query tile keeps (the diagonal tile is never skipped)
  int kt = 0;
  if (SEG)
    while (fwd_pair_skipped(tiles, qt, kt)) ++kt;
  int stage = 0;
  uint32_t phase = 0;
  auto advance = [&]() {
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1;
    }
  };

  mbar_wait(q_bar, 0);
  {  // prologue: S of the first unit alone
    const int k0 = kt * kFwdN;
    float s[4 * NJ];
    mbar_wait(&full_k[stage], phase);
    wgmma_fence();
    issue_s<NJ, Sh::kKSteps>(s, dQ, dK + stage * Sh::kTileDesc);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    float alpha[2];
    online_softmax<CAUSAL, SEG, NJ>(s, m2, alpha, l, is_masked(k0), k0, t, pos0, a.sk,
                                    sSeg + stage * kFwdN, qseg, sl2);
    pack_p<NJ>(s, pa);
  }
  // the unit before: its stage and phase, its unit of the tile, and whether
  // it ends its tile (then its PV hands the stage back)
  int prev = stage, prev_u = 0;
  uint32_t prev_phase = phase;
  bool prev_last = kUnits == 1;
  if (prev_last) advance();

  // one unit u of key tile kt: S of NJX column groups, O += P V of the unit before
  auto step = [&](auto nj, int kt, int u) {
    constexpr int NJX = decltype(nj)::value;
    const int k0 = kt * kFwdN + u * kUnitN;
    float s[4 * NJX];
    if (u == 0) mbar_wait(&full_k[stage], phase);
    mbar_wait(&full_v[prev], prev_phase);
    wgmma_fence();
    issue_s<NJX, Sh::kKSteps>(s, dQ,
                              dK + stage * Sh::kTileDesc + (kUnits == 1 ? 0 : u * kUnitDesc));
    wgmma_commit();
    issue_pv<KS, DP>(o, pa, dV + prev * Sh::kTileDesc + (kUnits == 1 ? 0 : prev_u * kUnitDesc));
    wgmma_commit();
    wgmma_wait<1>();  // S done; O += P V of the unit before still running
    fence_regs(s);
    float alpha[2], rsum[2];
    online_softmax<CAUSAL, SEG, NJX>(s, m2, alpha, rsum, is_masked(k0), k0, t, pos0, a.sk,
                                     sSeg + stage * kFwdN + u * kUnitN, qseg, sl2);
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(pa);
    if (prev_last) mbar_arrive(&empty[prev]);
    rescale<DP>(o, l, alpha, rsum);
    pack_p<NJX>(s, pa);
    prev = stage;
    prev_phase = phase;
    prev_u = u;
    prev_last = u == kUnits - 1 || NJX != NJ;  // the narrow unit ends the last tile
    if (prev_last) advance();
  };
  // the first tile's other units, then the rest; full attention (A; B
  // without a mask) with at most 16 keys past the last full key tile: that
  // tile is one unit of the n16 product and one PV k-step
  for (int u = 1; u < kUnits; ++u) step(std::integral_constant<int, NJ>(), kt, u);
  const bool narrow = !CAUSAL && !SEG && n_kt > 1 && a.sk - (n_kt - 1) * kFwdN <= 16;
  for (++kt; kt < n_kt - (narrow ? 1 : 0); ++kt) {
    if (SEG && fwd_pair_skipped(tiles, qt, kt)) continue;
#pragma unroll
    for (int u = 0; u < kUnits; ++u) step(std::integral_constant<int, NJ>(), kt, u);
  }
  if constexpr (!CAUSAL && !SEG) {
    if (narrow) step(std::integral_constant<int, 2>(), n_kt - 1, 0);
  }

  // epilogue: O += P V of the last unit (one k-step for the n16 form)
  mbar_wait(&full_v[prev], prev_phase);
  wgmma_fence();
  const uint64_t dv_last = dV + prev * Sh::kTileDesc + (kUnits == 1 ? 0 : prev_u * kUnitDesc);
  if (narrow) issue_pv<1, DP>(o, pa, dv_last);
  else issue_pv<KS, DP>(o, pa, dv_last);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(o);
  fence_regs(pa);
  mbar_arrive(&empty[prev]);
  store_rows<D, DP>(o, l, m2, a.o + b * a.o_sb + h * a.o_sh, a.o_ss,
             a.lse == nullptr ? nullptr : a.lse + (static_cast<long long>(b) * a.heads + h) * a.sq,
             row_lo, a.sq, t);
}

// E: one CTA per (up to kVitQPerCta query tiles, head, tile); the map is
// the fused buffer's (64, S, 3H, T): q of head h at map head h, k at H + h,
// v at 2H + h. The consumers rope all of K first (every K tile is loaded at
// once; each thread keeps three pairs' table loads in flight), then walk
// their query tiles. A last key tile of at most 16 keys (S = 1025 has one)
// takes an n16 S product and one PV k-step.
__global__ void __launch_bounds__(kFwdThreads, 1)
    vit_fwd_rope_sm90_kernel(const __grid_constant__ CUtensorMap map, const FwdArgs a) {
  using namespace sm90;
  constexpr int D = 64;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  bf16* sK = reinterpret_cast<bf16*>(sm + kVOffK);
  bf16* sQ = reinterpret_cast<bf16*>(sm + kVOffQ);
  bf16* sV = reinterpret_cast<bf16*>(sm + kVOffV);
  uint64_t* k_landed = reinterpret_cast<uint64_t*>(sm + kVOffBar);  // one use each
  uint64_t* q_full = k_landed + kVitMaxKT;
  uint64_t* q_empty = q_full + 2;
  uint64_t* v_full = q_empty + 2;
  uint64_t* v_empty = v_full + kVitStagesV;

  // the parts of one (tile, head) are neighbours in the index: they share K in L2
  const int n_qt = (a.sq + kFwdM - 1) / kFwdM, n_kt = (a.sk + kFwdN - 1) / kFwdN;
  const int parts = (n_qt + kVitQPerCta - 1) / kVitQPerCta;
  const int part = blockIdx.x % parts;
  const int h = blockIdx.x / parts % a.heads, b = blockIdx.x / parts / a.heads;
  const int qt0 = part * kVitQPerCta, qt1 = min(n_qt, qt0 + kVitQPerCta);

  if (threadIdx.x == 0) {
    for (int i = 0; i < kVitMaxKT; ++i) mbar_init(&k_landed[i], 1);
    for (int i = 0; i < 2; ++i) {
      mbar_init(&q_full[i], 1);
      mbar_init(&q_empty[i], 256);
    }
    for (int i = 0; i < kVitStagesV; ++i) {
      mbar_init(&v_full[i], 1);
      mbar_init(&v_empty[i], 256);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {  // producer: one thread issues every TMA load
    regs_dealloc<40>();
    if (threadIdx.x != 256) return;
    for (int kt = 0; kt < n_kt; ++kt) {
      mbar_arrive_expect_tx(&k_landed[kt], kFwdTile);
      tma_load_4d(sK + kt * kFwdN * D, &map, &k_landed[kt], 0, kt * kFwdN, a.heads + h, b);
    }
    int vs = 0;
    uint32_t vph = 0;
    for (int qt = qt0; qt < qt1; ++qt) {
      const int buf = (qt - qt0) & 1;
      mbar_wait(&q_empty[buf], (((qt - qt0) >> 1) & 1) ^ 1);
      mbar_arrive_expect_tx(&q_full[buf], kFwdTile);
      tma_load_4d(sQ + buf * kFwdM * D, &map, &q_full[buf], 0, qt * kFwdM, h, b);
      for (int kt = 0; kt < n_kt; ++kt) {
        mbar_wait(&v_empty[vs], vph ^ 1);
        mbar_arrive_expect_tx(&v_full[vs], kFwdTile);
        tma_load_4d(sV + vs * kFwdN * D, &map, &v_full[vs], 0, kt * kFwdN, 2 * a.heads + h, b);
        if (++vs == kVitStagesV) {
          vs = 0;
          vph ^= 1;
        }
      }
    }
    return;
  }

  // consumers: warpgroup w owns rows 64 w + [0, 64) of each query tile
  regs_alloc<232>();
  const int w = threadIdx.x >> 7, wi = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const float sl2 = a.scale * kLog2e;
  const int no_seg[2] = {0, 0};
  const float* cos_h = a.cos + static_cast<long long>(h) * a.sq * D;
  const float* sin_h = a.sin + static_cast<long long>(h) * a.sq * D;
  const uint64_t dK = desc_sw128(sK, 16, 1024);
  const uint64_t dV = desc_sw128(sV, kFwdTile, 1024);
  bf16* ob = a.o + b * a.o_sb + h * a.o_sh;
  const int k_last = (n_kt - 1) * kFwdN;
  const bool narrow = n_kt > 1 && a.sk - k_last <= 16;  // the last key tile's n16 form

  // rope all of K in place, both warpgroups, then meet
  rope_rows<3>(reinterpret_cast<uint8_t*>(sK), a.sk, 0, cos_h, sin_h, threadIdx.x, 256,
               [&](int p) { mbar_wait(&k_landed[p >> 7], 0); });
  fence_proxy_async();
  bar_sync(5, 256);

  int vs = 0;
  uint32_t vph = 0;
  for (int qt = qt0; qt < qt1; ++qt) {
    const int buf = (qt - qt0) & 1;
    const int q0 = qt * kFwdM;
    const int row_lo = q0 + 64 * w + 16 * wi + g;  // this thread's rows: row_lo, row_lo + 8
    bf16* sQw = sQ + buf * kFwdM * D + 64 * w * D;
    mbar_wait(&q_full[buf], ((qt - qt0) >> 1) & 1);
    // rope this warpgroup's rows of Q in place
    rope_rows<2>(reinterpret_cast<uint8_t*>(sQw), max(0, min(64, a.sq - q0 - 64 * w)),
                 q0 + 64 * w, cos_h, sin_h, threadIdx.x & 127, 128, [](int) {});
    fence_proxy_async();
    bar_sync(3 + w, 128);
    const uint64_t dQ = desc_sw128(sQw, 16, 1024);
    float o[32], m2[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] = 0.f;
    uint32_t pa[8][4];

    {  // prologue: S of key tile 0 alone
      float s[64];
      wgmma_fence();
      issue_s(s, dQ, dK);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      float alpha[2];
      online_softmax<false, false>(s, m2, alpha, l, kFwdN > a.sk, 0, t, 0, a.sk, nullptr, no_seg,
                                   sl2);
      pack_p(s, pa);
    }
    int prev = vs;
    uint32_t prev_ph = vph;
    // one key tile: S(kt) of NJ column groups, O += P(kt - 1) V(kt - 1)
    auto step = [&](auto nj, int kt) {
      constexpr int NJ = decltype(nj)::value;
      const int k0 = kt * kFwdN;
      if (++vs == kVitStagesV) {
        vs = 0;
        vph ^= 1;
      }
      float s[4 * NJ];
      mbar_wait(&v_full[prev], prev_ph);
      wgmma_fence();
      issue_s<NJ>(s, dQ, dK + kt * kStageDesc);
      wgmma_commit();
      issue_pv(o, pa, dV + prev * kStageDesc);
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(s);
      float alpha[2], rsum[2];
      online_softmax<false, false, NJ>(s, m2, alpha, rsum, k0 + 8 * NJ > a.sk, k0, t, 0, a.sk,
                                       nullptr, no_seg, sl2);
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(pa);
      mbar_arrive(&v_empty[prev]);
      rescale(o, l, alpha, rsum);
      pack_p<NJ>(s, pa);
      prev = vs;
      prev_ph = vph;
    };
    for (int kt = 1; kt + 1 < n_kt; ++kt) step(std::integral_constant<int, 16>(), kt);
    if (narrow) step(std::integral_constant<int, 2>(), n_kt - 1);
    else if (n_kt > 1) step(std::integral_constant<int, 16>(), n_kt - 1);
    if (++vs == kVitStagesV) {
      vs = 0;
      vph ^= 1;
    }

    // epilogue: O += P V of the last key tile (one k-step for the n16 form)
    mbar_wait(&v_full[prev], prev_ph);
    wgmma_fence();
    if (narrow) issue_pv<1>(o, pa, dV + prev * kStageDesc);
    else issue_pv(o, pa, dV + prev * kStageDesc);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(pa);
    mbar_arrive(&v_empty[prev]);
    mbar_arrive(&q_empty[buf]);
    store_rows(o, l, m2, ob, a.o_ss, nullptr, row_lo, a.sq, t);
  }
}

template <int D, bool CAUSAL, bool SEG>
inline int launch_fwd_sm90(const FwdMaps& maps, const FwdArgs& a, cudaStream_t stream) {
  auto kernel = flash_fwd_sm90_kernel<D, CAUSAL, SEG>;
  constexpr int smem = FwdShape<D>::kSmem;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = (a.sq + kFwdM - 1) / kFwdM * a.heads * a.batch;
  kernel<<<grid, kFwdThreads, smem, stream>>>(maps, a);
  return static_cast<int>(cudaGetLastError());
}

// B's four masks at head dim D.
template <int D>
inline int launch_masks(const FwdMaps& maps, const FwdArgs& a, bool causal, bool seg,
                        cudaStream_t st) {
  if (causal) return seg ? launch_fwd_sm90<D, true, true>(maps, a, st)
                         : launch_fwd_sm90<D, true, false>(maps, a, st);
  return seg ? launch_fwd_sm90<D, false, true>(maps, a, st)
             : launch_fwd_sm90<D, false, false>(maps, a, st);
}

}  // namespace gar

// Kernel B. q (batch, sq, heads, D), k/v (batch, sk, kv_heads, D) bf16
// through element strides (batch, sequence, head), the head dim contiguous,
// D 64 or 128 (96 for kernel A: full attention, no segment ids);
// o written through its strides; lse (batch, heads, sq) fp32 or nullptr;
// seg (batch, s) int32 with seg_tiles, each 128-row tile's [min, max] id
// (batch, ceil(s / 128), 2), or nullptr. Tensor maps are encoded per call.
extern "C" int gar_flash_attention(
    const void* q, const void* k, const void* v, void* o, void* lse, const void* seg,
    const void* seg_tiles, int batch, int sq, int sk, int heads, int kv_heads, int head_dim,
    int causal,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh,
    float scale, void* stream) {
  const bool known = head_dim == 64 || head_dim == 128 || (head_dim == 96 && !causal && !seg);
  if (!known || kv_heads <= 0 || heads % kv_heads != 0 || batch <= 0 || sq <= 0 ||
      sk <= 0 || (causal && sk < sq) || (seg && (sq != sk || !seg_tiles)))
    return static_cast<int>(cudaErrorInvalidValue);
  gar::FwdMaps maps;  // inner dim head_dim: a box's columns past it land as zeros
  int err = gar::encode_rows(&maps.q, q, false, sq, heads, batch, q_sb, q_ss, q_sh, gar::kFwdM,
                             head_dim);
  if (!err)
    err = gar::encode_rows(&maps.k, k, false, sk, kv_heads, batch, k_sb, k_ss, k_sh, gar::kFwdN,
                           head_dim);
  if (!err)
    err = gar::encode_rows(&maps.v, v, false, sk, kv_heads, batch, v_sb, v_ss, v_sh, gar::kFwdN,
                           head_dim);
  if (err) return err;
  gar::FwdArgs a;
  a.seg = static_cast<const int*>(seg);
  a.seg_tiles = static_cast<const int*>(seg_tiles);
  a.cos = a.sin = nullptr;
  a.o = static_cast<gar::bf16*>(o);
  a.lse = static_cast<float*>(lse);
  a.o_sb = o_sb;
  a.o_ss = o_ss;
  a.o_sh = o_sh;
  a.batch = batch;
  a.sq = sq;
  a.sk = sk;
  a.heads = heads;
  a.group = heads / kv_heads;
  a.q_offset = sk - sq;
  a.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (head_dim == 96) return gar::launch_fwd_sm90<96, false, false>(maps, a, st);
  return head_dim == 64 ? gar::launch_masks<64>(maps, a, causal, seg, st)
                        : gar::launch_masks<128>(maps, a, causal, seg, st);
}

// Kernel A: kernel B at full attention with one head per kv head. q, k, v,
// o (tiles, seq, heads, D) bf16, D 64 or 96, through element strides (tile,
// token, head), the head dim contiguous (views of the unfused block's qkv buffer:
// TMA takes 16-byte aligned bases and strides, which the wrapper checks);
// lse (tiles, heads, seq) fp32 or nullptr.
extern "C" int gar_vit_attention(
    const void* q, const void* k, const void* v, void* o, void* lse,
    int tiles, int seq, int heads, int head_dim,
    long long q_st, long long q_ss, long long q_sh,
    long long k_st, long long k_ss, long long k_sh,
    long long v_st, long long v_ss, long long v_sh,
    long long o_st, long long o_ss, long long o_sh,
    float scale, void* stream) {
  return gar_flash_attention(q, k, v, o, lse, nullptr, nullptr, tiles, seq, seq, heads, heads,
                             head_dim, /*causal*/ 0, q_st, q_ss, q_sh, k_st, k_ss, k_sh, v_st,
                             v_ss, v_sh, o_st, o_ss, o_sh, scale, stream);
}

// Kernel E. qkv (tiles, seq, 3 * heads * 64) bf16, contiguous: q of head h
// at column 64 h, k at D + 64 h, v at 2D + 64 h (D = heads * 64), read as
// one map (64, seq, 3 heads, tiles) with a row stride of 3D; cos/sin fp32
// (heads, seq, 64), contiguous, identity CLS rows; o (tiles, seq, D).
// seq <= 1152: a CTA keeps the head's whole roped K in shared memory.
extern "C" int gar_vit_attention_fused_qkv(
    const void* qkv, const void* cos, const void* sin, void* o,
    int tiles, int seq, int heads, int head_dim, float scale, void* stream) {
  if (head_dim != 64 || tiles <= 0 || seq <= 0 || heads <= 0 ||
      seq > gar::kVitMaxKT * gar::kFwdN)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long dm = static_cast<long long>(heads) * head_dim;
  CUtensorMap map;
  const int err = gar::encode_rows(&map, qkv, false, seq, 3 * heads, tiles, seq * 3 * dm,
                                   3 * dm, head_dim, gar::kFwdM);
  if (err) return err;
  gar::FwdArgs a;
  a.seg = a.seg_tiles = nullptr;
  a.cos = static_cast<const float*>(cos);
  a.sin = static_cast<const float*>(sin);
  a.o = static_cast<gar::bf16*>(o);
  a.lse = nullptr;
  a.o_sb = seq * dm;
  a.o_ss = dm;
  a.o_sh = head_dim;
  a.batch = tiles;
  a.sq = a.sk = seq;
  a.heads = heads;
  a.group = 1;
  a.q_offset = 0;
  a.scale = scale;
  const cudaError_t attr = cudaFuncSetAttribute(
      gar::vit_fwd_rope_sm90_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, gar::kVitSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int n_qt = (seq + gar::kFwdM - 1) / gar::kFwdM;
  const int parts = (n_qt + gar::kVitQPerCta - 1) / gar::kVitQPerCta;
  gar::vit_fwd_rope_sm90_kernel<<<parts * heads * tiles, gar::kFwdThreads, gar::kVitSmem,
                                  static_cast<cudaStream_t>(stream)>>>(map, a);
  return static_cast<int>(cudaGetLastError());
}
