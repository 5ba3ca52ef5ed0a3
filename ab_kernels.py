"""Kernels A, B and C, or kernel H, timed in copies of the package that
differ by named edits of their sources, in turns on one card: the parent
form, each variant, then the variants again in reverse and the parent
last. A design choice is kept only when it measures faster this way, in
one call.

Each variant (VARIANTS: name -> [(source, old, new), ...]) is built in its
own copy under build/copies/ (forward_mutants.make_copy). In each copy a
fresh process checks A and C against their plain versions (sized
tolerance; TOL16) and prints their times after an L2 flush (chip_smoke.py's
cuda_ms): A at (17, S, 16, 64) views of a qkv buffer, S = 1025 and 1024;
B at the causal prefill; C over layer 7 of a (16, B, 8, 5120, 64) cache at
B = 1, 2 and 24. The variants named h_* time kernel H instead (TIMING_H:
GAR-1B's w_down and wo at B = 1 and 24, checked against the plain version,
one call after an L2 flush and 16 layers back to back) against the parent
h_parent; those named m_* time kernels 21-23 (TIMING_M: 23 and 21 at
GAR-1B's widths at B = 1 and 24, one call and 16 layers back to back; 22
with bf16 and int8 wo over the main path's cache at B = 1 and 24, beside
C alone and C + H on wo) against m_parent; those named c8_* and i8_*
time kernels C8 and I8 (TIMING_Q8: C8 over layer 7 of the main path's
int8 (16, B, 8, 5120, 64) cache, I8 at GAR-1B's gate and up, each at B = 1
and 24 and checked against its plain version, I8 also 16 layers back to
back) against q8_parent; those named st_*, h8_* and i_* time the four
kernels of H's weight stream (TIMING_STREAM: H and H8 at GAR-1B's w_down
and wo, I and I8 at its gate and up, each at B = 1 and 24, checked against
its plain version, one call after an L2 flush and 16 layers back to back)
against st_parent; those named q_* time kernels 19 and 20 (TIMING_QKV)
against q_parent; those named g8_* time kernels A, B and C at GAR-8B's
head dims (TIMING_8B: A at (9, S, 16, 96), S = 1025 and 1024, B at the
2614-token causal prefill with 128-wide heads, C over a 128-wide cache at
B = 1 and 24, each checked) against g8_parent; those named w_* time kernel
18's wide instance (TIMING_W: kernel 5 at (9, S, 16, 96), v a view of a
(T, S, 3, H, 96) buffer, S = 1025 and 1024; 18 alone and the 18 call at
the 2614-token prompt, causal, 32 / 8 heads of 128, without and with two
documents; each checked at the output-sized tolerance, SDPA's backward
beside them) against w_parent. `--against=` runs one
timing (TIMING_Q8 unless another is named: abc, h, m, stream, steps:
TIMING_STEPS, the fused bf16 and int8 decode steps' and the mega step's
(bf16 and int8 weights) device and host ms at GAR-1B, vit: TIMING_VIT,
kernels D, F and G one call after an L2 flush at one GAR-1B ViT layer,
each checked at the output-sized tolerance, and the fused GAR-1B tower
over 17 tiles, or qkv: TIMING_QKV, kernels 19 and 20 at GAR-1B's widths,
B = 1 and 24, checked against their plain versions, one call after an L2
flush and 16 layers back to back; or j: TIMING_J, kernels J and J8 at
GAR-1B's widths, B = 1 and 24, checked against their plain versions, one
call after an L2 flush, 16 layers back to back and the host time a call;
or wide: TIMING_W; or bits: TIMING_BITS, a hash of the outputs of H, H8 (w_down and wo), I,
I8, J, J8, 19, 20, 23 and 21 at GAR-1B's widths, B = 1, 5, 17, 24 and 32,
on seeded inputs, which two checkouts that give the same bits print
alike; or attn_bits: TIMING_ATTN_BITS, the same hash of kernels A (with
its LSE), B (causal with its LSE, full, segment ids), C, C8 (and its
written column), 16 and 22 at GAR-1B's head dim 64, B = 1, 2 and 24; or
gar8b: TIMING_8B; or lora_step: TIMING_LORA, `chip_smoke.phase_gar8b_train`'s
GAR-8B LoRA step, two warm-up and three timed steps) in the package of
another checkout and in this tree, in turns.
Run from the repository root on a machine with the card:

    python3 ab_kernels.py [variant ...]
    python3 ab_kernels.py h_<variant> ...
    python3 ab_kernels.py m_<variant> ...
    python3 ab_kernels.py c8_<variant> | i8_<variant> ...
    python3 ab_kernels.py st_<variant> | h8_<variant> | i_<variant> ...
    python3 ab_kernels.py q_<variant> ...
    python3 ab_kernels.py g8_<variant> ...
    python3 ab_kernels.py w_<variant> ...
    python3 ab_kernels.py --against=<directory of another checkout> [q8 | abc | h | m | stream | steps | vit | qkv | j | wide | bits | attn_bits | gar8b | lora_step]
"""

from __future__ import annotations

import json
import sys

from pathlib import Path

from forward_mutants import FWD, REPO, SPLIT, make_copy, run

H_SRC = "grasp_any_region_tpu_torch/csrc/layer_matmul_sm90.cu"
H_PY = "grasp_any_region_tpu_torch/ops/layer_matmul.py"

# A's ragged last query tile (S = 1025: one row): its idle warpgroup leaves
# at once (so does that of B's causal last tile of <= 64 rows)
IDLE_WARPGROUP_LEAVES = [
    (FWD, "      mbar_init(&empty[s], 256);  // every consumer thread",
     "      mbar_init(&empty[s], 128 * min(2, (a.sq - q0 + 63) / 64));"),
    (FWD, "  const int pos0 = row_lo + a.q_offset;\n",
     "  if (q0 + 64 * w >= a.sq) return;\n  const int pos0 = row_lo + a.q_offset;\n")]
# full attention launches its query tiles in order, the ragged one last
RAGGED_TILE_LAST = [
    (FWD, "  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x) / pairs;",
     "  const int qt = CAUSAL ? n_qt - 1 - static_cast<int>(blockIdx.x) / pairs\n"
     "                        : static_cast<int>(blockIdx.x) / pairs;")]
VARIANTS = {
    "parent": [],
    "a_idle_warpgroup_leaves": IDLE_WARPGROUP_LEAVES,
    "a_ragged_tile_last": RAGGED_TILE_LAST,
    "a_both": IDLE_WARPGROUP_LEAVES + RAGGED_TILE_LAST,
    "c_six_stages": [(SPLIT, "constexpr int kSplitStages = 4;", "constexpr int kSplitStages = 6;")],
}


def h_variant(**consts) -> list:
    """Kernel H with named constants changed in its source and its plan's
    mirror (ops/layer_matmul.py): bk (rows a stage), stages (most in the
    ring), ctas_per_sm (how far clusters, up to 16, grow the grid); at one
    CTA an SM a CTA may take the SM's whole shared memory."""
    c = {**dict(bk=128, stages=3, ctas_per_sm=2), **consts}
    edits = [(H_PY, "STREAM_N, STREAM_MAX_SPLITS, STREAM_CTAS_PER_SM = 64, 8, 2",
              f"STREAM_N, STREAM_MAX_SPLITS, STREAM_CTAS_PER_SM = 64, 16, {c['ctas_per_sm']}"),
             (H_PY, "STREAM_BK = 128", f"STREAM_BK = {c['bk']}"),
             (H_SRC, "constexpr int kWsBK = 128;", f"constexpr int kWsBK = {c['bk']};"),
             (H_SRC, "constexpr int kWsStages = 3;", f"constexpr int kWsStages = {c['stages']};")]
    if c["ctas_per_sm"] == 1:
        edits.append((H_SRC, "constexpr int kWsCtaSmem = 232448 / 2 - 1024;",
                       "constexpr int kWsCtaSmem = 232448 - 1024;"))
    return edits


H_VARIANTS = {  # the parent: 128 rows and at most 3 stages, 8 CTAs a tile
    "h_parent": [],
    "h_two_stages": h_variant(stages=2),
    "h_four_stages": h_variant(stages=4),
    "h_six_stages": h_variant(stages=6),
    "h_bk64_four_stages": h_variant(bk=64, stages=4),
    "h_bk256_two_stages": h_variant(bk=256, stages=2),
    "h_sixteen_ctas_a_tile": h_variant(ctas_per_sm=4),
    "h_one_cta_an_sm": h_variant(ctas_per_sm=1),
    "h_one_cta_an_sm_six_stages": h_variant(ctas_per_sm=1, stages=6),
    "h_no_pdl": [(H_SRC, "  cfg.numAttrs = 2;", "  cfg.numAttrs = 1;")],
    "h_l2_promotion_256": [("grasp_any_region_tpu_torch/csrc/sm90.cuh",
                            "CU_TENSOR_MAP_L2_PROMOTION_L2_128B", "CU_TENSOR_MAP_L2_PROMOTION_L2_256B")],
    # the partials pulled: each CTA keeps its own (staged in its ring), the
    # cluster syncs, the finisher loads its columns from every CTA, and a
    # second barrier keeps each CTA alive while peers read it
    "h_pull_reduction": [(H_SRC, """  for (int e = threadIdx.x; e < splits * per_q; e += kWsThreads) {""",
                          """  for (int e = threadIdx.x; e < 0 * splits * per_q; e += kWsThreads) {"""),
                         (H_SRC, """    for (int w = 0; w < NW; ++w) {
      v[w] = 0.f;
      for (int r = 0; r < splits; ++r) v[w] += recv[((w * splits + r) * a.rows + row) * cols + c];
    }""", """    for (int w = 0; w < NW; ++w) v[w] = 0.f;
    float p[NW][kWsMaxSplits];
#pragma unroll
    for (int r = 0; r < kWsMaxSplits; ++r)
      if (r < splits)
#pragma unroll
        for (int w = 0; w < NW; ++w)
          p[w][r] = cluster.map_shared_rank(part, r)[(w * a.rows + row) * PP + rank * cols + c];
#pragma unroll
    for (int w = 0; w < NW; ++w)
#pragma unroll
      for (int r = 0; r < kWsMaxSplits; ++r)
        if (r < splits) v[w] += p[w][r];"""),
                         (H_SRC, """    sg.out[static_cast<size_t>(row) * sg.dout + col] = __float2bfloat16(o);
  }
}""", """    sg.out[static_cast<size_t>(row) * sg.dout + col] = __float2bfloat16(o);
  }
  cluster.sync();
}""")],
    # a warp hands a stage back as soon as its products are issued
    "h_release_at_once": [(H_SRC, """      if (j > 0) {  // stage j - 1: its products are issued, so its loads are done
        fence_proxy_async();
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[(j - 1) % stages]);
      }""", """      fence_proxy_async();
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);""")],
    # timing only (wrong results): the CTAs leave after their main loop, or
    # skip the cluster's reduction
    "h_no_epilogue": [(H_SRC, "  grid_dependency_wait();  // out may be memory the kernel before still reads\n",
                       "  grid_dependency_wait();  // out may be memory the kernel before still reads\n"
                       "  if (a.rows > 0) return;\n")],
    "h_no_cluster_reduce": [(H_SRC, "  cluster.sync();  // every partial is in its finisher's shared "
                             "memory; none is read remotely\n", "  if (a.rows > 0) return;\n")],
}

MLP_SRC = "grasp_any_region_tpu_torch/csrc/decode_mlp_sm90.cu"
WO_SRC = "grasp_any_region_tpu_torch/csrc/decode_attn_wo_sm90.cu"
SUM_SRC = "grasp_any_region_tpu_torch/csrc/ordered_sum.cuh"
MK_PY = "grasp_any_region_tpu_torch/ops/decode_megakernel.py"
MLP_SPLITS = "    return _card_mlp_splits(m // MLP_TILE, d, 16 if rows <= 16 else 32, q8, device.index)"
M_VARIANTS = {  # kernels 21-23 (TIMING_M)
    "m_parent": [],
    # timing only (wrong results): no ordered sum across clusters
    "m_no_sum": [(MLP_SRC, "      flags[j] = sum_completed(plan, block_of(j), tile, sum_arrive(plan, "
                  "block_of(j), tile));", "      flags[j] = 0;"),
                 (WO_SRC, "    if (tid == 0) last = sum_completed(", "    if (a.dm < 0) last = sum_completed(")],
    # 22: wo streamed after the attention at every B; timing only: no wo, no
    # products on the loaded boxes
    "m_22_streamed": [(WO_SRC, "  a.resident = per * G <= kWoResidentSlots",
                       "  a.resident = 0 && per * G <= kWoResidentSlots")],
    "m_22_no_wo": [(WO_SRC, "  const int n_box = n_ch * G;", "  const int n_box = 0 * n_ch * G;")],
    "m_22_no_products": [(WO_SRC, "      for (int n = 0; n < NT; ++n) mma_bf16_16816(acc[n], af, "
                          "bfr[n][0], bfr[n][1]);\n", "")],
    # 21 / 23: clusters of 8 CTAs a tile
    "m_mlp_splits_8": [(MK_PY, MLP_SPLITS, "    return 8")],
    # 22: 4 or 8 CTAs a (kv head, row) at every B (C's chooser: 2 at B = 24)
    "m_22_splits_4": [(MK_PY, "    return dec.card_splits(batch, kv_heads, device)", "    return 4")],
    "m_22_splits_8": [(MK_PY, "    return dec.card_splits(batch, kv_heads, device)", "    return 8")],
    # timing only: 21 / 23 arrive but do not sum
    "m_mlp_no_finish": [(MLP_SRC, "  if (m > 0)\n    sum_finish",
                         "  if (a.rows < 0 && m > 0)\n    sum_finish")],
    # timing only: the ordered sums' first level alone (no top arrivals)
    "m_level1_only": [(SUM_SRC, "  if (groups == 1) return;\n  sync();  // every group sum is stored",
                       "  if (groups >= 1) return;\n  sync();  // every group sum is stored")],
    # 21 / 23 and 22: no L2 cache hints on the weight loads
    "m_no_hints": [(MLP_SRC, "    const uint64_t policy = l2_evict_first();",
                    "    const uint64_t policy = l2_evict_first() * 0;"),
                   (MLP_SRC, "tma_load_4d_hint(st + bx * Sh::BOX1, &maps.gate, &full[s], m0 + bx * Sh::CPB, k,\n"
                    "                           a.layer, 0, policy);",
                    "tma_load_4d(st + bx * Sh::BOX1, &maps.gate, &full[s], m0 + bx * Sh::CPB, k, a.layer, 0);"),
                   (MLP_SRC, "tma_load_4d_hint(st + kMlpStage / 2 + bx * Sh::BOX1, &maps.up, &full[s],\n"
                    "                           m0 + bx * Sh::CPB, k, a.layer, 0, policy);",
                    "tma_load_4d(st + kMlpStage / 2 + bx * Sh::BOX1, &maps.up, &full[s], m0 + bx * Sh::CPB, k, a.layer, 0);"),
                   (MLP_SRC, "tma_load_4d_hint(st, &maps.down, &full[s], block_of(j - n1) * Sh::CPB, m0, a.layer, 0,\n"
                    "                         policy);",
                    "tma_load_4d(st, &maps.down, &full[s], block_of(j - n1) * Sh::CPB, m0, a.layer, 0);"),
                   (WO_SRC, "row0 + (j % G) * D, a.s.layer, 0, l2_evict_last());",
                    "row0 + (j % G) * D, a.s.layer, 0, 0 * l2_evict_last() + 0x1000000000000000ull);")],
}

STREAM_SRC = H_SRC
LM_PY = H_PY
TILE_SRC = "grasp_any_region_tpu_torch/csrc/weight_tile.cuh"
DEC_PY = "grasp_any_region_tpu_torch/ops/decode_attention.py"
I8_SPLITS = "_card_splits(m, din, dev.index, stream_n(torch.int8), STREAM_CTAS_PER_SM_Q8)"
Q8_VARIANTS = {  # kernels C8 and I8 (TIMING_Q8)
    "q8_parent": [],
    # C8: a deeper ring (C's too: TIMING_Q8 times C8 alone); clusters of up
    # to 8 or 4 CTAs (the chooser's cap)
    "c8_six_stages": VARIANTS["c_six_stages"],
    "c8_eight_stages": [(SPLIT, "constexpr int kSplitStages = 4;",
                         "constexpr int kSplitStages = 8;")],
    "c8_max_splits_8": [(DEC_PY, "MAX_SPLITS_Q8 = 16  #", "MAX_SPLITS_Q8 = 8  #")],
    "c8_max_splits_4": [(DEC_PY, "MAX_SPLITS_Q8 = 16  #", "MAX_SPLITS_Q8 = 4  #")],
    # timing only (wrong results): the int8 rows used as they land, not widened
    "c8_no_widen": [(SPLIT, "        widen_scaled(*reinterpret_cast<const uint4*>(qk + 16 * idx), "
                     "ksc, lo, hi);", "        lo = hi = *reinterpret_cast<const uint4*>(qk + 16 * "
                     "idx);"),
                    (SPLIT, "        widen_scaled(*reinterpret_cast<const uint4*>(qv + 16 * idx), "
                     "vsc, lo, hi);", "        lo = hi = *reinterpret_cast<const uint4*>(qv + 16 * "
                     "idx);")],
    # I8: a ring of 4 or 6 stages (H's too); clusters of 1 or 4 (two CTAs an
    # SM, each with half an SM's shared memory); stages handed back at once
    "i8_four_stages": [(STREAM_SRC, "constexpr int kWsStages = 3;", "constexpr int kWsStages = 4;")],
    "i8_six_stages": [(STREAM_SRC, "constexpr int kWsStages = 3;", "constexpr int kWsStages = 6;")],
    "i8_splits_1": [(LM_PY, I8_SPLITS, "1")],
    "i8_two_ctas_an_sm": [(LM_PY, "STREAM_CTAS_PER_SM_Q8 = 1", "STREAM_CTAS_PER_SM_Q8 = 2")],
    "i8_release_at_once": H_VARIANTS["h_release_at_once"],
    # timing only (wrong results): the int8 boxes not widened
    "i8_no_widen": [(TILE_SRC, """    static_assert(NT == 4, "two chunks of 16 int8 columns");
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      widen_i8x4(raw[2 * h], bfr[2 * h][0], bfr[2 * h + 1][0]);
      widen_i8x4(raw[2 * h + 1], bfr[2 * h][1], bfr[2 * h + 1][1]);
    }""", """#pragma unroll
    for (int h = 0; h < 2; ++h) {
      bfr[2 * h][0] = bfr[2 * h + 1][0] = raw[2 * h];
      bfr[2 * h][1] = bfr[2 * h + 1][1] = raw[2 * h + 1];
    }""")],
}

# lines of the stream's source that the variants below edit
X_WAIT = "  grid_dependency_wait();  // out may be memory the kernel before still reads\n"
MMA_LINE = ("            for (int n = 0; n < NT; ++n) mma_bf16_16816(acc[w][i][n], xa[h & 1][i], "
            "b[n][0], b[n][1]);\n")
AHEAD_LINE = "      for (int j = 0; j < ahead; ++j) weights(j, j);  // the weights wait for nothing\n"
PREFETCH_X = ('      asm volatile("prefetch.tensormap [%0];" :: "l"(reinterpret_cast<uint64_t>(&maps.x)) '
              ': "memory");\n')
X_ROWS = "  return (rows + 7) / 8 * 8;"
X_ROWS_16 = "  return rows <= 16 ? 16 : (rows + 7) / 8 * 8;"
ST_VARIANTS = {  # kernels H, H8, I and I8 (TIMING_STREAM)
    "st_parent": [],
    # H8: clusters of up to 16 CTAs (16 a tile at GAR-1B, 256 CTAs), not 8
    # (128 CTAs, each of which may take a whole SM's shared memory); of the
    # kernels timed, only H8's chooser reaches 16 at GAR-1B's widths
    "h8_sixteen_ctas_a_tile": [(LM_PY, "STREAM_N, STREAM_MAX_SPLITS, STREAM_CTAS_PER_SM = 64, 8, 2",
                                "STREAM_N, STREAM_MAX_SPLITS, STREAM_CTAS_PER_SM = 64, 16, 2")],
    # I: one CTA an SM (1 a tile at GAR-1B: 128 CTAs, no cluster reduction,
    # three stages at B = 24), not two (2 a tile, 256 CTAs, two stages)
    "i_one_cta_an_sm": [(LM_PY, "_card_splits(m, din, dev.index)",
                         "_card_splits(m, din, dev.index, STREAM_N, STREAM_CTAS_PER_SM_Q8)")],
    # the stream's partials stored fragment by fragment straight into their
    # finishers (4-byte remote stores), not staged and pushed in 16-byte
    # pieces
    "st_scattered_push": [(STREAM_SRC, """  float* part = reinterpret_cast<float*>(sm);
  __syncthreads();  // every stage is read
  if (warp < kWsConsumers) {""", """  float* part = reinterpret_cast<float*>(sm);
  const int cols = BN / splits;
  cluster_wait();
  if (warp < kWsConsumers) {"""), (STREAM_SRC, """            if (row < a.rows) part[(w * a.rows + row) * PP + col] = acc[w][i][j][e];
          }
  }
  __syncthreads();
  if constexpr (!SHARE) cluster_wait();  // every CTA of the cluster has started
  const int cols = BN / splits, quads = cols / 4, per_q = NW * a.rows * quads;
  for (int e = threadIdx.x; e < splits * per_q; e += kWsThreads) {""", """            if (row < a.rows)
              cluster.map_shared_rank(recv, col / cols)[((w * splits + rank) * a.rows + row) *
                                                            cols + col % cols] = acc[w][i][j][e];
          }
  }
  const int quads = cols / 4, per_q = NW * a.rows * quads;
  for (int e = threadIdx.x; e < 0 * splits * per_q; e += kWsThreads) {  // none: in place""")],
    # a deeper ring where the budget allows it (every stream kernel)
    "st_four_stages": [(STREAM_SRC, "constexpr int kWsStages = 3;",
                        "constexpr int kWsStages = 4;")],
    # timing only (wrong results), each leaving out one part of the work:
    # the reduction and the epilogue (CTAs leave after their main loop);
    # the products (and so the int8 widening that feeds them); x's loads
    # into the stages; the widening of int8 weights
    "st_no_epilogue": [(STREAM_SRC, X_WAIT, X_WAIT + "  if (a.rows > 0) return;\n")],
    "st_no_math": [(STREAM_SRC, MMA_LINE, "            ;\n")],
    "st_no_x_loads": [
        (STREAM_SRC, "NW * kWsBox + (XN == kXBoxes ? 2 * x_box : 0));",
         "NW * kWsBox + (XN == kXBoxes ? 0 * x_box : 0));"),
        (STREAM_SRC, "          for (int b = 0; b < 2; ++b)\n            tma_load_4d(xs",
         "          for (int b = 0; b < 0; ++b)\n            tma_load_4d(xs")],
    "st_no_widen": Q8_VARIANTS["i8_no_widen"],
    # x's tensor map fetched into the TMA unit's cache before the wait on
    # the kernel before (its first use is after it); x boxes of 16 rows up
    # to 16 rows (no row past the box), not B rounded up to 8
    "st_prefetch_x_map": [(STREAM_SRC, AHEAD_LINE, AHEAD_LINE + PREFETCH_X)],
    "st_x_rows_16": [(STREAM_SRC, X_ROWS, X_ROWS_16)],
}

QKV_PY = "grasp_any_region_tpu_torch/ops/decode_megakernel.py"
G8_VARIANTS = {  # kernels A, B and C at GAR-8B's head dims (TIMING_8B)
    "g8_parent": [],
    # two K/V stages at head dims 96 and 128 (160 KB with Q), not three (224
    # KB of the 227 a block takes)
    "g8_two_stages": [(FWD, "  static constexpr int kStages = 3;",
                       "  static constexpr int kStages = kAtoms == 1 ? 3 : 2;")],
}
BWD = "grasp_any_region_tpu_torch/csrc/flash_backward_sm90.cu"
W_VARIANTS = {  # kernel 18's wide instance: 5 at 96, the 18 call at 128 (TIMING_W)
    "w_parent": [],
    # a causal walk in one CTA, not split between the two of a cluster
    "w_unsplit": [(BWD, "  a.parts = head_dim > 64 && causal ? 2 : 1;", "  a.parts = 1;")],
    # a ring of two (Q, dO) stages, not three
    "w_two_stages": [(BWD, "  static constexpr int kStages = 3;",
                      "  static constexpr int kStages = 2;")],
    # at 96 dV and dK over 128 columns (TMA's zero-filled 96-127), not 96
    "w_n128_at_96": [(BWD, "  float dk[D / 2], dv[D / 2];", "  float dk[64], dv[64];"),
                     (BWD, """      if constexpr (D == 96) wgmma_m64n96k16_rs<1>(dv, pa[kk], dOm + su + 128 * kk);
      else wgmma_m64n128k16_rs<1>(dv, pa[kk], dOm + su + 128 * kk);""",
                      "      wgmma_m64n128k16_rs<1>(dv, pa[kk], dOm + su + 128 * kk);"),
                     (BWD, """      if constexpr (D == 96) wgmma_m64n96k16_rs<1>(dk, da[kk], dQm + su + 128 * kk);
      else wgmma_m64n128k16_rs<1>(dk, da[kk], dQm + su + 128 * kk);""",
                      "      wgmma_m64n128k16_rs<1>(dk, da[kk], dQm + su + 128 * kk);")],
    # full attention launched as causal is, key tile slowest (heaviest first)
    "w_key_tile_slowest": [(BWD, "  const int kt = CAUSAL ? item / (a.kv_heads * a.batch) : item % n_kt;",
                            "  const int kt = item / (a.kv_heads * a.batch);"),
                           (BWD, "  const int kvb = CAUSAL ? item % (a.kv_heads * a.batch) : item / n_kt;",
                            "  const int kvb = item % (a.kv_heads * a.batch);")],
}
QKV_VARIANTS = {  # kernels 19 and 20 (TIMING_QKV)
    "q_parent": [],
    # every CTA takes every row's rstd at every B (past 16 rows the CTAs of
    # a cluster share the rows' rstd by distributed shared memory)
    "q_rstd_each_cta": [(STREAM_SRC, "  constexpr bool SHARE = XN != kXBoxes && MT == 2;",
                         "  constexpr bool SHARE = false;")],
    # the rstd shared at every B
    "q_rstd_shared_at_every_b": [(STREAM_SRC, "  constexpr bool SHARE = XN != kXBoxes && MT == 2;",
                                  "  constexpr bool SHARE = XN != kXBoxes;")],
    # clusters grown while the grid stays within four CTAs an SM, not two
    # (19 at GAR-1B: 8 CTAs a tile, not 4; 20 stays at 8)
    "q_four_ctas_an_sm": [(QKV_PY, "    return min(lm.stream_splits(tiles, d, sms=sms), ",
                           "    return min(lm.stream_splits(tiles, d, sms=sms, ctas_per_sm=4), ")],
    # a ring of four stages (19 at GAR-1B: a CTA's whole K range in flight)
    "q_four_stages": [(STREAM_SRC, "constexpr int kWsStages = 3;", "constexpr int kWsStages = 4;")],
}

TIMING = r"""
import json, torch, chip_smoke as c
from grasp_any_region_tpu_torch.ops import decode_attention as dec
from grasp_any_region_tpu_torch.ops import flash_attention as fa
from grasp_any_region_tpu_torch.ops import vit_attention as va
c.phase_environment()
gen = torch.Generator(device="cuda").manual_seed(0)
def rnd(*shape):
    return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
t = {}
qkv = rnd(17, 1025, 3, 16, 64)
for s in (1025, 1024):
    q, k, v = (qkv[:, 1025 - s:, i] for i in range(3))
    ref = va.vit_attention_plain(q.float(), k.float(), v.float())
    c.max_err(va.vit_attention(q, k, v), ref, f"A S={s}", **c.sized_tol(ref))
    t[f"A S={s}"] = c.cuda_ms(lambda: va.vit_attention(q, k, v))
del qkv, q, k, v, ref
q, k, v = rnd(1, 4662, 32, 64), rnd(1, 4662, 8, 64), rnd(1, 4662, 8, 64)
t["B prefill"] = c.cuda_ms(lambda: fa.flash_attention(q, k, v, causal=True))
del q, k, v
pad, wpos, layer = 4662, 4700, 7
for b in (1, 2, 24):
    plens = {1: [4662], 2: [4662, 4000]}.get(b) or [min(x, pad) for x in c.PLENS_24]
    kw = dict(prompt_lens=torch.tensor(plens, dtype=torch.int32, device="cuda"),
              write_pos=torch.tensor(wpos, dtype=torch.int32, device="cuda"), prompt_pad=pad)
    k_all, v_all = rnd(16, b, 8, 5120, 64), rnd(16, b, 8, 5120, 64)
    q, k_new, v_new = rnd(b, 32, 64), rnd(b, 8, 64), rnd(b, 8, 64)
    k_ref, v_ref = k_all[layer:layer + 1].float(), v_all[layer:layer + 1].float()
    out = dec.decode_attention_fused(q, k_all, v_all, k_new, v_new, layer, **kw)
    ref = dec.decode_attention_fused_plain(q.float(), k_ref, v_ref, k_new.float(),
                                           v_new.float(), 0, **kw)
    c.max_err(out, ref, f"C B={b}", **c.TOL16)
    t[f"C B={b}"] = c.cuda_ms(lambda: dec.decode_attention_fused(q, k_all, v_all, k_new, v_new,
                                                                 layer, **kw))
    del k_all, v_all, k_ref, v_ref
print("AB " + json.dumps(t))
"""

TIMING_H = r"""
import json, torch, chip_smoke as c
from grasp_any_region_tpu_torch.ops import layer_matmul as lm
c.phase_environment()
gen = torch.Generator(device="cuda").manual_seed(0)
def rnd(*shape):
    return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
t = {}
for name, din in (("w_down", 8192), ("wo", 2048)):
    w = (rnd(16, din, 2048).float() * din ** -0.5).to(torch.bfloat16)
    for b in (1, 24):
        x = rnd(b, din)
        ref = lm.layer_matmul_plain(x.float(), w[7:8].float(), 0)
        try:
            c.max_err(lm.layer_matmul(x, w, 7), ref, f"H {name} B={b}")
        except AssertionError:  # a timing-only variant
            t["wrong results"] = 1
        t[f"{name} B={b}"] = c.cuda_ms(lambda: lm.layer_matmul(x, w, 7))
        t[f"{name} B={b} x16"] = c.cuda_ms(lambda: [lm.layer_matmul(x, w, i) for i in range(16)],
                                           iters=5, sleep_cycles=20_000_000) / 16
    del w
print("AB " + json.dumps(t))
"""

TIMING_M = r"""
import json, torch, chip_smoke as c
from grasp_any_region_tpu_torch.models.quantize import quantize_int8
from grasp_any_region_tpu_torch.ops import decode_attention as dec
from grasp_any_region_tpu_torch.ops import decode_megakernel as mk
from grasp_any_region_tpu_torch.ops import layer_matmul as lm
c.phase_environment()
gen = torch.Generator(device="cuda").manual_seed(0)
def rnd(*shape):
    return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
def stack(din, n):
    return (rnd(16, din, n).float() * din ** -0.5).to(torch.bfloat16)
t = {}
def check(out, ref, name):
    try:
        c.max_err(out, ref, name)
    except AssertionError:  # a timing-only variant
        t["wrong results"] = 1
d, m, layer = 2048, 8192, 7
wg, wu, wd = stack(d, m), stack(d, m), stack(m, d)
q8 = [u for w in (wg, wu, wd) for u in quantize_int8(w)]
norm = (1.0 + 0.2 * rnd(16, d).float()).to(torch.bfloat16)
for b in (1, 24):
    x = rnd(b, d) * 4
    for key, fn, plain, mats in (
            ("23", mk.layer_mlp_residual, mk.layer_mlp_residual_plain, (wg, wu, wd)),
            ("21", mk.layer_mlp_residual_q8, mk.layer_mlp_residual_q8_plain, q8)):
        check(fn(x, norm, *mats, layer, eps=1e-5), plain(x, norm, *mats, layer, eps=1e-5),
              f"{key} B={b}")
        t[f"{key} B={b}"] = c.cuda_ms(lambda: fn(x, norm, *mats, layer, eps=1e-5))
        t[f"{key} B={b} x16"] = c.cuda_ms(
            lambda: [fn(x, norm, *mats, i, eps=1e-5) for i in range(16)], iters=5,
            sleep_cycles=20_000_000) / 16
del wg, wu, wd, q8
wo = stack(2048, 2048)
wo8 = quantize_int8(wo)
pad, wpos = 4662, 4663
for b in (1, 24):
    plens = [pad] + [3000 + (97 * i) % 1663 for i in range(1, b)]
    kw = dict(prompt_lens=torch.tensor(plens, dtype=torch.int32, device="cuda"),
              write_pos=torch.tensor(wpos, dtype=torch.int32, device="cuda"), prompt_pad=pad)
    k_all, v_all = rnd(16, b, 8, 5120, 64), rnd(16, b, 8, 5120, 64)
    q, k_new, v_new, x = rnd(b, 32, 64), rnd(b, 8, 64), rnd(b, 8, 64), rnd(b, 2048)
    for label, w, s in (("bf16", wo, None), ("int8", *wo8)):
        k2, v2 = k_all[layer:layer + 1].clone(), v_all[layer:layer + 1].clone()
        ref = mk.decode_attention_wo_plain(q, k2, v2, k_new, v_new, w[layer:layer + 1], x, 0,
                                           wo_scale=None if s is None else s[layer:layer + 1],
                                           **kw)
        del k2, v2
        run = lambda: mk.decode_attention_wo(q, k_all, v_all, k_new, v_new, w, x, layer,
                                             wo_scale=s, **kw)
        check(run(), ref, f"22 {label} B={b}")
        t[f"22 {label} B={b}"] = c.cuda_ms(run)
    t[f"C B={b}"] = c.cuda_ms(lambda: dec.decode_attention_fused(q, k_all, v_all, k_new, v_new,
                                                                 layer, **kw))
    t[f"C+H B={b}"] = c.cuda_ms(lambda: lm.layer_matmul(dec.decode_attention_fused(
        q, k_all, v_all, k_new, v_new, layer, **kw).reshape(b, 2048), wo, layer))
    del k_all, v_all
print("AB " + json.dumps(t))
"""


TIMING_Q8 = r"""
import json, torch, chip_smoke as c
from grasp_any_region_tpu_torch.models.quantize import quantize_int8
from grasp_any_region_tpu_torch.ops import decode_attention as dec
from grasp_any_region_tpu_torch.ops import layer_matmul as lm
c.phase_environment()
gen = torch.Generator(device="cuda").manual_seed(0)
def rnd(*shape):
    return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
t = {}
def check(out, ref, name, **tol):
    try:
        c.max_err(out, ref, name, **tol)
    except AssertionError:  # a timing-only variant
        t["wrong results"] = 1
layer, pad, wpos = 7, 4662, 4662 + 128
for b in (1, 24):
    k_all, v_all = (torch.randint(-127, 128, (16, b, 8, 5120, 64), generator=gen, device="cuda",
                                  dtype=torch.int8) for _ in range(2))
    ks, vs = ((torch.rand((16, b, 4, 1, 1), generator=gen, device="cuda") + 0.5) / 73.3
              for _ in range(2))
    plens = [pad] + [3000 + (97 * i) % 1663 for i in range(1, b)]
    q, kn, vn = rnd(b, 32, 64), rnd(b, 8, 64), rnd(b, 8, 64)
    kw = dict(prompt_lens=torch.tensor(plens, dtype=torch.int32, device="cuda"),
              write_pos=torch.tensor(wpos, dtype=torch.int32, device="cuda"), prompt_pad=pad,
              k_scale=ks, v_scale=vs)
    ref = dec.decode_attention_fused_q8_plain(q.float(), k_all[layer:layer + 1].clone(),
                                              v_all[layer:layer + 1].clone(), kn, vn, 0,
                                              **dict(kw, k_scale=ks[layer:layer + 1],
                                                     v_scale=vs[layer:layer + 1]))
    check(dec.decode_attention_fused(q, k_all, v_all, kn, vn, layer, **kw), ref, f"C8 B={b}",
          **c.TOL16)
    t[f"C8 B={b}"] = c.cuda_ms(lambda: dec.decode_attention_fused(q, k_all, v_all, kn, vn,
                                                                  layer, **kw))
    del k_all, v_all
d, m = 2048, 8192
wg, wu = ((rnd(16, d, m).float() * d ** -0.5).to(torch.bfloat16) for _ in range(2))
mats = (*quantize_int8(wg), *quantize_int8(wu))
del wg, wu
for b in (1, 24):
    x = rnd(b, d)
    check(lm.layer_swiglu_q8(x, *mats, layer), lm.layer_swiglu_q8_plain(x.float(), *mats, layer),
          f"I8 B={b}")
    t[f"I8 B={b}"] = c.cuda_ms(lambda: lm.layer_swiglu_q8(x, *mats, layer))
    t[f"I8 B={b} x16"] = c.cuda_ms(lambda: [lm.layer_swiglu_q8(x, *mats, i) for i in range(16)],
                                   iters=5, sleep_cycles=20_000_000) / 16
print("AB " + json.dumps(t))
"""

TIMING_STREAM = r"""
import json, torch, chip_smoke as c
from grasp_any_region_tpu_torch.models.quantize import quantize_int8
from grasp_any_region_tpu_torch.ops import layer_matmul as lm
c.phase_environment()
gen = torch.Generator(device="cuda").manual_seed(0)
def rnd(*shape):
    return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
def stack(din, n):
    return (rnd(16, din, n).float() * din ** -0.5).to(torch.bfloat16)
t = {}
def check(out, ref, name):
    try:
        c.max_err(out, ref, name)
    except AssertionError:  # a timing-only variant
        t["wrong results"] = 1
layer = 7
cases = {}
for name, din in (("w_down", 8192), ("wo", 2048)):
    w = stack(din, 2048)
    cases[f"H {name}"] = (lm.layer_matmul, lm.layer_matmul_plain, (w,), din)
    cases[f"H8 {name}"] = (lm.layer_matmul_q8, lm.layer_matmul_q8_plain, quantize_int8(w), din)
gate_up = (stack(2048, 8192), stack(2048, 8192))
cases["I"] = (lm.layer_swiglu, lm.layer_swiglu_plain, gate_up, 2048)
cases["I8"] = (lm.layer_swiglu_q8, lm.layer_swiglu_q8_plain,
               (*quantize_int8(gate_up[0]), *quantize_int8(gate_up[1])), 2048)
for name, (fn, plain, mats, din) in cases.items():
    for b in (1, 24):
        x = rnd(b, din)
        check(fn(x, *mats, layer), plain(x.float(), *mats, layer), f"{name} B={b}")
        t[f"{name} B={b}"] = c.cuda_ms(lambda: fn(x, *mats, layer))
        t[f"{name} B={b} x16"] = c.cuda_ms(lambda: [fn(x, *mats, i) for i in range(16)],
                                           iters=5, sleep_cycles=20_000_000) / 16
print("AB " + json.dumps(t))
"""

TIMING_VIT = r"""
import json, torch, chip_smoke as c
from grasp_any_region_tpu_torch.core.config import gar_1b
from grasp_any_region_tpu_torch.models.gar import decode_mask_values, mask_patch_embed
from grasp_any_region_tpu_torch.models.vision import vision_forward
from grasp_any_region_tpu_torch.ops import vit_block as vb
c.phase_environment()
gen = torch.Generator(device="cuda").manual_seed(0)
def rnd(*shape):
    return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
def w(*shape, scale):
    return (rnd(*shape).float() * scale).to(torch.bfloat16)
t = {}
T, S, d, m = 17, 1025, 1024, 4096
x, attn = rnd(T, S, d), rnd(T, S, d)
ln = (1.0 + w(d, scale=0.2), w(d, scale=0.2))
cases = dict(
    D=(vb.vit_ln_qkv, vb.vit_ln_qkv_plain,
       (x, *ln, w(d, 3 * d, scale=d ** -0.5), w(3 * d, scale=0.1)), {}),
    F=(vb.vit_wo_residual, vb.vit_wo_residual_plain,
       (attn, x, w(d, d, scale=d ** -0.5), w(d, scale=0.1), w(d, scale=0.5)), {}),
    G=(vb.vit_mlp_residual, vb.vit_mlp_residual_plain,
       (x, *ln, w(d, m, scale=d ** -0.5), w(m, scale=0.1), w(m, d, scale=m ** -0.5),
        w(d, scale=0.1), w(d, scale=0.5)), dict(fast_gelu=True)))
for name, (fn, plain, args, kw) in cases.items():
    ref = plain(*(a.float() for a in args), **kw)
    try:
        c.max_err(fn(*args, **kw), ref, name, **c.sized_tol(ref))
    except AssertionError:
        t[f"{name} outside the sized tolerance"] = 1
    del ref
    t[name] = c.cuda_ms(lambda: fn(*args, **kw))
del x, attn, cases
cfg = gar_1b()
params = c.random_params(cfg, "cuda")
with torch.inference_mode():
    batch, _ = c.bench_batch(cfg, "cuda")
    pix = batch.pixel_values.reshape((-1,) + batch.pixel_values.shape[2:])
    msk = batch.mask_values.reshape((-1,) + batch.mask_values.shape[2:])
    me = mask_patch_embed(params, cfg, decode_mask_values(cfg, msk, compat=False)
                          .to(torch.bfloat16))
    run = lambda: vision_forward(params.vision, cfg.vision, pix, me, fused_blocks=True)
    t["fused tower"] = c.cuda_ms(run, iters=5, warmup=1)
print("AB " + json.dumps(t))
"""

TIMING_STEPS = r"""
import json, torch, chip_smoke as c
from grasp_any_region_tpu_torch.core.config import gar_1b
from grasp_any_region_tpu_torch.models.gar import gar_prefill, seed_cache_from_prefill
from grasp_any_region_tpu_torch.models.llama import embed_tokens, llama_decode_step, lm_logits
from grasp_any_region_tpu_torch.models.quantize import quantize_decode_weights
c.phase_environment()
cfg = gar_1b()
params = c.random_params(cfg, "cuda")
params_q8 = quantize_decode_weights(params)
t = {}
with torch.inference_mode():
    batch, plens = c.bench_batch(cfg, "cuda")
    s = batch.input_ids.shape[1]
    hidden, kv = gar_prefill(params, cfg, batch, mask_compat=False)
    first = lm_logits(params.llm, cfg.text, hidden[:, -1],
                      valid_vocab=cfg.extended_vocab_size).argmax(-1)
    max_len = ((s + 256 + 511) // 512) * 512
    seeded = {q8: seed_cache_from_prefill(cfg, kv, plens, max_len, quantize_kv=q8)
              for q8 in (False, True)}
    del hidden, kv
    emb = embed_tokens(params.llm, first[:, None])
    outs = {}
    for form, llm, q8, use in (("xla", params.llm, False, False),
                               ("fused", params.llm, False, "fused"),
                               ("int8", params_q8.llm, True, None),
                               ("mega", params.llm, False, "mega"),
                               ("mega int8 weights", params_q8.llm, False, "mega")):
        src = seeded[q8]
        cache = src._replace(k=src.k.clone(), v=src.v.clone(), write_pos=src.write_pos.clone())
        step = lambda: llama_decode_step(llm, cfg.text, emb, cache, s, use_kernel=use)
        outs[form] = step()[0].float()
        t[f"{form} device ms"], t[f"{form} host ms"] = c.step_times(step)
    got, want = outs["fused"], outs["xla"]
    t["fused vs xla"] = ((got - want).abs().max() / want.abs().max()).item()
    t["mega vs xla"] = ((outs["mega"] - want).abs().max() / want.abs().max()).item()
    if (max(t["fused vs xla"], t["mega vs xla"]) > c.E2E_TOL
            or not all(torch.isfinite(outs[f]).all() for f in ("int8", "mega int8 weights"))):
        t["wrong results"] = 1
print("AB " + json.dumps(t))
"""


TIMING_QKV = r"""
import json, torch, chip_smoke as c
from grasp_any_region_tpu_torch.core.config import gar_1b
from grasp_any_region_tpu_torch.models.quantize import quantize_int8
from grasp_any_region_tpu_torch.ops import decode_megakernel as mk
from grasp_any_region_tpu_torch.ops.rope import llama_inv_freq, rope_cos_sin
c.phase_environment()
gen = torch.Generator(device="cuda").manual_seed(0)
def rnd(*shape):
    return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
def stack(din, n):
    return (rnd(16, din, n).float() * din ** -0.5).to(torch.bfloat16)
t = {}
d, hq, hk, layer = 2048, 2048, 512, 7
bf = (stack(d, hq), stack(d, hk), stack(d, hk))
q8 = [u for w in bf for u in quantize_int8(w)]
norm = (1.0 + 0.2 * rnd(16, d).float()).to(torch.bfloat16)
for b in (1, 24):
    cos, sin = rope_cos_sin(torch.arange(b, device="cuda") + 4663, llama_inv_freq(gar_1b().text,
                                                                                  "cuda"))
    x = rnd(b, d) * 4
    for key, fn, plain, mats in (("19", mk.layer_qkv_norm_rope, mk.layer_qkv_norm_rope_plain, bf),
                                 ("20", mk.layer_qkv_norm_rope_q8, mk.layer_qkv_norm_rope_q8_plain,
                                  q8)):
        args = (x, norm, *mats, cos, sin, cos, sin)
        run = lambda i=layer: fn(*args, i, eps=1e-5, head_dim=64)
        try:
            for o, r in zip(run(), plain(*args, layer, eps=1e-5, head_dim=64)):
                c.max_err(o, r, f"{key} B={b}")
        except AssertionError:  # a timing-only variant
            t["wrong results"] = 1
        t[f"{key} B={b}"] = c.cuda_ms(run)
        t[f"{key} B={b} x16"] = c.cuda_ms(lambda: [run(i) for i in range(16)], iters=5,
                                          sleep_cycles=20_000_000) / 16
print("AB " + json.dumps(t))
"""


TIMING_J = r"""
import json, torch, chip_smoke as c
from grasp_any_region_tpu_torch.models.quantize import quantize_int8
from grasp_any_region_tpu_torch.ops import layer_matmul as lm
c.phase_environment()
gen = torch.Generator(device="cuda").manual_seed(0)
def rnd(*shape):
    return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
def stack(din, n):
    return (rnd(16, din, n).float() * din ** -0.5).to(torch.bfloat16)
t = {}
d, hq, hk, layer = 2048, 2048, 512, 7
bf = (stack(d, hq), stack(d, hk), stack(d, hk))
q8 = [u for w in bf for u in quantize_int8(w)]
for b in (1, 24):
    x = rnd(b, d)
    for key, fn, plain, mats in (("J", lm.layer_qkv, lm.layer_qkv_plain, bf),
                                 ("J8", lm.layer_qkv_q8, lm.layer_qkv_q8_plain, q8)):
        try:
            for o, r in zip(fn(x, *mats, layer), plain(x.float(), *mats, layer)):
                c.max_err(o, r, f"{key} B={b}")
        except AssertionError:  # a timing-only variant
            t["wrong results"] = 1
        t[f"{key} B={b}"] = c.cuda_ms(lambda: fn(x, *mats, layer))
        t[f"{key} B={b} x16"] = c.cuda_ms(lambda: [fn(x, *mats, i) for i in range(16)], iters=5,
                                          sleep_cycles=20_000_000) / 16
        t[f"{key} B={b} host us"] = c.host_us(lambda: fn(x, *mats, layer))
print("AB " + json.dumps(t))
"""


TIMING_BITS = r"""
import hashlib, json, torch, chip_smoke as c
from grasp_any_region_tpu_torch.models.quantize import quantize_int8
from grasp_any_region_tpu_torch.ops import decode_megakernel as mk
from grasp_any_region_tpu_torch.ops import layer_matmul as lm
c.phase_environment()
gen = torch.Generator(device="cuda").manual_seed(0)
def rnd(*shape):
    return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
def stack(din, n):
    return (rnd(4, din, n).float() * din ** -0.5).to(torch.bfloat16)
wd, wo, wg, wu = stack(8192, 2048), stack(2048, 2048), stack(2048, 8192), stack(2048, 8192)
wd2 = wg.transpose(1, 2).contiguous()
norm = (1.0 + 0.2 * rnd(4, 2048).float()).to(torch.bfloat16)
q = {k: quantize_int8(w) for k, w in dict(wd=wd, wo=wo, wg=wg, wu=wu, wd2=wd2).items()}
wqkv = (stack(2048, 2048), stack(2048, 512), stack(2048, 512))
qkv8 = [u for w in wqkv for u in quantize_int8(w)]
out = {}
for b in (1, 5, 17, 24, 32):
    x8k, x2k = rnd(b, 8192), rnd(b, 2048)
    ang = torch.arange(32 * b, device="cuda").float().reshape(b, 32) * 0.37
    cos, sin = torch.cos(torch.cat([ang, ang], -1)), torch.sin(torch.cat([ang, ang], -1))
    out[f"J {b}"] = torch.cat(lm.layer_qkv(x2k, *wqkv, 2), -1)
    out[f"J8 {b}"] = torch.cat(lm.layer_qkv_q8(x2k, *qkv8, 2), -1)
    out[f"19 {b}"] = torch.cat(mk.layer_qkv_norm_rope(x2k * 3, norm, *wqkv, cos, sin, cos, sin, 1,
                                                      eps=1e-5, head_dim=64), -1)
    out[f"20 {b}"] = torch.cat(mk.layer_qkv_norm_rope_q8(x2k * 3, norm, *qkv8, cos, sin, cos, sin,
                                                         1, eps=1e-5, head_dim=64), -1)
    out[f"H wd {b}"] = lm.layer_matmul(x8k, wd, 2)
    out[f"H wo {b}"] = lm.layer_matmul(x2k, wo, 2)
    out[f"H8 wd {b}"] = lm.layer_matmul_q8(x8k, *q["wd"], 2)
    out[f"H8 wo {b}"] = lm.layer_matmul_q8(x2k, *q["wo"], 2)
    out[f"I {b}"] = lm.layer_swiglu(x2k, wg, wu, 2)
    out[f"I8 {b}"] = lm.layer_swiglu_q8(x2k, *q["wg"], *q["wu"], 2)
    out[f"23 {b}"] = mk.layer_mlp_residual(x2k * 3, norm, wg, wu, wd2, 1, eps=1e-5)
    out[f"21 {b}"] = mk.layer_mlp_residual_q8(x2k * 3, norm, *q["wg"], *q["wu"], *q["wd2"], 1,
                                              eps=1e-5)
torch.cuda.synchronize()
print("AB " + json.dumps({k: hashlib.sha256(v.cpu().view(torch.int16).numpy().tobytes())
                          .hexdigest()[:12] for k, v in out.items()}))
"""


TIMING_ATTN_BITS = r"""
import hashlib, json, torch, chip_smoke as c
from grasp_any_region_tpu_torch.ops import decode_attention as dec
from grasp_any_region_tpu_torch.ops import decode_megakernel as mk
from grasp_any_region_tpu_torch.ops import flash_attention as fa
from grasp_any_region_tpu_torch.ops import vit_attention as va
c.phase_environment()
gen = torch.Generator(device="cuda").manual_seed(0)
def rnd(*shape):
    return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
def i32(x):
    return torch.tensor(x, dtype=torch.int32, device="cuda")
out = {}
qkv = rnd(17, 1025, 3, 16, 64)
out["A"], out["A lse"] = va.vit_attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2],
                                          return_lse=True)
q, k, v = rnd(1, 4662, 32, 64), rnd(1, 4662, 8, 64), rnd(1, 4662, 8, 64)
out["B"], out["B lse"] = fa.flash_attention(q, k, v, causal=True, return_lse=True)
out["B full"] = fa.flash_attention(q[:, :1000], k, v, causal=False)
seg = torch.zeros((2, 4096), dtype=torch.int32, device="cuda")
seg[:, :1500], seg[:, 1500:4000] = 1, 2
out["B seg"] = fa.flash_attention(rnd(2, 4096, 32, 64), rnd(2, 4096, 8, 64), rnd(2, 4096, 8, 64),
                                  causal=True, segment_ids=seg)
pad, wpos, s = 4662, 4700, 5120
wo = (rnd(16, 2048, 2048).float() * 2048 ** -0.5).to(torch.bfloat16)
for b in (1, 2, 24):
    plens = [4662] if b == 1 else [4662 - 150 * i for i in range(b)]
    kw = dict(prompt_lens=i32(plens), write_pos=i32(wpos), prompt_pad=pad)
    k_all, v_all = rnd(16, b, 8, s, 64), rnd(16, b, 8, s, 64)
    q, kn, vn, x = rnd(b, 32, 64), rnd(b, 8, 64), rnd(b, 8, 64), rnd(b, 2048)
    out[f"16 B={b}"] = dec.decode_attention_stacked(q, k_all, v_all, i32(7), **kw)
    out[f"22 B={b}"] = mk.decode_attention_wo(q, k_all, v_all, kn, vn, wo, x, 6, **kw)
    out[f"C B={b}"] = dec.decode_attention_fused(q, k_all, v_all, kn, vn, 7, **kw)
    g8 = torch.Generator(device="cuda").manual_seed(b)
    k8, v8 = (torch.randint(-127, 128, (16, b, 8, s, 64), generator=g8, device="cuda",
                            dtype=torch.int8) for _ in range(2))
    ks, vs = (torch.rand((16, b, 4, 1, 1), generator=g8, device="cuda") / 50 + 0.01
              for _ in range(2))
    out[f"C8 B={b}"] = dec.decode_attention_fused(q, k8, v8, kn, vn, 7, k_scale=ks, v_scale=vs,
                                                  **kw)
    out[f"C8 column B={b}"] = torch.cat([k8[7, :, :, wpos], v8[7, :, :, wpos]], -1)
    del k_all, v_all, k8, v8
torch.cuda.synchronize()
print("AB " + json.dumps({k: hashlib.sha256(v.contiguous().cpu().view(torch.int8).numpy()
                                            .tobytes()).hexdigest()[:12]
                          for k, v in out.items()}))
"""

# GAR-8B's attention shapes: A at (9, S, 16, 96) views of a qkv buffer, S =
# 1025 and 1024; B at the 2614-token causal prefill, 32 / 8 heads of 128; C
# over layer 7 of an (8, B, 8, 3072, 128) cache at B = 1 and 24, write_pos
# 2650; each checked against its plain version.
TIMING_8B = r"""
import json, torch, chip_smoke as c
from grasp_any_region_tpu_torch.ops import decode_attention as dec
from grasp_any_region_tpu_torch.ops import flash_attention as fa
from grasp_any_region_tpu_torch.ops import vit_attention as va
c.phase_environment()
gen = torch.Generator(device="cuda").manual_seed(0)
def rnd(*shape):
    return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
t = {}
qkv = rnd(9, 1025, 3, 16, 96)
for s in (1025, 1024):
    q, k, v = (qkv[:, 1025 - s:, i] for i in range(3))
    ref = va.vit_attention_plain(q.float(), k.float(), v.float())
    c.max_err(va.vit_attention(q, k, v), ref, f"A96 S={s}", **c.sized_tol(ref))
    t[f"A96 S={s}"] = c.cuda_ms(lambda: va.vit_attention(q, k, v))
del qkv, q, k, v, ref
q, k, v = rnd(1, 2614, 32, 128), rnd(1, 2614, 8, 128), rnd(1, 2614, 8, 128)
ref = fa.flash_attention_plain(q.float(), k.float(), v.float(), causal=True)
c.max_err(fa.flash_attention(q, k, v, causal=True), ref, "B128", **c.sized_tol(ref))
t["B128 prefill"] = c.cuda_ms(lambda: fa.flash_attention(q, k, v, causal=True))
del q, k, v, ref
pad, wpos, layer = 2614, 2650, 7
for b in (1, 24):
    plens = [pad] if b == 1 else [pad - 100 * i for i in range(b)]
    kw = dict(prompt_lens=torch.tensor(plens, dtype=torch.int32, device="cuda"),
              write_pos=torch.tensor(wpos, dtype=torch.int32, device="cuda"), prompt_pad=pad)
    k_all, v_all = rnd(8, b, 8, 3072, 128), rnd(8, b, 8, 3072, 128)
    q, k_new, v_new = rnd(b, 32, 128), rnd(b, 8, 128), rnd(b, 8, 128)
    k_ref, v_ref = k_all[layer:layer + 1].float(), v_all[layer:layer + 1].float()
    out = dec.decode_attention_fused(q, k_all, v_all, k_new, v_new, layer, **kw)
    ref = dec.decode_attention_fused_plain(q.float(), k_ref, v_ref, k_new.float(),
                                           v_new.float(), 0, **kw)
    c.max_err(out, ref, f"C128 B={b}", **c.TOL16)
    t[f"C128 B={b}"] = c.cuda_ms(lambda: dec.decode_attention_fused(q, k_all, v_all, k_new,
                                                                    v_new, layer, **kw))
    del k_all, v_all, k_ref, v_ref
print("AB " + json.dumps(t))
"""

# Kernel 18's wide instance at GAR-8B's shapes: kernel 5 (17's prep, 18 at
# head dim 96, 17's cast) at (9, S, 16, 96), v a view of a (T, S, 3, H, 96)
# buffer, S = 1025 and 1024; 18 alone and the 18 call (17, 18, 17) at the
# 2614-token prompt, causal, 32 / 8 heads of 128, without and with two
# documents and padding; each checked against its plain version at the
# output-sized tolerance; SDPA's backward at both shapes as the yardstick.
TIMING_W = r"""
import json, torch, chip_smoke as c
from grasp_any_region_tpu_torch.ops import flash_attention as fa
from grasp_any_region_tpu_torch.ops import flash_backward as fb
from grasp_any_region_tpu_torch.ops import vit_attention as va
c.phase_environment()
gen = torch.Generator(device="cuda").manual_seed(0)
def rnd(*shape):
    return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
def check(got, want, name):
    for n, a, w in zip(("dq", "dk", "dv"), got, want):
        c.max_err(a, w, f"{name} {n}", **c.sized_tol(w))
t = {}
q, k, g = (rnd(9, 1025, 16, 96) for _ in range(3))
v = rnd(9, 1025, 3, 16, 96)[:, :, 2]
for s in (1025, 1024):
    x = [y[:, 1025 - s:] if y is v else y[:, 1025 - s:].contiguous() for y in (q, k, v, g)]
    out, lse = va.vit_attention(*x[:3], return_lse=True)
    args = (*x[:3], out, lse, x[3])
    check(va.vit_attention_bwd(*args), va.vit_attention_bwd_plain(*args), f"5 S={s}")
    t[f"5 S={s}"] = c.cuda_ms(lambda: va.vit_attention_bwd(*args))
t["5 SDPA bwd"] = c.sdpa_bwd_ms(q, k, v, g)
del q, k, v, g, x, out, lse, args
n = c.GAR8B_PROMPT
q, g = rnd(1, n, 32, 128), rnd(1, n, 32, 128)
k, v = rnd(1, n, 8, 128), rnd(1, n, 8, 128)
seg = torch.zeros((1, n), dtype=torch.int32)
seg[0, :1900], seg[0, 1900:2500] = 1, 2
for name, sg in (("18 causal", None), ("18 documents", seg.cuda())):
    kw = dict(causal=True, segment_ids=sg)
    out, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
    check(fb.flash_attention_bwd(q, k, v, out, lse, g, **kw),
          fb.flash_attention_bwd_plain(q, k, v, out, lse, g, **kw), name)
    delta, acc = fb.bwd_prep(out, g)
    t[name] = c.cuda_ms(lambda: fb.flash_attention_bwd_dkv(q, k, v, g, lse, delta, acc, **kw))
    t[name + " call"] = c.cuda_ms(lambda: fb.flash_attention_bwd(q, k, v, out, lse, g, **kw))
t["18 SDPA bwd"] = c.sdpa_bwd_ms(q, k, v, g, is_causal=True, enable_gqa=True)
print("AB " + json.dumps(t))
"""

# The GAR-8B LoRA step as chip_smoke.py's phase runs it: its median and its
# three timed steps.
TIMING_LORA = r"""
import contextlib, io, json, re, chip_smoke as c
c.phase_environment()
buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    c.phase_gar8b_train()
m = re.search(r"ms/step ([0-9.]+) \(median of [0-9]+; steps ([^)]*)\)", buf.getvalue())
print("AB " + json.dumps({"8B LoRA step": float(m.group(1)), "steps": m.group(2)}))
"""


def against(other: str, timing: str = "q8") -> int:
    """One timing (TIMING_Q8, or TIMING, TIMING_H, TIMING_M, TIMING_STREAM,
    TIMING_STEPS, TIMING_VIT, TIMING_QKV, TIMING_J as abc, h, m, stream,
    steps, vit, qkv, j; or TIMING_BITS as bits) in
    the package checked out at `other` (e.g. `git archive` of the parent
    commit unpacked there) and in this tree, in turns: other, this, this,
    other."""
    code = dict(q8=TIMING_Q8, abc=TIMING, h=TIMING_H, m=TIMING_M, stream=TIMING_STREAM,
                steps=TIMING_STEPS, vit=TIMING_VIT, qkv=TIMING_QKV, j=TIMING_J,
                bits=TIMING_BITS, attn_bits=TIMING_ATTN_BITS, gar8b=TIMING_8B,
                wide=TIMING_W, lora_step=TIMING_LORA)[timing]
    for name, d in (("other", other), ("tree", str(REPO)), ("tree", str(REPO)), ("other", other)):
        res = run(Path(d), ["-c", code], 900)
        lines = [x for x in res.stdout.splitlines() if x.startswith("AB ")]
        print(f"[cmp] {name}: {lines[-1] if lines else (res.stdout + res.stderr)[-600:]}",
              flush=True)
    return 0


def main(names: list[str]) -> int:
    if names and names[0].startswith("--against="):
        return against(names[0].split("=", 1)[1], *names[1:])
    h = bool(names) and all(n.startswith("h_") for n in names)
    mega = bool(names) and all(n.startswith("m_") for n in names)
    q8 = bool(names) and all(n.startswith(("c8_", "i8_")) for n in names)
    st = bool(names) and all(n.startswith(("st_", "h8_", "i_")) for n in names)
    qkv = bool(names) and all(n.startswith("q_") for n in names)
    g8 = bool(names) and all(n.startswith("g8_") for n in names)
    wide = bool(names) and all(n.startswith("w_") for n in names)
    variants, parent, timing = ((H_VARIANTS, "h_parent", TIMING_H) if h
                                else (G8_VARIANTS, "g8_parent", TIMING_8B) if g8
                                else (W_VARIANTS, "w_parent", TIMING_W) if wide
                                else (QKV_VARIANTS, "q_parent", TIMING_QKV) if qkv
                                else (M_VARIANTS, "m_parent", TIMING_M) if mega
                                else (Q8_VARIANTS, "q8_parent", TIMING_Q8) if q8
                                else (ST_VARIANTS, "st_parent", TIMING_STREAM) if st
                                else (VARIANTS, "parent", TIMING))
    unknown = set(names) - set(variants)
    if unknown:
        raise SystemExit(f"unknown variants {sorted(unknown)}; known: {list(variants)}")
    chosen = [parent] + [n for n in variants if n != parent and (not names or n in names)]
    copies = {name: make_copy(f"ab_{name}", variants[name]) for name in chosen}
    for name in chosen + chosen[::-1]:
        res = run(copies[name], ["-c", timing], 900)
        lines = [x for x in res.stdout.splitlines() if x.startswith("AB ")]
        if res.returncode or not lines:
            tail = (res.stdout + res.stderr).strip().splitlines()[-3:]
            print(f"[ab] {name}: failed: {' | '.join(tail)}", flush=True)
            continue
        times = json.loads(lines[-1][3:])
        print(f"[ab] {name}: " + ", ".join(f"{k} {v:.4f}" for k, v in times.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
