"""Mutants of kernels A, B and E (csrc/flash_forward_sm90.cu), D, F and
G (csrc/gemm_sm90.cu, its main loop csrc/gemm_sm90.cuh, and D's and G's
LayerNorm pass, csrc/layer_norm.cuh), 5 (kernel
18's non-causal pass with the folded tail, csrc/flash_backward_sm90.cu),
C, C8 and 16 (the split-KV body, csrc/decode_split.cuh), H, H8, I, I8, J,
J8, 19 and 20 (the TMA-fed weight stream, csrc/layer_matmul_sm90.cu), 21 / 23 (the MLP's weight
stream, csrc/decode_mlp_sm90.cu), 22 (C's body with wo,
csrc/decode_attn_wo_sm90.cu) and their ordered sum (csrc/ordered_sum.cuh)
that the checks must catch. Each mutant names the source it edits and is
built in its own copy of the package under build/copies/ (ops/_build.py
builds a copy into its own build/), and two checks run there on the card:

- the card tests of those kernels in tests/test_torch_gpu.py, each case
  with its own verdict: a case that loses the CUDA context (a trapped
  kernel) ends its process, and the cases after it run again in a fresh
  one;
- phase 2 of chip_smoke.py (every kernel against its plain version), which
  stops at the first check that fails and names it. The mega step's
  mutants (MEGA, and 19's and 20's, QKV) run the mega kernels' part of it
  (`mega_kernels`: 19-23 at B = 24 and 1, each against its plain version,
  19 and 20 also against their stream mirrors and 20 on its xn low-half
  probe, a second launch's bits, the counters at 0), and only the mega
  kernels' card tests (QKV: 19's and 20's and the mega step's). C8's
  and I8's (Q8) run their kernel's part of it (`decode_attention_q8_kernel`
  or `decode_matmul_kernels`) and the int8 card cases; H8's, I's and x's
  misplaced box (ST) `decode_matmul_kernels` and the stream's card cases;
  J's and J8's (JQKV) `decode_matmul_kernels` and the card cases of J, J8
  and the fused decode steps;
  the ViT block's (VIT) `vit_block_kernels`, then `layer_norm_kernel`, and
  the card cases of D, F, G, 24 and the tower's form.

A mutant that no check catches means checks too weak to see that defect.
Run from the repository root on a machine with the card, for every mutant
or the named ones:

    python3 forward_mutants.py [name ...]
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
import xml.etree.ElementTree as ET
from pathlib import Path

REPO = Path(__file__).resolve().parent
COPIES = REPO / "build" / "copies"  # gitignored
CSRC = "grasp_any_region_tpu_torch/csrc/"
FWD, GEMM, GEMM_LOOP, BWD, SPLIT, STREAM, MLP, ATTN_WO, ORDERED, LN = (CSRC + name for name in (
    "flash_forward_sm90.cu", "gemm_sm90.cu", "gemm_sm90.cuh", "flash_backward_sm90.cu",
    "decode_split.cuh", "layer_matmul_sm90.cu", "decode_mlp_sm90.cu", "decode_attn_wo_sm90.cu",
    "ordered_sum.cuh", "layer_norm.cuh"))
MUTANTS = {  # name: (source, [(old, new), ...] in it)
    "drop_last_key_tile": (FWD, [
        # B: the causal band and the full rows lose their last key tile
        ("const int n_kt = CAUSAL ? min(n_kt_all, (a.q_offset + q0 + kFwdM - 1) / kFwdN + 1) "
         ": n_kt_all;",
         "const int n_kt = max(1, (CAUSAL ? min(n_kt_all, (a.q_offset + q0 + kFwdM - 1) / kFwdN "
         "+ 1) : n_kt_all) - 1);"),
        # E: the last key tile (past the first) is masked whole, so no barrier changes
        ("(s, m2, alpha, rsum, k0 + 8 * NJ > a.sk, k0, t, 0, a.sk,",
         "(s, m2, alpha, rsum, true, k0, t, 0, kt == n_kt - 1 ? k0 : a.sk,")]),
    "no_rope_on_k": (FWD, [  # E's K left unrotated
        ("rope_rows<3>(reinterpret_cast<uint8_t*>(sK), a.sk,",
         "rope_rows<3>(reinterpret_cast<uint8_t*>(sK), 0 * a.sk,")]),
    "every_head_on_kv_head_0": (FWD, [("const int kvh = h / a.group;", "const int kvh = 0 * h;")]),
    "segment_ids_unmasked": (FWD, [("if (SEG) ok = ok && kseg[key - k0] == qseg[r];", "")]),
    # F: x + ls * (attn @ wo + bo) loses a part
    "f_residual_dropped": (GEMM, [("const float2 x = __bfloat1622float2(*at);",
                                   "const float2 x = make_float2(0.f, 0.f);")]),
    "f_layer_scale_dropped": (GEMM, [
        ("x.x + l2.x * (c[0] + b2.x), x.y + l2.y * (c[1] + b2.y)",
         "x.x + (c[0] + b2.x), x.y + (c[1] + b2.y)")]),
    "f_last_k_slab_skipped": (GEMM_LOOP, [  # loaded and handed back, not multiplied
        ("for (int kk = 0; kk < kBK / 16; ++kk)  // A: 32 bytes",
         "for (int kk = 0; kk < (kb < k_slabs - 1 ? kBK / 16 : 0); ++kk)  // A: 32 bytes")]),
    "f_last_row_tile_not_stored": (GEMM, [
        ("tma_store_4d(&maps.out, tile_buf, 0, m0, atom0, 0);",
         "if (tile / walk.n_tiles < walk.m_tiles - 1) "
         "tma_store_4d(&maps.out, tile_buf, 0, m0, atom0, 0);")]),
    # D and G: D's bias dropped; the LayerNorm pass's mean not subtracted;
    # fc1's GELU skipped (both forms); fc2's last K slab skipped (K = M > N
    # there only); the hidden's last row tile not stored
    "d_bias_dropped": (GEMM, [
        ("const float2 b2 = *reinterpret_cast<const float2*>(p.bias + n0 + 8 * j);",
         "const float2 b2 = EPI == gemm90::kBias ? make_float2(0.f, 0.f) "
         ": *reinterpret_cast<const float2*>(p.bias + n0 + 8 * j);")]),
    "ln_mean_not_subtracted": (LN, [
        ("for (int e = 0; e < VEC; ++e) o[e] = (f[e] - mean) * rstd * wf[e] + bf[e];",
         "for (int e = 0; e < VEC; ++e) o[e] = f[e] * rstd * wf[e] + bf[e];")]),
    "g_gelu_skipped": (GEMM, [
        ("if constexpr (EPI == gemm90::kBiasGelu) {", "if constexpr (EPI < 0) {"),
        ("} else if constexpr (EPI == gemm90::kBiasGeluErf) {", "} else if constexpr (EPI < 0) {")]),
    "g_fc2_last_k_slab_skipped": (GEMM, [("k / gemm90::kBK};",
                                          "k / gemm90::kBK - (k > n ? 1 : 0)};")]),
    "g_hidden_last_row_tile_not_stored": (GEMM, [
        ("tma_store_4d(&maps.out, tile_buf, 0, m0, atom0, 0);",
         "if (EPI < gemm90::kBiasGelu || tile / walk.n_tiles < walk.m_tiles - 1) "
         "tma_store_4d(&maps.out, tile_buf, 0, m0, atom0, 0);")]),
    # 5: the keys past the last full tile (S = 1025's one key) left out; lse ignored
    "5_tail_dropped": (BWD, [("const bool has_tail = TAIL && k0 + kBwdK + a.tail == a.sk;",
                              "const bool has_tail = false;")]),
    "5_lse_not_applied": (BWD, [("l2[r] = in ? a.lse[row_base + q] * kLog2e",
                                 "l2[r] = in ? 0.f * a.lse[row_base + q]")]),
    # A: the n16 last key tile (S = 1025's one key) masked whole; the one-row
    # last query tile (S = 1025, 129) not stored; the LSE not written
    "a_last_key_tile_skipped": (FWD, [
        ("online_softmax<CAUSAL, SEG, NJ>(s, m2, alpha, rsum, is_masked(k0), k0, t, pos0, a.sk,",
         "online_softmax<CAUSAL, SEG, NJ>(s, m2, alpha, rsum, is_masked(k0), k0, t, pos0, "
         "NJ == 2 ? k0 : a.sk,")]),
    "a_one_row_query_tile_not_stored": (FWD, [
        ("             row_lo, a.sq, t);\n}\n\n// E:",
         "             row_lo, a.sq % kFwdM == 1 && qt == n_qt - 1 ? 0 : a.sq, t);\n}\n\n// E:")]),
    "a_lse_not_written": (FWD, [("if (lse_row != nullptr && t == 0)",
                                 "if (false && lse_row != nullptr && t == 0)")]),
    # C: the last CTA's chunk dropped; each chunk one column longer (the next
    # chunk's first counted twice); the current token folded in twice;
    # column write_pos left as it was
    "c_last_chunk_dropped": (SPLIT, [
        ("const int n_tiles = (f1 - f0 + kSplitRows - 1) / kSplitRows;",
         "const int n_tiles = rank == splits - 1 ? 0 : (f1 - f0 + kSplitRows - 1) / kSplitRows;")]),
    "c_chunk_edge_counted_twice": (SPLIT, [
        ("f1 = min(total, f0 + chunk);", "f1 = min(total, f0 + chunk + 1);")]),
    "c_current_token_twice": (SPLIT, [
        ("      l = p_cur;\n      acc = p_cur * v_cur;",
         "      l = 2.f * p_cur;\n      acc = 2.f * p_cur * v_cur;")]),
    "c_write_pos_not_written": (SPLIT, [
        ("if (rank == 0 && tid < D && wpos >= 0 && wpos < a.seq) {",
         "if (false && rank == 0 && tid < D && wpos >= 0 && wpos < a.seq) {")]),
    # 16: the layer read as 0; column write_pos left out; the last CTA's
    # chunk dropped; prompt columns past the last block_s block counted
    "16_layer_read_as_0": (SPLIT, [("    layer = a.layer_index[0];",
                                    "    layer = 0 * a.layer_index[0];")]),
    "16_write_pos_left_out": (SPLIT, [("    hi = min(wpos + 1, a.seq);",
                                       "    hi = min(wpos, a.seq);")]),
    "16_last_chunk_dropped": (SPLIT, [
        ("const int n_tiles = (f1 - f0 + kSplitRows - 1) / kSplitRows;",
         "const int n_tiles = !Append && rank == splits - 1 ? 0 "
         ": (f1 - f0 + kSplitRows - 1) / kSplitRows;")]),
    "16_prompt_past_block_counted": (SPLIT, [
        ("n1 = max(min(min(a.prompt_lens[b], (wpos / a.block_s + 1) * a.block_s), a.seq), 0);",
         "n1 = max(min(a.prompt_lens[b], a.seq), 0);")]),
    # H: the last stage of each CTA not multiplied; x's second box of each
    # stage loaded from the first box's columns; rank 1's partial summed
    # twice; the last column tile not stored
    "h_last_stage_skipped": (STREAM, [
        ("for (int n = 0; n < NT; ++n) mma_bf16_16816(acc[w][i][n], xa[h & 1][i], b[n][0], b[n][1]);",
         "for (int n = 0; n < NT; ++n)\n              if (j + 1 < n_stages) "
         "mma_bf16_16816(acc[w][i][n], xa[h & 1][i], b[n][0], b[n][1]);")]),
    "h_x_second_box_misplaced": (STREAM, [("k_begin + j * kWsBK + kWsXBox * b, 0, 0, 0);",
                                           "k_begin + j * kWsBK, 0, 0, 0);")]),
    "h_partial_summed_twice": (STREAM, [(
        "v[w] += recv[((w * splits + r) * a.rows + row) * cols + c];",
        "v[w] += (r == 1 ? 2.f : 1.f) * recv[((w * splits + r) * a.rows + row) * cols + c];")]),
    "h_last_tile_not_stored": (STREAM, [("if (col >= sg.dout) continue;",
                                         "if (col >= sg.dout || blockIdx.y == gridDim.y - 1) "
                                         "continue;")]),
    # 21: rank 1's gate / up partial dropped from the cluster's sum; one M
    # tile's slot counted twice; (21 / 22 / 23) the arrival counter not
    # reset, so a second launch never finds its last arriver
    "21_k_split_dropped": (MLP, [("if (r < splits) gs += gv[r], us += uv[r];",
                                  "if (r < splits && !(Q8 && r == 1)) gs += gv[r], us += uv[r];")]),
    "21_tile_slot_twice": (MLP, [("            slot[static_cast<size_t>(row) * a.d + col] = v;",
                                  "            slot[static_cast<size_t>(row) * a.d + col] = "
                                  "(Q8 && tile == 1 ? 2.f : 1.f) * v;")]),
    "counter_not_reset": (ORDERED, [("  atomicExch(p.counter(slice, g), 0u);\n  return true;",
                                     "  return true;")]),
    # 22: the last split's chunk of the cache dropped; kv head 1's wo
    # partial counted twice; each CTA's wo column slice read one box over
    "22_split_chunk_dropped": (SPLIT, [
        ("const int n_tiles = (f1 - f0 + kSplitRows - 1) / kSplitRows;",
         "const int n_tiles = a.out == nullptr && rank == splits - 1 ? 0 "
         ": (f1 - f0 + kSplitRows - 1) / kSplitRows;")]),
    "22_head_partial_twice": (ATTN_WO, [
        ("a.ws[(static_cast<size_t>(b) * kv + kh) * a.dm + col] = v;",
         "a.ws[(static_cast<size_t>(b) * kv + kh) * a.dm + col] = (kh == 1 ? 2.f : 1.f) * v;")]),
    "22_column_slice_shifted": (ATTN_WO, [
        ("tma_load_4d_hint(wo_smem + slot * kWoBox, &wo_map, &full[slot], (ch0 + j / G) * CPB,",
         "tma_load_4d_hint(wo_smem + slot * kWoBox, &wo_map, &full[slot], (ch0 + j / G + 1) * CPB,")]),
    # C8: the pair scale read one pair off; the current token's logit from
    # the bf16 k_new, not its dequantized value; the last CTA's chunk dropped
    "c8_scale_pair_off": (SPLIT, [
        ("* (a.kv_heads / 2) + kh / 2;", "* (a.kv_heads / 2) + (kh / 2 + 1) % (a.kv_heads / 2);")]),
    "c8_current_token_from_bf16": (SPLIT, [
        ("        kf = make_float2(quantize_q8(kf.x, ksc) * ksc, quantize_q8(kf.y, ksc) * ksc);",
         "        kf = kf;")]),
    "c8_last_chunk_dropped": (SPLIT, [
        ("const int n_tiles = (f1 - f0 + kSplitRows - 1) / kSplitRows;",
         "const int n_tiles = Q8 && rank == splits - 1 ? 0 "
         ": (f1 - f0 + kSplitRows - 1) / kSplitRows;")]),
    # I8: the up scale left off; rank 1's gate partial dropped from the sum
    "i8_up_scale_dropped": (STREAM, [("      if (NW == 2) v[NW - 1] *= sg.scale[NW - 1][col];\n",
                                      "")]),
    "i8_gate_partial_dropped": (STREAM, [
        ("v[w] += recv[((w * splits + r) * a.rows + row) * cols + c];",
         "v[w] += (NW == 2 && w == 0 && r == 1 ? 0.f : 1.f) * "
         "recv[((w * splits + r) * a.rows + row) * cols + c];")]),
    # H8: the column scale left off; rank 1's partial dropped from the sum.
    # I: the up weight's map made over the gate weight
    "h8_scale_dropped": (STREAM, [("      v[0] *= sg.scale[0][col];\n",
                                   "      if (NW == 2) v[0] *= sg.scale[0][col];\n")]),
    "h8_partial_dropped": (STREAM, [
        ("v[w] += recv[((w * splits + r) * a.rows + row) * cols + c];",
         "v[w] += (Q8 && NW == 1 && r == 1 ? 0.f : 1.f) * "
         "recv[((w * splits + r) * a.rows + row) * cols + c];")]),
    "i_up_as_gate": (STREAM, [
        ("stacked_weight_map(&maps.w[1], wu_all, 2, n_layers, din, m, kWsN, kWsBK)",
         "stacked_weight_map(&maps.w[1], wg_all, 2, n_layers, din, m, kWsN, kWsBK)")]),
    # 19 / 20: a rope partner read from the next pair's column; the RMSNorm
    # weight left off xn; v's segment dropped from the table (its tiles
    # become k's, past k's columns, and store nothing); 20's low half of xn
    # not multiplied; the last rank's partial not pushed to its finishers
    "qkv_rope_partner_off": (STREAM, [("const int pc = second ? c - cols / 2 : c + cols / 2;",
                                       "const int pc = (second ? c - cols / 2 : c + cols / 2) ^ 1;")]),
    "qkv_norm_weight_skipped": (STREAM, [
        ("            const float2 v = rms_value(xh[p], nh[p], rs);",
         "            const float2 v = rms_value(xh[p], __floats2bfloat162_rn(1.f, 1.f), rs);")]),
    "qkv_v_segment_dropped": (STREAM, [("  a.segs = 3;\n", "  a.segs = tables ? 2 : 3;\n")]),
    "qkv_low_half_dropped": (STREAM, [("                mma_bf16_16816(acc[w][i][n], xl[h & 1][i], "
                                       "b[n][0], b[n][1]);", "                ;")]),
    "qkv_last_rank_not_pushed": (STREAM, [
        ("  for (int e = threadIdx.x; e < splits * per_q; e += kWsThreads) {",
         "  for (int e = threadIdx.x; e < (rope && rank == splits - 1 ? 0 : splits * per_q);\n"
         "       e += kWsThreads) {")]),
    # J / J8: v's segment dropped from the table (as 19 / 20's mutant, for
    # the table without rope tables); the last rank's partial not pushed to
    # its finishers; J8's k scale left off; the segment lookup off by one
    # tile at each boundary (the grid's first k and v tiles fall into the
    # segment before, past its columns)
    "j_v_segment_dropped": (STREAM, [("  a.segs = 3;\n", "  a.segs = tables ? 3 : 2;\n")]),
    "j_last_rank_not_pushed": (STREAM, [
        ("  for (int e = threadIdx.x; e < splits * per_q; e += kWsThreads) {",
         "  for (int e = threadIdx.x;\n"
         "       e < (XN == kXBoxes && a.segs == 3 && rank == splits - 1 ? 0 : splits * per_q);\n"
         "       e += kWsThreads) {")]),
    "j8_k_scale_dropped": (STREAM, [("      v[0] *= sg.scale[0][col];\n",
                                     "      if (XN != kXBoxes || a.segs != 3 || si != 1) "
                                     "v[0] *= sg.scale[0][col];\n")]),
    "j_segment_tiles_shifted": (STREAM, [
        ("  while (si + 1 < a.segs && tile >= a.seg[si].tiles) tile -= a.seg[si++].tiles;",
         "  while (si + 1 < a.segs && tile >= a.seg[si].tiles + (XN == kXBoxes && a.segs == 3))\n"
         "    tile -= a.seg[si++].tiles;")]),
}
MEGA = ("21_k_split_dropped", "21_tile_slot_twice", "counter_not_reset", "22_split_chunk_dropped",
        "22_head_partial_twice", "22_column_slice_shifted")
MEGA_TESTS = "mlp_residual or attention_wo or mega_decode_step"
Q8 = ("c8_scale_pair_off", "c8_current_token_from_bf16", "c8_last_chunk_dropped",
      "i8_up_scale_dropped", "i8_gate_partial_dropped")
Q8_TESTS = "q8 or swiglu or int8_decode_step"
QKV = ("qkv_rope_partner_off", "qkv_norm_weight_skipped", "qkv_v_segment_dropped",
       "qkv_low_half_dropped", "qkv_last_rank_not_pushed")
QKV_TESTS = "qkv_norm_rope or mega_decode_step"
JQKV = ("j_v_segment_dropped", "j_last_rank_not_pushed", "j8_k_scale_dropped",
        "j_segment_tiles_shifted")
JQKV_TESTS = "layer_qkv or layer_matmul_kernels or layer_matmul_q8_kernels or decode_step"
ST = ("h8_scale_dropped", "h8_partial_dropped", "i_up_as_gate", "h_x_second_box_misplaced")
ST_TESTS = ("stream_nw or stream_kernels or layer_matmul_kernels or layer_matmul_q8_kernels "
            "or decode_step")
VIT = ("f_residual_dropped", "f_layer_scale_dropped", "f_last_k_slab_skipped",
       "f_last_row_tile_not_stored", "d_bias_dropped", "ln_mean_not_subtracted",
       "g_gelu_skipped", "g_fc2_last_k_slab_skipped", "g_hidden_last_row_tile_not_stored")
VIT_TESTS = ("vit_block_kernels or wo_residual_kernel or vit_ln_qkv_kernel or vit_mlp_kernel "
             "or test_layer_norm_kernel or vision_forward_auto_form")
TESTS = ("flash_attention_kernel or fused_qkv_kernel or lse_segments or lse_and_backward "
         "or wo_residual or vit_block_kernels or vit_attention_kernel "
         "or decode_attention_kernel or decode_attention_stacked or layer_matmul or stream_kernels")
CONTEXT_LOST = ("CUDA error", "AcceleratorError", "illegal instruction",
                "unspecified launch failure")
PHASE2 = "import chip_smoke as c; c.phase_environment(); c.phase_kernels()"
PHASE2_MEGA = ("import chip_smoke as c, torch; c.phase_environment(); "
               "g = torch.Generator(device='cuda').manual_seed(c.SEED); "
               "c.mega_kernels(lambda *s: torch.randn(s, generator=g, device='cuda')"
               ".to(torch.bfloat16))")
PHASE2_VIT = ("import chip_smoke as c, torch; c.phase_environment(); "
              "g = torch.Generator(device='cuda').manual_seed(c.SEED); "
              "r = lambda *s: torch.randn(s, generator=g, device='cuda').to(torch.bfloat16); "
              "c.vit_block_kernels(r, g); c.layer_norm_kernel(r)")
PHASE2_Q8 = {prefix: PHASE2_MEGA.replace("mega_kernels", part) for prefix, part in (
    ("c8", "decode_attention_q8_kernel"), ("i8", "decode_matmul_kernels"),
    ("h8", "decode_matmul_kernels"), ("i_", "decode_matmul_kernels"),
    ("h_", "decode_matmul_kernels"), ("j_", "decode_matmul_kernels"),
    ("j8", "decode_matmul_kernels"))}


def make_copy(name: str, edits: list[tuple[str, str, str]]) -> Path:
    """The package, tests/, native/, chip_smoke.py and pyproject.toml (so
    pytest's root is the copy) under build/copies/<name>, with each (source, old,
    new) edit applied. Raises if an old text is not in its source exactly
    once."""
    dst = COPIES / name
    shutil.rmtree(dst, ignore_errors=True)
    dst.mkdir(parents=True)
    ignore = shutil.ignore_patterns("__pycache__")
    for path in ("grasp_any_region_tpu_torch", "tests", "native"):  # native: chip_smoke's host library
        shutil.copytree(REPO / path, dst / path, ignore=ignore)
    for path in ("chip_smoke.py", "pyproject.toml"):
        shutil.copy(REPO / path, dst / path)
    for src, old, new in edits:
        text = (dst / src).read_text()
        if text.count(old) != 1:
            raise ValueError(f"{name}: {old!r} is not in {src} exactly once")
        (dst / src).write_text(text.replace(old, new))
    return dst


def run(dst: Path, args: list[str], timeout: int) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, *args], cwd=dst, capture_output=True, text=True,
                          env={**os.environ, "PYTHONPATH": str(dst)}, timeout=timeout)


def card_tests(dst: Path, tests: str = TESTS) -> dict[str, str]:
    """Each card case's verdict in the copy (the cases `tests` selects):
    passed, skipped, failed, or trapped (it lost the CUDA context; the
    cases after it run again)."""
    pytest = ["-m", "pytest", "--noconftest", "-p", "no:cacheprovider", "-q"]
    listed = run(dst, [*pytest, "--collect-only", "tests/test_torch_gpu.py", "-k", tests], 300)
    todo = [line for line in listed.stdout.splitlines() if "::" in line]
    verdicts: dict[str, str] = {}
    while todo:
        report = dst / "report.xml"
        report.unlink(missing_ok=True)
        run(dst, [*pytest, f"--junitxml={report}", *todo], 1800)
        cases = list(ET.parse(report).getroot().iter("testcase")) if report.exists() else []
        if not cases:
            raise RuntimeError(f"{dst.name}: pytest reported none of {len(todo)} cases")
        rest = list(todo)
        for case in cases:
            node = f"tests/test_torch_gpu.py::{case.get('name')}"
            bad = [c for c in case if c.tag in ("failure", "error")]
            text = " ".join((c.get("message") or "") + (c.text or "") for c in bad)
            lost = any(s in text for s in CONTEXT_LOST)
            skipped = any(c.tag == "skipped" for c in case)
            verdicts[node] = ("trapped" if lost else "failed" if bad
                              else "skipped" if skipped else "passed")
            if node in rest:
                rest.remove(node)
            if lost:
                break
        else:
            rest = []  # every case ran in a live context
        todo = rest
    return verdicts


def main(names: list[str]) -> int:
    unknown = set(names) - set(MUTANTS)
    if unknown:
        raise SystemExit(f"unknown mutants {sorted(unknown)}; known: {list(MUTANTS)}")
    for name, (src, edits) in MUTANTS.items():
        if names and name not in names:
            continue
        dst = make_copy(f"mutant_{name}", [(src, old, new) for old, new in edits])
        mega, q8, st, vit, qkv, jqkv = (name in MEGA, name in Q8, name in ST, name in VIT,
                                        name in QKV, name in JQKV)
        verdicts = card_tests(dst, MEGA_TESTS if mega else QKV_TESTS if qkv else Q8_TESTS if q8
                              else ST_TESTS if st else VIT_TESTS if vit
                              else JQKV_TESTS if jqkv else TESTS)
        counts = {v: list(verdicts.values()).count(v) for v in ("failed", "trapped", "passed", "skipped")}
        print(f"[mutant] {name}: card tests {counts}", flush=True)
        for node, v in sorted(verdicts.items()):
            if v != "passed":
                print(f"    {v}: {node.split('::')[1]}")
        phase2 = run(dst, ["-c", PHASE2_MEGA if mega or qkv
                              else PHASE2_Q8[name[:2]] if q8 or st or jqkv
                              else PHASE2_VIT if vit else PHASE2], 1200)
        lines = (phase2.stdout + phase2.stderr).strip().splitlines()
        caught = [line for line in lines if "Error" in line][-1:] or lines[-1:]
        print(f"[mutant] {name}: chip_smoke phase 2 "
              f"{'passed' if phase2.returncode == 0 else 'failed: ' + ' '.join(caught)}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
