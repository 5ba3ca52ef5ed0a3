"""Kernels A, B and C timed in copies of the package that differ by named
edits of their sources, in turns on one card: the parent form, each
variant, then the variants again in reverse and the parent last. A design
choice is kept only when it measures faster this way, in one call.

Each variant (VARIANTS: name -> [(source, old, new), ...]) is built in its
own copy under build/copies/ (forward_mutants.make_copy). In each copy a
fresh process checks A and C against their plain versions (sized
tolerance; TOL16) and prints their times after an L2 flush (chip_smoke.py's
cuda_ms): A at (17, S, 16, 64) views of a qkv buffer, S = 1025 and 1024;
B at the causal prefill; C over layer 7 of a (16, B, 8, 5120, 64) cache at
B = 1, 2 and 24. Run from the repository root on a machine with the card:

    python3 ab_kernels.py [variant ...]
"""

from __future__ import annotations

import json
import sys

from forward_mutants import FWD, SPLIT, make_copy, run

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


def main(names: list[str]) -> int:
    unknown = set(names) - set(VARIANTS)
    if unknown:
        raise SystemExit(f"unknown variants {sorted(unknown)}; known: {list(VARIANTS)}")
    chosen = ["parent"] + [n for n in VARIANTS if n != "parent" and (not names or n in names)]
    copies = {name: make_copy(f"ab_{name}", VARIANTS[name]) for name in chosen}
    for name in chosen + chosen[::-1]:
        res = run(copies[name], ["-c", TIMING], 900)
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
