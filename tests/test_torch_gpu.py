"""CUDA kernels A-J, the int8 kernels H8, I8, J8, C8, the training kernels,
the mega decode step's 19-23, the read-only decode attention 16 and the
LayerNorm 24 against their plain PyTorch versions, on the card.

Skips without a CUDA device. Imports no jax, so it runs on a machine that
has none; there, skip the repository's conftest (which sets up jax):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py

Tolerance atol = rtol = 2e-2: the kernels round p to bf16 before the PV
product (A, B, C, E), round LayerNorm and GELU outputs to bf16 before their
products (D, G), and write bf16; the plain versions run in fp32 from the
same bf16 inputs. Where that is about an output's size, a kernel is also
held at a tolerance sized to its output (`_sized_close`).
"""

import dataclasses

import pytest
import torch

from grasp_any_region_tpu_torch.ops import decode_attention as dec
from grasp_any_region_tpu_torch.ops import decode_megakernel as mk
from grasp_any_region_tpu_torch.ops import flash_attention as fa
from grasp_any_region_tpu_torch.ops import layer_matmul as lm
from grasp_any_region_tpu_torch.ops import norms
from grasp_any_region_tpu_torch.ops import vit_attention as va
from grasp_any_region_tpu_torch.ops import vit_block as vb

pytestmark = pytest.mark.gpu
TOL = dict(atol=2e-2, rtol=2e-2)


@pytest.fixture
def rnd():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    gen = torch.Generator(device="cuda").manual_seed(0)

    def make(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    return make


@pytest.mark.parametrize("t,s,h", [(2, 200, 2), (3, 1025, 4), (1, 64, 1), (1, 129, 2),
                                   (2, 1024, 3), (1, 77, 2), (17, 1025, 16)])
def test_vit_attention_kernel(rnd, t, s, h):
    """Kernel A (kernel B's Hopper forward, non-causal, one head per kv
    head) on q/k/v views of a fused buffer, at S with a one-key last key
    tile and a one-row last query tile (129, 1025), a multiple of 128 and
    a non-multiple of 16; its output at the sized tolerance, its LSE at
    atol 1e-3; B's counter untouched."""
    qkv = rnd(t, s, 3, h, 64)  # q/k/v as strided views of a fused buffer
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    before, b_before = va.launches, fa.launches
    out = va.vit_attention(q, k, v)
    out2, lse = va.vit_attention(q, k, v, return_lse=True)
    torch.cuda.synchronize()
    assert va.launches == before + 2 and fa.launches == b_before
    ref, ref_lse = va.vit_attention_plain(q.float(), k.float(), v.float(), return_lse=True)
    torch.testing.assert_close(out.float(), ref, **TOL)
    _sized_close(out, ref, "out")
    assert torch.equal(out, out2)
    torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=1e-4)


def _sized_close(got, want, name):
    """A kernel against its plain version at a tolerance sized to the
    output: atol a tenth of its RMS, rtol 2^-6 (two bf16 ulps). Attention
    outputs over many keys and the gradients of 17 and 18 (against the
    plain version that rounds p and dS to bf16 where the kernels do) have an
    RMS of 0.05-0.5, where TOL would pass a missing key tile, query head or
    rope."""
    atol = want.pow(2).mean().sqrt().item() / 10
    print(f"{name}: atol {atol:.3e}, max |diff| {(got.float() - want).abs().max().item():.3e}")
    torch.testing.assert_close(got.float(), want, atol=atol, rtol=2.0 ** -6, msg=name)


@pytest.mark.parametrize("b,sq,sk,h,kh,causal", [
    (1, 256, 256, 4, 2, True),
    (2, 130, 300, 4, 1, True),
    (2, 200, 333, 8, 2, False),
    (1, 300, 300, 8, 8, True),
    (1, 1, 70, 4, 4, True),
    (1, 64, 64, 2, 1, True),
    (2, 200, 200, 4, 4, False),
    (2, 333, 333, 8, 2, True),
    (1, 1025, 1025, 8, 1, True),
    (1, 1025, 1025, 16, 16, False),
    (1, 100, 1025, 16, 2, True),
    (1, 4662, 4662, 32, 8, True),
    (1, 4662, 4662, 8, 1, False),
])
def test_flash_attention_kernel(rnd, b, sq, sk, h, kh, causal):
    """Kernel B (csrc/flash_forward_sm90.cu) at S = 64-4662, Sq < Sk, groups
    1-8, causal and full, its output and LSE against the plain version."""
    q, k, v = rnd(b, sq, h, 64), rnd(b, sk, kh, 64), rnd(b, sk, kh, 64)
    before = fa.launches
    out = fa.flash_attention(q, k, v, causal=causal)
    out2, lse = fa.flash_attention(q, k, v, causal=causal, return_lse=True)
    torch.cuda.synchronize()
    assert fa.launches == before + 2
    ref, ref_lse = fa.flash_attention_plain(q.float(), k.float(), v.float(), causal=causal,
                                            return_lse=True)
    torch.testing.assert_close(out.float(), ref, **TOL)
    _sized_close(out, ref, "out")
    assert torch.equal(out, out2)
    torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=1e-4)


def test_flash_attention_kernel_reads_strided_views(rnd):
    """q, k and v as views of one (B, S, H + 2K, 64) buffer and the output
    as a view: the tensor maps take the strides, nothing is copied."""
    b, s, h, kh = 2, 777, 8, 2
    buf = rnd(b, s, h + 2 * kh, 64)
    q, k, v = buf[:, :, :h], buf[:, :, h:h + kh], buf[:, :, h + kh:]
    out, lse = fa.flash_attention(q, k, v, causal=True, return_lse=True)
    torch.cuda.synchronize()
    ref, ref_lse = fa.flash_attention_plain(q.float(), k.float(), v.float(), causal=True,
                                            return_lse=True)
    _sized_close(out, ref, "out")
    torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=1e-4)


def _split_layout(kind, splits):
    """(B, prompt lengths, prompt_pad, write_pos) on a 1024-column cache whose
    chunks of the flat index (ops/decode_attention.split_bounds, `splits`
    CTAs) meet the interval edges: "edges", row 0 cut at prompt_len - 1 |
    prompt_pad (24 + 8 (splits - 3) columns in chunks of 8), row 1 with a
    last chunk of one column, write_pos - 1; "empty", more CTAs than
    columns (one column; prompt only, write_pos = prompt_pad)."""
    if kind == "empty":
        return 2, (1, splits // 2), 300, 300
    pad = 256
    wpos = pad + 8 * (splits - 3)
    for p1 in range(1, pad):
        total = p1 + wpos - pad
        if total == -(-total // splits) * (splits - 1) + 1:
            return 2, (24, p1), pad, wpos
    raise AssertionError(f"no one-column last chunk for {splits} splits")


@pytest.mark.parametrize("group", [1, 2, 4, 8])
@pytest.mark.parametrize("b,plens,pad,wpos", [
    (2, (100, 37), 128, 170),
    (2, (128, 1), 128, 128),
    (2, (500, 700), 700, 1023),
    (1, (600,), 700, 1000),
    (24, None, 700, 800),   # ragged prompt lengths on both sides of prompt_pad
    (2, "edges", None, None),
    (2, "empty", None, None),
])
def test_decode_attention_kernel(rnd, group, b, plens, pad, wpos):
    """Kernel C (split-KV over a cluster) against the plain version at
    TOL16, then the interval probe (k = 0, spikes in v on each side of each
    edge) at TOL16; the cache bit-identical outside column write_pos."""
    L, kh, s, layer = 3, 2, 1024, 1
    splits = dec.card_splits(b, kh, torch.device("cuda"))
    assert splits > 1
    if isinstance(plens, str):
        b, plens, pad, wpos = _split_layout(plens, splits)
    elif plens is None:  # at and around write_pos and prompt_pad, then seeded
        plens = [700, 699, 701, 1, 2, 64, 65] + torch.randint(
            1, 700, (b - 7,), generator=torch.Generator().manual_seed(b)).tolist()
        plens = [min(x, pad) for x in plens]
    k_all, v_all = rnd(L, b, kh, s, 64), rnd(L, b, kh, s, 64)
    q, k_new, v_new = rnd(b, kh * group, 64), rnd(b, kh, 64), rnd(b, kh, 64)
    kw = dict(prompt_lens=_cuda_int32(plens), write_pos=_cuda_int32(wpos), prompt_pad=pad)
    for probe in (False, True):
        if probe:  # one column too many, too few or twice moves a row by >= 0.02
            k0, vp = _interval_probe(v_all[layer], plens, pad, wpos)
            k_all[layer], v_all[layer], k_new = k0, vp, torch.zeros_like(k_new)
        k_exp, v_exp = k_all.clone(), v_all.clone()
        ref = dec.decode_attention_fused_plain(q.float(), k_exp.float(), v_exp.float(),
                                               k_new.float(), v_new.float(), layer, **kw)
        before = dec.launches
        out = dec.decode_attention_fused(q, k_all, v_all, k_new, v_new, layer, **kw)
        torch.cuda.synchronize()
        assert dec.launches == before + 1
        if not probe:
            torch.testing.assert_close(out.float(), ref, **TOL)
        torch.testing.assert_close(out.float(), ref, **TOL16, msg=f"probe {probe}")
        k_exp[layer, :, :, wpos], v_exp[layer, :, :, wpos] = k_new, v_new
        assert torch.equal(k_all, k_exp) and torch.equal(v_all, v_exp)


@pytest.mark.parametrize("splits", [1, 2, 3, 5, 8, 16])
def test_decode_attention_kernel_any_split(rnd, monkeypatch, splits):
    """Kernel C with the CTAs a (kv head, row) forced (the chooser
    replaced), clusters of 1 to 16, over three ragged rows (one with fewer
    columns than CTAs), at TOL16; the cache bit-identical outside column
    write_pos."""
    monkeypatch.setattr(dec, "card_splits", lambda *_: splits)
    L, b, kh, s, layer, group = 2, 3, 2, 1024, 1, 4
    plens, pad, wpos = [300, 3, 1], 512, 515
    k_all, v_all = rnd(L, b, kh, s, 64), rnd(L, b, kh, s, 64)
    q, k_new, v_new = rnd(b, kh * group, 64), rnd(b, kh, 64), rnd(b, kh, 64)
    kw = dict(prompt_lens=_cuda_int32(plens), write_pos=_cuda_int32(wpos), prompt_pad=pad)
    k_exp, v_exp = k_all.clone(), v_all.clone()
    ref = dec.decode_attention_fused_plain(q.float(), k_exp.float(), v_exp.float(),
                                           k_new.float(), v_new.float(), layer, **kw)
    out = dec.decode_attention_fused(q, k_all, v_all, k_new, v_new, layer, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref, **TOL16)
    k_exp[layer, :, :, wpos], v_exp[layer, :, :, wpos] = k_new, v_new
    assert torch.equal(k_all, k_exp) and torch.equal(v_all, v_exp)


def test_wrappers_reject_what_the_kernels_do_not_take(rnd):
    q = rnd(1, 64, 2, 64)
    with pytest.raises(TypeError):
        va.vit_attention(q.float(), q.float(), q.float())
    with pytest.raises(ValueError):
        va.vit_attention(rnd(1, 64, 2, 32), rnd(1, 64, 2, 32), rnd(1, 64, 2, 32))
    with pytest.raises(ValueError):
        fa.flash_attention(q[:, :, :, :48], q[:, :, :, :48], q[:, :, :, :48])
    k_all = rnd(2, 1, 2, 128, 64)
    with pytest.raises(ValueError):  # write_pos must live on the card, as int32
        dec.decode_attention_fused(
            rnd(1, 4, 64), k_all, k_all.clone(), rnd(1, 2, 64), rnd(1, 2, 64), 0,
            prompt_lens=torch.tensor([3], dtype=torch.int32, device="cuda"),
            write_pos=torch.tensor(10), prompt_pad=8)


def _angles(t_gen, h, n):
    """(H, N, 32) per-head angles of the size mixed rope gives."""
    return torch.rand((h, n, 32), generator=t_gen, device="cuda") * 40.0


@pytest.mark.parametrize("t,s,h", [(2, 200, 2), (1, 65, 4), (3, 1025, 16), (1, 64, 2),
                                   (2, 333, 4), (1, 129, 3), (2, 1025, 4), (1, 257, 8),
                                   (1, 513, 2), (1, 1152, 2)])
def test_vit_attention_fused_qkv_kernel(rnd, t, s, h):
    """Kernel E at ragged S with mixed per-head rope angles (identity CLS
    row), against rope in fp32 rounded to bf16, then plain attention."""
    from grasp_any_region_tpu_torch.ops.rope import rope_head_tables

    gen = torch.Generator(device="cuda").manual_seed(1)
    qkv = rnd(t, s, 3 * h * 64)
    cos, sin = rope_head_tables(_angles(gen, h, s - 1), h, 1)
    before = va.launches_fused
    out = va.vit_attention_fused_qkv(qkv, cos, sin, h, 64)
    torch.cuda.synchronize()
    assert va.launches_fused == before + 1
    ref = va.vit_attention_fused_qkv_plain(qkv.float(), cos, sin, h, 64)
    torch.testing.assert_close(out.float(), ref, **TOL)
    _sized_close(out, ref, "out")


def _block_args(rnd, d, m, layer_scale=True):
    """Seeded bf16 weights of one ViT layer at width d, hidden m."""
    def w(*shape, scale):
        return (rnd(*shape).float() * scale).to(torch.bfloat16)

    return dict(
        ln=(1.0 + w(d, scale=0.2), w(d, scale=0.2)),
        wqkv=w(d, 3 * d, scale=d ** -0.5), bqkv=w(3 * d, scale=0.1),
        wo=w(d, d, scale=d ** -0.5), bo=w(d, scale=0.1),
        fc1=w(d, m, scale=d ** -0.5), b1=w(m, scale=0.1),
        fc2=w(m, d, scale=m ** -0.5), b2=w(d, scale=0.1),
        ls=w(d, scale=0.5) if layer_scale else None)


@pytest.mark.parametrize("t,s,d,m,layer_scale,fast_gelu", [
    (2, 65, 128, 256, True, True),     # ragged rows (130 = 2 x 64 + 2)
    (1, 200, 256, 1024, False, False),  # no LayerScale, erf GELU
    (17, 1025, 1024, 4096, True, True),  # one gar_1b layer
])
def test_vit_block_kernels(rnd, t, s, d, m, layer_scale, fast_gelu):
    a = _block_args(rnd, d, m, layer_scale)
    x, attn = rnd(t, s, d), rnd(t, s, d)
    f32 = {k: (tuple(v.float() for v in a[k]) if k == "ln" else
               None if a[k] is None else a[k].float()) for k in a}
    before = dict(vb.launches)
    qkv = vb.vit_ln_qkv(x, *a["ln"], a["wqkv"], a["bqkv"])
    wo = vb.vit_wo_residual(attn, x, a["wo"], a["bo"], a["ls"])
    mlp = vb.vit_mlp_residual(x, *a["ln"], a["fc1"], a["b1"], a["fc2"], a["b2"], a["ls"],
                              fast_gelu=fast_gelu)
    torch.cuda.synchronize()
    assert vb.launches == {k: v + 1 for k, v in before.items()}
    xf = x.float()
    ref = vb.vit_ln_qkv_plain(xf, *f32["ln"], f32["wqkv"], f32["bqkv"])
    torch.testing.assert_close(qkv.float(), ref, **TOL)
    _sized_close(qkv, ref, "D")
    torch.testing.assert_close(
        wo.float(), vb.vit_wo_residual_plain(attn.float(), xf, f32["wo"], f32["bo"], f32["ls"]),
        **TOL)
    ref = vb.vit_mlp_residual_plain(xf, *f32["ln"], f32["fc1"], f32["b1"], f32["fc2"],
                                    f32["b2"], f32["ls"], fast_gelu=fast_gelu)
    torch.testing.assert_close(mlp.float(), ref, **TOL)
    _sized_close(mlp, ref, "G")


@pytest.mark.parametrize("layer_scale", [True, False])
@pytest.mark.parametrize("rows", [(1, 1), (1, 127), (1, 128), (1, 129), (17, 1025)])
@pytest.mark.parametrize("d", [128, 256, 1024])
def test_wo_residual_kernel(rnd, d, rows, layer_scale):
    """Kernel F (csrc/gemm_sm90.cu) at widths of one, two and eight
    128-column tiles, rows on both sides of its 128-row tile, with and
    without LayerScale, against the plain version in fp32 at the
    output-sized tolerance."""
    a = _block_args(rnd, d, 128, layer_scale)
    x, attn = rnd(*rows, d), rnd(*rows, d)
    before = vb.launches["F"]
    out = vb.vit_wo_residual(attn, x, a["wo"], a["bo"], a["ls"])
    torch.cuda.synchronize()
    assert vb.launches["F"] == before + 1
    ls = None if a["ls"] is None else a["ls"].float()
    want = vb.vit_wo_residual_plain(attn.float(), x.float(), a["wo"].float(), a["bo"].float(), ls)
    _sized_close(out, want, f"F at {rows} x {d}")


@pytest.mark.parametrize("rows", [(1, 1), (1, 127), (1, 128), (1, 129), (17, 1025)])
@pytest.mark.parametrize("d", [128, 256, 1024])
def test_vit_ln_qkv_kernel(rnd, d, rows):
    """Kernel D (LayerNorm pass, then the Hopper GEMM with a bias epilogue)
    at widths of one, two and eight 128-column tiles (N = 3D), rows on both
    sides of the 128-row tile, against the plain version in fp32 at the
    output-sized tolerance."""
    a = _block_args(rnd, d, 128)
    x = rnd(*rows, d)
    before = vb.launches["D"]
    out = vb.vit_ln_qkv(x, *a["ln"], a["wqkv"], a["bqkv"])
    torch.cuda.synchronize()
    assert vb.launches["D"] == before + 1 and out.shape == rows + (3 * d,)
    want = vb.vit_ln_qkv_plain(x.float(), *(v.float() for v in a["ln"]), a["wqkv"].float(),
                               a["bqkv"].float())
    _sized_close(out, want, f"D at {rows} x {d}")


@pytest.mark.parametrize("layer_scale,fast_gelu", [(True, True), (False, False), (True, False),
                                                   (False, True)])
@pytest.mark.parametrize("ratio", [2, 4])
@pytest.mark.parametrize("rows", [(1, 1), (1, 127), (1, 128), (1, 129), (17, 1025)])
@pytest.mark.parametrize("d", [128, 256, 1024])
def test_vit_mlp_kernel(rnd, d, rows, ratio, layer_scale, fast_gelu):
    """Kernel G (LayerNorm pass, fc1 with its GELU epilogue into the hidden,
    fc2 with kernel F's epilogue) at widths of one, two and eight
    128-column tiles, M = 2D and 4D, rows on both sides of the 128-row
    tile, with and without LayerScale, both GELU forms, against the plain
    version in fp32 at the output-sized tolerance."""
    a = _block_args(rnd, d, ratio * d, layer_scale)
    x = rnd(*rows, d)
    before = vb.launches["G"]
    out = vb.vit_mlp_residual(x, *a["ln"], a["fc1"], a["b1"], a["fc2"], a["b2"], a["ls"],
                              fast_gelu=fast_gelu)
    torch.cuda.synchronize()
    assert vb.launches["G"] == before + 1 and out.shape == x.shape
    f32 = {k: None if a[k] is None else a[k].float() for k in ("fc1", "b1", "fc2", "b2", "ls")}
    want = vb.vit_mlp_residual_plain(x.float(), *(v.float() for v in a["ln"]), f32["fc1"],
                                     f32["b1"], f32["fc2"], f32["b2"], f32["ls"],
                                     fast_gelu=fast_gelu)
    _sized_close(out, want, f"G at {rows} x {d}, M = {ratio * d}")


@pytest.mark.parametrize("t", [136, 272])
def test_vit_block_kernels_at_an_admission_group(rnd, t):
    """Kernels D, E, F and G over the tiles of one serving admission group,
    8 and 16 requests of 17 tiles at gar_1b's widths: at 272 tiles G's
    hidden is 2.28 GB and D's output 1.71 GB, so byte offsets pass 2^31.
    Rows are independent, so each output is held against its plain version
    in fp32 block by block of 34 tiles, at TOL and at the output-sized
    tolerance."""
    from grasp_any_region_tpu_torch.ops.rope import rope_head_tables

    s, d, m, h, block = 1025, 1024, 4096, 16, 34
    a = _block_args(rnd, d, m)
    x, attn, qkv = rnd(t, s, d), rnd(t, s, d), rnd(t, s, 3 * d)
    gen = torch.Generator(device="cuda").manual_seed(1)
    cos, sin = rope_head_tables(_angles(gen, h, s - 1), h, 1)
    f32 = {k: (tuple(v.float() for v in a[k]) if k == "ln" else a[k].float()) for k in a}
    cases = {
        "D": (vb.vit_ln_qkv(x, *a["ln"], a["wqkv"], a["bqkv"]),
              lambda i: vb.vit_ln_qkv_plain(x[i].float(), *f32["ln"], f32["wqkv"], f32["bqkv"])),
        "E": (va.vit_attention_fused_qkv(qkv, cos, sin, h, 64),
              lambda i: va.vit_attention_fused_qkv_plain(qkv[i].float(), cos, sin, h, 64)),
        "F": (vb.vit_wo_residual(attn, x, a["wo"], a["bo"], a["ls"]),
              lambda i: vb.vit_wo_residual_plain(attn[i].float(), x[i].float(), f32["wo"],
                                                 f32["bo"], f32["ls"])),
        "G": (vb.vit_mlp_residual(x, *a["ln"], a["fc1"], a["b1"], a["fc2"], a["b2"], a["ls"],
                                  fast_gelu=True),
              lambda i: vb.vit_mlp_residual_plain(x[i].float(), *f32["ln"], f32["fc1"],
                                                  f32["b1"], f32["fc2"], f32["b2"], f32["ls"],
                                                  fast_gelu=True)),
    }
    torch.cuda.synchronize()
    for name, (out, plain) in cases.items():
        for i in range(0, t, block):
            tiles = slice(i, i + block)
            want = plain(tiles)
            torch.testing.assert_close(out[tiles].float(), want, **TOL)
            _sized_close(out[tiles], want, f"{name} at {t} tiles, tiles {i}-{i + block - 1}")
            del want


def test_vision_forward_auto_form_on_the_card(rnd):
    """fused_blocks=None on a CUDA tensor takes the fused form at head_dim
    64 and an even head count (kernels D-G, no A), and the unfused form
    (A only) at an odd head count, as the JAX package's rule does."""
    from grasp_any_region_tpu_torch.core.config import VisionConfig
    from grasp_any_region_tpu_torch.models.vision import VisionParams, vision_forward

    for width, heads, fused in ((256, 4, True), (192, 3, False)):
        cfg = VisionConfig(width=width, depth=2, num_heads=heads, img_size=(112, 112),
                           fast_gelu=True)
        params = VisionParams(cfg, device="cuda", dtype=torch.bfloat16)
        with torch.no_grad():
            for p in params.parameters():
                p.copy_(rnd(*p.shape).float() * 0.02)
        va.launches = va.launches_fused = 0
        vb.launches.update(D=0, F=0, G=0)
        out = vision_forward(params, cfg, rnd(2, 3, 112, 112))
        torch.cuda.synchronize()
        assert out.shape == (2, cfg.seq_len, width) and torch.isfinite(out.float()).all()
        n = cfg.depth if fused else 0
        assert (va.launches_fused, vb.launches["D"], vb.launches["G"]) == (n, n, n)
        assert va.launches == cfg.depth - n


def test_lm_logits_keeps_fp32_sums_on_the_card(rnd):
    from grasp_any_region_tpu_torch.core.config import gar_tiny
    from grasp_any_region_tpu_torch.models.llama import LlamaParams, lm_logits

    cfg = gar_tiny().text
    params = LlamaParams(cfg, device="cuda", dtype=torch.bfloat16)
    with torch.no_grad():
        for p in params.parameters():
            p.copy_(rnd(*p.shape))
    hidden = rnd(3, cfg.hidden_size) * 4
    out = lm_logits(params, cfg, hidden)
    assert out.dtype == torch.float32
    from grasp_any_region_tpu_torch.ops.norms import rms_norm

    x = rms_norm(hidden, params.final_norm, cfg.rms_norm_eps)
    ref = x.float() @ params.embed.float().t()
    scale = ref.abs().max()
    torch.testing.assert_close(out / scale, ref / scale, rtol=1e-5, atol=1e-5)


def _decode_weights(rnd, n_layers, d, m, hq, hk):
    """Seeded bf16 decoder weights, stacked (L, Din, Dout), scaled by
    Din^-0.5 so the products stay near unit size."""
    def stack(din, n):
        return (rnd(n_layers, din, n).float() * din ** -0.5).to(torch.bfloat16)

    return dict(wq=stack(d, hq), wk=stack(d, hk), wv=stack(d, hk), wo=stack(hq, d),
                w_gate=stack(d, m), w_up=stack(d, m), w_down=stack(m, d))


@pytest.mark.parametrize("b", [1, 5, 24])
@pytest.mark.parametrize("d,m,hq,hk", [
    (384, 1024, 384, 64),     # ragged: 6 column tiles of 64, one tile of kv
    (200, 520, 136, 40),      # multiples of 8 only: partial tiles and K slabs
    (2048, 8192, 2048, 512),  # gar_1b
])
def test_layer_matmul_kernels(rnd, b, d, m, hq, hk):
    layer = 1
    w = _decode_weights(rnd, 3, d, m, hq, hk)
    x_d, x_q, x_m = rnd(b, d), rnd(b, hq), rnd(b, m)
    before = dict(lm.launches)
    wo = lm.layer_matmul(x_q, w["wo"], layer)
    down = lm.layer_matmul(x_m, w["w_down"], layer)
    act = lm.layer_swiglu(x_d, w["w_gate"], w["w_up"], layer)
    qkv = lm.layer_qkv(x_d, w["wq"], w["wk"], w["wv"], layer)
    torch.cuda.synchronize()
    assert lm.launches == dict(before, H=before["H"] + 2, I=before["I"] + 1, J=before["J"] + 1)
    f = {k: v[layer:layer + 1].float() for k, v in w.items()}
    torch.testing.assert_close(wo.float(), lm.layer_matmul_plain(x_q.float(), f["wo"], 0),
                               **TOL)
    torch.testing.assert_close(down.float(), lm.layer_matmul_plain(x_m.float(), f["w_down"], 0),
                               **TOL)
    ref = lm.layer_swiglu_plain(x_d.float(), f["w_gate"], f["w_up"], 0)
    torch.testing.assert_close(act.float(), ref, **TOL)
    refs = lm.layer_qkv_plain(x_d.float(), f["wq"], f["wk"], f["wv"], 0)
    assert [tuple(o.shape) for o in qkv] == [(b, hq), (b, hk), (b, hk)]
    for out, ref in zip(qkv, refs):
        torch.testing.assert_close(out.float(), ref, **TOL)


def test_layer_matmul_wrappers_reject_what_the_kernels_do_not_take(rnd):
    w, x = rnd(2, 64, 128), rnd(3, 64)
    with pytest.raises(TypeError):  # a non-bf16 weight
        lm.layer_matmul(x, w.float(), 0)
    with pytest.raises(IndexError):  # a layer out of range
        lm.layer_swiglu(x, w, w, 2)
    with pytest.raises(ValueError):  # a non-contiguous x
        lm.layer_qkv(rnd(64, 3).t(), w, w, w, 0)
    with pytest.raises(ValueError):  # q's stack with another layer count than k's and v's
        lm.layer_qkv(x, rnd(3, 64, 128), w, w, 0)
    with pytest.raises(ValueError):  # more rows than the kernels take
        lm.layer_matmul(rnd(lm.MAX_ROWS + 1, 64), w, 0)


@pytest.mark.parametrize("b", [1, 5, 17, 24, 32])
@pytest.mark.parametrize("din,dout", [
    (200, 136),    # one CTA a tile: a part box of rows and of columns
    (2056, 520),   # 8 CTAs a tile, two with no rows; rows past Din and columns past Dout
    (8192, 2048),  # gar_1b's w_down
])
def test_layer_matmul_stream_kernel(rnd, b, din, dout):
    """Kernel H (the TMA-fed weight stream) at the first and the last layer
    against the plain version, then the same with a new weight of the same
    shape: the cached tensor map stays right for it."""
    n_layers = 3
    for _ in range(2):
        w = (rnd(n_layers, din, dout).float() * din ** -0.5).to(torch.bfloat16)
        x = rnd(b, din)
        for layer in (0, n_layers - 1):
            before = lm.launches["H"]
            out = lm.layer_matmul(x, w, layer)
            torch.cuda.synchronize()
            assert lm.launches["H"] == before + 1
            ref = lm.layer_matmul_plain(x.float(), w[layer:layer + 1].float(), 0)
            torch.testing.assert_close(out.float(), ref, **TOL)
        del w, x, out  # the next weight may take this one's address


@pytest.mark.parametrize("splits", [1, 2, 4, 8, 16])
def test_layer_matmul_stream_kernel_any_split(rnd, monkeypatch, splits):
    """Kernel H with its cluster size forced (the chooser replaced), 1 to 16
    CTAs a tile, over ragged widths, against the plain version and against
    the mirror of its summation order."""
    monkeypatch.setattr(lm, "_card_splits", lambda *_: splits)
    n_layers, layer, din, dout = 2, 1, 2056, 200
    w = (rnd(n_layers, din, dout).float() * din ** -0.5).to(torch.bfloat16)
    for b in (1, 24):
        x = rnd(b, din)
        out = lm.layer_matmul(x, w, layer)
        torch.cuda.synchronize()
        ref = lm.layer_matmul_plain(x.float(), w[layer:layer + 1].float(), 0)
        torch.testing.assert_close(out.float(), ref, **TOL)
        mirror = lm.layer_matmul_stream_plain(x.float(), w[layer:layer + 1].float(), 0, splits)
        torch.testing.assert_close(out.float(), mirror, **TOL)


def test_gar_decode_step_takes_the_fused_form_on_the_card(rnd):
    """use_kernel=None on a CUDA tensor runs kernels J, C, H, I, H a layer,
    and agrees with the XLA form on the same cache."""
    from grasp_any_region_tpu_torch.core.config import gar_tiny
    from grasp_any_region_tpu_torch.core.weights import init_gar_params
    from grasp_any_region_tpu_torch.models.gar import gar_decode_step, seed_cache_from_prefill

    base = gar_tiny()
    cfg = dataclasses.replace(base, text=dataclasses.replace(
        base.text, hidden_size=256, num_heads=4, num_kv_heads=1, head_dim=64, num_layers=2,
        intermediate_size=1024))
    tc = cfg.text
    params = init_gar_params(cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda",
                             dtype=torch.bfloat16)
    b, s = 2, 100
    kv = tuple(rnd(tc.num_layers, b, s, tc.num_kv_heads, tc.head_dim) for _ in range(2))
    plens = torch.tensor([s, 61], dtype=torch.int32, device="cuda")
    tok = torch.tensor([5, 7], dtype=torch.int32, device="cuda")
    lm.launches.update(dict.fromkeys(lm.launches, 0))
    dec.launches = dec.launches_q8 = 0
    logits, cache = gar_decode_step(params, cfg, tok, seed_cache_from_prefill(cfg, kv, plens, 512),
                                    s)
    torch.cuda.synchronize()
    assert lm.launches == dict(H=2 * tc.num_layers, I=tc.num_layers, J=tc.num_layers,
                               H8=0, I8=0, J8=0)
    assert dec.launches == tc.num_layers and int(cache.write_pos) == s + 1
    ref, _ = gar_decode_step(params, cfg, tok, seed_cache_from_prefill(cfg, kv, plens, 512), s,
                             use_kernel=False)
    assert torch.isfinite(logits).all()
    assert ((logits - ref).abs().max() / ref.abs().max()).item() < 5e-2


def _q8(rnd, n_layers, din, n):
    """Seeded int8 (L, Din, N) weights in [-127, 127] and fp32 (L, 1, N)
    column scales that keep the products near unit size."""
    gen = torch.Generator(device="cuda").manual_seed(din * 7 + n)
    q = torch.randint(-127, 128, (n_layers, din, n), generator=gen, device="cuda",
                      dtype=torch.int8)
    s = (torch.rand((n_layers, 1, n), generator=gen, device="cuda") + 0.5) * din ** -0.5 / 73.3
    return q, s


@pytest.mark.parametrize("b", [1, 5, 24])
@pytest.mark.parametrize("d,m,hq,hk", [
    (384, 1024, 384, 64),     # ragged: 6 column tiles of 64, one tile of kv
    (208, 528, 144, 48),      # multiples of 16 only: partial tiles and K slabs
    (2048, 8192, 2048, 512),  # gar_1b
])
def test_layer_matmul_q8_kernels(rnd, b, d, m, hq, hk):
    """Kernels H8, I8, J8 against their plain versions on the same inputs."""
    layer = 1
    wq, wk, wv, wo = _q8(rnd, 3, d, hq), _q8(rnd, 3, d, hk), _q8(rnd, 3, d, hk), _q8(rnd, 3, hq, d)
    wg, wu, wd = _q8(rnd, 3, d, m), _q8(rnd, 3, d, m), _q8(rnd, 3, m, d)
    x_d, x_q, x_m = rnd(b, d), rnd(b, hq), rnd(b, m)
    before = dict(lm.launches)
    outs = dict(wo=lm.layer_matmul_q8(x_q, *wo, layer), down=lm.layer_matmul_q8(x_m, *wd, layer),
                act=lm.layer_swiglu_q8(x_d, *wg, *wu, layer),
                qkv=lm.layer_qkv_q8(x_d, *wq, *wk, *wv, layer))
    torch.cuda.synchronize()
    assert lm.launches == dict(before, H8=before["H8"] + 2, I8=before["I8"] + 1,
                               J8=before["J8"] + 1)
    refs = dict(wo=lm.layer_matmul_q8_plain(x_q.float(), *wo, layer),
                down=lm.layer_matmul_q8_plain(x_m.float(), *wd, layer),
                act=lm.layer_swiglu_q8_plain(x_d.float(), *wg, *wu, layer),
                qkv=lm.layer_qkv_q8_plain(x_d.float(), *wq, *wk, *wv, layer))
    for name, out in outs.items():
        for o, r in zip(out if name == "qkv" else (out,), refs[name] if name == "qkv" else
                        (refs[name],)):
            assert o.dtype == torch.bfloat16 and o.shape == r.shape
            torch.testing.assert_close(o.float(), r, **TOL, msg=name)


def _swiglu_q8_case(rnd, d, m, seed):
    """Seeded int8 gate and up (L = 2) with their column scales, distinct."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    mats = []
    for _ in range(2):
        mats.append(torch.randint(-127, 128, (2, d, m), generator=gen, device="cuda",
                                  dtype=torch.int8))
        mats.append((torch.rand((2, 1, m), generator=gen, device="cuda") + 0.5)
                    * d ** -0.5 / 73.3)
    return mats


@pytest.mark.parametrize("splits", [1, 2, 4, 8, 16])
def test_layer_swiglu_q8_kernel_any_split(rnd, monkeypatch, splits):
    """Kernel I8 (H's weight stream, int8 gate and up two boxes a stage) with
    its cluster size forced (the chooser replaced), 1 to 16 CTAs a tile, at
    ragged widths and GAR-1B's, B = 1, 24 and 32, against the plain version
    and against the mirror of its summation order."""
    monkeypatch.setattr(lm, "_card_splits", lambda *_: splits)
    for d, m in ((200, 144), (1032, 400), (2048, 8192)):
        mats = _swiglu_q8_case(rnd, d, m, d + splits)
        for b in (1, 24, 32):
            x = rnd(b, d)
            before = lm.launches["I8"]
            out = lm.layer_swiglu_q8(x, *mats, 1)
            torch.cuda.synchronize()
            assert lm.launches["I8"] == before + 1
            torch.testing.assert_close(out.float(), lm.layer_swiglu_q8_plain(
                x.float(), *mats, 1).float(), **TOL, msg=f"{d} x {m}, B = {b}")
            mirror = lm.layer_swiglu_q8_stream_plain(x.float(), *mats, 1, splits)
            torch.testing.assert_close(out.float(), mirror.float(), **TOL)


def test_layer_swiglu_q8_kernel_same_bits(rnd):
    """Kernel I8 gives the same bits on a second launch and on two replays of
    a CUDA graph of one launch, at B = 1 and 24 (two row tiles)."""
    mats = _swiglu_q8_case(rnd, 2048, 8192, 5)
    for b in (1, 24):
        x = rnd(b, 2048)
        out = lm.layer_swiglu_q8(x, *mats, 1)
        _same_bits_twice_and_replayed(lambda: lm.layer_swiglu_q8(x, *mats, 1), out)


def _bf16_stack(rnd, n_layers, din, n):
    return (rnd(n_layers, din, n).float() * din ** -0.5).to(torch.bfloat16)


# kernels H8 and I on H's weight stream: (wrapper, plain version, mirror of
# the kernel's order of summation, seeded weights (L = 2) for (Din, N, seed))
STREAM_NW = dict(
    H8=(lm.layer_matmul_q8, lm.layer_matmul_q8_plain, lm.layer_matmul_q8_stream_plain,
        lambda rnd, din, n, seed: _swiglu_q8_case(rnd, din, n, seed)[:2]),
    I=(lm.layer_swiglu, lm.layer_swiglu_plain, lm.layer_swiglu_stream_plain,
       lambda rnd, din, n, seed: (_bf16_stack(rnd, 2, din, n), _bf16_stack(rnd, 2, din, n))))
STREAM_NW_WIDTHS = dict(  # ragged (a part stage, a part tile), then GAR-1B's
    H8=((200, 144), (1032, 400), (2048, 2048), (8192, 2048)),
    I=((200, 136), (1032, 392), (2048, 8192)))


def _plain_of(plain, x, mats, layer):
    """The plain version in fp32 on the same (bf16 or int8) inputs."""
    return plain(x.float(), *(m if m.dtype == torch.int8 else m.float() for m in mats),
                 layer).float()


@pytest.mark.parametrize("splits", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("key", ["H8", "I"])
def test_stream_nw_kernel_any_split(rnd, monkeypatch, key, splits):
    """Kernels H8 (one int8 weight a stage) and I (bf16 gate and up, two
    boxes a stage) on H's weight stream with the cluster size forced (the
    chooser replaced), 1 to 16 CTAs a tile, at ragged widths and GAR-1B's
    (H8: wo and w_down), B = 1, 24 and 32, against the plain version and
    against the mirror of the kernel's order of summation."""
    wrapper, plain, mirror, weights = STREAM_NW[key]
    monkeypatch.setattr(lm, "_card_splits", lambda *_: splits)
    for din, n in STREAM_NW_WIDTHS[key]:
        mats = weights(rnd, din, n, din + splits)
        for b in (1, 24, 32):
            x = rnd(b, din)
            before = lm.launches[key]
            out = wrapper(x, *mats, 1)
            torch.cuda.synchronize()
            assert lm.launches[key] == before + 1
            assert out.dtype == torch.bfloat16 and out.shape == (b, n)
            torch.testing.assert_close(out.float(), _plain_of(plain, x, mats, 1), **TOL,
                                       msg=f"{key} {din} x {n}, B = {b}")
            torch.testing.assert_close(out.float(), mirror(x.float(), *mats, 1, splits).float(),
                                       **TOL, msg=f"{key} mirror {din} x {n}, B = {b}")


@pytest.mark.parametrize("key,din,n", [("H8", 8192, 2048), ("H8", 2048, 2048),
                                       ("I", 2048, 8192)])
def test_stream_nw_kernel_same_bits(rnd, key, din, n):
    """Kernels H8 (at GAR-1B's w_down and wo) and I (gate and up) give the
    same bits on a second launch and on two replays of a CUDA graph of one
    launch, at B = 1 and 24 (two row tiles)."""
    wrapper, _, _, weights = STREAM_NW[key]
    mats = weights(rnd, din, n, 5)
    for b in (1, 24):
        x = rnd(b, din)
        out = wrapper(x, *mats, 1)
        _same_bits_twice_and_replayed(lambda: wrapper(x, *mats, 1), out)


@pytest.mark.parametrize("b", [1, 5, 24])
@pytest.mark.parametrize("key", ["H8", "I"])
def test_stream_nw_kernel_fresh_weight(rnd, key, b):
    """Kernels H8 and I at the first and the last layer against the plain
    version, then the same with new weights of the same shape made after
    the first are freed (they may take the same address): the cached tensor
    maps stay right for them."""
    wrapper, plain, _, weights = STREAM_NW[key]
    din, n = 1032, 400
    for seed in range(2):
        mats = weights(rnd, din, n, seed)  # another weight each time
        x = rnd(b, din)
        for layer in (0, 1):
            out = wrapper(x, *mats, layer)
            torch.cuda.synchronize()
            torch.testing.assert_close(out.float(), _plain_of(plain, x, mats, layer), **TOL)
        del mats, x, out  # the next weights may take these ones' addresses


@pytest.mark.parametrize("key", ["H", "H8", "I", "I8"])
def test_stream_kernels_every_row_count(rnd, key):
    """The four kernels of H's weight stream at every B from 1 to 32 (x's
    tensor map has boxes of B rounded up to 8 rows; one or two row tiles),
    each x a fresh tensor that may take the last one's address with
    another shape, against the plain version at a ragged width."""
    din, n = 1032, 400
    if key == "H":
        wrapper, plain, mats = lm.layer_matmul, lm.layer_matmul_plain, (
            _bf16_stack(rnd, 2, din, n),)
    elif key == "I8":
        wrapper, plain = lm.layer_swiglu_q8, lm.layer_swiglu_q8_plain
        mats = _swiglu_q8_case(rnd, din, n, 3)
    else:
        wrapper, plain, _, weights = STREAM_NW[key]
        mats = weights(rnd, din, n, 3)
    for b in range(1, lm.MAX_ROWS + 1):
        x = rnd(b, din)
        out = wrapper(x, *mats, 1)
        torch.cuda.synchronize()
        torch.testing.assert_close(out.float(), _plain_of(plain, x, mats, 1), **TOL,
                                   msg=f"{key} B = {b}")
        del x, out


# kernels J and J8 on H's weight stream, three segments (q, k, v): the
# shapes of test_layer_matmul_kernels / test_layer_matmul_q8_kernels
# (ragged: a part tile, k and v narrower than a tile; then GAR-1B's)
QKV_STREAM_WIDTHS = {False: ((384, 384, 64), (200, 136, 40), (2048, 2048, 512)),
                     True: ((384, 384, 64), (208, 144, 48), (2048, 2048, 512))}


def _layer_qkv_case(rnd, q8, d, hq, hk, n_layers=3, scale=None):
    """J or J8, its plain version, its stream mirror, its counter key and
    seeded (L = n_layers) weights (int8: with their column scales, by
    default `_q8`'s, else `scale` x (0.5-1.5))."""
    if not q8:
        w = _decode_weights(rnd, n_layers, d, 64, hq, hk)
        return (lm.layer_qkv, lm.layer_qkv_plain, lm.layer_qkv_stream_plain, "J",
                (w["wq"], w["wk"], w["wv"]))
    mats = []
    for n in (hq, hk, hk):
        w, s = _q8(rnd, n_layers, d, n)
        if scale is not None:
            gen = torch.Generator(device="cuda").manual_seed(n)
            s = (torch.rand(s.shape, generator=gen, device="cuda") + 0.5) * scale
        mats += [w, s]
    return (lm.layer_qkv_q8, lm.layer_qkv_q8_plain, lm.layer_qkv_q8_stream_plain, "J8",
            tuple(mats))


def _at_layer(mats, layer):
    """The layer's slice of each stacked weight and scale, bf16 widened to
    fp32 and int8 kept (the mirror takes int8's tile width from it), for
    the plain versions and the mirrors at layer 0."""
    return [m[layer:layer + 1] if m.dtype == torch.int8 else m[layer:layer + 1].float()
            for m in mats]


def _check_layer_qkv(kernel, plain, mirror, key, mats, x, layer, splits, msg):
    before = dict(lm.launches)
    out = kernel(x, *mats, layer)
    torch.cuda.synchronize()
    assert lm.launches == dict(before, **{key: before[key] + 1}), msg
    ref = plain(x.float(), *_at_layer(mats, layer), 0)
    want = mirror(x.float(), *_at_layer(mats, layer), 0, splits)
    for o, r, m, part in zip(out, ref, want, "qkv"):
        assert o.dtype == torch.bfloat16 and o.shape == r.shape
        torch.testing.assert_close(o.float(), r.float(), **TOL, msg=f"{msg}, {part}")
        torch.testing.assert_close(o.float(), m.float(), **TOL, msg=f"{msg}, {part} mirror")


@pytest.mark.parametrize("splits", list(range(1, 17)))
@pytest.mark.parametrize("q8", [False, True], ids=["J", "J8"])
def test_layer_qkv_stream_kernel_any_split(rnd, monkeypatch, q8, splits):
    """Kernels J and J8 (three segments of H's weight stream) with the
    cluster size forced (the chooser replaced), 1 to 16 CTAs a tile, at the
    ragged widths and GAR-1B's, B = 1, 5 and 24, against the plain version
    and the mirror of their partition and order; a cluster size that is
    not a power of two is refused."""
    monkeypatch.setattr(lm, "_card_qkv_stream_splits", lambda *_: splits)
    for d, hq, hk in QKV_STREAM_WIDTHS[q8]:
        kernel, plain, mirror, key, mats = _layer_qkv_case(rnd, q8, d, hq, hk)
        for b in (1, 5, 24):
            x = rnd(b, d)
            if splits & (splits - 1):
                with pytest.raises(RuntimeError, match="gar_layer_qkv"):
                    kernel(x, *mats, 1)
                continue
            _check_layer_qkv(kernel, plain, mirror, key, mats, x, 1, splits,
                             f"{key} {d} x ({hq}, {hk}), B = {b}, {splits} CTAs a tile")


@pytest.mark.parametrize("q8", [False, True], ids=["J", "J8"])
def test_layer_qkv_stream_kernels_at_the_chooser(rnd, q8):
    """J and J8 at the chooser's CTAs a tile (4 and 8 at GAR-1B) at every
    layer of the ragged widths and GAR-1B's, B = 1, 5, 24, against the plain
    version and the stream mirror; then new weights of the same shapes
    (they may take the freed ones' addresses): the cached tensor maps stay
    right."""
    for d, hq, hk in QKV_STREAM_WIDTHS[q8]:
        for _ in range(2):
            kernel, plain, mirror, key, mats = _layer_qkv_case(rnd, q8, d, hq, hk)
            splits = lm._card_qkv_stream_splits(hq, hk, d, 1 if q8 else 2, 0)
            for b in (1, 5, 24):
                x = rnd(b, d)
                for layer in range(3):
                    _check_layer_qkv(kernel, plain, mirror, key, mats, x, layer, splits,
                                     f"{key} {d} x ({hq}, {hk}), B = {b}, layer {layer}")
            del mats, x


@pytest.mark.parametrize("q8", [False, True], ids=["J", "J8"])
def test_layer_qkv_stream_kernels_every_row_count(rnd, q8):
    """J and J8 at every B from 1 to 32 (x's tensor map has boxes of B
    rounded up to 8 rows; one or two row tiles), each x a fresh tensor, at
    a ragged width, against the plain version and the stream mirror."""
    d, hq, hk = QKV_STREAM_WIDTHS[q8][1]
    kernel, plain, mirror, key, mats = _layer_qkv_case(rnd, q8, d, hq, hk)
    splits = lm._card_qkv_stream_splits(hq, hk, d, 1 if q8 else 2, 0)
    for b in range(1, lm.MAX_ROWS + 1):
        x = rnd(b, d)
        _check_layer_qkv(kernel, plain, mirror, key, mats, x, 1, splits, f"{key} B = {b}")
        del x


@pytest.mark.parametrize("q8", [False, True], ids=["J", "J8"])
def test_layer_qkv_stream_kernel_same_bits(rnd, q8):
    """J and J8 at GAR-1B's widths give the same bits on a second launch and
    on two replays of a CUDA graph of one launch, at B = 1 and 24."""
    kernel, _, _, _, mats = _layer_qkv_case(rnd, q8, 2048, 2048, 512)
    for b in (1, 24):
        x = rnd(b, 2048)

        def run():
            return torch.cat(kernel(x, *mats, 1), -1)

        _same_bits_twice_and_replayed(run, run())


@pytest.mark.parametrize("d,hq,hk", QKV_STREAM_WIDTHS[True])
def test_layer_qkv_q8_kernel_at_the_old_scale(rnd, d, hq, hk):
    """J8 with column scales 0.02 x (0.5-1.5), the int8 tests' earlier scale
    (outputs of tens, not of one), at B = 1, 5 and 24, against the plain
    version and the stream mirror at the chooser's CTAs a tile."""
    kernel, plain, mirror, key, mats = _layer_qkv_case(rnd, True, d, hq, hk, scale=0.02)
    splits = lm._card_qkv_stream_splits(hq, hk, d, 1, 0)
    for b in (1, 5, 24):
        _check_layer_qkv(kernel, plain, mirror, key, mats, rnd(b, d), 2, splits,
                         f"J8 {d} x ({hq}, {hk}), B = {b}")


def test_layer_matmul_q8_wrappers_reject_what_the_kernels_do_not_take(rnd):
    w, s = _q8(rnd, 2, 64, 128)
    x = rnd(3, 64)
    with pytest.raises(TypeError):  # a bf16 weight
        lm.layer_matmul_q8(x, w.to(torch.bfloat16), s, 0)
    with pytest.raises(TypeError):  # bf16 scales
        lm.layer_swiglu_q8(x, w, s.to(torch.bfloat16), w, s, 0)
    with pytest.raises(ValueError):  # Dout not a multiple of 16
        lm.layer_qkv_q8(x, *_q8(rnd, 2, 64, 40), w, s, w, s, 0)
    with pytest.raises(IndexError):
        lm.layer_matmul_q8(x, w, s, 2)


def _q8_cache(L, b, kh, s, seed):
    """A seeded int8 (L, B, K, S, 64) cache and its fp32 (L, B, K / 2) pair
    scales, which make the dequantized cache unit-size, as C's bf16 randn
    cache (and a quantized one: int8 spans each pair's max)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    k_all, v_all = (torch.randint(-127, 128, (L, b, kh, s, 64), generator=gen, device="cuda",
                                  dtype=torch.int8) for _ in range(2))
    k_scale, v_scale = ((torch.rand((L, b, kh // 2, 1, 1), generator=gen, device="cuda") + 0.5)
                        / 73.3 for _ in range(2))
    return k_all, v_all, k_scale, v_scale


def _q8_probe(kind, k_all, v_all, k_scale, v_scale, q, k_new, v_new, layer, plens, pad, wpos):
    """C8's probes at `layer` (the other layers as they are). "interval":
    k = 0 and v int8 spikes on each side of each interval edge, the i-th
    16 i steps of a scale of the row's count of valid columns / 800, so
    each spike is 0.02 i times that count (as `_interval_probe`); one
    column too many, too few or twice moves a row by 0.02 or more.
    "current": k and v = 0 in the cache and the first query head of each
    kv head carrying about half its weight on the current token (q . k_new
    scaled to log n), k_new and v_new quantized at a coarse scale of 0.5:
    folding in the bf16 k_new or v_new instead of their dequantized values
    moves those rows by a few hundredths."""
    k_all, v_all, k_scale, v_scale = (t.clone() for t in (k_all, v_all, k_scale, v_scale))
    b, kh = k_new.shape[:2]
    k_all[layer].zero_()
    counts = [p + max(0, wpos + 1 - max(pad, p)) for p in plens]
    if kind == "interval":
        k_new = torch.zeros_like(k_new)
        gen = torch.Generator(device="cuda").manual_seed(len(plens))
        v_all[layer] = torch.randint(-16, 17, v_all[layer].shape, generator=gen,
                                     device="cuda", dtype=torch.int8)
        for row, (plen, n) in enumerate(zip(plens, counts)):
            edges = sorted({plen - 1, plen, pad - 1, pad, wpos, wpos + 1}
                           & set(range(v_all.shape[3])))
            for i, col in enumerate(edges):
                v_all[layer, row, :, col] = 16 * (i + 1)
            v_scale[layer, row] = n / 800
    else:
        v_all[layer].zero_()
        k_scale[layer], v_scale[layer] = 0.5, 0.5
        q0 = q.float().reshape(b, kh, -1, 64)[:, :, 0]  # (B, K, 64)
        n = torch.tensor(counts, device=q.device, dtype=torch.float32)[:, None, None]
        k_new = (q0 * 8 * n.log() / q0.pow(2).sum(-1, keepdim=True)).to(torch.bfloat16)
        v_new = (v_new.float() * 2).to(torch.bfloat16)
    return k_all, v_all, k_scale, v_scale, k_new, v_new


def _check_q8(k_all, v_all, k_scale, v_scale, q, k_new, v_new, layer, plens, pad, wpos,
              splits=None):
    """C8 against its plain version at TOL16 (and, with `splits`, against
    the split mirror); the cache changes only at column write_pos, there
    within one quantization step of the plain version's."""
    kw = dict(prompt_lens=_cuda_int32(plens), write_pos=_cuda_int32(wpos), prompt_pad=pad,
              k_scale=k_scale, v_scale=v_scale)
    k_exp, v_exp = k_all.clone(), v_all.clone()
    ref = dec.decode_attention_fused_q8_plain(q.float(), k_exp, v_exp, k_new, v_new, layer, **kw)
    before = dec.launches_q8
    out = dec.decode_attention_fused(q, k_all, v_all, k_new, v_new, layer, **kw)
    torch.cuda.synchronize()
    assert dec.launches_q8 == before + 1
    torch.testing.assert_close(out.float(), ref, **TOL16)
    if splits is not None:
        mirror = dec.decode_attention_fused_q8_split_plain(
            q.float(), k_all.clone(), v_all.clone(), k_new, v_new, layer, splits=splits, **kw)
        torch.testing.assert_close(out.float(), mirror, **TOL16)
    for got, want in ((k_all, k_exp), (v_all, v_exp)):
        assert (got[layer, :, :, wpos].int() - want[layer, :, :, wpos].int()).abs().max() <= 1
        got[layer, :, :, wpos] = want[layer, :, :, wpos]
        assert torch.equal(got, want)
    return out


@pytest.mark.parametrize("group", [1, 2, 4, 8])
@pytest.mark.parametrize("b,plens,pad,wpos", [
    (2, (100, 37), 128, 170),
    (2, (128, 1), 128, 128),
    (3, (500, 700, 9), 700, 1023),
    (24, None, 700, 800),   # ragged prompt lengths on both sides of prompt_pad
    (2, "edges", None, None),
    (2, "empty", None, None),
])
def test_decode_attention_q8_kernel(rnd, group, b, plens, pad, wpos):
    """Kernel C8 (C's split-KV body on the int8 cache) against its plain
    version at TOL16, then the interval probe and the current-token probe
    (`_q8_probe`) at TOL16: the cache changes only at column write_pos,
    there within one quantization step."""
    L, kh, s, layer = 3, 4, 1024, 1
    splits = dec.card_splits(b, kh, torch.device("cuda"), dec.MAX_SPLITS_Q8)
    if isinstance(plens, str):
        b, plens, pad, wpos = _split_layout(plens, splits)
    elif plens is None:  # at and around write_pos and prompt_pad, then seeded
        plens = [700, 699, 1, 2, 64, 65] + torch.randint(
            1, 700, (b - 6,), generator=torch.Generator().manual_seed(b)).tolist()
    cache = _q8_cache(L, b, kh, s, group)
    q, k_new, v_new = rnd(b, kh * group, 64), rnd(b, kh, 64), rnd(b, kh, 64)
    args = (layer, plens, pad, wpos)
    _check_q8(*cache, q, k_new, v_new, *args)
    for kind in ("interval", "current"):
        k_all, v_all, ks, vs, kn, vn = _q8_probe(kind, *cache, q, k_new, v_new, *args)
        _check_q8(k_all, v_all, ks, vs, q, kn, vn, *args)


@pytest.mark.parametrize("splits", [1, 2, 3, 5, 8, 16])
def test_decode_attention_q8_kernel_any_split(rnd, monkeypatch, splits):
    """Kernel C8 with the CTAs a (kv head, row) forced (the chooser
    replaced), clusters of 1 to 16, over three ragged rows (one with fewer
    columns than CTAs), against the plain version and the split mirror at
    TOL16, then the interval probe."""
    monkeypatch.setattr(dec, "card_splits", lambda *_: splits)
    L, b, kh, s, layer, group = 2, 3, 4, 1024, 1, 4
    args = (layer, [300, 3, 1], 512, 515)
    cache = _q8_cache(L, b, kh, s, splits)
    q, k_new, v_new = rnd(b, kh * group, 64), rnd(b, kh, 64), rnd(b, kh, 64)
    _check_q8(*cache, q, k_new, v_new, *args, splits=splits)
    k_all, v_all, ks, vs, kn, vn = _q8_probe("interval", *cache, q, k_new, v_new, *args)
    _check_q8(k_all, v_all, ks, vs, q, kn, vn, *args, splits=splits)


@pytest.mark.parametrize("group", [1, 4, 8])
@pytest.mark.parametrize("b,plens,pad,wpos", [(2, (100, 37), 128, 170),
                                              (24, [700 - 29 * i for i in range(24)], 700, 800)])
def test_decode_attention_q8_kernel_is_c_on_the_widened_cache(rnd, group, b, plens, pad, wpos):
    """With power-of-two pair scales every dequantized value is exact in
    bf16, so kernel C8 must give kernel C's bits on the widened cache (the
    int8 cache times its scales, as bf16) with the new K/V as C8 quantizes
    them, and write the same column (at the same splits)."""
    L, kh, s, layer = 3, 4, 1024, 1
    k_all, v_all, _, _ = _q8_cache(L, b, kh, s, group)
    exps = torch.arange(L * b * (kh // 2), device="cuda").reshape(L, b, kh // 2, 1, 1) % 3
    k_scale, v_scale = 2.0 ** -(5 + exps).float(), 2.0 ** -(6 + exps).float()
    q, k_new, v_new = rnd(b, kh * group, 64), rnd(b, kh, 64), rnd(b, kh, 64)

    def widen(x, sc):  # (L, B, K, ...) int8 at the pairs' scales, as bf16 (exact)
        return (x.float() * sc.repeat_interleave(2, dim=2).reshape(
            L, b, kh, *[1] * (x.dim() - 3))).to(torch.bfloat16)

    k16, v16 = widen(k_all, k_scale), widen(v_all, v_scale)
    kn16 = widen(torch.clamp(torch.round(k_new.float()[None] / k_scale[layer].repeat_interleave(
        2, dim=1)[None, ..., 0]), -127, 127).to(torch.int8).expand(L, -1, -1, -1), k_scale)[layer]
    vn16 = widen(torch.clamp(torch.round(v_new.float()[None] / v_scale[layer].repeat_interleave(
        2, dim=1)[None, ..., 0]), -127, 127).to(torch.int8).expand(L, -1, -1, -1), v_scale)[layer]
    kw = dict(prompt_lens=_cuda_int32(plens), write_pos=_cuda_int32(wpos), prompt_pad=pad)
    splits = dec.card_splits(b, kh, torch.device("cuda"), dec.MAX_SPLITS_Q8)
    out8 = dec.decode_attention_fused(q, k_all, v_all, k_new, v_new, layer, k_scale=k_scale,
                                      v_scale=v_scale, **kw)
    with pytest.MonkeyPatch.context() as mp:  # kernel C at C8's splits
        mp.setattr(dec, "card_splits", lambda *_: splits)
        out16 = dec.decode_attention_fused(q, k16, v16, kn16, vn16, layer, **kw)
    torch.cuda.synchronize()
    assert torch.equal(out8, out16)
    assert torch.equal(widen(k_all, k_scale), k16) and torch.equal(widen(v_all, v_scale), v16)


@pytest.mark.parametrize("group", [1, 4, 8])
@pytest.mark.parametrize("b,plens,pad,wpos", [
    (2, (100, 37), 128, 170),
    (3, (500, 700, 9), 700, 1023),
    (24, [700, 699, 1, 2, 64, 65] + [700 - 37 * i for i in range(18)], 700, 800),
])
def test_decode_attention_q8_kernel_at_the_old_scale(rnd, group, b, plens, pad, wpos):
    """C8 with pair scales 0.02 x (0.5-1.5), the int8 tests' scale before
    the unit-size cache of `_q8_cache` (dequantized values up to 3.8),
    against the split mirror at the chooser's CTAs (it rounds p to bf16
    where the kernel does) at TOL16, and against the plain version at TOL;
    the cache changes only at column write_pos, there within one
    quantization step."""
    L, kh, s, layer = 3, 4, 1024, 1
    k_all, v_all, _, _ = _q8_cache(L, b, kh, s, group)
    gen = torch.Generator(device="cuda").manual_seed(group + b)
    k_scale, v_scale = ((torch.rand((L, b, kh // 2, 1, 1), generator=gen, device="cuda") + 0.5)
                        * 0.02 for _ in range(2))
    q, k_new, v_new = rnd(b, kh * group, 64), rnd(b, kh, 64), rnd(b, kh, 64)
    splits = dec.card_splits(b, kh, torch.device("cuda"), dec.MAX_SPLITS_Q8)
    kw = dict(prompt_lens=_cuda_int32(plens), write_pos=_cuda_int32(wpos), prompt_pad=pad,
              k_scale=k_scale, v_scale=v_scale)
    k_exp, v_exp = k_all.clone(), v_all.clone()
    ref = dec.decode_attention_fused_q8_plain(q.float(), k_exp, v_exp, k_new, v_new, layer, **kw)
    mirror = dec.decode_attention_fused_q8_split_plain(q.float(), k_all.clone(), v_all.clone(),
                                                       k_new, v_new, layer, splits=splits, **kw)
    before = dec.launches_q8
    out = dec.decode_attention_fused(q, k_all, v_all, k_new, v_new, layer, **kw)
    torch.cuda.synchronize()
    assert dec.launches_q8 == before + 1
    print(f"splits {splits}: max |out - mirror| {(out.float() - mirror).abs().max().item():.3e}, "
          f"|out - plain| {(out.float() - ref).abs().max().item():.3e}, "
          f"max |out| {out.float().abs().max().item():.3f}")
    torch.testing.assert_close(out.float(), mirror, **TOL16)
    torch.testing.assert_close(out.float(), ref, **TOL)
    for got, want in ((k_all, k_exp), (v_all, v_exp)):
        assert (got[layer, :, :, wpos].int() - want[layer, :, :, wpos].int()).abs().max() <= 1
        got[layer, :, :, wpos] = want[layer, :, :, wpos]
        assert torch.equal(got, want)


def test_decode_attention_q8_kernel_same_bits(rnd):
    """Kernel C8 gives the same bits on a second launch and on two replays
    of a CUDA graph of one launch (the append writes the same column)."""
    layer, plens, pad, wpos = 1, [900, 17], 900, 1000
    k_all, v_all, ks, vs = _q8_cache(2, 2, 4, 1024, 3)
    q, k_new, v_new = rnd(2, 16, 64), rnd(2, 4, 64), rnd(2, 4, 64)
    kw = dict(prompt_lens=_cuda_int32(plens), write_pos=_cuda_int32(wpos), prompt_pad=pad,
              k_scale=ks, v_scale=vs)

    def run():
        return dec.decode_attention_fused(q, k_all, v_all, k_new, v_new, layer, **kw)

    out = run()
    _same_bits_twice_and_replayed(run, out)


def test_decode_attention_q8_wrapper_rejects_what_the_kernel_does_not_take(rnd):
    k_all = torch.zeros((2, 1, 2, 128, 64), dtype=torch.int8, device="cuda")
    scale = torch.ones((2, 1, 1, 1, 1), device="cuda")
    kw = dict(prompt_lens=torch.tensor([3], dtype=torch.int32, device="cuda"),
              write_pos=torch.tensor(10, dtype=torch.int32, device="cuda"), prompt_pad=8)
    args = (rnd(1, 4, 64), k_all, k_all.clone(), rnd(1, 2, 64), rnd(1, 2, 64), 0)
    with pytest.raises(ValueError):  # no scales
        dec.decode_attention_fused(*args, **kw)
    with pytest.raises(ValueError):  # one scale per head, not per pair
        dec.decode_attention_fused(*args, k_scale=scale.expand(2, 1, 2, 1, 1).contiguous(),
                                   v_scale=scale, **kw)
    with pytest.raises(TypeError):  # bf16 scales
        dec.decode_attention_fused(*args, k_scale=scale.bfloat16(), v_scale=scale, **kw)


def test_int8_decode_step_on_the_card(rnd):
    """An int8 gar_decode_step (int8 weights and cache) on the card runs
    J8, C8, H8, I8, H8 a layer and no bf16 kernel, and agrees with the same
    step's plain path on the CPU."""
    import copy

    from grasp_any_region_tpu_torch.core.config import gar_tiny
    from grasp_any_region_tpu_torch.core.weights import init_gar_params
    from grasp_any_region_tpu_torch.models.gar import gar_decode_step, seed_cache_from_prefill
    from grasp_any_region_tpu_torch.models.quantize import quantize_decode_weights

    base = gar_tiny()
    cfg = dataclasses.replace(base, text=dataclasses.replace(
        base.text, hidden_size=256, num_heads=4, num_kv_heads=2, head_dim=64, num_layers=2,
        intermediate_size=1024))
    tc = cfg.text
    cpu = quantize_decode_weights(init_gar_params(cfg, torch.Generator().manual_seed(0),
                                                  device="cpu", dtype=torch.bfloat16))
    card = copy.deepcopy(cpu).to("cuda")
    b, s = 2, 100
    kv = tuple(rnd(tc.num_layers, b, s, tc.num_kv_heads, tc.head_dim) for _ in range(2))
    plens = torch.tensor([s, 61], dtype=torch.int32)
    tok = torch.tensor([5, 7], dtype=torch.int32)
    lm.launches.update(dict.fromkeys(lm.launches, 0))
    dec.launches = dec.launches_q8 = 0
    logits, cache = gar_decode_step(card, cfg, tok.cuda(), seed_cache_from_prefill(
        cfg, kv, plens.cuda(), 512, quantize_kv=True), s)
    torch.cuda.synchronize()
    n = tc.num_layers
    assert lm.launches == dict(H=0, I=0, J=0, H8=2 * n, I8=n, J8=n)
    assert (dec.launches, dec.launches_q8) == (0, n) and int(cache.write_pos) == s + 1
    ref, _ = gar_decode_step(cpu, cfg, tok, seed_cache_from_prefill(
        cfg, tuple(t.cpu() for t in kv), plens, 512, quantize_kv=True), s)
    assert torch.isfinite(logits).all()
    assert ((logits.cpu() - ref).abs().max() / ref.abs().max()).item() < 5e-2


# ---- training: A and B with their LSE, B with segment ids, kernels 5, 17, 18


def _packed_segments(b, s, gen):
    """(B, S) int32 ids of documents 1, 2, ... of 30-300 tokens, then padding (0)."""
    seg = torch.zeros((b, s), dtype=torch.int32)
    for r in range(b):
        off, doc = 0, 1
        while True:
            n = int(torch.randint(30, 300, (1,), generator=gen))
            if off + n > s - 17:
                break
            seg[r, off:off + n] = doc
            off, doc = off + n, doc + 1
    return seg.cuda()


@pytest.mark.parametrize("t,s,h", [(2, 200, 2), (3, 1025, 4), (1, 64, 1), (1, 129, 2),
                                   (2, 1024, 3), (1, 77, 2)])
def test_vit_attention_lse_and_backward_kernels(rnd, t, s, h):
    """Kernel A with its LSE, then kernel 5 (17's prep, 18's non-causal
    pass, 17's cast) with v a strided view of a (T, S, 3, H, 64) buffer, as
    the unfused tower passes it, against the plain backward, which rounds p
    and dS to bf16 where the kernels do, at the output-sized tolerance."""
    from grasp_any_region_tpu_torch.ops import flash_backward as fb

    q, k, g = (rnd(t, s, h, 64) for _ in range(3))
    v = rnd(t, s, 3, h, 64)[:, :, 2]
    out, lse = va.vit_attention(q, k, v, return_lse=True)
    ref, ref_lse = va.vit_attention_plain(q.float(), k.float(), v.float(), return_lse=True)
    torch.testing.assert_close(out.float(), ref, **TOL)
    _sized_close(out, ref, "out")
    torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=1e-4)
    before = va.launches_bwd, fb.launches_dq, fb.launches_dkv
    got = va.vit_attention_bwd(q, k, v, out, lse, g)
    torch.cuda.synchronize()
    assert (va.launches_bwd, fb.launches_dq, fb.launches_dkv) == tuple(x + 1 for x in before)
    want = [w.float() for w in va.vit_attention_bwd_plain(q, k, v, out, lse, g)]
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        _sized_close(a, b, name)


def _documents(b, s, ends):
    """(B, S) int32 ids: documents 1, 2, ... ending at `ends`, then padding (0)."""
    seg = torch.zeros((b, s), dtype=torch.int32)
    for doc, (lo, hi) in enumerate(zip((0,) + ends[:-1], ends), start=1):
        seg[:, lo:hi] = doc
    return seg.cuda()


@pytest.mark.parametrize("b,sq,sk,h,kh,causal,packed", [
    (1, 256, 256, 4, 2, True, False),
    (2, 130, 300, 4, 1, True, False),
    (2, 200, 333, 8, 2, False, False),
    (1, 300, 300, 8, 8, True, False),
    (2, 700, 700, 8, 2, True, True),
    (1, 450, 450, 4, 4, False, True),
    (1, 200, 200, 8, 1, True, False),
    (2, 333, 333, 4, 2, True, False),
    (1, 100, 333, 2, 1, True, False),
    (1, 333, 333, 8, 4, True, (100, 129, 250)),
    (2, 520, 520, 8, 1, True, (64, 127, 130, 300, 511)),
    (1, 1025, 1025, 8, 2, True, (127, 128, 129, 600, 1000)),
    (1, 700, 700, 4, 1, False, (255, 256, 257, 640)),
    # non-causal, a few keys past the last full 128-key tile: folded into
    # that tile's CTA, over a GQA group of 4
    (1, 1040, 1040, 8, 2, False, False),
    (2, 130, 130, 4, 1, False, False),
])
def test_flash_attention_lse_segments_and_backward_kernels(rnd, b, sq, sk, h, kh, causal,
                                                           packed):
    from grasp_any_region_tpu_torch.ops import flash_backward as fb

    q, g = rnd(b, sq, h, 64), rnd(b, sq, h, 64)
    k, v = rnd(b, sk, kh, 64), rnd(b, sk, kh, 64)
    seg = None
    if packed is True:
        seg = _packed_segments(b, sq, torch.Generator().manual_seed(sq))
    elif packed:  # documents ending inside and at the edges of 128-key tiles
        seg = _documents(b, sq, packed)
    kw = dict(causal=causal, segment_ids=seg)
    out, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
    ref, ref_lse = fa.flash_attention_plain(q.float(), k.float(), v.float(), return_lse=True,
                                            **kw)
    torch.testing.assert_close(out.float(), ref, **TOL)
    torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=1e-4)
    before = fb.launches_dq, fb.launches_dkv
    got = fb.flash_attention_bwd(q, k, v, out, lse, g, **kw)
    again = fb.flash_attention_bwd(q, k, v, out, lse, g, **kw)
    torch.cuda.synchronize()
    assert (fb.launches_dq, fb.launches_dkv) == tuple(x + 2 for x in before)
    want = [w.float() for w in fb.flash_attention_bwd_plain(q, k, v, out, lse, g, **kw)]
    for name, a, b_ in zip(("dq", "dk", "dv"), got, want):
        _sized_close(a, b_, name)
    # dk and dv are summed in registers in a fixed order; dq by atomics
    assert torch.equal(got[1], again[1]) and torch.equal(got[2], again[2])
    _sized_close(again[0], want[0], "dq, second run")


def test_flash_backward_prep_writes_delta_and_a_zeroed_workspace(rnd):
    """Kernel 17's prep: delta = rowsum(g * out) in fp32 (its plain version
    `bwd_delta`), out read through strides, and a zeroed fp32 workspace;
    its cast: bf16(workspace * 64 ** -0.5)."""
    from grasp_any_region_tpu_torch.ops import flash_backward as fb

    out = rnd(2, 77, 6, 3, 64)[:, :, :, 1]  # a strided view, as of a fused buffer
    g = rnd(2, 77, 6, 64)
    delta, acc = fb.bwd_prep(out, g)
    torch.cuda.synchronize()
    torch.testing.assert_close(delta, fb.bwd_delta(out, g), atol=1e-4, rtol=1e-5)
    assert acc.shape == (2, 77, 6, 64) and acc.dtype == torch.float32
    assert not acc.any()
    acc.normal_()
    torch.testing.assert_close(fb.bwd_dq_cast(acc).float(),
                               (acc * 0.125).to(torch.bfloat16).float(), atol=0, rtol=0)


def test_raw_attention_wrappers_refuse_a_gradient(rnd):
    q = rnd(1, 64, 2, 64).requires_grad_()
    with pytest.raises(RuntimeError, match="vit_attention_df"):
        va.vit_attention(q, q, q)
    with pytest.raises(RuntimeError, match="flash_attention_df"):
        fa.flash_attention(q, q, q)


def test_train_step_backward_runs_the_kernels_on_the_card(rnd):
    """One loss.backward() at a narrow gar_1b (2 + 2 layers): the card's
    gradients come through kernels A, 5, B, 17, 18 (A and B twice a block:
    the remat recompute; 17 and 18 once a decoder layer and once a ViT
    layer, as kernel 5) and are finite."""
    from grasp_any_region_tpu_torch.core.config import gar_1b
    from grasp_any_region_tpu_torch.core.weights import init_gar_params
    from grasp_any_region_tpu_torch.data.synthetic import synthetic_batch
    from grasp_any_region_tpu_torch.ops import flash_backward as fb
    from grasp_any_region_tpu_torch.train import loss_fn

    cfg = gar_1b()
    cfg = dataclasses.replace(
        cfg, vision=dataclasses.replace(cfg.vision, width=256, num_heads=4, depth=2),
        text=dataclasses.replace(cfg.text, hidden_size=256, num_heads=4, num_kv_heads=2,
                                 head_dim=64, num_layers=2, intermediate_size=1024))
    params = init_gar_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                             dtype=torch.bfloat16)
    for p in params.parameters():
        p.requires_grad_(True)
    batch, labels, _ = synthetic_batch(cfg, grid=(2, 1), seed=0)
    before = va.launches, va.launches_bwd, fa.launches, fb.launches_dq, fb.launches_dkv
    loss = loss_fn(params, cfg, batch, labels, mask_compat=False)
    loss.backward()
    torch.cuda.synchronize()
    after = va.launches, va.launches_bwd, fa.launches, fb.launches_dq, fb.launches_dkv
    assert tuple(a - b for a, b in zip(after, before)) == (4, 2, 4, 4, 4)
    assert torch.isfinite(loss)
    assert all(torch.isfinite(p.grad).all() for p in params.parameters() if p.grad is not None)
    assert params.vision.blocks.wqkv.grad.abs().max() > 0


# ---- the mega decode step: kernels 19-23


def _rope_rows(b):
    gen = torch.Generator(device="cuda").manual_seed(b)
    ang = torch.rand((b, 32), generator=gen, device="cuda") * 4000.0
    ang = torch.cat([ang, ang], -1)
    return torch.cos(ang), torch.sin(ang)


def _norm(rnd, n_layers, d):
    return (1.0 + 0.2 * rnd(n_layers, d).float()).to(torch.bfloat16)


def _qkv_case(rnd, q8, d, hq, hk, n_layers=3):
    """Kernel 19 or 20, its plain version, its stream mirror, its counter
    key and seeded (L = n_layers) weights (int8: with their scales)."""
    if q8:
        mats = (*_q8(rnd, n_layers, d, hq), *_q8(rnd, n_layers, d, hk), *_q8(rnd, n_layers, d, hk))
        return (mk.layer_qkv_norm_rope_q8, mk.layer_qkv_norm_rope_q8_plain,
                mk.layer_qkv_norm_rope_q8_stream_plain, "20", mats)
    w = _decode_weights(rnd, n_layers, d, 256, hq, hk)
    return (mk.layer_qkv_norm_rope, mk.layer_qkv_norm_rope_plain,
            mk.layer_qkv_norm_rope_stream_plain, "19", (w["wq"], w["wk"], w["wv"]))


def _qkv_tables(b, hq, hk):
    """The (B, 64) rope rows for q and k, and JAX's tiled (B, N) tables."""
    cos, sin = _rope_rows(b)
    return {"rows": (cos, sin, cos, sin),
            "tiled": (cos.repeat(1, hq // 64), sin.repeat(1, hq // 64), cos.repeat(1, hk // 64),
                      sin.repeat(1, hk // 64))}


@pytest.mark.parametrize("q8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("b", [1, 5, 24])
@pytest.mark.parametrize("d,hq,hk", [(256, 256, 64), (384, 256, 128), (2048, 2048, 512)])
def test_qkv_norm_rope_kernels(rnd, q8, b, d, hq, hk):
    """Kernels 19 and 20 against their plain versions, with (B, 64) rope
    rows and with JAX's tiled (B, N) tables."""
    layer = 1
    x, norm = rnd(b, d) * 3, _norm(rnd, 3, d)
    kernel, plain, _, key, mats = _qkv_case(rnd, q8, d, hq, hk)
    for tables in _qkv_tables(b, hq, hk).values():
        before = dict(mk.launches)
        out = kernel(x, norm, *mats, *tables, layer, eps=1e-5, head_dim=64)
        torch.cuda.synchronize()
        assert mk.launches == dict(before, **{key: before[key] + 1})
        ref = plain(x, norm, *mats, *tables, layer, eps=1e-5, head_dim=64)
        for o, r in zip(out, ref):
            assert o.dtype == torch.bfloat16 and o.shape == r.shape
            torch.testing.assert_close(o.float(), r.float(), **TOL)


@pytest.mark.parametrize("q8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("b", [1, 2, 17, 24, 32])
@pytest.mark.parametrize("d,hq,hk", [(200, 128, 64), (1032, 384, 128), (2048, 2048, 512)])
def test_qkv_norm_rope_kernels_match_the_stream_mirror(rnd, q8, b, d, hq, hk):
    """Kernels 19 and 20 on the weight stream against the mirror of their
    partition and order (`layer_qkv_norm_rope_stream_plain`, at the
    chooser's CTAs a tile) and the plain version, at every layer, with both
    table widths; D = 200 and 1032 are not multiples of 128 (a part stage),
    and 200 leaves most CTAs of a cluster no K rows."""
    x, norm = rnd(b, d) * 3, _norm(rnd, 3, d)
    kernel, plain, mirror, _, mats = _qkv_case(rnd, q8, d, hq, hk)
    splits = mk.qkv_card_splits(hq, hk, d, q8, x.device)
    for name, tables in _qkv_tables(b, hq, hk).items():
        for layer in range(3):
            out = kernel(x, norm, *mats, *tables, layer, eps=1e-5, head_dim=64)
            torch.cuda.synchronize()
            want = mirror(x, norm, *mats, *tables, layer, eps=1e-5, head_dim=64, splits=splits)
            ref = plain(x, norm, *mats, *tables, layer, eps=1e-5, head_dim=64)
            for o, m, r, part in zip(out, want, ref, "qkv"):
                msg = f"{part}, {name} tables, layer {layer}, {splits} CTAs a tile"
                torch.testing.assert_close(o.float(), m.float(), **TOL, msg=msg)
                torch.testing.assert_close(o.float(), r.float(), **TOL, msg=msg)


def _qkv_fits(q8, d, b, splits):
    """Whether 19 / 20's CTA holds xn over its K range (k_split columns of
    B rounded up to 8 rows, two bf16 halves for 20) beside two 16 KB stages,
    its received partials and 1200 bytes of barriers and slack, within the
    227 KB of an SM (csrc/layer_matmul_sm90.cu: launch_stream)."""
    k_split = -(-(-(-d // splits)) // 128) * 128
    rows = -(-b // 8) * 8
    xn = (2 if q8 else 1) * k_split * 2 * rows
    return xn + 2 * 16384 + b * (128 if q8 else 64) * 4 + 1200 <= 232448


@pytest.mark.parametrize("q8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("splits", [1, 2, 4, 8, 16])
def test_qkv_norm_rope_kernel_any_split(rnd, monkeypatch, q8, splits):
    """Kernels 19 and 20 at GAR-1B's widths over clusters of 1-16 CTAs a
    tile (the chooser replaced) against the stream mirror, at B = 1 and 24;
    a cluster whose rope finishers would hold fewer than 4 pairs of a head
    (19 at 16), or whose CTA cannot hold xn (20 at 1, B = 24), is
    refused."""
    d, hq, hk, layer = 2048, 2048, 512, 2
    monkeypatch.setattr(mk, "qkv_card_splits", lambda *_: splits)
    kernel, _, mirror, _, mats = _qkv_case(rnd, q8, d, hq, hk)
    norm = _norm(rnd, 3, d)
    for b in (1, 24):
        x = rnd(b, d) * 3
        tables = _qkv_tables(b, hq, hk)["rows"]
        if splits > mk.box_cols(1 if q8 else 2) // 8 or not _qkv_fits(q8, d, b, splits):
            with pytest.raises(RuntimeError, match="gar_qkv_norm_rope"):
                kernel(x, norm, *mats, *tables, layer, eps=1e-5, head_dim=64)
            continue
        out = kernel(x, norm, *mats, *tables, layer, eps=1e-5, head_dim=64)
        torch.cuda.synchronize()
        want = mirror(x, norm, *mats, *tables, layer, eps=1e-5, head_dim=64, splits=splits)
        for o, m in zip(out, want):
            torch.testing.assert_close(o.float(), m.float(), **TOL, msg=f"B = {b}")


@pytest.mark.parametrize("d,hq,hk", [(2048, 2048, 512), (1032, 384, 128)])
def test_qkv_norm_rope_q8_keeps_xn_low_half(rnd, d, hq, hk):
    """Kernel 20 on `chip_smoke.xn_low_half_probe`: inputs whose two halves
    of K cancel but for xn's low bits, so each output is rstd d 2^-15 with
    JAX's fp32 xn and 0 or 8 with xn rounded to bf16."""
    import chip_smoke

    assert chip_smoke.xn_low_half_probe(d, hq, hk) < TOL["atol"] + TOL["rtol"] * d * 2 ** -15


@pytest.mark.parametrize("q8", [False, True], ids=["bf16", "int8"])
def test_qkv_norm_rope_kernel_same_bits(rnd, q8):
    """Kernels 19 and 20 at GAR-1B's widths give the same bits on a second
    launch and on two replays of a CUDA graph of one launch, at B = 1 and
    24."""
    d, hq, hk = 2048, 2048, 512
    kernel, _, _, _, mats = _qkv_case(rnd, q8, d, hq, hk)
    norm = _norm(rnd, 3, d)
    for b in (1, 24):
        x = rnd(b, d) * 3
        tables = _qkv_tables(b, hq, hk)["rows"]

        def run():
            return torch.cat(kernel(x, norm, *mats, *tables, 1, eps=1e-5, head_dim=64), -1)

        _same_bits_twice_and_replayed(run, run())


def _counters_at_zero(device):
    return not mk._counters(device).any()


def _mlp_case(rnd, q8, d, m):
    """Kernel 21 or 23, its plain version, the split mirror's scales and the
    (L = 3) weights."""
    if q8:
        mats = (*_q8(rnd, 3, d, m), *_q8(rnd, 3, d, m), *_q8(rnd, 3, m, d))
        return (mk.layer_mlp_residual_q8, mk.layer_mlp_residual_q8_plain, "21", mats,
                (mats[0], mats[2], mats[4]), (mats[1], mats[3], mats[5]))
    w = _decode_weights(rnd, 3, d, m, 64, 64)
    mats = (w["w_gate"], w["w_up"], w["w_down"])
    return mk.layer_mlp_residual, mk.layer_mlp_residual_plain, "23", mats, mats, None


def _same_bits_twice_and_replayed(run, out):
    """A second launch and two replays of a CUDA graph of one launch give
    `out`'s bits, and the arrival counters stay at 0."""
    again = run()
    torch.cuda.synchronize()
    assert torch.equal(again, out) and _counters_at_zero(out.device)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(stream):
        run()  # warm on the capture stream
        stream.synchronize()
        with torch.cuda.graph(graph, stream=stream):
            captured = run()
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(captured, out) and _counters_at_zero(out.device)


@pytest.mark.parametrize("q8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("b", [1, 2, 17, 24, 32])
@pytest.mark.parametrize("d,m", [(256, 1024), (384, 640), (2048, 8192)])
def test_mlp_residual_kernels(rnd, q8, b, d, m):
    """Kernels 23 and 21 against their plain versions (at GAR-1B's (2048,
    8192) too); a second launch and a CUDA-graph replay give the same bits,
    and the arrival counters are 0 after each launch."""
    layer = 1
    x, norm = rnd(b, d) * 3, _norm(rnd, 3, d)
    kernel, plain, key, mats, _, _ = _mlp_case(rnd, q8, d, m)
    before = dict(mk.launches)
    out = kernel(x, norm, *mats, layer, eps=1e-5)
    torch.cuda.synchronize()
    assert mk.launches == dict(before, **{key: before[key] + 1})
    assert _counters_at_zero(x.device)
    ref = plain(x, norm, *mats, layer, eps=1e-5)
    assert out.dtype == torch.bfloat16 and out.shape == ref.shape
    torch.testing.assert_close(out.float(), ref.float(), **TOL)
    _same_bits_twice_and_replayed(lambda: kernel(x, norm, *mats, layer, eps=1e-5), out)


@pytest.mark.parametrize("q8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("b", [1, 24])
@pytest.mark.parametrize("splits", [1, 2, 4, 8, 16])
def test_mlp_residual_kernel_any_split(rnd, monkeypatch, q8, b, splits):
    """Kernels 23 and 21 at GAR-1B's (2048, 8192) over clusters of 1-16 CTAs
    a tile (the chooser replaced): against the plain version, and against
    the split mirror, which sums in the kernel's partition and order."""
    d, m, layer = 2048, 8192, 2
    monkeypatch.setattr(mk, "mlp_card_splits", lambda *_: splits)
    x, norm = rnd(b, d) * 3, _norm(rnd, 3, d)
    kernel, plain, _, mats, weights, scales = _mlp_case(rnd, q8, d, m)
    out = kernel(x, norm, *mats, layer, eps=1e-5)
    torch.cuda.synchronize()
    assert _counters_at_zero(x.device)
    torch.testing.assert_close(out.float(), plain(x, norm, *mats, layer, eps=1e-5).float(), **TOL)
    mirror = mk.layer_mlp_residual_split_plain(x, norm, *weights, layer, eps=1e-5, splits=splits,
                                               scales=scales)
    torch.testing.assert_close(out.float(), mirror.float(), **TOL)
    assert torch.equal(kernel(x, norm, *mats, layer, eps=1e-5), out)


def _attention_wo_case(rnd, q8, b, kh, group, s, dm, n_layers=3):
    k_all, v_all = rnd(n_layers, b, kh, s, 64), rnd(n_layers, b, kh, s, 64)
    q, k_new, v_new = rnd(b, kh * group, 64), rnd(b, kh, 64), rnd(b, kh, 64)
    x = rnd(b, dm)
    if q8:
        wo, wo_scale = _q8(rnd, n_layers, kh * group * 64, dm)
    else:
        wo, wo_scale = _decode_weights(rnd, n_layers, dm, 64, kh * group * 64, 64)["wo"], None
    return q, k_all, v_all, k_new, v_new, wo, x, wo_scale


def _check_attention_wo(case, layer, plens, pad, wpos, splits=None):
    """Kernel 22 against its plain version (and, with `splits`, the split
    mirror): the new residual, and the cache, which changes only at column
    write_pos, to the new K/V; then a second launch and a CUDA-graph replay
    give the same bits."""
    q, k_all, v_all, k_new, v_new, wo, x, wo_scale = case
    kw = dict(prompt_lens=torch.tensor(plens, dtype=torch.int32, device="cuda"),
              write_pos=torch.tensor(wpos, dtype=torch.int32, device="cuda"), prompt_pad=pad,
              wo_scale=wo_scale)
    k_exp, v_exp = k_all.clone(), v_all.clone()
    ref = mk.decode_attention_wo_plain(q, k_exp, v_exp, k_new, v_new, wo, x, layer, **kw)
    before = mk.launches["22"]
    out = mk.decode_attention_wo(q, k_all, v_all, k_new, v_new, wo, x, layer, **kw)
    torch.cuda.synchronize()
    assert mk.launches["22"] == before + 1
    assert _counters_at_zero(x.device)
    torch.testing.assert_close(out.float(), ref.float(), **TOL)
    assert torch.equal(k_all, k_exp) and torch.equal(v_all, v_exp)
    assert torch.equal(k_all[layer, :, :, wpos], k_new)
    if splits is not None:
        mirror = mk.decode_attention_wo_split_plain(q, k_exp.clone(), v_exp.clone(), k_new, v_new,
                                                    wo, x, layer, splits=splits, **kw)
        torch.testing.assert_close(out.float(), mirror.float(), **TOL)
    _same_bits_twice_and_replayed(
        lambda: mk.decode_attention_wo(q, k_all, v_all, k_new, v_new, wo, x, layer, **kw), out)
    assert torch.equal(k_all, k_exp) and torch.equal(v_all, v_exp)


# (B, prompt_lens, prompt_pad, write_pos) over S = 1024: prompt only; ragged
# rows; the history at the cache's end; 5 columns over 8 CTAs (empty chunks);
# 16 columns over 8 (chunk edges at prompt_len | prompt_pad); B = 17, 24, 32
# with prompts of 0 to prompt_pad columns
WO_LAYOUTS = [(1, (128,), 128, 128), (2, (100, 37), 128, 170), (3, (500, 700, 9), 700, 1023),
              (1, (3,), 64, 66), (2, (8, 16), 64, 72),
              (17, tuple(range(0, 340, 20)), 320, 400),
              (24, tuple((37 * i) % 301 for i in range(24)), 300, 555),
              (32, tuple((53 * i) % 257 for i in range(32)), 256, 1000)]


@pytest.mark.parametrize("q8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("group", [1, 2, 4, 8])
@pytest.mark.parametrize("b,plens,pad,wpos", WO_LAYOUTS)
def test_decode_attention_wo_kernel(rnd, q8, group, b, plens, pad, wpos):
    """Kernel 22 against its plain version at the card's splits (wo loaded
    whole at B = 1-2 here, streamed after the attention at B >= 17): the new
    residual, the cache changed only at write_pos, the same bits on a second
    launch and a graph replay, the counters at 0."""
    case = _attention_wo_case(rnd, q8, b, 4, group, 1024, 512)
    _check_attention_wo(case, 1, plens, pad, wpos)


@pytest.mark.parametrize("q8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("splits", [1, 2, 3, 5, 8, 16])
def test_decode_attention_wo_kernel_any_split(rnd, monkeypatch, q8, splits):
    """Kernel 22 over clusters of 1-16 CTAs (the chooser replaced), G = 4, a
    residual width of 5 chunks (some CTAs own no wo columns), against the
    plain version and the split mirror."""
    monkeypatch.setattr(mk, "attention_wo_splits", lambda *_: splits)
    dm = 640 if q8 else 320
    case = _attention_wo_case(rnd, q8, 3, 2, 4, 512, dm)
    _check_attention_wo(case, 2, (128, 3, 64), 128, 300, splits=splits)


@pytest.mark.parametrize("q8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("b", [1, 24])
def test_decode_attention_wo_kernel_gar_1b(rnd, q8, b):
    """Kernel 22 at GAR-1B's shapes: 32 query heads over 8 kv heads, a
    residual of 2048, a (2, B, 8, 5120, 64) cache with the 4662-token
    prompt, write_pos just past prompt_pad."""
    case = _attention_wo_case(rnd, q8, b, 8, 4, 5120, 2048, n_layers=2)
    plens = (4662,) + tuple(3000 + (97 * i) % 1663 for i in range(1, b))
    _check_attention_wo(case, 1, plens, 4662, 4663)


@pytest.mark.parametrize("q8", [False, True], ids=["bf16", "int8"])
def test_mega_decode_step_on_the_card(rnd, q8, monkeypatch):
    """GAR_DECODE_PATH=mega: one gar_decode_step on the card runs 19, 22, 23
    (or 20, 22, 21) once a layer and no kernel of the fused step, and
    agrees with the same step's plain path on the CPU."""
    import copy

    from grasp_any_region_tpu_torch.core.config import gar_tiny
    from grasp_any_region_tpu_torch.core.weights import init_gar_params
    from grasp_any_region_tpu_torch.models.gar import gar_decode_step, seed_cache_from_prefill
    from grasp_any_region_tpu_torch.models.quantize import quantize_decode_weights

    base = gar_tiny()
    cfg = dataclasses.replace(base, text=dataclasses.replace(
        base.text, hidden_size=256, num_heads=4, num_kv_heads=2, head_dim=64, num_layers=2,
        intermediate_size=1024))
    tc = cfg.text
    cpu = init_gar_params(cfg, torch.Generator().manual_seed(0), device="cpu",
                          dtype=torch.bfloat16)
    if q8:
        cpu = quantize_decode_weights(cpu)
    card = copy.deepcopy(cpu).to("cuda")
    b, s = 2, 100
    kv = tuple(rnd(tc.num_layers, b, s, tc.num_kv_heads, tc.head_dim) for _ in range(2))
    plens = torch.tensor([s, 61], dtype=torch.int32)
    tok = torch.tensor([5, 7], dtype=torch.int32)
    monkeypatch.setenv("GAR_DECODE_PATH", "mega")
    lm.launches.update(dict.fromkeys(lm.launches, 0))
    mk.launches.update(dict.fromkeys(mk.launches, 0))
    dec.launches = dec.launches_q8 = 0
    logits, cache = gar_decode_step(card, cfg, tok.cuda(),
                                    seed_cache_from_prefill(cfg, kv, plens.cuda(), 512), s)
    torch.cuda.synchronize()
    n = tc.num_layers
    want = dict(zip(("19", "20", "21", "22", "23"), (0, n, n, n, 0) if q8 else (n, 0, 0, n, n)))
    assert mk.launches == want
    assert not any(lm.launches.values()) and dec.launches == dec.launches_q8 == 0
    assert int(cache.write_pos) == s + 1
    ref, _ = gar_decode_step(cpu, cfg, tok, seed_cache_from_prefill(
        cfg, tuple(t.cpu() for t in kv), plens, 512), s, use_kernel="mega")
    assert torch.isfinite(logits).all()
    assert ((logits.cpu() - ref).abs().max() / ref.abs().max()).item() < 5e-2


def _bf16_ulp(t):
    """One bf16 ulp at each |t| (8 significant bits)."""
    _, e = torch.frexp(t.abs())
    return torch.ldexp(torch.ones_like(t), e - 8)


def test_ce_head_backward_rounds_once_on_the_card(rnd):
    """The CE head's backward on the card contracts the fp32 logit gradient
    with the bf16 operands in fp32 and rounds each result once, as JAX's
    VJP and the CPU branch's fp32 formula do. Bound: at most 2% of the
    elements differ from that formula rounded to bf16 (the two-half split
    keeps 16 significant bits of the gradient, and the sums run in another
    order, which moves a rounding near its boundary), every element within
    one bf16 ulp of it plus 2^-14 of the sum of the products' magnitudes.
    Rounding the gradient to bf16 before the products, the form before,
    misses the rounded formula on ten times as many elements."""
    from grasp_any_region_tpu_torch.train.losses import _HeadLogits

    gen = torch.Generator(device="cuda").manual_seed(0)
    n, v, d = 512, 4096, 256
    for tied in (True, False):
        x = rnd(n, d).requires_grad_()
        head = (rnd(v, d) if tied else rnd(d, v)).requires_grad_()
        g = torch.randn((n, v), generator=gen, device="cuda") * 1e-3
        _HeadLogits.apply(x, head, tied).backward(g)
        xf, hf = x.detach().float(), head.detach().float()
        w = hf if tied else hf.t()

        def products(a, b):  # (a @ b, |a| @ |b|) in fp32, dx's then dhead's operand order
            return a @ b, a.abs() @ b.abs()

        refs = (products(g, w), products(g.t(), xf) if tied else products(xf.t(), g))
        gb, wb, xb = g.bfloat16(), w.bfloat16(), x.detach()
        before = (gb @ wb, gb.t() @ xb if tied else xb.t() @ gb)
        for got, (ref, mag), old in zip((x.grad, head.grad), refs, before):
            once = ref.bfloat16()
            miss = (got != once).float().mean().item()
            old_miss = (old != once).float().mean().item()
            assert miss <= 0.02 and old_miss > 10 * miss, (tied, miss, old_miss)
            gap = (got.float() - ref).abs() - _bf16_ulp(ref) - mag * 2.0 ** -14
            assert gap.max().item() <= 0, (tied, gap.max().item())


def _cuda_int32(x):
    return torch.tensor(x, dtype=torch.int32, device="cuda")


# Kernel 16's outputs are averages over hundreds of columns, ~0.05 in size: atol
# is a tenth of that, rtol one rounding of a bf16 output.
TOL16 = dict(atol=2e-3, rtol=2.0 ** -8)


def _interval_probe(v, plens, pad, wpos):
    """A one-layer (B, K, S, D) cache on which kernel 16's answer is the
    mean of v over each row's valid columns: k = 0 weighs every column the
    same, and v holds a distinct spike on each side of each interval edge,
    the i-th of a row 0.02 i times its count of valid columns, so one column
    too many, too few or counted twice moves that row by 0.02 or more."""
    v = v.clone()
    for row, plen in enumerate(plens):
        n = plen + max(0, wpos + 1 - max(pad, plen))
        edges = sorted({plen - 1, plen, pad - 1, pad, wpos, wpos + 1} & set(range(v.shape[2])))
        for i, col in enumerate(edges):
            v[row, :, col] = 0.02 * (i + 1) * n
    return torch.zeros_like(v), v


@pytest.mark.parametrize("group", [1, 2, 4, 8])
@pytest.mark.parametrize("b,plens,pad,wpos,block_s", [
    (2, (100, 37), 128, 170, 512),
    (1, (128,), 128, 128, 512),
    (2, (500, 700), 700, 1023, 256),    # write_pos at S - 1
    (2, (300, 900), 256, 280, 128),     # prompts past prompt_pad and past write_pos
    (24, None, 700, 800, 512),          # ragged prompt lengths on both sides of prompt_pad
])
def test_decode_attention_stacked_kernel(rnd, group, b, plens, pad, wpos, block_s):
    """Kernel 16 at every layer, picked by a device scalar, against the plain
    version; the cache stays as it was; the unstacked form is layer 0 of
    the one-layer stack; the interval probe counts each valid column once."""
    n_layers, kh, s = 3, 2, 1024
    if plens is None:  # at and around write_pos, prompt_pad and block edges, then seeded
        plens = [801, 800, 750, 701, 700, 699, 513, 512, 511, 1] + torch.randint(
            1, 1000, (b - 10,), generator=torch.Generator().manual_seed(b)).tolist()
    k_all, v_all = rnd(n_layers, b, kh, s, 64), rnd(n_layers, b, kh, s, 64)
    q = rnd(b, kh * group, 64)
    k_ref, v_ref = k_all.clone(), v_all.clone()
    kw = dict(prompt_lens=_cuda_int32(plens), write_pos=_cuda_int32(wpos), prompt_pad=pad,
              block_s=block_s)
    for layer in range(n_layers):
        lay = _cuda_int32(layer)
        before = dec.launches_stacked
        out = dec.decode_attention_stacked(q, k_all, v_all, lay, **kw)
        torch.cuda.synchronize()
        assert dec.launches_stacked == before + 1
        ref = dec.decode_attention_plain(q.float(), k_all.float(), v_all.float(), lay, **kw)
        torch.testing.assert_close(out.float(), ref, **TOL16)
        one = dec.decode_attention(q, k_all[layer], v_all[layer], **kw)
        torch.testing.assert_close(one, out, atol=0, rtol=0)
    assert torch.equal(k_all, k_ref) and torch.equal(v_all, v_ref)
    k0, vp = _interval_probe(v_all[0], plens, pad, wpos)
    out = dec.decode_attention(q, k0, vp, **kw)
    ref = dec.decode_attention_plain(q.float(), k0[None].float(), vp[None].float(),
                                     _cuda_int32(0), **kw)
    torch.testing.assert_close(out.float(), ref, **TOL16)
    # scale multiplies the logits
    out = dec.decode_attention_stacked(q, k_all, v_all, _cuda_int32(1), scale=0.3, **kw)
    ref = dec.decode_attention_plain(q.float(), k_all.float(), v_all.float(), _cuda_int32(1),
                                     scale=0.3, **kw)
    torch.testing.assert_close(out.float(), ref, **TOL16)
    # a layer outside the stack gives NaN rows, not a read outside the cache
    out = dec.decode_attention_stacked(q, k_all, v_all, _cuda_int32(n_layers), **kw)
    assert torch.isnan(out.float()).all()


@pytest.mark.parametrize("group", [1, 4, 8])
@pytest.mark.parametrize("splits", list(range(1, 17)))
def test_decode_attention_stacked_kernel_any_split(rnd, monkeypatch, splits, group):
    """Kernel 16 with the CTAs a (kv head, row) forced (the chooser
    replaced), clusters of 1 to 16, over three rows: a prompt past write_pos
    and past the last block_s block the TPU kernel visits (cut there), 8
    columns (fewer than the CTAs: empty chunks), and 207; at TOL16 against
    the plain version and the mirror of its chunks, then the interval probe;
    the cache unchanged; a layer outside the stack gives NaN rows."""
    monkeypatch.setattr(dec, "card_splits", lambda *_: splits)
    n_layers, kh, s, layer = 2, 2, 1024, 1
    plens, pad, wpos, block_s = [900, 1, 200], 256, 262, 128
    k_all, v_all = rnd(n_layers, 3, kh, s, 64), rnd(n_layers, 3, kh, s, 64)
    q = rnd(3, kh * group, 64)
    k_ref, v_ref = k_all.clone(), v_all.clone()
    kw = dict(prompt_lens=_cuda_int32(plens), write_pos=_cuda_int32(wpos), prompt_pad=pad,
              block_s=block_s)
    lay = _cuda_int32(layer)
    out = dec.decode_attention_stacked(q, k_all, v_all, lay, **kw)
    torch.cuda.synchronize()
    ref = dec.decode_attention_plain(q.float(), k_all.float(), v_all.float(), lay, **kw)
    torch.testing.assert_close(out.float(), ref, **TOL16)
    mirror = dec.decode_attention_split_plain(q.float(), k_all.float(), v_all.float(), lay,
                                              splits=splits, **kw)
    torch.testing.assert_close(out.float(), mirror, **TOL16)
    assert torch.equal(k_all, k_ref) and torch.equal(v_all, v_ref)
    k0, vp = _interval_probe(v_all[layer], plens, pad, wpos)
    out = dec.decode_attention(q, k0, vp, **kw)
    ref = dec.decode_attention_plain(q.float(), k0[None].float(), vp[None].float(),
                                     _cuda_int32(0), **kw)
    torch.testing.assert_close(out.float(), ref, **TOL16)
    out = dec.decode_attention_stacked(q, k_all, v_all, _cuda_int32(-1), **kw)
    assert torch.isnan(out.float()).all()


def test_decode_attention_stacked_rejects_what_the_kernel_does_not_take(rnd):
    kw = dict(prompt_lens=_cuda_int32([3]), write_pos=_cuda_int32(10), prompt_pad=8)
    lay = _cuda_int32(0)
    k_all = rnd(2, 1, 2, 128, 64)
    before = dec.launches_stacked
    with pytest.raises(ValueError):  # 16 keeps head_dim 64 (C took 128 for GAR-8B)
        dec.decode_attention_stacked(rnd(1, 4, 128), rnd(2, 1, 2, 128, 128),
                                     rnd(2, 1, 2, 128, 128), lay, **kw)
    k8 = torch.zeros((2, 1, 2, 128, 64), dtype=torch.int8, device="cuda")
    with pytest.raises(TypeError):  # _decode_kernel has no int8 cache scales
        dec.decode_attention_stacked(rnd(1, 4, 64), k8, k8.clone(), lay, **kw)
    with pytest.raises(ValueError):  # the layer lives on the card, as int32
        dec.decode_attention_stacked(rnd(1, 4, 64), k_all, k_all.clone(), 0, **kw)
    with pytest.raises(ValueError):
        dec.decode_attention_stacked(rnd(1, 4, 64), k_all, k_all.clone(), torch.tensor(0), **kw)
    with pytest.raises(ValueError):  # 3 query heads per kv head
        dec.decode_attention_stacked(rnd(1, 6, 64), k_all, k_all.clone(), lay, **kw)
    with pytest.raises(ValueError):  # block_s must divide the cache
        dec.decode_attention_stacked(rnd(1, 4, 64), k_all, k_all.clone(), lay, block_s=96, **kw)
    assert dec.launches_stacked == before  # nothing above launched


@pytest.mark.parametrize("shape,x_dtype,p_dtype", [
    ((17, 1025, 1024), torch.bfloat16, torch.bfloat16),  # the tower's LayerNorm
    ((17, 1025, 1024), torch.float32, torch.float32),
    ((3, 37, 1024), torch.bfloat16, torch.float32),
    ((2, 11, 256), torch.float32, torch.bfloat16),
    ((5, 8), torch.bfloat16, torch.bfloat16),            # D = 8, 5 rows
    ((13, 8), torch.float32, torch.float32),
    ((7, 8192), torch.bfloat16, torch.bfloat16),         # the widest row
    ((3, 8192), torch.float32, torch.float32),
    ((9, 520), torch.bfloat16, torch.bfloat16),          # D not a multiple of a warp's vectors
])
def test_layer_norm_kernel(rnd, shape, x_dtype, p_dtype):
    d = shape[-1]
    x = (rnd(*shape).float() * 3 + 1).to(x_dtype)
    w = (1 + 0.3 * rnd(d).float()).to(p_dtype)
    b = (0.2 * rnd(d).float()).to(p_dtype)
    before = norms.launches
    out = norms.layer_norm_fused(x, w, b)
    torch.cuda.synchronize()
    assert norms.launches == before + 1 and out.dtype == x_dtype and out.shape == x.shape
    ref = norms.layer_norm_fused_plain(x.float(), w.float(), b.float())
    if x_dtype == torch.float32:
        torch.testing.assert_close(out, ref, atol=1e-4, rtol=1e-4)
    else:
        torch.testing.assert_close(out.float(), ref, **TOL)


def test_layer_norm_rejects_what_the_kernel_does_not_take(rnd):
    w = rnd(1024)
    with pytest.raises(ValueError):  # D % 8 != 0
        norms.layer_norm_fused(rnd(4, 100), rnd(100), rnd(100))
    with pytest.raises(ValueError):  # D > 8192
        norms.layer_norm_fused(rnd(2, 8200), rnd(8200), rnd(8200))
    with pytest.raises(TypeError):
        norms.layer_norm_fused(rnd(4, 1024).half(), w, w)
    with pytest.raises(ValueError):  # weight of the wrong width
        norms.layer_norm_fused(rnd(4, 1024), rnd(512), w)
    with pytest.raises(ValueError):
        norms.layer_norm_fused(rnd(1024, 4).t(), w, w)
    with pytest.raises(RuntimeError):  # no backward: layer_norm_fused_df has one
        norms.layer_norm_fused(rnd(4, 1024).requires_grad_(), w, w)


def test_layer_norm_fused_df_on_the_card(rnd):
    """Kernel 24 forward and autograd through the plain LayerNorm backward,
    against autograd through the plain version, on the tower's shape."""
    x, w, b = rnd(17, 1025, 1024), 1 + 0.3 * rnd(1024), 0.2 * rnd(1024)
    g = rnd(17, 1025, 1024)
    leaves = [t.clone().requires_grad_() for t in (x, w, b)]
    refs = [t.clone().requires_grad_() for t in (x, w, b)]
    before = norms.launches
    out = norms.layer_norm_fused_df(*leaves)
    out.backward(g)
    assert norms.launches == before + 1
    ref = norms.layer_norm(*refs)
    ref.backward(g)
    torch.testing.assert_close(out.float(), ref.float(), **TOL)
    for got, want in zip(leaves, refs):
        scale = want.grad.float().abs().max()
        assert (got.grad.float() - want.grad.float()).abs().max() <= 2e-2 * scale


# ---------------------------------------------------------------- GAR-8B: head dims 96 and 128


@pytest.mark.parametrize("t,s,h", [(2, 1025, 4), (1, 1024, 3), (9, 1025, 16), (1, 129, 2),
                                   (2, 200, 2)])
def test_vit_attention_kernel_head_dim_96(rnd, t, s, h):
    """Kernel A at GAR-8B's head dim 96 (B's two-atom instance, columns
    96-127 zero-filled by TMA) on q/k/v views of a (T, S, 3, H, 96) qkv
    buffer, as the unfused PE-G block passes them (192-byte head stride),
    at S = 1025 (a one-key last key tile, a one-row last query tile) and
    1024; output at the sized tolerance, LSE at atol 1e-3."""
    qkv = rnd(t, s, 3, h, 96)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    before = va.launches
    out, lse = va.vit_attention(q, k, v, return_lse=True)
    out2 = va.vit_attention(q, k, v)
    torch.cuda.synchronize()
    assert va.launches == before + 2 and out.shape == (t, s, h, 96)
    ref, ref_lse = va.vit_attention_plain(q.float(), k.float(), v.float(), return_lse=True)
    torch.testing.assert_close(out.float(), ref, **TOL)
    _sized_close(out, ref, "out")
    assert torch.equal(out, out2)
    torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=1e-4)


@pytest.mark.parametrize("b,sq,sk,h,kh,causal", [
    (1, 2614, 2614, 32, 8, True),   # GAR-8B's prefill
    (2, 130, 300, 4, 1, True),      # Sq < Sk, right-aligned
    (2, 200, 333, 8, 2, False),
    (1, 1, 70, 4, 4, True),
    (1, 1025, 1025, 16, 16, False),  # a one-key last key tile
    (1, 300, 300, 8, 8, True),
])
def test_flash_attention_kernel_head_dim_128(rnd, b, sq, sk, h, kh, causal):
    """Kernel B at GAR-8B's head dim 128 (two 64-key units a 128-key stage,
    two stages), causal and full, GQA, Sq < Sk, its output and LSE against
    the plain version."""
    q, k, v = rnd(b, sq, h, 128), rnd(b, sk, kh, 128), rnd(b, sk, kh, 128)
    before = fa.launches
    out, lse = fa.flash_attention(q, k, v, causal=causal, return_lse=True)
    out2 = fa.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa.launches == before + 2
    ref, ref_lse = fa.flash_attention_plain(q.float(), k.float(), v.float(), causal=causal,
                                            return_lse=True)
    torch.testing.assert_close(out.float(), ref, **TOL)
    _sized_close(out, ref, "out")
    assert torch.equal(out, out2)
    torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=1e-4)


def test_flash_attention_kernel_head_dim_128_segments_and_views(rnd):
    """Kernel B at head dim 128 with segment ids (packed rows, padding at
    the end) and with q, k, v as views of one (B, S, H + 2K, 128) buffer."""
    b, s, h, kh = 2, 777, 8, 2
    buf = rnd(b, s, h + 2 * kh, 128)
    q, k, v = buf[:, :, :h], buf[:, :, h:h + kh], buf[:, :, h + kh:]
    seg = torch.zeros((b, s), dtype=torch.int32, device="cuda")
    seg[:, :300], seg[:, 300:700] = 1, 2
    for ids in (None, seg):
        out, lse = fa.flash_attention(q, k, v, causal=True, segment_ids=ids, return_lse=True)
        torch.cuda.synchronize()
        ref, ref_lse = fa.flash_attention_plain(q.float(), k.float(), v.float(), causal=True,
                                                segment_ids=ids, return_lse=True)
        _sized_close(out, ref, f"out, segments {ids is not None}")
        torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=1e-4)


@pytest.mark.parametrize("group", [1, 4, 8])
@pytest.mark.parametrize("b", [1, 2, 24])
def test_decode_attention_kernel_head_dim_128(rnd, group, b):
    """Kernel C at GAR-8B's head dim 128 (256-byte cache rows) over layer 3
    of a (4, B, 8, 3072, 128) cache, prompt_pad 2614, write_pos 2650 (B = 24:
    prompt lengths from 1 to prompt_pad), against the plain version at
    TOL16, then the interval probe at TOL16; column write_pos holds the new
    K/V bit for bit and the rest of the cache is unchanged."""
    L, kh, s, layer, pad, wpos = 4, 8, 3072, 3, 2614, 2650
    plens = [pad] if b == 1 else [pad, 2000] if b == 2 else \
        [pad, pad - 1, 1, 2, 64, 65, 128, 129] + list(range(100, 2600, 160))
    k_all, v_all = rnd(L, b, kh, s, 128), rnd(L, b, kh, s, 128)
    q, k_new, v_new = rnd(b, kh * group, 128), rnd(b, kh, 128), rnd(b, kh, 128)
    kw = dict(prompt_lens=_cuda_int32(plens), write_pos=_cuda_int32(wpos), prompt_pad=pad)
    for probe in (False, True):
        if probe:  # one column too many, too few or twice moves a row by >= 0.02
            k0, vp = _interval_probe(v_all[layer], plens, pad, wpos)
            k_all[layer], v_all[layer], k_new = k0, vp, torch.zeros_like(k_new)
        k_exp, v_exp = k_all.clone(), v_all.clone()
        ref = dec.decode_attention_fused_plain(q.float(), k_exp.float(), v_exp.float(),
                                               k_new.float(), v_new.float(), layer, **kw)
        before = dec.launches
        out = dec.decode_attention_fused(q, k_all, v_all, k_new, v_new, layer, **kw)
        torch.cuda.synchronize()
        assert dec.launches == before + 1 and out.shape == (b, kh * group, 128)
        torch.testing.assert_close(out.float(), ref, **TOL16, msg=f"probe {probe}")
        k_exp[layer, :, :, wpos], v_exp[layer, :, :, wpos] = k_new, v_new
        assert torch.equal(k_all, k_exp) and torch.equal(v_all, v_exp)


@pytest.mark.parametrize("splits", [1, 3, 8, 16])
def test_decode_attention_kernel_head_dim_128_any_split(rnd, monkeypatch, splits):
    """Kernel C at head dim 128 with the CTAs a (kv head, row) forced,
    clusters of 1 to 16, over three ragged rows (one with fewer columns
    than CTAs), at TOL16."""
    monkeypatch.setattr(dec, "card_splits", lambda *_: splits)
    L, b, kh, s, layer = 2, 3, 2, 1024, 1
    plens, pad, wpos = [300, 3, 1], 512, 515
    k_all, v_all = rnd(L, b, kh, s, 128), rnd(L, b, kh, s, 128)
    q, k_new, v_new = rnd(b, kh * 4, 128), rnd(b, kh, 128), rnd(b, kh, 128)
    kw = dict(prompt_lens=_cuda_int32(plens), write_pos=_cuda_int32(wpos), prompt_pad=pad)
    ref = dec.decode_attention_fused_plain(q.float(), k_all.float(), v_all.float(),
                                           k_new.float(), v_new.float(), layer, **kw)
    out = dec.decode_attention_fused(q, k_all, v_all, k_new, v_new, layer, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref, **TOL16)


def test_wrappers_refuse_gar8b_head_dims_without_an_instance(rnd):
    """On the card, what has no instance at GAR-8B's head dims raises with
    the missing kernel's name and launches nothing: an int8 cache at 128
    (C8), kernel 16 at 128, A at 80, B at 96 (A's instance is full
    attention only), the backward of A at 80 (5) and of causal attention
    at 96 (17 and 18 take 96 for kernel 5's full attention only): the
    autograd functions raise before their forward. 5 at 96 and 17, 18 at
    128 have their instances (the tests below)."""
    kw = dict(prompt_lens=_cuda_int32([3]), write_pos=_cuda_int32(10), prompt_pad=8)
    k8 = torch.zeros((2, 1, 2, 128, 128), dtype=torch.int8, device="cuda")
    scale = torch.ones((2, 1, 1, 1, 1), device="cuda")
    before = (va.launches, fa.launches, dec.launches, dec.launches_q8, dec.launches_stacked)
    with pytest.raises(ValueError, match="kernel C8"):
        dec.decode_attention_fused(rnd(1, 8, 128), k8, k8.clone(), rnd(1, 2, 128),
                                   rnd(1, 2, 128), 0, k_scale=scale, v_scale=scale, **kw)
    with pytest.raises(ValueError, match="kernel 16"):
        dec.decode_attention_stacked(rnd(1, 8, 128), rnd(2, 1, 2, 128, 128),
                                     rnd(2, 1, 2, 128, 128), _cuda_int32(0), **kw)
    with pytest.raises(ValueError, match="kernel A"):
        va.vit_attention(*(rnd(1, 64, 2, 80),) * 3)
    with pytest.raises(ValueError, match="kernel B"):
        fa.flash_attention(*(rnd(1, 64, 2, 96),) * 3)
    with pytest.raises(ValueError, match="kernel 5"):
        va.vit_attention_df(*(rnd(1, 64, 2, 80).requires_grad_() for _ in range(3)))
    with pytest.raises(ValueError, match="kernels 17 and 18"):
        fa.flash_attention_df(*(rnd(1, 64, 2, 96).requires_grad_() for _ in range(3)),
                              causal=True)
    assert (va.launches, fa.launches, dec.launches, dec.launches_q8,
            dec.launches_stacked) == before


@pytest.mark.parametrize("b", [1, 24])
def test_layer_matmul_kernels_at_gar8b_widths(rnd, b):
    """H (wo 4096 -> 4096, w_down 14336 -> 4096), I (4096 -> 14336) and J
    (q 4096, k and v 1024) and their int8 forms on the weight stream at
    GAR-8B's widths (2 layers, layer 1), against their plain versions."""
    d, m, hq, hk, layer = 4096, 14336, 4096, 1024, 1
    w = _decode_weights(rnd, 2, d, m, hq, hk)
    x_d, x_m = rnd(b, d), rnd(b, m)
    f = {k: v[layer:layer + 1].float() for k, v in w.items()}
    outs = dict(wo=lm.layer_matmul(x_d, w["wo"], layer),
                down=lm.layer_matmul(x_m, w["w_down"], layer),
                act=lm.layer_swiglu(x_d, w["w_gate"], w["w_up"], layer))
    refs = dict(wo=lm.layer_matmul_plain(x_d.float(), f["wo"], 0),
                down=lm.layer_matmul_plain(x_m.float(), f["w_down"], 0),
                act=lm.layer_swiglu_plain(x_d.float(), f["w_gate"], f["w_up"], 0))
    qkv = lm.layer_qkv(x_d, w["wq"], w["wk"], w["wv"], layer)
    torch.cuda.synchronize()
    for name, out in outs.items():
        torch.testing.assert_close(out.float(), refs[name], **TOL, msg=name)
    for out, ref in zip(qkv, lm.layer_qkv_plain(x_d.float(), f["wq"], f["wk"], f["wv"], 0)):
        torch.testing.assert_close(out.float(), ref, **TOL)
    del w, f
    q8 = {name: _q8(rnd, 2, *shape) for name, shape in dict(
        wq=(d, hq), wk=(d, hk), wv=(d, hk), wo=(hq, d), wg=(d, m), wu=(d, m), wd=(m, d)).items()}
    outs = dict(wo=lm.layer_matmul_q8(x_d, *q8["wo"], layer),
                down=lm.layer_matmul_q8(x_m, *q8["wd"], layer),
                act=lm.layer_swiglu_q8(x_d, *q8["wg"], *q8["wu"], layer),
                qkv=torch.cat(lm.layer_qkv_q8(x_d, *q8["wq"], *q8["wk"], *q8["wv"], layer), -1))
    refs = dict(wo=lm.layer_matmul_q8_plain(x_d.float(), *q8["wo"], layer),
                down=lm.layer_matmul_q8_plain(x_m.float(), *q8["wd"], layer),
                act=lm.layer_swiglu_q8_plain(x_d.float(), *q8["wg"], *q8["wu"], layer),
                qkv=torch.cat(lm.layer_qkv_q8_plain(x_d.float(), *q8["wq"], *q8["wk"], *q8["wv"],
                                                    layer), -1))
    torch.cuda.synchronize()
    for name, out in outs.items():
        torch.testing.assert_close(out.float(), refs[name], **TOL, msg=f"{name} int8")


def _gar8b_step_case(rnd, q8):
    """GAR-8B's decoder at full width and 2 layers (hidden 4096, 32 / 8
    heads of 128, MLP 14336), bf16 or int8 decode weights, and a seeded bf16
    cache of 2 rows (prompts 2614 and 2000, 3072 columns)."""
    from grasp_any_region_tpu_torch.core.config import gar_8b
    from grasp_any_region_tpu_torch.models.gar import seed_cache_from_prefill
    from grasp_any_region_tpu_torch.models.llama import DECODE_MATMULS, LlamaParams
    from grasp_any_region_tpu_torch.models.quantize import quantize_int8

    base = gar_8b()
    cfg = dataclasses.replace(base, text=dataclasses.replace(base.text, num_layers=2))
    tc = cfg.text
    llm = LlamaParams(tc, vocab_rows=256, device="cuda", dtype=torch.bfloat16,
                      q8=DECODE_MATMULS if q8 else None, drop_bf16=q8)
    w = _decode_weights(rnd, 2, tc.hidden_size, tc.intermediate_size, 4096, 1024)
    with torch.no_grad():
        for name in DECODE_MATMULS:
            if q8:
                qv, sc = quantize_int8(w[name])
                getattr(llm.blocks, f"{name}_q8").copy_(qv)
                getattr(llm.blocks, f"{name}_scale").copy_(sc)
            else:
                getattr(llm.blocks, name).copy_(w[name])
        for name in ("attn_norm", "mlp_norm"):
            getattr(llm.blocks, name).copy_(_norm(rnd, 2, tc.hidden_size))
    b, s = 2, 2614
    kv = tuple(rnd(tc.num_layers, b, s, tc.num_kv_heads, tc.head_dim) for _ in range(2))
    cache = seed_cache_from_prefill(cfg, kv, _cuda_int32([s, 2000]), 3072)
    return tc, llm, cache, s


@pytest.mark.parametrize("q8", [False, True], ids=["bf16", "int8"])
def test_gar8b_fused_decode_step_graph_replay(rnd, q8):
    """GAR-8B's fused decode step (J, C, H, I, H a layer; J8, C, H8, I8, H8
    with int8 weights) at full width: its launches, its hidden against the
    XLA form within 5e-2 of the range (bf16 weights), and one CUDA-graph
    replay of the step from the same cache giving the eager step's bits,
    hidden and cache."""
    from grasp_any_region_tpu_torch.models.llama import llama_decode_step

    tc, llm, cache0, s = _gar8b_step_case(rnd, q8)
    emb = rnd(2, 1, tc.hidden_size)

    def fresh():
        return cache0._replace(k=cache0.k.clone(), v=cache0.v.clone(),
                               write_pos=cache0.write_pos.clone())

    eager = fresh()
    lm.launches.update(dict.fromkeys(lm.launches, 0))
    dec.launches = dec.launches_q8 = 0
    h_eager, _ = llama_decode_step(llm, tc, emb, eager, s, use_kernel="fused")
    torch.cuda.synchronize()
    n = tc.num_layers
    want = dict(H8=2 * n, I8=n, J8=n) if q8 else dict(H=2 * n, I=n, J=n)
    assert {k: v for k, v in lm.launches.items() if v} == want and dec.launches == n
    assert dec.launches_q8 == 0 and int(eager.write_pos) == s + 1
    if not q8:
        ref, _ = llama_decode_step(llm, tc, emb, fresh(), s, use_kernel=False)
        rel = ((h_eager.float() - ref.float()).abs().max() / ref.float().abs().max()).item()
        assert rel < 5e-2, rel

    graphed = fresh()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(stream):
        llama_decode_step(llm, tc, emb, graphed, s, use_kernel="fused")  # warm
        stream.synchronize()
        for dst, src in zip((graphed.k, graphed.v, graphed.write_pos),
                            (cache0.k, cache0.v, cache0.write_pos)):
            dst.copy_(src)
        with torch.cuda.graph(graph, stream=stream):
            h_graph, _ = llama_decode_step(llm, tc, emb, graphed, s, use_kernel="fused")
    for dst, src in zip((graphed.k, graphed.v, graphed.write_pos),
                        (cache0.k, cache0.v, cache0.write_pos)):
        dst.copy_(src)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(h_graph, h_eager)
    assert torch.equal(graphed.k, eager.k) and torch.equal(graphed.v, eager.v)
    assert int(graphed.write_pos) == s + 1


# ---- serving: kernels at the engine's shapes, the paged steps, the engine


@pytest.mark.parametrize("sq,sk", [(1024, 3072), (566, 4662), (512, 1500), (476, 1500)])
def test_flash_attention_prefill_chunk_kernel(rnd, sq, sk):
    """Kernel B on a prompt chunk against its prefix (llama_prefill_chunk's
    shapes: Sq = the chunk, Sk = prefix + chunk, the causal mask
    right-aligned by Sk - Sq), 32 query heads over 8 kv heads: output at
    the sized tolerance, LSE at atol 1e-3."""
    q, k, v = rnd(1, sq, 32, 64), rnd(1, sk, 8, 64), rnd(1, sk, 8, 64)
    before = fa.launches
    out, lse = fa.flash_attention(q, k, v, causal=True, return_lse=True)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    ref, ref_lse = fa.flash_attention_plain(q.float(), k.float(), v.float(), causal=True,
                                            return_lse=True)
    torch.testing.assert_close(out.float(), ref, **TOL)
    _sized_close(out, ref, "out")
    torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=1e-4)


def _window_layout(b):
    """A serving window's dense cache: each slot's own cached tokens
    4662 - 64 r (prompt_lens), the window base 4864 (prompt_pad) and the
    window's 18th step (write_pos), 5120 columns."""
    return [4662 - 64 * r for r in range(b)], 4864, 4864 + 17, 5120


@pytest.mark.parametrize("b", [8, 16])
def test_decode_attention_kernel_over_a_window_cache(rnd, b):
    """Kernel C over a window cache of 8 and 16 slots with distinct
    prompt_lens: against the plain version at TOL16, then the interval
    probe at TOL16; the cache changes only at column write_pos."""
    plens, pad, wpos, s = _window_layout(b)
    L, kh, layer = 2, 8, 1
    k_all, v_all = rnd(L, b, kh, s, 64), rnd(L, b, kh, s, 64)
    q, k_new, v_new = rnd(b, 32, 64), rnd(b, kh, 64), rnd(b, kh, 64)
    kw = dict(prompt_lens=_cuda_int32(plens), write_pos=_cuda_int32(wpos), prompt_pad=pad)
    for probe in (False, True):
        if probe:
            k0, vp = _interval_probe(v_all[layer], plens, pad, wpos)
            k_all[layer], v_all[layer], k_new = k0, vp, torch.zeros_like(k_new)
        k_exp, v_exp = k_all.clone(), v_all.clone()
        ref = dec.decode_attention_fused_plain(q.float(), k_exp.float(), v_exp.float(),
                                               k_new.float(), v_new.float(), layer, **kw)
        out = dec.decode_attention_fused(q, k_all, v_all, k_new, v_new, layer, **kw)
        torch.cuda.synchronize()
        torch.testing.assert_close(out.float(), ref, **TOL16, msg=f"probe {probe}")
        k_exp[layer, :, :, wpos], v_exp[layer, :, :, wpos] = k_new, v_new
        assert torch.equal(k_all, k_exp) and torch.equal(v_all, v_exp)


@pytest.mark.parametrize("b", [8, 16])
def test_decode_attention_q8_kernel_over_a_window_cache(rnd, b):
    """Kernel C8 over an int8 window cache of 8 and 16 slots (scales one
    per (layer, slot, kv-head pair), as the int8 window quantizes them):
    against the plain version at TOL16, then the interval and current-token
    probes."""
    plens, pad, wpos, s = _window_layout(b)
    cache = _q8_cache(2, b, 8, s, b)
    q, k_new, v_new = rnd(b, 32, 64), rnd(b, 8, 64), rnd(b, 8, 64)
    args = (1, plens, pad, wpos)
    _check_q8(*cache, q, k_new, v_new, *args)
    for kind in ("interval", "current"):
        k_all, v_all, ks, vs, kn, vn = _q8_probe(kind, *cache, q, k_new, v_new, *args)
        _check_q8(k_all, v_all, ks, vs, q, kn, vn, *args)


@pytest.mark.parametrize("b", [8, 16])
def test_stream_kernels_at_the_serving_slot_counts(rnd, b):
    """J, I, H (wo, w_down) and J8, I8, H8 at GAR-1B's widths with 8 and 16
    rows, the engine's slot counts, against their plain versions at TOL."""
    from grasp_any_region_tpu_torch.models.quantize import quantize_int8

    layer = 1
    w = _decode_weights(rnd, 3, 2048, 8192, 2048, 512)
    q8 = {k: quantize_int8(v) for k, v in w.items()}
    x_d, x_q, x_m = rnd(b, 2048), rnd(b, 2048), rnd(b, 8192)
    cases = [
        (lm.layer_qkv, lm.layer_qkv_plain, x_d, (w["wq"], w["wk"], w["wv"])),
        (lm.layer_swiglu, lm.layer_swiglu_plain, x_d, (w["w_gate"], w["w_up"])),
        (lm.layer_matmul, lm.layer_matmul_plain, x_q, (w["wo"],)),
        (lm.layer_matmul, lm.layer_matmul_plain, x_m, (w["w_down"],)),
        (lm.layer_qkv_q8, lm.layer_qkv_q8_plain, x_d, (*q8["wq"], *q8["wk"], *q8["wv"])),
        (lm.layer_swiglu_q8, lm.layer_swiglu_q8_plain, x_d, (*q8["w_gate"], *q8["w_up"])),
        (lm.layer_matmul_q8, lm.layer_matmul_q8_plain, x_q, q8["wo"]),
        (lm.layer_matmul_q8, lm.layer_matmul_q8_plain, x_m, q8["w_down"]),
    ]
    before = dict(lm.launches)
    for kernel, plain, x, mats in cases:
        out = kernel(x, *mats, layer)
        torch.cuda.synchronize()
        ref = plain(x.float(), *(t[layer:layer + 1].float() for t in mats), 0)
        outs, refs = (out, ref) if isinstance(out, tuple) else ((out,), (ref,))
        for o, r in zip(outs, refs):
            assert o.shape[0] == b
            torch.testing.assert_close(o.float(), r, **TOL)
    assert lm.launches == {k: v + (2 if k.startswith("H") else 1) for k, v in before.items()}


def _serving_config():
    """gar_1b narrowed to what the kernels take at small widths (chip_smoke's
    narrow config): the tower at width 256, 4 heads of 64, depth 2; the
    decoder at hidden 256, 4 heads over 2 kv heads of 64, 2 layers, MLP
    1024. The engine tests run 3 slots != 2 kv heads."""
    from grasp_any_region_tpu_torch.core.config import gar_1b

    base = gar_1b()
    return dataclasses.replace(
        base, vision=dataclasses.replace(base.vision, width=256, num_heads=4, depth=2),
        text=dataclasses.replace(base.text, hidden_size=256, num_heads=4, num_kv_heads=2,
                                 head_dim=64, num_layers=2, intermediate_size=1024))


def _serving_params(cfg):
    from grasp_any_region_tpu_torch.core.weights import init_gar_params

    params = init_gar_params(cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda",
                             dtype=torch.bfloat16)
    with torch.no_grad():
        params.mask_embed.kernel.normal_(0.0, 0.02)
    return params


def test_paged_fused_step_matches_the_paged_step(rnd):
    """llama_decode_step_paged_fused (J, H, I, H a layer) against
    llama_decode_step_paged (cuBLAS products) on the same pools: hidden and
    the written entries within 5e-2 of their range, no other entry
    changed outside the trash page, no kernel C."""
    from grasp_any_region_tpu_torch.models.llama import (llama_decode_step_paged,
                                                         llama_decode_step_paged_fused)

    cfg = _serving_config()
    tc = cfg.text
    params = _serving_params(cfg)
    n_pages, ps = 40, 64
    pools = [rnd(2, 2, n_pages, ps, 64) for _ in range(2)]
    bt = (torch.randperm(n_pages - 1, generator=torch.Generator().manual_seed(1))[:12] + 1) \
        .reshape(3, 4).to(torch.int32).cuda()
    seq_lens = _cuda_int32([200, 63, 5])
    active = torch.tensor([True, True, False], device="cuda")
    emb = rnd(3, 1, tc.hidden_size)
    outs = []
    for step in (llama_decode_step_paged, llama_decode_step_paged_fused):
        kp, vp = (p.clone() for p in pools)
        before, c_before = dict(lm.launches), dec.launches
        hidden, kp, vp = step(params.llm, tc, emb, kp, vp, bt, seq_lens, active)
        torch.cuda.synchronize()
        assert dec.launches == c_before
        outs.append((hidden, kp, vp))
    assert lm.launches == {k: v + {"J": 2, "I": 2, "H": 4}.get(k, 0) for k, v in before.items()}
    (h1, k1, v1), (h2, k2, v2) = outs
    assert ((h2[:2].float() - h1[:2].float()).abs().max() / h1[:2].float().abs().max()) < 5e-2
    pid, off = bt[[0, 1], [200 // ps, 63 // ps]].long(), torch.tensor([200 % ps, 63], device="cuda")
    for a, c, pool in ((k1, k2, pools[0]), (v1, v2, pools[1])):
        rel = (c[:, :, pid, off].float() - a[:, :, pid, off].float()).abs().max() \
            / a[:, :, pid, off].float().abs().max()
        assert rel < 5e-2
        c[:, :, pid, off] = pool[:, :, pid, off]
        c[:, :, 0] = pool[:, :, 0]
        assert torch.equal(c, pool)


def _engine_run(params, cfg, reqs, burst=True, **kw):
    from grasp_any_region_tpu_torch.serve import ContinuousBatchingEngine, EngineConfig

    ecfg = EngineConfig(**{**dict(slots=3, page_size=64, num_pages=100, max_pages_per_slot=32,
                                  max_new_tokens=20, eot_id=-1, mask_compat=False,
                                  decode_chunk=8), **kw})
    eng = ContinuousBatchingEngine(params, cfg, ecfg)
    if not burst:
        eng._burst = lambda live: False
    ids = [eng.submit(*r) for r in reqs]
    out = eng.run()
    assert eng.allocator.free_pages == ecfg.num_pages - 1
    return [out[i] for i in ids], eng


def _serving_requests(cfg, n):
    from grasp_any_region_tpu_torch.data.synthetic import synthetic_batch

    reqs = []
    for seed in range(n):
        batch, _, plens = synthetic_batch(cfg, grid=(1, 1), seed=seed, device="cuda")
        reqs.append((batch, int(plens[0])))
    return reqs


def test_engine_burst_path_equals_gather_path(rnd):
    """The bf16 engine on the card: its burst window (prefill K/V straight
    into the window cache) and its gather path (pages seeded and gathered)
    give the same tokens bit for bit (masked columns are never read), and
    the burst run took the burst path."""
    cfg = _serving_config()
    params = _serving_params(cfg)
    reqs = _serving_requests(cfg, 3)
    (burst, eng_b), (gather, eng_g) = (_engine_run(params, cfg, reqs, burst=b) for b in (True, False))
    assert eng_b.counts["fresh_windows"] >= 1 and "fresh_windows" not in eng_g.counts
    assert burst == gather and all(len(t) == 20 for t in burst)


@pytest.mark.parametrize("quantize_kv", [False, True], ids=["bf16", "int8"])
def test_engine_window_run_twice_gives_the_same_tokens(rnd, quantize_kv):
    """The same requests through the same engine twice: the second run
    finds stale pages and a trash page written in another order, and gives
    the same tokens (the int8 window's scales skip the masked columns)."""
    cfg = _serving_config()
    params = _serving_params(cfg)
    reqs = _serving_requests(cfg, 3)
    first, eng = _engine_run(params, cfg, reqs, quantize_kv=quantize_kv, decode_chunk=4)
    ids = [eng.submit(*r) for r in reqs]
    out = eng.run()
    assert [out[i] for i in ids] == first
    assert eng.counts["gathers"] >= 2


# ---------------------------------------------------------------- GAR-8B training: 5 at 96, 17 / 18 at 128


@pytest.mark.parametrize("t,s,h", [(9, 1025, 16), (2, 129, 2), (1, 257, 3), (2, 1024, 2),
                                   (1, 77, 1), (3, 1040, 2)])
def test_vit_attention_backward_kernel_head_dim_96(rnd, t, s, h):
    """Kernel 5 at GAR-8B's head dim 96 (17's prep, 18's wide pass at 128's
    two-atom layout with columns 96-127 zero-filled, 17's cast), v a view of
    a (T, S, 3, H, 96) buffer as the unfused PE-G block passes it, at the 8B
    tower's shape and at ragged S (a one-key ninth key tile, a 77-row one,
    a 32-row query tile's edge), against the plain backward at the sized
    tolerance; dk and dv bit-equal across two runs."""
    from grasp_any_region_tpu_torch.ops import flash_backward as fb

    q, k, g = (rnd(t, s, h, 96) for _ in range(3))
    v = rnd(t, s, 3, h, 96)[:, :, 2]
    out, lse = va.vit_attention(q, k, v, return_lse=True)
    before = va.launches_bwd, fb.launches_dq, fb.launches_dkv
    got = va.vit_attention_bwd(q, k, v, out, lse, g)
    again = va.vit_attention_bwd(q, k, v, out, lse, g)
    torch.cuda.synchronize()
    assert (va.launches_bwd, fb.launches_dq, fb.launches_dkv) == tuple(x + 2 for x in before)
    want = [w.float() for w in va.vit_attention_bwd_plain(q, k, v, out, lse, g)]
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.shape == (t, s, h, 96)
        _sized_close(a, b, name)
    assert torch.equal(got[1], again[1]) and torch.equal(got[2], again[2])


@pytest.mark.parametrize("b,sq,sk,h,kh,causal,packed", [
    (1, 2614, 2614, 32, 8, True, False),  # the 8B train step's prefill
    (1, 2614, 2614, 32, 8, True, (1900, 2500)),  # with two documents and padding
    (2, 333, 333, 8, 2, True, False),
    (1, 130, 300, 4, 1, True, False),
    (1, 200, 333, 8, 2, False, False),
    (1, 333, 333, 8, 4, True, (100, 129, 250)),
    (2, 520, 520, 8, 1, True, (64, 127, 130, 300, 511)),
    (2, 700, 700, 8, 2, True, True),
    (1, 1040, 1040, 8, 2, False, False),
    (2, 31, 31, 4, 4, True, False),
])
def test_flash_backward_kernels_head_dim_128(rnd, b, sq, sk, h, kh, causal, packed):
    """Kernels 17 and 18 at GAR-8B's decoder head dim 128 (18's wide
    instance: 32-row query steps, two consumer warpgroups, thread 0 the TMA
    loader) from B's forward with its LSE, at the 8B prefill (with and
    without segment ids) and at ragged shapes: Sq < Sk, GQA 1-8, documents
    ending inside and at the edges of the 32-row and 128-key tiles, full
    attention; against the plain backward at the sized tolerance; dk and dv
    bit-equal across two runs, the counters one each a call."""
    from grasp_any_region_tpu_torch.ops import flash_backward as fb

    q, g = rnd(b, sq, h, 128), rnd(b, sq, h, 128)
    k, v = rnd(b, sk, kh, 128), rnd(b, sk, kh, 128)
    seg = None
    if packed is True:
        seg = _packed_segments(b, sq, torch.Generator().manual_seed(sq))
    elif packed:
        seg = _documents(b, sq, packed)
    kw = dict(causal=causal, segment_ids=seg)
    out, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
    before = fb.launches_dq, fb.launches_dkv, fb.launches_segments
    got = fb.flash_attention_bwd(q, k, v, out, lse, g, **kw)
    again = fb.flash_attention_bwd(q, k, v, out, lse, g, **kw)
    torch.cuda.synchronize()
    assert (fb.launches_dq, fb.launches_dkv, fb.launches_segments) == (
        before[0] + 2, before[1] + 2, before[2] + 2 * (seg is not None))
    want = [w.float() for w in fb.flash_attention_bwd_plain(q, k, v, out, lse, g, **kw)]
    for name, a, b_ in zip(("dq", "dk", "dv"), got, want):
        _sized_close(a, b_, name)
    assert torch.equal(got[1], again[1]) and torch.equal(got[2], again[2])
    _sized_close(again[0], want[0], "dq, second run")


@pytest.mark.parametrize("d", [96, 128])
def test_flash_backward_prep_at_gar8b_head_dims(rnd, d):
    """Kernel 17's prep at 96 (four threads a row, three 8-column chunks
    each) and 128 (eight threads, two chunks): delta against `bwd_delta`,
    out a strided view, the workspace zeroed; its cast at d ** -0.5."""
    from grasp_any_region_tpu_torch.ops import flash_backward as fb

    out = rnd(2, 77, 6, 3, d)[:, :, :, 1]
    g = rnd(2, 77, 6, d)
    delta, acc = fb.bwd_prep(out, g)
    torch.cuda.synchronize()
    torch.testing.assert_close(delta, fb.bwd_delta(out, g), atol=1e-4, rtol=1e-5)
    assert acc.shape == (2, 77, 6, d) and not acc.any()
    acc.normal_()
    torch.testing.assert_close(fb.bwd_dq_cast(acc).float(),
                               (acc * d ** -0.5).to(torch.bfloat16).float(), atol=0, rtol=0)


def test_lora_train_step_at_a_narrow_8b_config_matches_the_cpu(rnd):
    """One LoRA loss and backward at a narrow GAR-8B-shaped config (the
    PE-G tower at head dim 96, 2 heads, depth 2; the decoder at head dim
    128, 4 / 1 heads, 2 layers; untied head): the card's kernel path (A, 5
    at 96; B, 17, 18 at 128) against the CPU's plain path from the same
    seeded bf16 base and fp32 adapters (B random, so A's gradient flows);
    the loss and every gradient leaf, `llm/lora_scaling` and the frozen
    ones included, within 5e-2 of that leaf's max |g| (as chip_smoke.py's
    train cross-check); then two lora_only steps on the card: finite, the
    frozen base unchanged, the adapters moved, every gradient freed."""
    import copy

    from grasp_any_region_tpu_torch.core.config import gar_8b
    from grasp_any_region_tpu_torch.core.weights import flat_grads, init_gar_params
    from grasp_any_region_tpu_torch.data.synthetic import synthetic_batch
    from grasp_any_region_tpu_torch.ops import flash_backward as fb
    from grasp_any_region_tpu_torch.train import (OptimizerConfig, init_state, loss_fn,
                                                  make_train_step)
    from grasp_any_region_tpu_torch.train.lora import LoRAConfig, add_lora_params

    cfg = gar_8b()
    cfg = dataclasses.replace(
        cfg, vision=dataclasses.replace(cfg.vision, width=192, num_heads=2, depth=2),
        text=dataclasses.replace(cfg.text, hidden_size=512, num_heads=4, num_kv_heads=1,
                                 head_dim=128, num_layers=2, intermediate_size=1024))
    gen = torch.Generator().manual_seed(0)
    base = init_gar_params(cfg, gen, device="cpu", dtype=torch.bfloat16)
    with torch.no_grad():
        base.mask_embed.kernel.normal_(0.0, 0.02, generator=gen)
    p_cpu = add_lora_params(base, cfg.text, LoRAConfig(), gen)
    with torch.no_grad():
        for t in LoRAConfig().targets:
            getattr(p_cpu.llm.blocks, f"{t}_lora_b").normal_(0.0, 0.02, generator=gen)
    runs = {}
    for dev in ("cuda", "cpu"):
        params = copy.deepcopy(p_cpu).to(dev)
        for p in params.parameters():
            p.requires_grad_(True)
        batch, labels, _ = synthetic_batch(cfg, grid=(2, 1), seed=0, device=dev)
        before = va.launches, va.launches_bwd, fa.launches, fb.launches_dq, fb.launches_dkv
        loss = loss_fn(params, cfg, batch, labels, mask_compat=False)
        loss.backward()
        after = va.launches, va.launches_bwd, fa.launches, fb.launches_dq, fb.launches_dkv
        runs[dev] = loss.item(), flat_grads(params), tuple(a - b for a, b in zip(after, before))
    (loss_card, g_card, launched), (loss_cpu, g_cpu, _) = runs["cuda"], runs["cpu"]
    assert launched == (4, 2, 4, 4, 4)  # A, 5, B (twice a block: remat), 17, 18
    assert abs(loss_card - loss_cpu) <= 5e-2 * abs(loss_cpu)
    assert set(g_card) == set(g_cpu) and "llm/lora_scaling" in g_card
    for name, ref in g_cpu.items():
        scale = float(abs(ref).max())
        err = float(abs(g_card[name] - ref).max())
        assert err <= 5e-2 * scale + 1e-6, (name, err, scale)
    assert float(abs(g_cpu["llm/blocks/wq_lora_a"]).max()) > 0

    state, tx = init_state(copy.deepcopy(p_cpu), OptimizerConfig(lr=1e-3, total_steps=10,
                                                                  warmup_ratio=0.0,
                                                                  lora_only=True))
    start = {n: p.detach().clone() for n, p in state.params.named_parameters()}
    step = make_train_step(cfg, tx, mask_compat=False)
    batch, labels, _ = synthetic_batch(cfg, grid=(2, 1), seed=0)
    for _ in range(2):
        state, metrics = step(state, batch, labels)
        assert torch.isfinite(metrics["loss"]) and torch.isfinite(metrics["grad_norm"])
    for n, p in state.params.named_parameters():
        assert p.grad is None
        if n not in tx.names:
            assert torch.equal(p, start[n]), n  # the frozen base never moves
    for n in ("llm.blocks.wq_lora_a", "llm.blocks.wo_lora_b", "mask_embed.kernel"):
        assert not torch.equal(state.params.get_parameter(n), start[n]), n


# ---- evaluation, RoIAlign and the profiler on the card


def _eval_narrow_config():
    from grasp_any_region_tpu_torch.core.config import gar_1b

    cfg = gar_1b()
    return dataclasses.replace(
        cfg, vision=dataclasses.replace(cfg.vision, width=256, num_heads=4, depth=2),
        text=dataclasses.replace(cfg.text, hidden_size=256, num_heads=4, num_kv_heads=1,
                                 head_dim=64, num_layers=2, intermediate_size=1024))


def _eval_samples(n):
    import numpy as np

    from grasp_any_region_tpu_torch.data.builders import RegionSample

    rng = np.random.default_rng(0)
    out = []
    for i in range(n):
        img = rng.integers(0, 256, (300 + 40 * i, 420, 3), dtype=np.uint8)
        mask = np.zeros(img.shape[:2], np.uint8)
        mask[20 + 10 * i:200, 40:300 - 20 * i] = 1
        out.append(RegionSample(img, {1: mask}))
    return out


def test_batched_captioner_batch_on_the_card_equals_the_cpu(rnd, monkeypatch):
    """`BatchedCaptioner` at a narrow gar_1b in fp32: three items in batches
    of two (the second padded) on the card give the CPU plain path's tokens.
    The prefill's kernels and kernel C take bf16 only, so the card's prefill
    runs on the CPU (the same weights) and its decode attention is the plain
    version; the decode step's products are cuBLAS fp32."""
    import copy
    import functools

    from grasp_any_region_tpu_torch.cli import runtime as rtm
    from grasp_any_region_tpu_torch.core.weights import init_gar_params
    from grasp_any_region_tpu_torch.data.image_processor import (GARImageProcessor,
                                                                 ImageProcessorConfig)
    from grasp_any_region_tpu_torch.data.tokenizer import GARTokenizer
    from grasp_any_region_tpu_torch.evaluation.engine import BatchedCaptioner
    from grasp_any_region_tpu_torch.models import gar, generate as gen_mod, llama

    cfg = _eval_narrow_config()
    p_cpu = init_gar_params(cfg, torch.Generator().manual_seed(0), device="cpu",
                            dtype=torch.float32)
    with torch.no_grad():
        p_cpu.mask_embed.kernel.normal_(0.0, 0.02, generator=torch.Generator().manual_seed(1))
        for name in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
            getattr(p_cpu.llm.blocks, name).mul_(10.0)
    p_gpu = copy.deepcopy(p_cpu).to("cuda")

    def runtime(params, device):
        return rtm.GARRuntime(cfg, params, GARTokenizer.synthetic(cfg.prompt_numbers),
                              GARImageProcessor(ImageProcessorConfig(max_num_tiles=cfg.max_num_tiles)),
                              torch.device(device), torch.float32,
                              torch.Generator(device=device).manual_seed(0))

    def cpu_prefill(params, cfg_, batch_, **kw):
        if params is p_gpu:
            hidden, (k, v) = gar.gar_prefill(p_cpu, cfg_, gar.map_batch(lambda t: t.cpu(), batch_),
                                             **kw)
            return hidden.cuda(), (k.cuda(), v.cuda())
        return gar.gar_prefill(params, cfg_, batch_, **kw)

    toks = {"cpu": [], "cuda": []}
    real = rtm.generate

    def recording(*a, **k):
        out = real(*a, **k)
        toks[out.tokens.device.type].append(out.tokens.cpu())
        return out

    monkeypatch.setattr(gen_mod, "gar_prefill", cpu_prefill)
    monkeypatch.setattr(gen_mod, "gar_decode_step",
                        functools.partial(gar.gar_decode_step, use_kernel=False))
    monkeypatch.setattr(llama, "decode_attention_fused", dec.decode_attention_fused_plain)
    monkeypatch.setattr(rtm, "generate", recording)
    samples = _eval_samples(3)
    caps = {d: BatchedCaptioner(runtime(p, d), batch_size=2, max_new_tokens=12)
            for d, p in (("cpu", p_cpu), ("cuda", p_gpu))}
    texts = {d: cap.run(samples) for d, cap in caps.items()}
    assert texts["cuda"] == texts["cpu"] and len(texts["cuda"]) == 3
    assert [b["pad"] for b in caps["cuda"].batches] == [0, 1]
    for got, want in zip(toks["cuda"], toks["cpu"]):
        assert torch.equal(got, want), (got, want)
    assert len(toks["cuda"]) == 2 and len(set(toks["cuda"][0][0].tolist())) > 1


def test_roi_align_on_the_card_equals_the_cpu(rnd):
    from grasp_any_region_tpu_torch.ops.roi_align import roi_align

    gen = torch.Generator().manual_seed(3)
    feat = torch.randn((64, 48, 80), generator=gen)
    boxes = torch.tensor([[2.0, 3.0, 61.5, 40.0], [0.0, 0.0, 79.0, 47.0], [10.2, 5.7, 11.9, 8.1],
                          [-3.0, -3.0, 5.0, 5.0], [70.0, 40.0, 90.0, 60.0]])
    for kw in (dict(output_size=(16, 16)), dict(output_size=(7, 9), spatial_scale=0.5,
                                                aligned=False)):
        got = roi_align(feat.cuda(), boxes.cuda(), **kw)
        assert got.device.type == "cuda"
        torch.testing.assert_close(got.cpu(), roi_align(feat, boxes, **kw), rtol=1e-5, atol=1e-5)


def test_trace_records_kernels_b_and_c_on_the_card(rnd, tmp_path):
    """A narrow bf16 caption on the card inside `utils.profiling.trace`:
    the trace holds kernel B's launches in the prefill range and kernel C's
    in the decode range, and the memory stats name the card."""
    import numpy as np

    from grasp_any_region_tpu_torch.cli.runtime import GARRuntime
    from grasp_any_region_tpu_torch.core.weights import init_gar_params
    from grasp_any_region_tpu_torch.data.image_processor import (GARImageProcessor,
                                                                 ImageProcessorConfig)
    from grasp_any_region_tpu_torch.data.tokenizer import GARTokenizer
    from grasp_any_region_tpu_torch.utils.profiling import (device_memory_stats, trace,
                                                            trace_kernels)

    cfg = _eval_narrow_config()
    params = init_gar_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                             dtype=torch.bfloat16)
    rt = GARRuntime(cfg, params, GARTokenizer.synthetic(cfg.prompt_numbers),
                    GARImageProcessor(ImageProcessorConfig(max_num_tiles=cfg.max_num_tiles)),
                    torch.device("cuda"), torch.bfloat16,
                    torch.Generator(device="cuda").manual_seed(0))
    samples = _eval_samples(1)
    rt.caption(samples, max_new_tokens=4)  # warm-up: the kernel library is built
    with trace(str(tmp_path)) as prof:
        rt.caption(samples, max_new_tokens=6)
    kernels = trace_kernels(prof.trace_file)
    b = [k for k in kernels if "flash_fwd_sm90_kernel" in k["name"]]
    c = [k for k in kernels if "decode_split_kernel" in k["name"]]
    assert len(b) >= 1 and all("prefill" in k["ranges"] for k in b), b[:3]
    assert len(c) >= 1 and all("decode" in k["ranges"] for k in c), c[:3]
    assert len(c) == cfg.text.num_layers * 5  # one a layer a decode step
    stats = device_memory_stats()
    assert len(stats) == torch.cuda.device_count() and stats[0]["peak_bytes_in_use"] > 0
    assert np.isfinite(sum(k["us"] for k in kernels))
