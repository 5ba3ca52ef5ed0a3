"""The PyTorch port's SAM (`grasp_any_region_tpu_torch/sam/`) against the
JAX package's on the same weights, at fp32 on the CPU.

The small config's 16-token grid does not divide by its 14-token window,
so the windowed blocks pad (to 28) and unpad, as ViT-H's 64-token grid
pads to 70. The weights are JAX `init_sam_params`', carried onto the port
by `sam_params_from_numpy`, with the decoder's mask path scaled up (at
init the mask logits are ~1e-3, where an absolute 1e-4 would pass a wrong
kernel flip). Model outputs are held at rtol 1e-4 and atol 1e-4 of the
output's range (JAX's ONNX test holds the decoder at 1e-4); the host
pipeline (resizes, predictor masks) bit for bit, with JAX's native resize
patched off (the port has only the numpy one).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grasp_any_region_tpu.sam import model as jm
from grasp_any_region_tpu.sam import pipeline as jp
from grasp_any_region_tpu_torch.sam import model as tm
from grasp_any_region_tpu_torch.sam import pipeline as tp
from grasp_any_region_tpu_torch.sam.weights import sam_params_from_numpy

SMALL = dict(img_size=256, patch_size=16, embed_dim=64, depth=2, num_heads=2, window_size=14,
             global_attn_indexes=(1,), out_chans=64, decoder_mlp_dim=128)
CFG_J, CFG_T = jm.SAMConfig(**SMALL), tm.SAMConfig(**SMALL)


def close(got, want, rtol=1e-4):
    """got within rtol and 1e-4 of want's range."""
    want = np.asarray(want, np.float32)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-4 * float(np.abs(want).max()))


def jax_tree(seed: int = 0) -> dict:
    tree = jax.tree_util.tree_map(np.asarray, jm.init_sam_params(jax.random.PRNGKey(seed), CFG_J))
    dec = tree["decoder"]
    dec["upscale1"] = dec["upscale1"] * 20.0
    dec["upscale2"] = dec["upscale2"] * 20.0
    for mp in dec["hyper_mlps"]:
        for k in ("fc1", "fc2", "fc3"):
            mp[k] = mp[k] * 20.0
    return tree


@pytest.fixture(scope="module")
def weights():
    tree = jax_tree()
    return tree, sam_params_from_numpy(tree, device="cpu")


@pytest.fixture(scope="module")
def pixels():
    return np.random.default_rng(1).standard_normal((2, 3, 256, 256)).astype(np.float32)


@pytest.fixture(scope="module")
def embeddings(weights, pixels):
    tree, params = weights
    want = np.asarray(jm.encode_image(tree, CFG_J, jnp.asarray(pixels)))
    got = tm.encode_image(params, CFG_T, torch.from_numpy(pixels))
    return want, got


@pytest.fixture(autouse=True)
def numpy_resize(monkeypatch):
    """JAX's resize_bicubic takes the native C++ resize when it is built;
    the port has the numpy one only."""
    monkeypatch.setattr("grasp_any_region_tpu.data.resize_native.resize_bicubic_native",
                        lambda *a, **k: None)


PROMPTS = {
    "fg": ([[0.3, 0.4]], [1]),
    "fg_bg_pad": ([[0.3, 0.4], [0.8, 0.1], [0.0, 0.0]], [1, 0, -1]),
    "box": ([[0.1, 0.2], [0.7, 0.9]], [2, 3]),
    "box_and_point": ([[0.5, 0.5], [0.1, 0.2], [0.7, 0.9]], [1, 2, 3]),
}


def test_param_tree_names_and_layouts(weights):
    tree, params = weights
    flat = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{prefix}{k}.")
        elif isinstance(node, list):
            for i, v in enumerate(node):
                walk(v, f"{prefix}{i}.")
        else:
            flat[prefix[:-1]] = node

    walk(tree, "")
    got = dict(params.named_parameters())
    assert sorted(got) == sorted(flat)
    for name, value in flat.items():
        assert torch.equal(got[name], torch.from_numpy(np.array(value))), name
    assert not any(p.requires_grad for p in params.parameters())
    # a fresh port init has JAX's tree: the same names and shapes
    fresh = tm.init_sam_params(CFG_T, torch.Generator().manual_seed(0), device="cpu")
    assert {n: tuple(p.shape) for n, p in fresh.named_parameters()} == \
        {n: tuple(np.shape(v)) for n, v in flat.items()}
    assert torch.equal(fresh["encoder"]["blocks"][0]["ln1"]["scale"], torch.ones(64))


def test_init_sam_params_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this checks the refusal without a card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tm.init_sam_params(CFG_T, torch.Generator().manual_seed(0))


@pytest.mark.parametrize("shape,ws", [((2, 7, 9, 5), 4), ((1, 16, 16, 3), 14),
                                      ((1, 14, 28, 2), 14)])
def test_window_partition_round_trip(shape, ws):
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    want, padded_j = jm._window_partition(jnp.asarray(x), ws)
    got, padded = tm._window_partition(torch.from_numpy(x), ws)
    assert padded == padded_j
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    back = tm._window_unpartition(got, ws, padded, shape[1:3])
    np.testing.assert_array_equal(back.numpy(), x)


@pytest.mark.parametrize("row", [0, 1])
def test_encode_image_matches_jax(embeddings, row):
    want, got = embeddings
    assert got.shape == (2, 64, 16, 16)
    close(got[row], want[row])


def test_rel_pos_bias_matches_jax():
    rel = np.random.default_rng(2).standard_normal((27, 8)).astype(np.float32)
    np.testing.assert_array_equal(tm._rel_pos_bias(torch.from_numpy(rel), 14).numpy(),
                                  np.asarray(jm._rel_pos_bias(jnp.asarray(rel), 14)))


def test_conv_transpose_flips_the_kernel_as_jax():
    """The decoder's 2x2 stride-2 transposed conv equals torch's
    conv_transpose2d with the kernel spatially flipped (JAX's
    lax.conv_transpose without transpose_kernel), and not without the flip."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((1, 5, 6, 8)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((8, 4, 2, 2)).astype(np.float32))
    got = tm._conv_transpose2x2(x, w)
    flipped = torch.nn.functional.conv_transpose2d(
        x.permute(0, 3, 1, 2), torch.flip(w, dims=(2, 3)), stride=2).permute(0, 2, 3, 1)
    plain = torch.nn.functional.conv_transpose2d(x.permute(0, 3, 1, 2), w,
                                                 stride=2).permute(0, 2, 3, 1)
    torch.testing.assert_close(got, flipped, rtol=1e-5, atol=1e-5)
    assert (got - plain).abs().max() > 1.0
    want = jax.lax.conv_transpose(jnp.asarray(x.numpy()),
                                  jnp.asarray(w.numpy()).transpose(2, 3, 0, 1), (2, 2), "VALID",
                                  dimension_numbers=("NHWC", "HWIO", "NHWC"))
    close(got, want)


def test_neck_conv_matches_conv2d():
    """The neck's 3x3 "SAME" conv (nine shifted products) is F.conv2d with
    the HWIO kernel permuted to (out, in, kh, kw)."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((1, 9, 7, 6)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((3, 3, 6, 5)).astype(np.float32))
    want = torch.nn.functional.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                                      padding=1).permute(0, 2, 3, 1)
    torch.testing.assert_close(tm._conv3x3_same(x, w), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("prompt", sorted(PROMPTS))
def test_encode_points_matches_jax(weights, prompt):
    tree, params = weights
    pts, labs = PROMPTS[prompt]
    pts, labs = np.asarray([pts], np.float32), np.asarray([labs], np.int32)
    want = jm.encode_points(tree, jnp.asarray(pts), jnp.asarray(labs))
    close(tm.encode_points(params, torch.from_numpy(pts), torch.from_numpy(labs)), want)


def test_image_pe_matches_jax(weights):
    tree, params = weights
    close(tm.image_pe(params, CFG_T), jm.image_pe(tree, CFG_J))


@pytest.mark.parametrize("prompt", ["fg_bg_pad", "box"])
def test_decode_masks_matches_jax(weights, embeddings, prompt):
    tree, params = weights
    emb = embeddings[0]
    pts, labs = PROMPTS[prompt]
    pts, labs = np.asarray([pts] * 2, np.float32), np.asarray([labs] * 2, np.int32)
    sparse = np.asarray(jm.encode_points(tree, jnp.asarray(pts), jnp.asarray(labs)))
    masks_j, iou_j = jm.decode_masks(tree, CFG_J, jnp.asarray(emb), jnp.asarray(sparse))
    masks, iou = tm.decode_masks(params, CFG_T, torch.from_numpy(emb), torch.from_numpy(sparse))
    assert masks.shape == (2, 4, 64, 64) and iou.shape == (2, 4)
    assert np.abs(np.asarray(masks_j)).max() > 1.0  # the scaled mask path is not near zero
    close(masks, masks_j)
    close(iou, iou_j)


def test_predict_mask_matches_jax(weights, pixels):
    tree, params = weights
    pts, labs = PROMPTS["box_and_point"]
    pts, labs = np.asarray([pts], np.float32), np.asarray([labs], np.int32)
    best_j, iou_j = jm.predict_mask(tree, CFG_J, jnp.asarray(pixels[:1]), jnp.asarray(pts),
                                    jnp.asarray(labs))
    best, iou = tm.predict_mask(params, CFG_T, torch.from_numpy(pixels[:1]), torch.from_numpy(pts),
                                torch.from_numpy(labs))
    assert best.shape == (1, 64, 64)
    close(best, best_j)
    close(iou, iou_j)


@pytest.mark.parametrize("hw", [(300, 500), (500, 300), (256, 256)])
def test_preprocess_and_postprocess_are_bit_equal(hw):
    rng = np.random.default_rng(5)
    img = rng.integers(0, 256, hw + (3,), dtype=np.uint8)
    pix_j, scale_j, shp_j = jp.preprocess_sam(img, 256)
    pix, scale, shp = tp.preprocess_sam(img, 256)
    assert (scale, shp) == (scale_j, shp_j)
    np.testing.assert_array_equal(pix, pix_j)
    logits = rng.standard_normal((64, 64)).astype(np.float32)
    np.testing.assert_array_equal(tp.postprocess_mask(logits, shp, hw, 256),
                                  jp.postprocess_mask(logits, shp_j, hw, 256))


PREDICTOR_PROMPTS = {
    "points": dict(points=[(120.0, 80.0), (150.0, 100.0)], point_labels=[1, 1]),
    "negative_point": dict(points=[(120.0, 80.0), (40.0, 30.0)], point_labels=[1, 0]),
    "box": dict(box=(60.0, 40.0, 220.0, 150.0)),
    "box_and_point": dict(points=[(120.0, 80.0)], point_labels=[1], box=(60.0, 40.0, 220.0, 150.0)),
}


@pytest.fixture(scope="module")
def predictors(weights):
    tree, params = weights
    return (jp.SamPredictor(params=tree, cfg=CFG_J), tp.SamPredictor(params=params, cfg=CFG_T))


@pytest.mark.parametrize("prompt", sorted(PREDICTOR_PROMPTS))
def test_predictor_mask_matches_jax(predictors, prompt):
    jpred, tpred = predictors
    img = np.random.default_rng(6).integers(0, 256, (180, 260, 3), dtype=np.uint8)
    kw = PREDICTOR_PROMPTS[prompt]
    want = jpred.predict(img, **kw)
    got = tpred.predict(img, **kw)
    assert got.shape == (180, 260) and got.dtype == np.uint8
    assert 0 < want.sum() < want.size
    np.testing.assert_array_equal(got, want)


def test_predictor_caches_the_embedding(weights, monkeypatch):
    _, params = weights
    pred = tp.SamPredictor(params=params, cfg=CFG_T)
    calls = []
    real = tp.encode_image
    monkeypatch.setattr(tp, "encode_image", lambda *a: calls.append(1) or real(*a))
    rng = np.random.default_rng(7)
    img = rng.integers(0, 256, (120, 160, 3), dtype=np.uint8)
    pred.predict(img, points=[(50.0, 40.0)], point_labels=[1])
    pred.predict(img, box=(10.0, 10.0, 90.0, 80.0))
    assert len(calls) == 1  # the second prompt on the same image hits the cache
    for i in range(9):  # eight entries at most, the oldest evicted
        pred.predict(rng.integers(0, 256, (120, 160, 3), dtype=np.uint8),
                     points=[(50.0, 40.0)], point_labels=[1])
    assert len(calls) == 10 and len(pred._emb_cache) == 8
    pred.predict(img, points=[(50.0, 40.0)], point_labels=[1])
    assert len(calls) == 11


@pytest.mark.parametrize("prompt", ["box", "points", "negative_point"])
def test_stand_in_without_weights_matches_jax(prompt, capsys):
    img = np.zeros((100, 200, 3), np.uint8)
    kw = {"box": dict(box=(20, 10, 80, 60)),
          "points": dict(points=[(100, 50), (30, 20)], point_labels=[1, 1]),
          "negative_point": dict(points=[(100, 50), (30, 20)], point_labels=[1, 0])}[prompt]
    got = tp.SamPredictor().predict(img, **kw)
    np.testing.assert_array_equal(got, jp.SamPredictor().predict(img, **kw))
    assert got.sum() > 0 and not tp.SamPredictor().has_model
    assert "no SAM weights loaded" in capsys.readouterr().err


def test_contours_and_overlay_match_jax():
    m = np.zeros((40, 50), np.uint8)
    m[5:30, 8:41] = 1
    img = np.random.default_rng(8).integers(0, 256, (40, 50, 3), dtype=np.uint8)
    np.testing.assert_array_equal(tp.mask_contours(m), jp.mask_contours(m))
    np.testing.assert_array_equal(tp.draw_mask_overlay(img, m), jp.draw_mask_overlay(img, m))


# ---------------------------------------------------------------------------
# HF checkpoints
# ---------------------------------------------------------------------------

def hf_tensors(cfg, seed: int = 9) -> dict:
    """A random state dict in the HF SamModel layout at cfg's shapes."""
    rng = np.random.default_rng(seed)
    d, p, g, c = cfg.embed_dim, cfg.patch_size, cfg.grid, cfg.out_chans
    dh, m, nm = d // cfg.num_heads, cfg.decoder_mlp_dim, cfg.num_multimask_outputs + 1
    shapes = {
        "vision_encoder.patch_embed.projection.weight": (d, 3, p, p),
        "vision_encoder.patch_embed.projection.bias": (d,),
        "vision_encoder.pos_embed": (1, g, g, d),
        "vision_encoder.neck.conv1.weight": (c, d, 1, 1),
        "vision_encoder.neck.layer_norm1.weight": (c,),
        "vision_encoder.neck.layer_norm1.bias": (c,),
        "vision_encoder.neck.conv2.weight": (c, c, 3, 3),
        "vision_encoder.neck.layer_norm2.weight": (c,),
        "vision_encoder.neck.layer_norm2.bias": (c,),
        "shared_image_embedding.positional_embedding": (2, c // 2),
        "prompt_encoder.not_a_point_embed.weight": (1, c),
        "prompt_encoder.no_mask_embed.weight": (1, c),
        "mask_decoder.iou_token.weight": (1, c), "mask_decoder.mask_tokens.weight": (nm, c),
        "mask_decoder.upscale_conv1.weight": (c, c // 4, 2, 2),
        "mask_decoder.upscale_layer_norm.weight": (c // 4,),
        "mask_decoder.upscale_layer_norm.bias": (c // 4,),
        "mask_decoder.upscale_conv2.weight": (c // 4, c // 8, 2, 2),
        "mask_decoder.transformer.layer_norm_final_attn.weight": (c,),
        "mask_decoder.transformer.layer_norm_final_attn.bias": (c,),
    }
    for i in range(4):
        shapes[f"prompt_encoder.point_embed.{i}.weight"] = (1, c)
    for i in range(cfg.depth):
        b = f"vision_encoder.layers.{i}."
        size = g if i in cfg.global_attn_indexes else cfg.window_size
        shapes.update({
            b + "layer_norm1.weight": (d,), b + "layer_norm1.bias": (d,),
            b + "attn.qkv.weight": (3 * d, d), b + "attn.qkv.bias": (3 * d,),
            b + "attn.proj.weight": (d, d), b + "attn.proj.bias": (d,),
            b + "attn.rel_pos_h": (2 * size - 1, dh), b + "attn.rel_pos_w": (2 * size - 1, dh),
            b + "layer_norm2.weight": (d,), b + "layer_norm2.bias": (d,),
            b + "mlp.lin1.weight": (4 * d, d), b + "mlp.lin1.bias": (4 * d,),
            b + "mlp.lin2.weight": (d, 4 * d), b + "mlp.lin2.bias": (d,),
        })

    def attn(prefix):
        for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
            shapes[f"{prefix}{n}.weight"] = (c, c)
            shapes[f"{prefix}{n}.bias"] = (c,)

    for i in range(cfg.decoder_depth):
        b = f"mask_decoder.transformer.layers.{i}."
        for n in ("self_attn.", "cross_attn_token_to_image.", "cross_attn_image_to_token."):
            attn(b + n)
        for j in range(1, 5):
            shapes[f"{b}layer_norm{j}.weight"] = (c,)
            shapes[f"{b}layer_norm{j}.bias"] = (c,)
        shapes.update({b + "mlp.lin1.weight": (m, c), b + "mlp.lin1.bias": (m,),
                       b + "mlp.lin2.weight": (c, m), b + "mlp.lin2.bias": (c,)})
    attn("mask_decoder.transformer.final_attn_token_to_image.")
    heads = [f"mask_decoder.output_hypernetworks_mlps.{i}." for i in range(nm)]
    for prefix, n_out in [(h, c // 8) for h in heads] + [("mask_decoder.iou_prediction_head.", nm)]:
        shapes.update({prefix + "proj_in.weight": (c, c), prefix + "proj_in.bias": (c,),
                       prefix + "layers.0.weight": (c, c), prefix + "layers.0.bias": (c,),
                       prefix + "proj_out.weight": (n_out, c), prefix + "proj_out.bias": (n_out,)})
    return {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}


def flat_tree(node, prefix=""):
    if isinstance(node, dict):
        out = {}
        for k, v in node.items():
            out.update(flat_tree(v, f"{prefix}{k}."))
        return out
    if isinstance(node, list):
        out = {}
        for i, v in enumerate(node):
            out.update(flat_tree(v, f"{prefix}{i}."))
        return out
    return {prefix[:-1]: np.asarray(node)}


PE = "pe_gaussian"


@pytest.mark.parametrize("layout", ["hf", "transposed_table"])
def test_convert_hf_sam_matches_jax(layout):
    """Leaf for leaf JAX's tree. HF stores the Fourier table as (2, C/2)
    (coords @ table); JAX transposes it whatever its shape, so from HF's
    layout JAX's table is the transpose of the port's (which the model
    multiplies as HF does); from a (C/2, 2) table both agree."""
    from grasp_any_region_tpu.sam.weights import convert_hf_sam as jconvert
    from grasp_any_region_tpu_torch.sam.weights import convert_hf_sam

    t = hf_tensors(CFG_T)
    name = "shared_image_embedding.positional_embedding"
    if layout == "transposed_table":
        t[name] = np.ascontiguousarray(t[name].T)
    want, got = flat_tree(jconvert(CFG_J, t)), flat_tree(convert_hf_sam(CFG_T, t))
    assert sorted(got) == sorted(want)
    for k in want:
        if k.endswith(PE) and layout == "hf":
            np.testing.assert_array_equal(got[k], want[k].T, err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["prompt." + PE].shape == (2, 32)
    assert sorted(got) == sorted(n for n, _ in tm.init_sam_params(
        CFG_T, torch.Generator().manual_seed(0), device="cpu").named_parameters())


@pytest.fixture
def hf_checkpoint(tmp_path, monkeypatch):
    """An HF-layout checkpoint of the small config, written by
    safetensors.numpy in two shards; both packages' `_cfg_from_hf` patched
    to return the small config (it maps widths to ViT-B / L / H)."""
    from safetensors.numpy import save_file

    t = hf_tensors(CFG_T)
    names = sorted(t)
    save_file({k: t[k] for k in names[:len(names) // 2]}, str(tmp_path / "model-1.safetensors"))
    save_file({k: t[k] for k in names[len(names) // 2:]}, str(tmp_path / "model-2.safetensors"))
    (tmp_path / "config.json").write_text(json.dumps({"vision_config": {"hidden_size": 64}}))
    monkeypatch.setattr("grasp_any_region_tpu.sam.weights._cfg_from_hf", lambda hf: CFG_J)
    monkeypatch.setattr("grasp_any_region_tpu_torch.sam.weights._cfg_from_hf", lambda hf: CFG_T)
    return str(tmp_path)


def test_load_sam_checkpoint_matches_jax(hf_checkpoint):
    from grasp_any_region_tpu.sam.weights import load_sam_checkpoint as jload
    from grasp_any_region_tpu_torch.sam.weights import load_sam_checkpoint

    cfg_j, tree = jload(hf_checkpoint)
    cfg, params = load_sam_checkpoint(hf_checkpoint, device="cpu")
    assert cfg == CFG_T
    want = flat_tree(tree)
    got = {n: p.numpy() for n, p in params.named_parameters()}
    assert sorted(got) == sorted(want)
    for k in want:  # the Fourier table: HF's (2, C/2) layout, see above
        np.testing.assert_array_equal(got[k], want[k].T if k.endswith(PE) else want[k],
                                      err_msg=k)
    pred = tp.SamPredictor.load(hf_checkpoint, device="cpu")
    assert pred.has_model and pred.cfg == CFG_T


@pytest.mark.parametrize("hidden,name", [(768, "sam_vit_b"), (1024, "sam_vit_l"),
                                         (1280, "sam_vit_h")])
def test_cfg_from_hf(hidden, name):
    from grasp_any_region_tpu_torch.sam.weights import _cfg_from_hf

    assert _cfg_from_hf({"vision_config": {"hidden_size": hidden}}) == getattr(tm, name)()


# ---------------------------------------------------------------------------
# ONNX export (JAX's tests/test_onnx_export.py, on the port's parameters)
# ---------------------------------------------------------------------------

def test_onnx_decoder_matches_decode_masks(weights, embeddings):
    from grasp_any_region_tpu_torch.sam.onnx_export import build_torch_decoder

    _, params = weights
    emb = torch.from_numpy(embeddings[0][:1])
    pts01 = np.array([[[0.3, 0.6], [0.8, 0.2], [0.0, 0.0]]], np.float32)
    labels = np.array([[1.0, 0.0, -1.0]], np.float32)
    sparse = tm.encode_points(params, torch.from_numpy(pts01), torch.from_numpy(labels))
    masks_t, iou_t = tm.decode_masks(params, CFG_T, emb, sparse)
    mod = build_torch_decoder(params, CFG_T, return_single_mask=False)
    with torch.no_grad():
        masks, iou, low = mod(emb, torch.from_numpy(pts01 * 256), torch.from_numpy(labels),
                              torch.zeros(1, 1, 64, 64), torch.zeros(1),
                              torch.tensor([256.0, 256.0]))
    close(low, masks_t.numpy())
    close(iou, iou_t.numpy())
    assert masks.shape == (1, 4, 256, 256)


def test_onnx_single_mask_is_predict_masks_choice(weights, embeddings):
    from grasp_any_region_tpu_torch.sam.onnx_export import build_torch_decoder

    _, params = weights
    emb = torch.from_numpy(embeddings[0][:1])
    pts01 = np.array([[[0.5, 0.5]]], np.float32)
    labels = np.array([[1.0]], np.float32)
    masks_t, iou_t = tm.decode_masks(params, CFG_T, emb, tm.encode_points(
        params, torch.from_numpy(pts01), torch.from_numpy(labels)))
    best = int(torch.argmax(iou_t[0, 1:])) + 1
    mod = build_torch_decoder(params, CFG_T, return_single_mask=True)
    with torch.no_grad():
        _, iou, low = mod(emb, torch.from_numpy(pts01 * 256), torch.from_numpy(labels),
                          torch.zeros(1, 1, 64, 64), torch.zeros(1), torch.tensor([128.0, 256.0]))
    assert low.shape == (1, 1, 64, 64)
    close(low[0, 0], masks_t[0, best].numpy())
    close(iou[0, 0], iou_t[0, best].numpy())


def test_onnx_export_writes_the_official_interface(weights, tmp_path):
    from grasp_any_region_tpu_torch.sam.onnx_export import export_mask_decoder_onnx

    _, params = weights
    out = tmp_path / "sam_decoder.onnx"
    assert export_mask_decoder_onnx(params, CFG_T, str(out)) == str(out)
    data = out.read_bytes()
    assert len(data) > 10_000
    assert data[0] == 0x08 and b"pytorch" in data[:64]  # ModelProto: ir_version, producer
    for name in (b"image_embeddings", b"point_coords", b"point_labels", b"mask_input",
                 b"has_mask_input", b"orig_im_size", b"masks", b"iou_predictions",
                 b"low_res_masks"):
        assert name in data, name.decode()
    assert b"Einsum" not in data  # onnxruntime-web builds may lack it


def test_concurrent_onnx_exports_restore_the_patched_pass(weights):
    """Two exports at once (two GET /sam_decoder.onnx on a threading server)
    each give the interface, and torch's `_add_onnxscript_fn` is its own
    again afterwards: the patch and its restore do not interleave."""
    import threading

    from grasp_any_region_tpu_torch.sam import onnx_export

    _, params = weights
    utils = onnx_export._proto_utils()
    before = utils._add_onnxscript_fn
    out, errors = [], []

    def export():
        try:
            out.append(onnx_export.mask_decoder_onnx_bytes(params, CFG_T))
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=export) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors and len(out) == 2 and out[0] == out[1]
    assert utils._add_onnxscript_fn is before


def test_onnx_export_refuses_without_its_pass_or_onnx(weights, tmp_path, monkeypatch):
    """Where torch keeps no `_add_onnxscript_fn` to patch and `onnx` is
    missing, the export raises and writes no file."""
    import builtins

    from grasp_any_region_tpu_torch.sam import onnx_export

    _, params = weights
    monkeypatch.setattr(onnx_export, "_PROTO_UTILS", ("no.such.module",))
    real_import = builtins.__import__

    def no_onnx(name, *a, **k):
        if name == "onnx":
            raise ImportError("no onnx here")
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_onnx)
    out = tmp_path / "x.onnx"
    with pytest.raises(RuntimeError, match="cannot export ONNX"):
        onnx_export.export_mask_decoder_onnx(params, CFG_T, str(out))
    assert not out.exists()
    with pytest.raises(RuntimeError, match="not a model"):
        onnx_export._check_model_bytes(b"\x08" + b"x" * 100, ["image_embeddings"], [])


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------

def _png(path, array):
    from PIL import Image

    Image.fromarray(array).save(path)
    return str(path)


@pytest.mark.parametrize("case", ["points", "box", "viz", "sam_path"])
def test_gar_with_sam_cli(tmp_path, capsys, case, request):
    from PIL import Image

    from grasp_any_region_tpu_torch.cli import gar_with_sam
    from grasp_any_region_tpu_torch.cli.runtime import GARRuntime
    from grasp_any_region_tpu_torch.data.builders import RegionSample

    img = np.random.default_rng(10).integers(0, 256, (150, 210, 3), dtype=np.uint8)
    path = _png(tmp_path / "img.png", img)
    prompt = {"box": ["--box", "30,20,170,120"]}.get(
        case, ["--point", "100,70", "--point", "120,90", "--neg-point", "10,10"])
    argv = ["--preset", "gar_tiny", "--random-init", "--max-new-tokens", "4", "--device", "cpu",
            "--image", path] + prompt
    sam = tp.SamPredictor()
    if case == "sam_path":
        ckpt = request.getfixturevalue("hf_checkpoint")
        argv += ["--sam-path", ckpt]
        sam = tp.SamPredictor.load(ckpt, device="cpu")
    if case == "viz":
        argv += ["--viz", str(tmp_path / "viz.png")]
    gar_with_sam.main(argv)
    out = capsys.readouterr().out
    points = [(100.0, 70.0), (120.0, 90.0), (10.0, 10.0)]
    mask = sam.predict(img, None if case == "box" else points,
                       None if case == "box" else [1, 1, 0],
                       (30.0, 20.0, 170.0, 120.0) if case == "box" else None)
    rt = GARRuntime.load(None, "gar_tiny", True, device="cpu")
    text = rt.caption([RegionSample(img, {1: mask})], max_new_tokens=4)[0]
    assert out.endswith(text + "\n")
    if case == "viz":
        viz = np.asarray(Image.open(tmp_path / "viz.png"))
        np.testing.assert_array_equal(viz, tp.draw_mask_overlay(img, mask))
        assert "wrote visualization" in out


def test_gar_with_sam_cli_needs_a_prompt(tmp_path, capsys):
    from grasp_any_region_tpu_torch.cli import gar_with_sam

    path = _png(tmp_path / "img.png", np.zeros((20, 20, 3), np.uint8))
    with pytest.raises(SystemExit) as info:
        gar_with_sam.main(["--image", path, "--device", "cpu"])
    assert info.value.code == 2 and "--point or a --box" in capsys.readouterr().err


@pytest.mark.parametrize("source", ["random_init", "checkpoint"])
def test_export_sam_onnx_cli(tmp_path, capsys, source, request, monkeypatch):
    from grasp_any_region_tpu_torch.cli import export_sam_onnx
    from grasp_any_region_tpu_torch.sam import model as sam_model

    out = tmp_path / "dec.onnx"
    if source == "checkpoint":
        argv = ["--checkpoint", request.getfixturevalue("hf_checkpoint"), "--multimask"]
    else:  # the CLI's ViT-B, cut to the small config to keep the test quick
        monkeypatch.setattr(sam_model, "sam_vit_b", lambda: CFG_T)
        argv = ["--random-init"]
    export_sam_onnx.main(argv + ["--out", str(out)])
    data = out.read_bytes()
    assert data[0] == 0x08 and b"low_res_masks" in data
    assert f"[export] {out}" in capsys.readouterr().err


def test_predictor_needs_a_prompt(weights):
    _, params = weights
    pred = tp.SamPredictor(params=params, cfg=CFG_T)
    with pytest.raises(ValueError, match="at least one point or a box"):
        pred.predict(np.zeros((40, 60, 3), np.uint8))
