"""The PyTorch port's self-speculative decoding (`models/speculative.py`)
against the JAX package's at `gar_tiny`, on the CPU.

The weights are JAX gar_tiny params with a random mask_embed and the
decoder's projections scaled by 10 (as tests/test_torch_model.py builds
them, so greedy decoding does not repeat one token), loaded into the port
by `load_flat_params`. JAX's `generate_speculative` fixes its compute dtype
at bf16; it runs here at fp32 by patching `gar_prefill` and
`_forward_chunk` in its module (a fresh jit), the port at fp32 by its
argument. Tokens, num_generated and the stats are held equal. The port's
tokens are also held to its own `generate` (JAX's tests/test_speculative.py
holds JAX's so), at fp32 and bf16.
"""

import copy
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

F32 = torch.float32
NEW = 16


@pytest.fixture(scope="module")
def setup():
    from grasp_any_region_tpu.core.config import gar_tiny as jtiny
    from grasp_any_region_tpu.core.weights import flatten_params
    from grasp_any_region_tpu.data.synthetic import synthetic_batch as jsb
    from grasp_any_region_tpu.models import init_gar_params
    from grasp_any_region_tpu_torch.core.config import gar_tiny
    from grasp_any_region_tpu_torch.core.weights import load_flat_params
    from grasp_any_region_tpu_torch.data.synthetic import synthetic_batch as tsb

    cfg_j, cfg_t = jtiny(), gar_tiny()
    params = init_gar_params(jax.random.PRNGKey(0), cfg_j)
    shape = params["mask_embed"]["kernel"].shape
    params["mask_embed"]["kernel"] = jnp.asarray(
        np.random.default_rng(1).standard_normal(shape).astype(np.float32) * 0.02)
    for name in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
        params["llm"]["blocks"][name] = params["llm"]["blocks"][name] * 10.0
    tparams = load_flat_params(flatten_params(params), cfg_t, device="cpu")
    jb, _, jlens = jsb(cfg_j, batch=1, grid=(2, 1), seed=0)
    tb, _, _ = tsb(cfg_t, batch=1, grid=(2, 1), seed=0, device="cpu")
    tb = tb._replace(**{k: torch.from_numpy(np.array(getattr(jb, k)))
                        for k in ("input_ids", "segment_ids", "positions")})
    return dict(cfg_j=cfg_j, cfg_t=cfg_t, params=params, tparams=tparams, jb=jb, tb=tb,
                jlens=jlens, tlens=torch.from_numpy(np.array(jlens)))


def run_port(s, dtype=F32, **kw):
    from grasp_any_region_tpu_torch.models.speculative import generate_speculative

    return generate_speculative(s["tparams"], s["cfg_t"], s["tb"], s["tlens"],
                                compute_dtype=dtype, **kw)


def run_jax(s, **kw):
    from grasp_any_region_tpu.models import gar as jg

    jspec = importlib.import_module("grasp_any_region_tpu.models.speculative")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jspec, "gar_prefill",
                   functools.partial(jg.gar_prefill, compute_dtype=jnp.float32))
        mp.setattr(jspec, "_forward_chunk",
                   functools.partial(jspec._forward_chunk, compute_dtype=jnp.float32))
        fn = jax.jit(jspec.generate_speculative.__wrapped__,
                     static_argnames=("cfg", "max_new_tokens", "gamma", "draft_layers",
                                      "eot_id"))
        return fn(s["params"], s["cfg_j"], s["jb"], s["jlens"], **kw)


def free_tokens(s, dtype=F32):
    """The port's `generate` without eot, once a dtype for the module."""
    from grasp_any_region_tpu_torch.models.generate import generate

    cache = s.setdefault("free", {})
    if dtype not in cache:
        cache[dtype] = generate(s["tparams"], s["cfg_t"], s["tb"], s["tlens"],
                                max_new_tokens=NEW, eot_id=-1, compute_dtype=dtype)
    return cache[dtype]


def assert_same(out, ref):
    np.testing.assert_array_equal(out.tokens.numpy(), np.asarray(ref.tokens))
    np.testing.assert_array_equal(out.num_generated.numpy(), np.asarray(ref.num_generated))
    assert (out.stats.rounds, out.stats.drafted, out.stats.accepted) == (
        int(ref.stats.rounds), int(ref.stats.drafted), int(ref.stats.accepted))


@pytest.mark.parametrize("gamma,k", [(4, 1), (2, 2), (3, 1)])
def test_speculative_matches_jax(setup, gamma, k):
    kw = dict(max_new_tokens=NEW, gamma=gamma, draft_layers=k, eot_id=-1)
    out = run_port(setup, **kw)
    assert_same(out, run_jax(setup, **kw))
    assert len(set(out.tokens[0].tolist())) > 4
    assert out.stats.drafted == gamma * out.stats.rounds


def test_speculative_eot_mid_round_matches_jax(setup):
    """draft_layers = L accepts every draft, so after the prefill's token a
    round emits gamma + 1 = 4 tokens (1-4, 5-8, ...): an eot at index 6
    lands mid-round, the round is cut after it and the rest is pad."""
    free = free_tokens(setup).tokens[0].tolist()
    assert free[6] not in free[:6]
    kw = dict(max_new_tokens=NEW, gamma=3, draft_layers=2, eot_id=free[6])
    out = run_port(setup, **kw)
    assert_same(out, run_jax(setup, **kw))
    assert out.num_generated.tolist() == [7]
    assert out.tokens[0, :7].tolist() == free[:7] and out.tokens[0, 7:].eq(0).all()
    assert (out.stats.rounds, out.stats.accepted) == (2, 4)  # 3 + the 1 draft before the eot


@pytest.mark.parametrize("dtype", [F32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("gamma,k", [(4, 1), (2, 2)])
def test_speculative_equals_generate(setup, gamma, k, dtype):
    ref = free_tokens(setup, dtype)
    out = run_port(setup, dtype, max_new_tokens=NEW, gamma=gamma, draft_layers=k, eot_id=-1)
    assert torch.equal(out.tokens, ref.tokens)
    assert torch.equal(out.num_generated, ref.num_generated)


def test_identity_tail_accepts_every_draft(setup):
    """wo and w_down zeroed past the draft depth make those layers exact
    residual passthroughs: the draft is the full model, and every round
    accepts all gamma drafts (15 tokens after the prefill's, 3 rounds of 5)."""
    from grasp_any_region_tpu_torch.models.generate import generate

    s = {k: v for k, v in setup.items() if k != "free"}
    s["tparams"] = params = copy.deepcopy(setup["tparams"])
    with torch.no_grad():
        params.llm.blocks.wo[1:] = 0
        params.llm.blocks.w_down[1:] = 0
    gamma = 4
    out = run_port(s, max_new_tokens=NEW, gamma=gamma, draft_layers=1, eot_id=-1)
    assert (out.stats.rounds, out.stats.drafted, out.stats.accepted) == (3, 12, 12)
    ref = generate(params, s["cfg_t"], s["tb"], s["tlens"], max_new_tokens=NEW, eot_id=-1,
                   compute_dtype=F32)
    assert torch.equal(out.tokens, ref.tokens)


def test_eot_first_token_ends_at_once(setup):
    free = free_tokens(setup).tokens[0].tolist()
    out = run_port(setup, max_new_tokens=NEW, gamma=2, draft_layers=1, eot_id=free[0])
    assert out.num_generated.tolist() == [1] and out.stats.rounds == 0
    assert out.tokens[0].tolist() == [free[0]] + [0] * (NEW - 1)


def test_chunk_attention_matches_jax():
    from grasp_any_region_tpu.models import speculative as jspec
    from grasp_any_region_tpu_torch.models.speculative import _chunk_attention

    rng = np.random.default_rng(2)
    q = rng.standard_normal((1, 3, 4, 16)).astype(np.float32)
    k = rng.standard_normal((1, 2, 64, 16)).astype(np.float32)
    v = rng.standard_normal((1, 2, 64, 16)).astype(np.float32)
    kw = dict(write_pos=40, prompt_pad=32)
    want = jspec._chunk_attention(jnp.asarray(q), jnp.asarray(k, jnp.bfloat16),
                                  jnp.asarray(v, jnp.bfloat16), prompt_lens=jnp.asarray([29]), **kw)
    got = _chunk_attention(torch.from_numpy(q), torch.from_numpy(k).bfloat16(),
                           torch.from_numpy(v).bfloat16(), prompt_lens=torch.tensor([29]), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_verify_row_zero_is_one_decode_step(setup):
    """The verify pass's first row is the decode step of its token: logits
    against one XLA-form `llama_decode_step` from the same seeded cache."""
    from grasp_any_region_tpu_torch.models.gar import gar_decode_step, gar_prefill, \
        seed_cache_from_prefill
    from grasp_any_region_tpu_torch.models.llama import lm_logits
    from grasp_any_region_tpu_torch.models.speculative import _forward_chunk

    s = setup
    cfg, params = s["cfg_t"], s["tparams"]
    seq = s["tb"].input_ids.shape[1]
    with torch.no_grad():
        hidden, kv = gar_prefill(params, cfg, s["tb"], compute_dtype=F32)
        tok = torch.argmax(lm_logits(params.llm, cfg.text, hidden[:, seq - 1],
                                     valid_vocab=cfg.extended_vocab_size), -1).to(torch.int32)
        cols = (seq + 4 + 511) // 512 * 512
        caches = [seed_cache_from_prefill(cfg, kv, s["tlens"], cols) for _ in range(2)]
        chunk = torch.cat([tok[:, None], torch.tensor([[5, 7, 9]], dtype=torch.int32)], 1)
        h, _, _ = _forward_chunk(params.llm, cfg.text, chunk, caches[0].k, caches[0].v,
                                 prompt_lens=caches[0].prompt_lens, write_pos=seq,
                                 prompt_pad=seq, num_layers=cfg.text.num_layers,
                                 compute_dtype=F32)
        verify = lm_logits(params.llm, cfg.text, h[:, 0], valid_vocab=cfg.extended_vocab_size)
        step, _ = gar_decode_step(params, cfg, tok, caches[1], seq, compute_dtype=F32,
                                  use_kernel=False)
    valid = slice(0, cfg.extended_vocab_size)
    torch.testing.assert_close(verify[:, valid], step[:, valid], rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(caches[0].k[:, :, :, :seq + 1], caches[1].k[:, :, :, :seq + 1])


@pytest.mark.parametrize("case", ["batch_of_two", "draft_layers", "gamma", "unmerged_lora"])
def test_refusals(setup, case):
    from grasp_any_region_tpu_torch.data.synthetic import synthetic_batch
    from grasp_any_region_tpu_torch.train import lora as tlora

    s = dict(setup)
    kw = dict(max_new_tokens=4, gamma=2, draft_layers=1)
    if case == "batch_of_two":
        s["tb"], _, s["tlens"] = synthetic_batch(s["cfg_t"], batch=2, grid=(1, 1),
                                                 device="cpu")
        match = "single-stream"
    elif case == "unmerged_lora":
        s["tparams"] = tlora.add_lora_params(
            s["tparams"], s["cfg_t"].text, tlora.LoRAConfig(rank=4, alpha=8.0),
            torch.Generator().manual_seed(0))
        match = "unmerged LoRA"
    elif case == "draft_layers":
        kw["draft_layers"], match = 3, "draft_layers"
    else:
        kw["gamma"], match = 0, "gamma"
    with pytest.raises(ValueError, match=match):
        run_port(s, **kw)


def test_runtime_refuses_sampling_and_batches():
    from grasp_any_region_tpu_torch.cli.runtime import GARRuntime
    from grasp_any_region_tpu_torch.data.builders import RegionSample

    rt = GARRuntime.load(None, "gar_tiny", random_init=True, device="cpu")
    rng = np.random.default_rng(3)
    m = np.zeros((100, 120), np.uint8)
    m[20:70, 30:90] = 1
    sample = RegionSample(rng.integers(0, 256, (100, 120, 3), dtype=np.uint8), {1: m})
    with pytest.raises(ValueError, match="temperature 0"):
        rt.caption([sample], max_new_tokens=2, temperature=0.7, speculative=(2, 1))
    with pytest.raises(ValueError, match="single-stream greedy"):
        rt.caption([sample, sample], max_new_tokens=2, speculative=(2, 1))
