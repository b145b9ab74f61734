"""Port parity: the transformer's serving forward and the weight converter.

JAX ``CausalTransformerLM`` params (perturbed with numpy noise so norm
weights and biases are not the trivial 1/0 of a fresh init) go through
``from_jax_params`` into the port's model; the logits of
``apply_with_cache`` (prefill then decode) and ``apply_with_paged_cache``
must match the JAX model's in fp32 within rtol=atol=1e-4 (matmul
summation order differs between the two frameworks across two layers).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models.transformer import (
    CausalTransformerLM as JaxLM, TransformerConfig as JaxConfig)
from deepspeed_tpu.ops.paged_attention import PagedAllocator as JaxAllocator
from deepspeed_tpu_torch.models.convert import (from_jax_params,
                                                to_numpy_params)
from deepspeed_tpu_torch.models.transformer import (CausalTransformerLM,
                                                    TransformerConfig)
from torch_threads import _one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-4, atol=1e-4)

CONFIGS = {
    # Llama-style: RoPE, RMSNorm, SwiGLU, GQA
    "llama_gqa": dict(hidden_size=64, n_heads=4, n_kv_heads=2),
    # GPT-style: learned positions, LayerNorm with bias, tanh-GELU,
    # linear biases, tied head
    "gpt": dict(hidden_size=64, n_heads=4, activation="gelu",
                use_rmsnorm=False, use_rope=False, norm_bias=True,
                use_bias=True, tie_embeddings=True),
    # partial rotary, untied head with a bias
    "partial_rope": dict(hidden_size=64, n_heads=4, rope_dim=8,
                         lm_head_bias=True),
}


def _models(name, seed=0):
    kw = CONFIGS[name]
    jcfg = JaxConfig.tiny(**kw)
    tcfg = TransformerConfig.tiny(**kw)
    jmodel = JaxLM(jcfg)
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda x: (np.asarray(x) + 0.05 * rng.standard_normal(x.shape))
        .astype(np.float32), jmodel.init(jax.random.key(seed)))
    tmodel = CausalTransformerLM(tcfg, device="cpu")
    state = from_jax_params(params, tcfg)
    tmodel.load_state_dict(state, strict=True)
    return jcfg, jmodel, jax.tree_util.tree_map(jnp.asarray, params), tmodel


@pytest.mark.parametrize("name", list(CONFIGS))
def test_apply_with_cache_matches_jax(name):
    cfg, jmodel, params, tmodel = _models(name)
    rng = np.random.default_rng(1)
    B, T, steps = 2, 6, 3
    ids = rng.integers(0, cfg.vocab_size, (B, T))
    nxt = rng.integers(0, cfg.vocab_size, (steps, B, 1))
    jc = jmodel.init_caches(B, T + steps, jnp.float32)
    tc = tmodel.init_caches(B, T + steps, torch.float32)
    for step_ids in [ids] + list(nxt):
        jl, jc = jmodel.apply_with_cache(params, jnp.asarray(step_ids), jc)
        tl, tc = tmodel.apply_with_cache(torch.from_numpy(step_ids), tc)
        assert tl.dtype == torch.float32
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert tc.length == int(jc.length)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_apply_with_paged_cache_matches_jax(name):
    cfg, jmodel, params, tmodel = _models(name)
    page, n_pages = 4, 16
    rng = np.random.default_rng(2)
    alloc = JaxAllocator(n_pages, page, max_pages_per_seq=4,
                         reserve_scratch=True)
    alloc.allocate(0, 13)
    alloc.allocate(1, 9)
    tables = np.zeros((3, 5), np.int32)       # row 2: an inactive slot
    tables[:2, :4] = alloc.block_table([0, 1])
    ids = rng.integers(0, cfg.vocab_size, (3, 8))
    jc = jmodel.init_paged_caches(n_pages, page, jnp.float32)
    tc = tmodel.init_paged_caches(n_pages, page, torch.float32)
    jlen = jnp.zeros(3, jnp.int32)
    tlen = torch.zeros(3, dtype=torch.int32)
    # bucket-padded prefill (T=8) then two decode steps
    for step_ids in [ids, ids[:, :1], ids[:, 1:2]]:
        if step_ids.shape[1] == 1:
            jlen = jlen.at[2].set(0)
            tlen[2] = 0
        jl, jc, jlen = jmodel.apply_with_paged_cache(
            params, jnp.asarray(step_ids), jc, jnp.asarray(tables), jlen,
            attn_backend="jnp")
        tl, tc, tlen = tmodel.apply_with_paged_cache(
            torch.from_numpy(step_ids), tc, torch.from_numpy(tables), tlen)
        # rows 0-1 are live; row 2 is the scratch slot whose output the
        # engine discards
        np.testing.assert_allclose(tl.numpy()[:2], np.asarray(jl)[:2], **TOL)
        np.testing.assert_array_equal(tlen.numpy(), np.asarray(jlen))


def test_config_fields_and_presets_match_jax():
    assert [f.name for f in dataclasses.fields(TransformerConfig)] == \
        [f.name for f in dataclasses.fields(JaxConfig)]
    for preset in ("tiny", "gpt2_125m", "gpt2_1_5b", "moe_tiny",
                   "llama2_7b", "llama2_70b"):
        ours = dataclasses.asdict(getattr(TransformerConfig, preset)())
        theirs = dataclasses.asdict(getattr(JaxConfig, preset)())
        assert ours == theirs, preset
    c = TransformerConfig.llama2_7b()
    assert (c.hidden_size, c.n_heads, c.head_dim, c.ffn_dim, c.vocab_size,
            c.n_layers) == (4096, 32, 128, 11008, 32000, 32)


def test_llama2_7b_parameter_count_on_meta():
    model = CausalTransformerLM(TransformerConfig.llama2_7b(),
                                device="meta", dtype=torch.bfloat16)
    n = sum(p.numel() for p in model.parameters())
    assert n == JaxConfig.llama2_7b().num_params()


def test_converter_keeps_in_out_orientation():
    cfg, _, params, tmodel = _models("llama_gqa")
    wq = np.asarray(params["layers"]["wq"][1])
    assert tuple(tmodel.layers[1].wq.shape) == wq.shape == (64, 64)
    np.testing.assert_array_equal(tmodel.layers[1].wq.detach().numpy(), wq)
    assert tuple(tmodel.layers[0].wk.shape) == (64, 32)


def test_init_distributions():
    model = CausalTransformerLM(TransformerConfig.tiny(use_bias=True),
                                device="cpu").init(seed=3)
    layer = model.layers[0]
    assert layer.attn_norm.eq(1).all() and layer.wq_b.eq(0).all()
    # normal / sqrt(fan_in): std of wq ~ 1/sqrt(64)
    assert abs(layer.wq.std().item() - 1 / 8) < 0.02
    again = CausalTransformerLM(TransformerConfig.tiny(use_bias=True),
                                device="cpu").init(seed=3)
    assert torch.equal(again.layers[0].wq, layer.wq)


@pytest.mark.parametrize("kw", [dict(parallel_block=True), dict(qk_norm="rms"),
                                dict(attn_logit_softcap=30.0),
                                dict(moe_num_experts=4)])
def test_unported_features_raise(kw):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        CausalTransformerLM(TransformerConfig.tiny(**kw), device="cpu")


# the training-only switches: BLOOM-style (ALiBi, embedding LayerNorm, no
# position table) and GPT-Neo-style (alternating global / local windows)
BIASED = {
    "bloom": dict(hidden_size=64, n_heads=4, activation="gelu",
                  use_rmsnorm=False, use_rope=False, use_alibi=True,
                  embed_norm=True, use_bias=True, norm_bias=True,
                  tie_embeddings=True),
    "gpt_neo": dict(hidden_size=64, n_heads=4, activation="gelu",
                    use_rmsnorm=False, use_rope=False, use_bias=True,
                    norm_bias=True, tie_embeddings=True, attn_scale=1.0,
                    local_attn_pattern=(0, 8)),
    "embed_norm_rope": dict(hidden_size=64, n_heads=4, n_kv_heads=2,
                            embed_norm=True),
}


@pytest.mark.parametrize("name", list(BIASED))
def test_biased_configs_round_trip(name):
    """``from_jax_params`` takes the JAX params of every biased config
    (``embed_norm``/``embed_norm_b`` present, ``pos_embed`` absent under
    ALiBi) and ``to_numpy_params`` gives them back bit for bit."""
    jcfg, tcfg = JaxConfig.tiny(**BIASED[name]), \
        TransformerConfig.tiny(**BIASED[name])
    rng = np.random.default_rng(4)
    params = jax.tree_util.tree_map(
        lambda x: (np.asarray(x) + 0.05 * rng.standard_normal(x.shape))
        .astype(np.float32), JaxLM(jcfg).init(jax.random.key(4)))
    model = CausalTransformerLM(tcfg, device="cpu")
    model.load_state_dict(from_jax_params(params, tcfg), strict=True)
    back = to_numpy_params(model)
    assert set(back) == set(params)
    assert ("pos_embed" in back) == (not tcfg.use_alibi and
                                     not tcfg.use_rope)
    assert ("embed_norm_b" in back) == (tcfg.embed_norm and tcfg.norm_bias)
    for key in set(params) - {"layers"}:
        np.testing.assert_array_equal(back[key], params[key], err_msg=key)
    assert set(back["layers"]) == set(params["layers"])
    for key, val in params["layers"].items():
        np.testing.assert_array_equal(back["layers"][key], val,
                                      err_msg=key)
    n = sum(p.numel() for p in model.parameters())
    biases = sum(p.numel() for name_, p in model.named_parameters()
                 if name_.endswith("_b"))
    assert n - biases == JaxConfig.tiny(**BIASED[name]).num_params()


@pytest.mark.parametrize("name", list(BIASED))
def test_biased_models_do_not_serve(name):
    """ALiBi, windows and the embedding norm train but do not decode yet:
    the cache paths and both serving entry points raise at construction,
    naming the ROADMAP item."""
    import deepspeed_tpu_torch
    cfg = TransformerConfig.tiny(**BIASED[name])
    model = CausalTransformerLM(cfg, device="cpu").init(0)
    for call in (lambda: model.init_caches(1, 8, torch.float32),
                 lambda: model.init_paged_caches(4, 4, torch.float32),
                 lambda: deepspeed_tpu_torch.init_inference(model,
                                                            device="cpu"),
                 lambda: deepspeed_tpu_torch.create_serving_engine(
                     model, max_batch=1, page_size=4, max_seq=8)):
        with pytest.raises(NotImplementedError, match="ROADMAP A18"):
            call()
