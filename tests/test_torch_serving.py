"""Port parity: the two serving entry points, end to end.

The same weights (JAX init, converted through numpy) serve the same
prompts in both packages, fp32 on the CPU: greedy tokens must be
IDENTICAL -- ``init_inference(...).generate`` and a continuous-batching
``ServingEngine`` with more requests than slots and an EOS that frees a
slot early.  Temperature / top-k sampling in the serving engine is the
same host numpy sampler on both sides, so those streams are identical
too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.inference.serving import ServingEngine as JaxServing
from deepspeed_tpu.models.transformer import (
    CausalTransformerLM as JaxLM, TransformerConfig as JaxConfig)
from deepspeed_tpu_torch.inference.robustness import RequestRejected
from deepspeed_tpu_torch.inference.serving import ServingEngine
from deepspeed_tpu_torch.models.convert import from_jax_params
from deepspeed_tpu_torch.models.transformer import (CausalTransformerLM,
                                                    TransformerConfig)

KW = dict(hidden_size=64, n_heads=4, n_kv_heads=2)


@pytest.fixture(scope="module")
def tiny():
    jmodel = JaxLM(JaxConfig.tiny(**KW))
    params = jmodel.init(jax.random.key(0))
    np_params = jax.tree_util.tree_map(np.asarray, params)
    cfg = TransformerConfig.tiny(**KW)
    tmodel = CausalTransformerLM(cfg, device="cpu")
    tmodel.load_state_dict(from_jax_params(np_params, cfg))
    return cfg, jmodel, params, np_params, tmodel


def _prompts(cfg, lens, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, (n,)).tolist() for n in lens]


def test_generate_greedy_identical(tiny):
    cfg, jmodel, params, np_params, tmodel = tiny
    prompt = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 5))
    jeng = deepspeed_tpu.init_inference(model=jmodel,
                                        config={"dtype": "float32"},
                                        params=params)
    want = np.asarray(jeng.generate(prompt, max_new_tokens=8))
    teng = deepspeed_tpu_torch.init_inference(
        CausalTransformerLM(cfg, device="cpu"), config={"dtype": "float32"},
        params=from_jax_params(np_params, cfg), device="cpu")
    got = teng.generate(prompt, max_new_tokens=8)
    assert got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want)


def test_generate_eos_padding_matches_jax(tiny):
    cfg, jmodel, params, _, tmodel = tiny
    prompt = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 4))
    jeng = deepspeed_tpu.init_inference(model=jmodel,
                                        config={"dtype": "float32"},
                                        params=params)
    ref = np.array(jeng.generate(prompt, max_new_tokens=6))
    eos = int(ref[0, 5])
    # the JAX engine's own eos_token_id path writes into a read-only view
    # of its output (ValueError); apply its padding rule here instead:
    # every token after the first EOS becomes EOS
    want = ref.copy()
    for b in range(want.shape[0]):
        hits = np.where(want[b, 4:] == eos)[0]
        if hits.size:
            want[b, 4 + hits[0] + 1:] = eos
    teng = deepspeed_tpu_torch.init_inference(tmodel, dtype="fp32",
                                              device="cpu")
    got = teng.generate(prompt, max_new_tokens=6, eos_token_id=eos)
    np.testing.assert_array_equal(got.numpy(), want)


def _serve_both(tiny, prompts, max_batch, max_new, eos=None, **sampling):
    cfg, jmodel, params, _, tmodel = tiny
    jeng = JaxServing(jmodel, params, max_batch=max_batch, page_size=8,
                      max_seq=64, dtype=jnp.float32, eos_token_id=eos,
                      serving={"attention_backend": "jnp"})
    teng = ServingEngine(tmodel, max_batch=max_batch, page_size=8,
                         max_seq=64, dtype=torch.float32, eos_token_id=eos)
    want = jeng.generate(prompts, max_new_tokens=max_new, **sampling)
    got = teng.generate(prompts, max_new_tokens=max_new, **sampling)
    assert jeng.leak_report() == {}
    assert teng.leak_report() == {}
    return got, want, teng


def test_serving_identical_with_eos_through_two_slots(tiny):
    cfg = tiny[0]
    prompts = _prompts(cfg, (4, 9, 6, 12, 5, 7, 10, 3), seed=1)
    ref, _, _ = _serve_both(tiny, prompts, max_batch=2, max_new=6)
    # the second generated token of request 2 becomes EOS: request 2 (and
    # any other that emits it) must stop early and hand its slot over
    eos = ref[2][len(prompts[2]) + 1]
    got, want, teng = _serve_both(tiny, prompts, max_batch=2, max_new=6,
                                  eos=eos)
    assert got == want
    assert len(got[2]) == len(prompts[2]) + 2 and got[2][-1] == eos
    assert teng.n_active == 0 and not teng.queue
    assert len(teng.alloc.free) == teng.alloc.num_pages - 1
    assert teng.stats["finished"] == len(prompts)


def test_serving_temperature_sampling_identical(tiny):
    cfg = tiny[0]
    prompts = _prompts(cfg, (5, 11, 3), seed=2)
    got, want, _ = _serve_both(tiny, prompts, max_batch=4, max_new=6,
                               temperature=0.8, top_k=20, top_p=0.9)
    assert got == want


def test_create_serving_engine_and_config(tiny):
    cfg, _, _, _, tmodel = tiny
    teng = deepspeed_tpu_torch.init_inference(tmodel, dtype="fp32",
                                              device="cpu")
    se = teng.create_serving_engine(max_batch=2, page_size=8, max_seq=32)
    assert se.attention_backend == "auto" and se.max_pages_per_seq == 4
    se2 = deepspeed_tpu_torch.create_serving_engine(
        tmodel, {"serving": {"max_batch": 3, "page_size": 8, "max_seq": 32,
                             "attention_backend": "plain"}})
    assert se2.max_batch == 3 and se2.attention_backend == "plain"
    with pytest.raises(ValueError, match="attention_backend"):
        ServingEngine(tmodel, max_batch=1, page_size=8, max_seq=32,
                      serving={"attention_backend": "pallas"})
    with pytest.raises(RequestRejected, match="oversized"):
        se.add_request("big", list(range(30)), max_new_tokens=8)


# (serving.fault_injection specs build the engine's injector now:
# tests/test_torch_resilience.py)
@pytest.mark.parametrize("kwargs", [dict(tp_size=2), dict(ep_size=2)])
def test_unported_serving_features_raise(tiny, kwargs):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ServingEngine(tiny[4], max_batch=1, page_size=8, max_seq=32,
                      **kwargs)


def test_speculative_zero_drafts_is_off_as_in_the_code(tiny):
    """``num_draft_tokens: 0`` is the "speculation off" point (the JAX
    code's behaviour), so a monolithic engine accepts it."""
    se = ServingEngine(tiny[4], max_batch=1, page_size=8, max_seq=32,
                       serving={"scheduler": {"speculative": {
                           "enabled": True, "num_draft_tokens": 0}}})
    assert se.scheduler.policy == "monolithic"


# ------------------------------------------------------------ fp16 serving
# fp16 rounds at 2**-11 relative.  Two layers round their activations at
# about ten places each, and the two frameworks round at different ones,
# so per-step logits may differ by some tens of fp16 ulps of the largest
# logit: held to FP16_LOGIT_TOL * max|logit| (20 ulps of 2**-11).
FP16_LOGIT_TOL = 1e-2


@pytest.fixture(scope="module")
def tiny_fp16(tiny):
    cfg, jmodel, params, np_params, _ = tiny
    half = jax.tree_util.tree_map(lambda x: np.asarray(x, np.float16),
                                  np_params)
    tmodel = CausalTransformerLM(cfg, device="cpu", dtype=torch.float16)
    tmodel.load_state_dict(from_jax_params(half, cfg))
    return cfg, jmodel, jax.tree_util.tree_map(jnp.asarray, half), tmodel


def test_fp16_paged_logits_match_jax_per_step(tiny_fp16):
    """A bucketed prefill and four decode steps over fp16 page pools:
    every step's logits within FP16_LOGIT_TOL of the JAX model's, and the
    same argmax."""
    cfg, jmodel, jparams, tmodel = tiny_fp16
    B, T, page = 2, 8, 8
    rng = np.random.default_rng(3)
    ids = rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
    nxt = rng.integers(0, cfg.vocab_size, (4, B, 1)).astype(np.int32)
    tables = np.array([[1, 2, 0], [3, 4, 0]], np.int32)
    jc = jmodel.init_paged_caches(5, page, dtype=jnp.float16)
    tc = tmodel.init_paged_caches(5, page, dtype=torch.float16)
    jl = jnp.zeros(B, jnp.int32)
    tl = torch.zeros(B, dtype=torch.int32)
    tt = torch.as_tensor(tables)
    for step_ids in [ids] + list(nxt):
        jlog, jc, jl = jmodel.apply_with_paged_cache(
            jparams, jnp.asarray(step_ids), jc, jnp.asarray(tables), jl,
            attn_backend="jnp")
        tlog, tc, tl = tmodel.apply_with_paged_cache(
            torch.as_tensor(step_ids, dtype=torch.long), tc, tt, tl)
        want = np.asarray(jlog, np.float32)
        got = tlog.float().numpy()
        assert np.isfinite(got).all()
        err = np.abs(got - want).max()
        assert err <= FP16_LOGIT_TOL * np.abs(want).max(), err
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_fp16_serving_greedy_identical_to_jax(tiny_fp16):
    cfg, jmodel, jparams, tmodel = tiny_fp16
    prompts = _prompts(cfg, (4, 9, 6, 12, 5), seed=4)
    jeng = JaxServing(jmodel, jparams, max_batch=2, page_size=8, max_seq=64,
                      dtype=jnp.float16, serving={"attention_backend": "jnp"})
    teng = ServingEngine(tmodel, max_batch=2, page_size=8, max_seq=64,
                         dtype="fp16")
    assert teng.cache_dtype == torch.float16
    assert teng.generate(prompts, max_new_tokens=6) == \
        jeng.generate(prompts, max_new_tokens=6)
    assert teng.leak_report() == {}


def test_fp16_generate_greedy_identical_to_jax(tiny_fp16):
    cfg, jmodel, jparams, tmodel = tiny_fp16
    prompt = np.random.default_rng(6).integers(0, cfg.vocab_size, (2, 5))
    jeng = deepspeed_tpu.init_inference(model=jmodel,
                                        config={"dtype": "float16"},
                                        params=jparams)
    want = np.asarray(jeng.generate(prompt, max_new_tokens=6))
    teng = deepspeed_tpu_torch.init_inference(tmodel, dtype="fp16",
                                              device="cpu")
    np.testing.assert_array_equal(
        teng.generate(prompt, max_new_tokens=6).numpy(), want)
