"""Port parity of the training path: model loss/grads and the engine.

* Model: ``CausalTransformerLM.apply`` logits and ``loss`` with every
  parameter gradient against the JAX model's ``apply``/``loss`` and
  ``jax.grad``, fp32, on a Llama-style GQA config, a GPT-style one, a
  BLOOM-style one (ALiBi, embedding norm) and a GPT-Neo-style one (global
  and local layers), with remat on and off and the dense and chunked
  losses.  Tolerance rtol = atol = 1e-4: the same numbers, summed in other
  orders (the port runs attention through the flash path's plain
  versions; the JAX model through ``reference_attention``, or for the
  biased configs through its biased Pallas kernels in interpret mode).
* Engine: ``deepspeed_tpu_torch.initialize(...).train_batch`` against
  ``deepspeed_tpu.initialize(...).train_batch`` on the same config and
  numpy batches, three steps: per-step losses and grad norms (rtol 1e-4)
  and the final fp32 parameters (atol 2e-5 + rtol 1e-4: AdamW moves each
  parameter by about lr = 1e-3 per step, so this is 2% of one step).
  The harness gives JAX 8 virtual CPU devices; the JAX engine gets 1
  sequence per device, so its global micro-batch is 8 and the port is
  given that micro-batch of 8 on its one device.
* ``forward``/``backward``/``step`` leaves the same state as
  ``train_batch`` and, at gas 3, the same as the JAX engine's three
  calls; unported config blocks raise naming their item.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models.transformer import (
    CausalTransformerLM as JaxLM, TransformerConfig as JaxConfig)
from deepspeed_tpu_torch.models.convert import (from_jax_params,
                                                to_numpy_params)
from deepspeed_tpu_torch.models.transformer import (CausalTransformerLM,
                                                    TransformerConfig)

TOL = dict(rtol=1e-4, atol=1e-4)

CONFIGS = {
    # Llama-style: RoPE, RMSNorm, SwiGLU, GQA
    "llama_gqa": dict(hidden_size=64, n_heads=4, n_kv_heads=2),
    # GPT-style: learned positions, LayerNorm with bias, tanh-GELU, tied
    "gpt": dict(hidden_size=64, n_heads=4, activation="gelu",
                use_rmsnorm=False, use_rope=False, norm_bias=True,
                tie_embeddings=True),
    # BLOOM-style: ALiBi (no position table), embedding LayerNorm, biases;
    # the JAX model runs its biased flash kernels in interpret mode
    # (attn_impl "pallas", blocks of 8: the window skips whole blocks)
    "bloom": dict(hidden_size=64, n_heads=4, activation="gelu",
                  use_rmsnorm=False, use_rope=False, use_alibi=True,
                  embed_norm=True, use_bias=True, norm_bias=True,
                  tie_embeddings=True, attn_impl="pallas", attn_block_q=8,
                  attn_block_k=8),
    # GPT-Neo-style: global / local (window 8) layers, unscaled logits
    "gpt_neo": dict(hidden_size=64, n_heads=4, activation="gelu",
                    use_rmsnorm=False, use_rope=False, use_bias=True,
                    norm_bias=True, tie_embeddings=True, attn_scale=1.0,
                    local_attn_pattern=(0, 8), attn_impl="pallas",
                    attn_block_q=8, attn_block_k=8),
}
# (remat, loss_chunk_size): dense loss, chunked (chunk < B*S), remat'd
LOSS_MODES = {"dense": (False, 0), "chunked": (False, 10),
              "remat_chunked": (True, 10)}


def _params(jcfg, seed=0):
    """JAX init perturbed with numpy noise (norm weights and biases away
    from the trivial 1 / 0), numpy leaves."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: (np.asarray(x) + 0.05 * rng.standard_normal(x.shape))
        .astype(np.float32), JaxLM(jcfg).init(jax.random.key(seed)))


def _port_model(tcfg, params):
    model = CausalTransformerLM(tcfg, device="cpu")
    model.load_state_dict(from_jax_params(params, tcfg), strict=True)
    return model


def _ids(shape, seed=1, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, shape)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_apply_logits_match_jax(name):
    kw = CONFIGS[name]
    jcfg, tcfg = JaxConfig.tiny(**kw), TransformerConfig.tiny(**kw)
    params = _params(jcfg)
    ids = _ids((2, 24))
    want = JaxLM(jcfg).apply(jax.tree_util.tree_map(jnp.asarray, params),
                             jnp.asarray(ids))
    with torch.no_grad():
        got = _port_model(tcfg, params).apply(torch.as_tensor(ids))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("mode", list(LOSS_MODES))
@pytest.mark.parametrize("name", list(CONFIGS))
def test_loss_and_grads_match_jax(name, mode):
    remat, chunk = LOSS_MODES[mode]
    kw = dict(CONFIGS[name], remat=remat, loss_chunk_size=chunk)
    jcfg, tcfg = JaxConfig.tiny(**kw), TransformerConfig.tiny(**kw)
    params = _params(jcfg)
    ids = _ids((2, 24))
    jloss, jgrads = jax.value_and_grad(JaxLM(jcfg).loss)(
        jax.tree_util.tree_map(jnp.asarray, params),
        {"input_ids": jnp.asarray(ids)})
    model = _port_model(tcfg, params)
    loss = model.loss({"input_ids": torch.as_tensor(ids)})
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), **TOL)
    got = to_numpy_params({n: p.grad for n, p in model.named_parameters()})
    want = jax.tree_util.tree_map(np.asarray, jgrads)
    assert set(got) == set(want)
    assert set(got["layers"]) == set(want["layers"])
    for key in got["layers"]:
        np.testing.assert_allclose(got["layers"][key], want["layers"][key],
                                   err_msg=key, **TOL)
    for key in set(got) - {"layers"}:
        np.testing.assert_allclose(got[key], want[key], err_msg=key, **TOL)


# ---------------------------------------------------------------- engine
JAX_DEVICES = 8          # the harness's virtual CPU devices
GAS, SEQ, STEPS = 2, 16, 3


def _engine_config(micro, clip, gas=GAS):
    cfg = {"train_micro_batch_size_per_gpu": micro,
           "gradient_accumulation_steps": gas,
           "optimizer": {"type": "AdamW",
                         "params": {"lr": 1e-3, "weight_decay": 0.01}}}
    if clip:
        cfg["gradient_clipping"] = clip
    return cfg


def _batches(gas=GAS):
    rng = np.random.default_rng(5)
    return [{"input_ids": rng.integers(0, 256, (gas, JAX_DEVICES, SEQ))}
            for _ in range(STEPS)]


# final-parameter atol where 2e-5 (2% of one AdamW step) is too tight: in
# the GPT-Neo-style config (unscaled logits, window 8) some weights get a
# first gradient near Adam's eps (1e-8; e.g. -1.4e-8 in w_up, median
# 2.5e-3), and the first step lr * g / (|g| + eps) turns that gradient's
# rounding noise into ~5% of a step; losses and grad norms still match to
# 1e-4 at every step
PARAM_ATOL = {"gpt_neo": 1e-4}


# gas 3 as well: a count that is not a power of two
@pytest.mark.parametrize("name,clip,gas", [
    pytest.param("llama_gqa", 0.0, GAS, id="llama_gqa-0.0"),
    pytest.param("gpt", 0.5, GAS, id="gpt-0.5"),
    pytest.param("gpt", 0.0, 3, id="gpt-0.0-gas3"),
    pytest.param("bloom", 0.0, GAS, id="bloom-0.0"),
    pytest.param("gpt_neo", 0.0, GAS, id="gpt_neo-0.0")])
def test_engine_trajectory_matches_jax(name, clip, gas):
    assert jax.device_count() == JAX_DEVICES
    jcfg = JaxConfig.tiny(**CONFIGS[name])
    tcfg = TransformerConfig.tiny(**CONFIGS[name])
    params = _params(jcfg)
    batches = _batches(gas)

    jeng, *_ = deepspeed_tpu.initialize(
        model=JaxLM(jcfg), model_parameters=params,
        config=_engine_config(1, clip, gas))
    teng, opt, loader, sched = deepspeed_tpu_torch.initialize(
        model=CausalTransformerLM(tcfg, device="cpu"),
        model_parameters=params,
        config=_engine_config(JAX_DEVICES, clip, gas), device="cpu")
    assert opt is teng.optimizer and loader is None
    assert sched is teng.lr_scheduler   # the JAX engine returns its own too
    for step, batch in enumerate(batches):
        jloss = float(jeng.train_batch(batch=batch))
        tloss = float(teng.train_batch(batch=batch))
        np.testing.assert_allclose(tloss, jloss, rtol=1e-4,
                                   err_msg=f"loss, step {step}")
        np.testing.assert_allclose(teng.get_global_grad_norm(),
                                   jeng.get_global_grad_norm(), rtol=1e-4,
                                   err_msg=f"grad norm, step {step}")
        if clip:
            assert teng.get_global_grad_norm() > clip   # clipping acts
    assert teng.global_steps == jeng.global_steps == STEPS
    got = to_numpy_params(teng.module_state_dict())
    want = jax.tree_util.tree_map(np.asarray,
                                  jax.device_get(jeng.state.params))
    for key in got["layers"]:
        if key == "wk_b":
            # the softmax is invariant to one shift of every key, so the
            # key bias's true gradient is 0 and each side's is rounding
            # noise, which Adam turns into steps of up to ~lr: only that
            # bound is shared (lr 1e-3; 1.5x for Adam's later steps)
            for side in (got, want):
                moved = np.abs(side["layers"][key] - params["layers"][key])
                assert moved.max() <= 1.5e-3 * STEPS, key
            continue
        np.testing.assert_allclose(got["layers"][key], want["layers"][key],
                                   rtol=1e-4, atol=PARAM_ATOL.get(name, 2e-5),
                                   err_msg=key)
    for key in set(got) - {"layers"}:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4,
                                   atol=PARAM_ATOL.get(name, 2e-5),
                                   err_msg=key)


def test_three_call_api_matches_train_batch():
    tcfg = TransformerConfig.tiny(**CONFIGS["gpt"])
    params = _params(JaxConfig.tiny(**CONFIGS["gpt"]))
    cfg = _engine_config(4, 0.5)
    engines = [deepspeed_tpu_torch.initialize(
        model=CausalTransformerLM(tcfg, device="cpu"),
        model_parameters=params, config=cfg, device="cpu")[0]
        for _ in range(2)]
    fused, three = engines
    rng = np.random.default_rng(7)
    for _ in range(2):
        batch = rng.integers(0, 256, (GAS, 4, SEQ))
        want = float(fused.train_batch(batch={"input_ids": batch}))
        losses = []
        for i in range(GAS):
            assert not three.is_gradient_accumulation_boundary()
            loss = three.forward({"input_ids": batch[i]})
            three.backward(loss)
            three.step()
            losses.append(float(loss.detach()))
            assert three.was_step_applied() == (i == GAS - 1)
        assert np.mean(losses) == pytest.approx(want, rel=1e-6)
        assert three.get_global_grad_norm() == fused.get_global_grad_norm()
    assert three.global_steps == fused.global_steps == 2
    assert torch.equal(three.master, fused.master)
    assert torch.equal(three.opt_state.m, fused.opt_state.m)
    for p3, pf in zip(three.module.parameters(), fused.module.parameters()):
        assert torch.equal(p3, pf)


def test_three_call_api_matches_jax_at_gas3():
    gas = 3
    jcfg = JaxConfig.tiny(**CONFIGS["gpt"])
    tcfg = TransformerConfig.tiny(**CONFIGS["gpt"])
    params = _params(jcfg)
    jeng, *_ = deepspeed_tpu.initialize(
        model=JaxLM(jcfg), model_parameters=params,
        config=_engine_config(1, 0.5, gas))
    teng, *_ = deepspeed_tpu_torch.initialize(
        model=CausalTransformerLM(tcfg, device="cpu"),
        model_parameters=params,
        config=_engine_config(JAX_DEVICES, 0.5, gas), device="cpu")
    for step, batch in enumerate(_batches(gas)[:2]):
        for i in range(gas):
            mb = {"input_ids": batch["input_ids"][i]}
            jloss = jeng.forward(mb)
            jeng.backward(jloss)
            jeng.step()
            tloss = teng.forward(mb)
            teng.backward(tloss)
            teng.step()
            np.testing.assert_allclose(float(tloss.detach()), float(jloss),
                                       rtol=1e-4, err_msg=f"step {step}")
            assert teng.was_step_applied() == jeng.was_step_applied() == \
                (i == gas - 1)
        np.testing.assert_allclose(teng.get_global_grad_norm(),
                                   jeng.get_global_grad_norm(), rtol=1e-4)
    got = to_numpy_params(teng.module_state_dict())
    want = jax.tree_util.tree_map(np.asarray,
                                  jax.device_get(jeng.state.params))
    for key in got["layers"]:
        np.testing.assert_allclose(got["layers"][key], want["layers"][key],
                                   rtol=1e-4, atol=2e-5, err_msg=key)
    for key in set(got) - {"layers"}:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4,
                                   atol=2e-5, err_msg=key)


# fp16 and the scheduler block train now; what of them is still unported
# raises: fp16 master weights and grads, bf16 moments under a schedule, and
# a client optimizer (the last column: initialize's other arguments)
@pytest.mark.parametrize("block,item,client", [
    ({"fp16": {"enabled": True, "fp16_master_weights_and_grads": True}},
     "A7", {}),
    ({"scheduler": {"type": "WarmupLR", "params": {}}}, "A7",
     {"optimizer": torch.optim.SGD}),
    ({"zero_optimization": {"stage": 2,
                            "offload_optimizer": {"device": "cpu"}}}, "A12",
     {}),
    ({"optimizer": {"type": "AdamW",
                    "params": {"moment_dtype": "bfloat16"}}}, "A7", {}),
    ({"optimizer": {"type": "Lamb", "params": {}}}, "A7", {}),
    ({"data_types": {"grad_accum_dtype": "bf16"}}, "A7", {}),
])
def test_unported_blocks_raise(block, item, client):
    cfg = {"train_micro_batch_size_per_gpu": 1, **block}
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        deepspeed_tpu_torch.initialize(
            model=CausalTransformerLM(TransformerConfig.tiny(),
                                      device="cpu").init(0),
            config=cfg, device="cpu", **client)


def test_unported_engine_methods_raise():
    """What the engine still cannot run raises: ``train_batch()`` with no
    batch, iterator or ``training_data`` (the JAX engine asserts), and the
    client-state broadcast over ranks (ROADMAP A8)."""
    eng, *_ = deepspeed_tpu_torch.initialize(
        model=CausalTransformerLM(TransformerConfig.tiny(),
                                  device="cpu").init(0),
        config={"train_batch_size": 2}, device="cpu")
    assert (eng.train_batch_size(), eng.train_micro_batch_size_per_gpu(),
            eng.gradient_accumulation_steps()) == (2, 2, 1)
    assert eng.get_lr() == [1e-3]
    with pytest.raises(ValueError, match="training_data"):
        eng.train_batch()
    from deepspeed_tpu_torch.runtime import checkpoint_engine
    cs = {"global_steps": 3}
    assert checkpoint_engine.broadcast_client_state(cs) is cs


def test_benchmark_builds_the_jax_benchmark_shapes():
    from deepspeed_tpu.benchmarks.training import MODELS as JAX_MODELS
    from deepspeed_tpu_torch.benchmarks.training import (MODELS,
                                                         model_config,
                                                         run_benchmark)
    assert MODELS == JAX_MODELS
    cfg = model_config("gpt_1b", 1024)
    want = JaxConfig(max_seq_len=1024, remat=True,
                     remat_policy="dots_saveable", activation="gelu",
                     use_rmsnorm=False, use_rope=False, tie_embeddings=True,
                     vocab_size=50304, **JAX_MODELS["gpt_1b"])
    assert cfg.num_params() == want.num_params() == 1_011_165_184
    out = run_benchmark(dict(hidden_size=64, n_layers=2, n_heads=4),
                        batch=2, gas=2, seq=16, steps=2, vocab_size=256,
                        dtype="bf16", device="cpu")
    assert len(out["losses"]) == 3 and np.isfinite(out["losses"]).all()
    assert out["mfu"] is None            # no MFU for a run off the card
    assert out["tokens_per_sec"] > 0 and out["n_params"] > 0
