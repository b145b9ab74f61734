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
from torch_threads import _one_torch_thread  # noqa: F401

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
    # GPT-style at head dim 64 (2 heads of 64), the head dim of gpt2_125m,
    # gpt_350m (ds_bench train's default) and gpt2_1_5b
    "gpt_d64": dict(hidden_size=128, n_heads=2, activation="gelu",
                    use_rmsnorm=False, use_rope=False, norm_bias=True,
                    tie_embeddings=True),
    # the same at head dims 80 (gpt_2_7b's) and 96 (gpt_760m's)
    "gpt_d80": dict(hidden_size=160, n_heads=2, activation="gelu",
                    use_rmsnorm=False, use_rope=False, norm_bias=True,
                    tie_embeddings=True),
    "gpt_d96": dict(hidden_size=192, n_heads=2, activation="gelu",
                    use_rmsnorm=False, use_rope=False, norm_bias=True,
                    tie_embeddings=True),
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
# the same cause at head dims 80 and 96 (hidden 160 and 192: more weights,
# so more of them meet it; and in the Gemma-wired model of
# test_embed_scale_matches_jax, 2 heads of 256): a handful of weights get a first gradient of
# 1e-9 to 1e-8 (Adam's eps; the median is ~1e-3), whose first step lr * g
# / (|g| + eps) is then a fraction of lr fixed by rounding noise.  Weights
# whose first gradient (the port's) is under this floor are held to
# Adam's step bound, as the key bias is; every other weight keeps the
# limits above
FIRST_GRAD_FLOOR = {"gpt_d80": 1e-7, "gpt_d96": 1e-7, "gemma": 1e-7}


# gas 3 as well: a count that is not a power of two
@pytest.mark.parametrize("name,clip,gas", [
    pytest.param("llama_gqa", 0.0, GAS, id="llama_gqa-0.0"),
    pytest.param("gpt", 0.5, GAS, id="gpt-0.5"),
    pytest.param("gpt", 0.0, 3, id="gpt-0.0-gas3"),
    pytest.param("bloom", 0.0, GAS, id="bloom-0.0"),
    pytest.param("gpt_neo", 0.0, GAS, id="gpt_neo-0.0"),
    pytest.param("gpt_d64", 0.0, GAS, id="gpt_d64-0.0"),
    pytest.param("gpt_d80", 0.0, GAS, id="gpt_d80-0.0"),
    pytest.param("gpt_d96", 0.0, GAS, id="gpt_d96-0.0")])
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
    first_grads = None
    for step, batch in enumerate(batches):
        jloss = float(jeng.train_batch(batch=batch))
        tloss = float(teng.train_batch(batch=batch))
        if step == 0:        # m after one step is (1 - beta1) * gradient
            named = list(teng.module.named_parameters())
            first_grads = to_numpy_params({
                n: (m / (1 - 0.9)).view(p.shape) for (n, p), m in zip(
                    named, teng.opt_state.m.split([p.numel()
                                                   for _, p in named]))})
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
    floor = FIRST_GRAD_FLOOR.get(name, 0.0)

    def close(g, w, init, g1, key):
        # weights under the first-gradient floor: Adam's step bound only
        # (lr 1e-3; 1.5x for Adam's later steps), on each side
        noise = np.abs(g1) < floor
        for side in (g, w):
            assert np.abs(side - init)[noise].max(initial=0.0) <= \
                1.5e-3 * STEPS, key
        np.testing.assert_allclose(g[~noise], w[~noise], rtol=1e-4,
                                   atol=PARAM_ATOL.get(name, 2e-5),
                                   err_msg=key)

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
        close(got["layers"][key], want["layers"][key], params["layers"][key],
              first_grads["layers"][key], key)
    for key in set(got) - {"layers"}:
        close(got[key], want[key], params[key], first_grads[key], key)


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


# what the training config still cannot run raises: a mesh wider than one
# rank (the last column: initialize's other arguments).  fp16 master
# weights, bf16 moments and gradients, every other optimizer and client
# optimizers train since ROADMAP A6 / A7 (tests/test_torch_optimizers.py,
# test_torch_moment_dtype.py, test_torch_activation_checkpointing.py);
# optimizer offload, cpuadam and cpu_checkpointing since A12's first part
# (tests/test_torch_offload.py); parameter offload (the legacy key too)
# and the memory block since A12b (test_blocks_once_refused_now_train,
# tests/test_torch_param_stream.py)
@pytest.mark.parametrize("block,item,client", [
    ({"mesh": {"fsdp": 2}}, "A8", {}),
])
def test_unported_blocks_raise(block, item, client):
    cfg = {"train_micro_batch_size_per_gpu": 1, **block}
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        deepspeed_tpu_torch.initialize(
            model=CausalTransformerLM(TransformerConfig.tiny(),
                                      device="cpu").init(0),
            config=cfg, device="cpu", **client)


# the three blocks test_unported_blocks_raise held to a raise until the
# parameter stream (ROADMAP A12b): each engine now builds and trains
@pytest.mark.parametrize("block,stream,client", [
    ({"zero_optimization": {"stage": 2,
                            "offload_param": {"device": "cpu"}}}, True, {}),
    ({"memory": {"placement_policy": "nvme", "nvme_dir": "d"}}, False,
     {"optimizer": torch.optim.SGD}),
    ({"zero_optimization": {"stage": 2, "cpu_offload_param": True}}, True,
     {}),
])
def test_blocks_once_refused_now_train(block, stream, client):
    cfg = {"train_micro_batch_size_per_gpu": 1, **block}
    eng, *_ = deepspeed_tpu_torch.initialize(
        model=CausalTransformerLM(TransformerConfig.tiny(),
                                  device="cpu").init(0),
        config=cfg, device="cpu", **client)
    assert (eng._param_stream is not None) == stream
    ids = {"input_ids": np.random.default_rng(0).integers(0, 256, (1, 8))}
    losses = [float(eng.train_batch(batch=ids)) for _ in range(2)]
    assert np.isfinite(losses).all() and losses[1] < losses[0]


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


@pytest.mark.parametrize("name,head_dim,n_params", [
    ("gpt_760m", 96, 758_392_320), ("gpt_2_7b", 80, 2_648_148_480)])
def test_benchmark_models_at_head_dims_96_and_80(name, head_dim, n_params):
    """gpt_760m (16 heads of 96) and gpt_2_7b (32 heads of 80) -- the CLI
    models the flash kernels' D=96 and D=80 forms train -- have the JAX
    benchmark's shapes and parameter counts."""
    from deepspeed_tpu.benchmarks.training import MODELS as JAX_MODELS
    from deepspeed_tpu_torch.benchmarks.training import model_config
    cfg = model_config(name, 1024)
    want = JaxConfig(max_seq_len=1024, remat=True,
                     remat_policy="dots_saveable", activation="gelu",
                     use_rmsnorm=False, use_rope=False, tie_embeddings=True,
                     vocab_size=50304, **JAX_MODELS[name])
    assert cfg.head_dim == want.head_dim == head_dim
    assert cfg.num_params() == want.num_params() == n_params


def test_benchmark_runs_the_cli_default_shape_on_the_cpu():
    """``ds_bench train``'s default model (gpt_350m: 1024 wide, 16 heads
    of 64) at run_benchmark's defaults (bf16, ZeRO 3, AdamW), cut to 2
    layers and a short sequence, on the CPU: the plain versions train head
    dim 64."""
    import inspect
    from deepspeed_tpu_torch.benchmarks import training as bench
    defaults = {k: v.default for k, v in
                inspect.signature(bench.run_benchmark).parameters.items()}
    assert (defaults["model"], defaults["batch"], defaults["gas"],
            defaults["seq"]) == ("gpt_350m", 8, 1, 1024)
    shape = dict(bench.MODELS[defaults["model"]], n_layers=2)
    cfg = bench.model_config(shape, 32)
    assert (cfg.hidden_size, cfg.n_heads, cfg.head_dim) == (1024, 16, 64)
    out = bench.run_benchmark(shape, batch=2, seq=32, steps=2,
                              vocab_size=512, device="cpu")
    assert out["n_layers"] == 2 and out["dtype"] == "bf16"
    assert out["zero_stage"] == 3 and out["gas"] == 1
    assert len(out["losses"]) == 3 and np.isfinite(out["losses"]).all()
    assert out["tokens_per_sec"] > 0


# Gemma's wiring at a tiny width (as ``GemmaPolicy.build`` maps it): 2
# heads of 256 over 1 kv head (H * dh != d), GeGLU, the input embedding
# scaled by sqrt(d), tied head
GEMMA_TINY = dict(hidden_size=64, n_heads=2, n_kv_heads=1,
                  head_dim_override=256, ffn_hidden_size=128,
                  activation="gelu", gated_mlp=True, embed_scale=64 ** 0.5,
                  norm_eps=1e-6, tie_embeddings=True)


def test_embed_scale_matches_jax():
    """Gemma's embedding scale: sqrt(d) rounded to the activation dtype
    before the product (55.5 in bf16 at d = 3072, 55.4375 in fp16), so
    the port's bf16 ``_embed`` equals the JAX model's embedding step bit
    for bit -- where the fp32 scale would not -- and the tied head still
    reads the unscaled table.  Then one fp32 training step of a tiny
    Gemma-wired model on the CPU against the JAX engine: loss and grad
    norm rtol 1e-4, parameters atol 2e-5 + rtol 1e-4."""
    d = 3072
    assert float(torch.tensor(d ** 0.5, dtype=torch.bfloat16)) == 55.5
    assert float(torch.tensor(d ** 0.5, dtype=torch.float16)) == 55.4375
    kw = dict(hidden_size=d, n_layers=1, n_heads=1, head_dim_override=64,
              ffn_hidden_size=64, activation="gelu", gated_mlp=True,
              embed_scale=d ** 0.5, tie_embeddings=True)
    jcfg, tcfg = JaxConfig.tiny(**kw), TransformerConfig.tiny(**kw)
    table = np.random.default_rng(3).standard_normal(
        (tcfg.vocab_size, d)).astype(np.float32)
    ids = _ids((2, 7))
    x = jnp.asarray(table, jnp.bfloat16)[jnp.asarray(ids)]
    want = np.asarray((x * jnp.asarray(jcfg.embed_scale, x.dtype))
                      .astype(jnp.float32))
    model = CausalTransformerLM(tcfg, device="cpu", dtype=torch.bfloat16)
    with torch.no_grad():
        model.tok_embed.copy_(torch.from_numpy(table))
    table_bf16 = model.tok_embed.detach().clone()
    with torch.no_grad():
        got = model._embed(torch.as_tensor(ids), None).float().numpy()
    np.testing.assert_array_equal(got, want)
    fp32_scale = (table_bf16[torch.as_tensor(ids)].float() * d ** 0.5).to(
        torch.bfloat16).float().numpy()
    assert (fp32_scale != want).any()      # the rounding is the point
    assert torch.equal(model.tok_embed, table_bf16)
    assert torch.equal(model._head(), table_bf16.T)

    jcfg, tcfg = JaxConfig.tiny(**GEMMA_TINY), TransformerConfig.tiny(
        **GEMMA_TINY)
    assert tcfg.head_dim == 256 and tcfg.gated
    params = _params(jcfg)
    batch = _batches()[0]
    jeng, *_ = deepspeed_tpu.initialize(
        model=JaxLM(jcfg), model_parameters=params,
        config=_engine_config(1, 0.0))
    teng, *_ = deepspeed_tpu_torch.initialize(
        model=CausalTransformerLM(tcfg, device="cpu"),
        model_parameters=params, config=_engine_config(JAX_DEVICES, 0.0),
        device="cpu")
    np.testing.assert_allclose(float(teng.train_batch(batch=batch)),
                               float(jeng.train_batch(batch=batch)),
                               rtol=1e-4)
    np.testing.assert_allclose(teng.get_global_grad_norm(),
                               jeng.get_global_grad_norm(), rtol=1e-4)
    # the first gradient (m after one step is (1 - beta1) * gradient): as
    # at head dims 80 and 96, a weight whose first gradient is under
    # FIRST_GRAD_FLOOR takes a first step lr * g / (|g| + eps) set by
    # rounding noise, and is held to Adam's step bound (lr 1e-3) only
    named = list(teng.module.named_parameters())
    first = to_numpy_params({n: (m / (1 - 0.9)).view(p.shape) for (n, p), m
                             in zip(named, teng.opt_state.m.split(
                                 [p.numel() for _, p in named]))})
    got = to_numpy_params(teng.module_state_dict())
    want = jax.tree_util.tree_map(np.asarray,
                                  jax.device_get(jeng.state.params))

    def close(g, w, init, g1, key):
        noise = np.abs(g1) < FIRST_GRAD_FLOOR["gemma"]
        for side in (g, w):
            assert np.abs(side - init)[noise].max(initial=0.0) <= 1.5e-3
        np.testing.assert_allclose(g[~noise], w[~noise], rtol=1e-4,
                                   atol=2e-5, err_msg=key)

    for key in got["layers"]:
        close(got["layers"][key], want["layers"][key],
              params["layers"][key], first["layers"][key], key)
    for key in set(got) - {"layers"}:
        close(got[key], want[key], params[key], first[key], key)
