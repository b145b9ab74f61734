"""Port parity: fp16 mixed precision, loss scaling and LR schedules.

* The flash path's plain versions on fp16 inputs against the JAX
  package's ``_flash_fwd`` / ``_flash_bwd_pallas`` in the Pallas
  interpreter: both compute in fp32 and round each output to fp16 once,
  so they agree within one fp16 ulp (rtol 2**-10, atol 1e-6 for fp32
  order noise near 0); the fp32 LSE within 1e-5.
* Fused Adam's plain version with the skip flag: p, m, v and the count
  bit for bit.
* The engine: ``deepspeed_tpu_torch.initialize(...).train_batch`` against
  the JAX engine on a tiny GPT-style model, fp16 with dynamic loss scaling
  (hysteresis 1 with WarmupDecayLR, hysteresis 2) and a static scale.  One
  fixed batch whose fp16 gradients overflow from a loss scale of 2**18.59
  on (the smaller of its two micro-batches' thresholds, bisected on the
  port), so every scale from 2**19 up overflows by 33% or more and 2**18
  leaves 50% headroom: the skip pattern, the loss scale after every step
  and the skipped count are EXACT; the host lr within float32's rounding
  of the JAX engine's base lr.  Losses and grad norms rtol 1e-3 (two
  fp16 ulps: the engines round the same values to fp16 in other places);
  each parameter's update (final minus initial) within 5e-2 relative L2 of
  the JAX engine's (Adam's first steps move each weight by about lr, so a
  gradient whose fp16 rounding flips its sign flips its step: 5e-2 is such
  a flip in 0.06% of a tensor's weights; the worst reading here, w_up
  after two applied steps, is 2.5e-2).  The three-call API the same way.
* fp32 trajectories with WarmupDecayLR (nonzero minimum) and with OneCycle
  cycling beta1, at ``test_torch_training``'s limits: losses and grad norms
  rtol 1e-4, parameters atol 2e-5 + rtol 1e-4.
* ``eval_batch`` against the JAX one (fp32 rtol 1e-5; fp16 1e-3), a client
  ``lr_scheduler``, the config's fp16 rules, the ``ds_bench train`` CLI on
  the CPU, and fp16 serving refused at construction on the card (C2).
"""

import json
import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models.transformer import (
    CausalTransformerLM as JaxLM, TransformerConfig as JaxConfig)
from deepspeed_tpu.ops.pallas.flash_attention import (_flash_bwd_pallas,
                                                      _flash_fwd)
from deepspeed_tpu_torch.models.convert import to_numpy_params
from deepspeed_tpu_torch.models.transformer import (CausalTransformerLM,
                                                    TransformerConfig)
from deepspeed_tpu_torch.ops.adam import adam_hyper, init_state, reference_impl
from deepspeed_tpu_torch.ops.flash_attention import (
    flash_attention_bwd_plain, flash_attention_fwd_plain)
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfigError
from torch_threads import _one_torch_thread  # noqa: F401

FP16_OUT_TOL = dict(rtol=2.0 ** -10, atol=1e-6)


# ---------------------------------------------------------------- kernels
@pytest.mark.parametrize("H,Hkv", [(4, 4), (4, 2)])
def test_fp16_plain_flash_matches_pallas(H, Hkv):
    B, S, D, BLOCK = 2, 128, 32, 64
    rng = np.random.default_rng(7)
    q, g = (rng.standard_normal((B, S, H, D)).astype(np.float16)
            for _ in range(2))
    k, v = (rng.standard_normal((B, S, Hkv, D)).astype(np.float16)
            for _ in range(2))
    scale = 1.0 / math.sqrt(D)
    jo, jlse = _flash_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          scale, True, BLOCK, BLOCK, interpret=True)
    t = [torch.as_tensor(x) for x in (q, k, v, g)]
    to, tlse = flash_attention_fwd_plain(*t[:3], scale, True)
    assert to.dtype == torch.float16 and tlse.dtype == torch.float32
    np.testing.assert_allclose(to.float().numpy(),
                               np.asarray(jo).astype(np.float32),
                               **FP16_OUT_TOL)
    np.testing.assert_allclose(tlse.numpy(), np.asarray(jlse), rtol=1e-5,
                               atol=1e-5)
    res = tuple(jnp.asarray(x) for x in (q, k, v, np.asarray(jo),
                                         np.asarray(jlse)))
    want = _flash_bwd_pallas(scale, True, res, jnp.asarray(g), BLOCK, BLOCK,
                             interpret=True)
    got = flash_attention_bwd_plain(*t[:3], torch.as_tensor(np.array(jo)),
                                    torch.as_tensor(np.array(jlse)), t[3],
                                    scale, True)
    for name, a, b in zip("qkv", got, want):
        assert a.dtype == torch.float16
        np.testing.assert_allclose(a.float().numpy(),
                                   np.asarray(b).astype(np.float32),
                                   err_msg=f"d{name}", **FP16_OUT_TOL)


def test_adam_skip_flag_leaves_state_bit_for_bit():
    rng = np.random.default_rng(2)
    p = torch.as_tensor(rng.standard_normal(5000).astype(np.float32))
    g = torch.as_tensor(rng.standard_normal(5000).astype(np.float32))
    st = init_state(p)
    hyper = adam_hyper(st.count, 1e-3, 0.9, 0.999)
    reference_impl(p, g, st, hyper, weight_decay=0.01)      # one real step
    before = [t.clone() for t in (p, st.m, st.v)]
    g_bad = g.clone()
    g_bad[::3] = float("nan")
    skip = torch.ones((), dtype=torch.int32)
    hyper = adam_hyper(st.count, 1e-3, 0.9, 0.999)
    reference_impl(p, g_bad, st, hyper, skip, weight_decay=0.01)
    assert all(torch.equal(a, b) for a, b in zip((p, st.m, st.v), before))
    assert int(st.count) == 1
    reference_impl(p, g, st, hyper, torch.zeros((), dtype=torch.int32),
                   weight_decay=0.01)
    assert int(st.count) == 2 and not torch.equal(p, before[0])


# ---------------------------------------------------------------- engine
JAX_DEVICES = 8
GPT = dict(hidden_size=64, n_heads=4, activation="gelu", use_rmsnorm=False,
           use_rope=False, norm_bias=True, tie_embeddings=True)


def _params(jcfg, seed=0):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: (np.asarray(x) + 0.05 * rng.standard_normal(x.shape))
        .astype(np.float32), JaxLM(jcfg).init(jax.random.key(seed)))


def _engines(extra, gas=2):
    """The JAX engine (micro 1 on each of its 8 devices) and the port's
    (micro 8 on its one), from one set of numpy params."""
    jcfg, tcfg = JaxConfig.tiny(**GPT), TransformerConfig.tiny(**GPT)
    params = _params(jcfg)
    base = {"gradient_accumulation_steps": gas,
            "optimizer": {"type": "AdamW",
                          "params": {"lr": 1e-3, "weight_decay": 0.01}},
            **extra}
    jeng, *_ = deepspeed_tpu.initialize(
        model=JaxLM(jcfg), model_parameters=params,
        config=dict(base, train_micro_batch_size_per_gpu=1))
    teng, _, _, sched = deepspeed_tpu_torch.initialize(
        model=CausalTransformerLM(tcfg, device="cpu"),
        model_parameters=params,
        config=dict(base, train_micro_batch_size_per_gpu=JAX_DEVICES),
        device="cpu")
    assert sched is teng.lr_scheduler
    return jeng, teng, params


# the fixed batch whose fp16 gradients overflow from 2**18.59 on (see the
# module docstring)
FIXED = {"input_ids": np.random.default_rng(11).integers(
    0, 256, (2, JAX_DEVICES, 16))}
WARMUP_DECAY = {"type": "WarmupDecayLR",
                "params": {"warmup_min_lr": 1e-4, "warmup_max_lr": 1e-3,
                           "warmup_num_steps": 2, "total_num_steps": 10}}
# (fp16 block, scheduler, steps, expected skipped count after each step)
FP16_CASES = {
    "dynamic_hysteresis1_warmup_decay": (
        {"enabled": True, "initial_scale_power": 20, "hysteresis": 1},
        WARMUP_DECAY, 5, [1, 2, 2, 2, 2]),
    "dynamic_hysteresis2": (
        {"enabled": True, "initial_scale_power": 19, "hysteresis": 2},
        None, 4, [1, 2, 2, 2]),
    "static_1024": ({"enabled": True, "loss_scale": 1024}, None, 3,
                    [0, 0, 0]),
}


def _update_rel(got, want, init):
    """Largest relative L2 gap of the update (final - init) over the
    parameters, and its name."""
    worst = (0.0, None)
    for key in want["layers"]:
        a = got["layers"][key] - init["layers"][key]
        b = want["layers"][key] - init["layers"][key]
        worst = max(worst, (float(np.linalg.norm(a - b) /
                                  max(np.linalg.norm(b), 1e-30)), key))
    return worst


@pytest.mark.parametrize("case", list(FP16_CASES))
def test_fp16_engine_matches_jax(case):
    fp16, sched, steps, skipped = FP16_CASES[case]
    extra = {"fp16": fp16}
    if sched:
        extra["scheduler"] = sched
    jeng, teng, params = _engines(extra)
    assert teng.compute_dtype == torch.float16
    assert teng.get_loss_scale() == jeng.get_loss_scale()
    for step in range(steps):
        jloss = float(jeng.train_batch(batch=FIXED))
        tloss = float(teng.train_batch(batch=FIXED))
        np.testing.assert_allclose(tloss, jloss, rtol=1e-3,
                                   err_msg=f"loss, step {step}")
        # skip pattern and loss scale: exact
        assert int(teng.skipped_steps) == int(jeng.state.skipped_steps) == \
            skipped[step], f"step {step}"
        assert teng.last_step_overflowed() == (
            skipped[step] > (skipped[step - 1] if step else 0))
        assert teng.get_loss_scale() == jeng.get_loss_scale(), step
        assert teng.cur_scale == teng.get_loss_scale()
        # the host lr: the JAX engine's base lr is its float32 rounding
        np.testing.assert_allclose(teng.get_lr(), jeng.get_lr(), rtol=1e-7)
        jn, tn = jeng.get_global_grad_norm(), teng.get_global_grad_norm()
        if math.isfinite(jn):
            np.testing.assert_allclose(tn, jn, rtol=1e-3,
                                       err_msg=f"grad norm, step {step}")
        else:
            assert not math.isfinite(tn)
    assert teng.applied_steps() == steps - skipped[-1]
    got = to_numpy_params(teng.module_state_dict())
    want = jax.tree_util.tree_map(np.asarray,
                                  jax.device_get(jeng.state.params))
    rel, key = _update_rel(got, want, params)
    assert rel <= 5e-2, (key, rel)


def test_fp16_three_call_api_matches_jax():
    """forward / backward / step under fp16: each micro-batch's gradients
    unscaled and divided by gas, the overflow of any micro-batch skips the
    step; the skip pattern and the scale exact, the rest at the fp16
    limits above."""
    jeng, teng, params = _engines(
        {"fp16": {"enabled": True, "initial_scale_power": 20,
                  "hysteresis": 1}})
    for step in range(4):
        for i in range(2):
            mb = {"input_ids": FIXED["input_ids"][i]}
            jloss = jeng.forward(mb)
            jeng.backward(jloss)
            jeng.step()
            tloss = teng.forward(mb)
            teng.backward(tloss)
            teng.step()
            np.testing.assert_allclose(float(tloss.detach()), float(jloss),
                                       rtol=1e-3, err_msg=f"step {step}")
        assert int(teng.skipped_steps) == int(jeng.state.skipped_steps) == \
            min(step + 1, 2), step
        assert teng.get_loss_scale() == jeng.get_loss_scale(), step
    got = to_numpy_params(teng.module_state_dict())
    want = jax.tree_util.tree_map(np.asarray,
                                  jax.device_get(jeng.state.params))
    rel, key = _update_rel(got, want, params)
    assert rel <= 5e-2, (key, rel)


@pytest.mark.parametrize("sched", [
    WARMUP_DECAY,
    {"type": "OneCycle", "params": {"cycle_min_lr": 1e-4,
                                    "cycle_max_lr": 2e-3,
                                    "cycle_first_step_size": 2,
                                    "cycle_min_mom": 0.8,
                                    "cycle_max_mom": 0.95}}],
    ids=["warmup_decay", "one_cycle_momentum"])
def test_fp32_schedule_trajectory_matches_jax(sched):
    jeng, teng, params = _engines({"scheduler": sched})
    rng = np.random.default_rng(5)
    for step in range(4):
        batch = {"input_ids": rng.integers(0, 256, (2, JAX_DEVICES, 16))}
        np.testing.assert_allclose(float(teng.train_batch(batch=batch)),
                                   float(jeng.train_batch(batch=batch)),
                                   rtol=1e-4, err_msg=f"loss, step {step}")
        np.testing.assert_allclose(teng.get_global_grad_norm(),
                                   jeng.get_global_grad_norm(), rtol=1e-4)
        np.testing.assert_allclose(teng.get_lr(), jeng.get_lr(), rtol=1e-6)
    got = to_numpy_params(teng.module_state_dict())
    want = jax.tree_util.tree_map(np.asarray,
                                  jax.device_get(jeng.state.params))
    for key in got["layers"]:
        np.testing.assert_allclose(got["layers"][key], want["layers"][key],
                                   rtol=1e-4, atol=2e-5, err_msg=key)
    for key in set(got) - {"layers"}:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4,
                                   atol=2e-5, err_msg=key)


@pytest.mark.parametrize("fp16", [False, True], ids=["fp32", "fp16"])
def test_eval_batch_matches_jax(fp16):
    jeng, teng, _ = _engines({"fp16": {"enabled": True}} if fp16 else {})
    ids = np.random.default_rng(9).integers(0, 256, (JAX_DEVICES, 16))
    got = teng.eval_batch({"input_ids": ids})
    assert got.dim() == 0 and not got.requires_grad
    np.testing.assert_allclose(float(got),
                               float(jeng.eval_batch({"input_ids": ids})),
                               rtol=1e-3 if fp16 else 1e-5)
    # eval leaves the state alone: the next train_batch is the first step
    assert teng.global_steps == 0 and teng.applied_steps() == 0


def test_client_lr_scheduler_matches_jax():
    """A client LRScheduler drives Adam's lr as the JAX engine's does, is
    returned fourth as given, and a config scheduler block takes
    precedence over it."""
    from deepspeed_tpu.runtime import lr_schedules as jlr
    from deepspeed_tpu_torch.runtime import lr_schedules as tlr
    params = {"warmup_min_lr": 2e-4, "warmup_max_lr": 2e-3,
              "warmup_num_steps": 3}
    jcfg, tcfg = JaxConfig.tiny(**GPT), TransformerConfig.tiny(**GPT)
    init = _params(jcfg)
    base = {"gradient_accumulation_steps": 2,
            "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}}}
    jsched = jlr.LRScheduler(jlr.build_schedule("WarmupLR", params))
    tsched = tlr.LRScheduler(tlr.build_schedule("WarmupLR", params))
    jeng, *_, jret = deepspeed_tpu.initialize(
        model=JaxLM(jcfg), model_parameters=init, lr_scheduler=jsched,
        config=dict(base, train_micro_batch_size_per_gpu=1))
    teng, *_, tret = deepspeed_tpu_torch.initialize(
        model=CausalTransformerLM(tcfg, device="cpu"), model_parameters=init,
        lr_scheduler=tsched, device="cpu",
        config=dict(base, train_micro_batch_size_per_gpu=JAX_DEVICES))
    assert tret is tsched and jret is jsched
    rng = np.random.default_rng(6)
    for step in range(3):
        batch = {"input_ids": rng.integers(0, 256, (2, JAX_DEVICES, 16))}
        np.testing.assert_allclose(float(teng.train_batch(batch=batch)),
                                   float(jeng.train_batch(batch=batch)),
                                   rtol=1e-4, err_msg=f"loss, step {step}")
        np.testing.assert_allclose(teng.get_lr(), jeng.get_lr(), rtol=1e-6)
    got = to_numpy_params(teng.module_state_dict())
    want = jax.tree_util.tree_map(np.asarray,
                                  jax.device_get(jeng.state.params))
    for key in got["layers"]:
        np.testing.assert_allclose(got["layers"][key], want["layers"][key],
                                   rtol=1e-4, atol=2e-5, err_msg=key)
    # a callable on the step works too; the config's block wins over it
    calls = []

    def client(step):
        calls.append(step)
        return step * 0 + 5e-4

    eng, *_ = deepspeed_tpu_torch.initialize(
        model=CausalTransformerLM(tcfg, device="cpu").init(0),
        lr_scheduler=client, device="cpu",
        config=dict(base, train_micro_batch_size_per_gpu=2))
    assert eng.optimizer.lr is client and eng.get_lr() == [5e-4]
    eng, *_ = deepspeed_tpu_torch.initialize(
        model=CausalTransformerLM(tcfg, device="cpu").init(0),
        lr_scheduler=client, device="cpu",
        config=dict(base, train_micro_batch_size_per_gpu=2,
                    scheduler={"type": "WarmupLR", "params": params}))
    assert eng.optimizer.lr is not client
    np.testing.assert_allclose(eng.get_lr(), [2e-4], rtol=1e-6)


def test_fp16_config_rules():
    from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
    cfg = DeepSpeedConfig({"train_batch_size": 2, "fp16": {
        "enabled": True, "loss_scale": 0, "initial_scale_power": 12,
        "loss_scale_window": 7, "hysteresis": 3, "min_loss_scale": 2}})
    fc = cfg.fp16_config
    assert cfg.fp16_enabled and cfg.dynamic_loss_scale
    assert (fc.initial_scale_power, fc.loss_scale_window, fc.hysteresis,
            fc.min_loss_scale) == (12, 7, 3, 2)
    static = DeepSpeedConfig({"train_batch_size": 2,
                              "fp16": {"enabled": True, "loss_scale": 128}})
    assert not static.dynamic_loss_scale and static.loss_scale == 128
    assert not DeepSpeedConfig({"train_batch_size": 2}).fp16_enabled
    with pytest.raises(DeepSpeedConfigError, match="cannot both"):
        DeepSpeedConfig({"train_batch_size": 2, "fp16": {"enabled": True},
                         "bf16": {"enabled": True}})
    sched = DeepSpeedConfig({"train_batch_size": 2, "scheduler": {
        "type": "WarmupLR", "params": {"warmup_num_steps": 5}}})
    assert sched.scheduler_config.type == "WarmupLR"
    assert sched.scheduler_config.params == {"warmup_num_steps": 5}


# --------------------------------------------------------------- ds_bench
_JAX_KEYS = {"model", "n_params", "batch", "gas", "seq", "zero_stage",
             "steps", "tokens_per_sec_per_chip", "model_tflops_per_chip",
             "loss", "device_kind", "n_chips"}


@pytest.fixture
def tiny_bench(monkeypatch):
    from deepspeed_tpu_torch.benchmarks import training
    monkeypatch.setitem(training.MODELS, "tiny",
                        dict(hidden_size=32, n_layers=2, n_heads=4))
    return training


def test_ds_bench_cli_fp16_on_cpu(tiny_bench, capsys):
    """``ds_bench train --dtype fp16`` on the CPU: JSON with the JAX CLI's
    keys plus loss_scale and skipped_steps; a start at 2**30 overflows (the
    logits' fp16 gradient alone is 2**30 / 30 tokens), so the first steps
    are skipped and the scale halves; the warm-up and 3 timed steps, of
    which at least one skipped."""
    out = tiny_bench.main(["--model", "tiny", "--batch", "2", "--gas", "2",
                           "--seq", "16", "--steps", "3", "--dtype", "fp16",
                           "--scheduler", "WarmupDecayLR",
                           "--initial-scale-power", "30", "--device", "cpu",
                           "--zero-stage", "2", "--json"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(printed) == _JAX_KEYS | {"loss_scale", "skipped_steps"}
    assert printed["zero_stage"] == 2 and printed["n_chips"] == 1
    assert out["dtype"] == "fp16" and out["mfu"] is None
    assert 1 <= printed["skipped_steps"] <= 4
    assert printed["loss_scale"] == 2.0 ** 30 / 2 ** (
        printed["skipped_steps"] // 2)          # hysteresis 2
    assert np.isfinite(out["losses"]).all() and len(out["losses"]) == 4


def test_ds_bench_cli_bf16_table_on_cpu(tiny_bench, capsys):
    """The JAX CLI's default run shape (gas 1, no schedule) as a table."""
    out = tiny_bench.main(["--model", "tiny", "--batch", "4", "--seq", "16",
                           "--steps", "1", "--device", "cpu"])
    text = capsys.readouterr().out
    assert "tokens_per_sec_per_chip" in text and "skipped_steps" in text
    assert out["skipped_steps"] == 0 and out["loss_scale"] == 1.0
    assert np.isfinite(out["loss"]) and out["tokens_per_sec_per_chip"] > 0


@pytest.mark.parametrize("flags,exc,match", [
    (["--buffer-count", "2"], NotImplementedError, "ROADMAP A12"),
    (["--offload-param", "nvme"], NotImplementedError, "ROADMAP A12"),
    (["--attn-block-q", "16"], ValueError, "fixed"),
])
def test_ds_bench_cli_refuses_unported_flags(tiny_bench, flags, exc, match):
    with pytest.raises(exc, match=match):
        tiny_bench.main(["--model", "tiny", "--batch", "2", "--seq", "8",
                         "--steps", "1", "--device", "cpu", *flags])


# ---------------------------------------- fp16 serving, no longer refused
def test_fp16_inference_on_the_card_is_accepted_at_construction():
    """B4 and B5 have fp16 forms: init_inference and the serving engine
    build fp16 engines for the card with the kernels' backend (the refusal
    they raised before those forms existed is gone).  Reached here
    without a card by a stub model whose device is "cuda": construction
    puts nothing on the device.  The model has 2 heads of 64, a head dim
    the serving kernels take (any other is refused on the card at
    construction, ROADMAP A16)."""
    from deepspeed_tpu_torch.inference.serving import ServingEngine
    model = CausalTransformerLM(
        TransformerConfig.tiny(**dict(GPT, hidden_size=128, n_heads=2)),
        device="cpu").init(0)
    made = []
    stub = types.SimpleNamespace(
        config=model.config, device=torch.device("cuda"),
        init_paged_caches=lambda *a, **k: made.append(k["dtype"]))
    for backend in ("auto", "cuda"):
        se = ServingEngine(stub, max_batch=2, page_size=8, max_seq=32,
                           dtype="fp16", serving={"attention_backend": backend})
        assert se.cache_dtype == torch.float16
    assert made == [torch.float16, torch.float16]
    # on the CPU the plain path serves fp16
    eng = deepspeed_tpu_torch.init_inference(model, dtype="fp16",
                                             device="cpu")
    out = eng.generate(np.random.default_rng(0).integers(0, 256, (2, 5)), 3)
    assert np.asarray(out).shape == (2, 8)
