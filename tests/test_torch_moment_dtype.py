"""bf16 Adam moments (``moment_dtype``) and bf16 gradient accumulation
(``data_types.grad_accum_dtype``) on the port (ROADMAP A7).

Mirrors ``tests/unit/test_moment_dtype.py`` and
``tests/unit/test_grad_accum_dtype.py`` on port engines (a tiny model on
the CPU; the plain version of B3): the trajectories track fp32 (rtol 0.1,
atol 0.05, the JAX tests' own limits), the state and the gradients really
are bf16, stochastic rounding holds the second moment's fp32 fixed point
within 5% after 400 steps, and junk names raise.  The plain stochastic
rounding is unbiased: the mean of 2**14 roundings of one value lies within
5 standard errors of it.  One JAX engine with bf16 moments and bf16
gradients against the port: the loss within rtol 1e-2 at each of 5 steps
(the two draw their rounding bits from different generators -- JAX's
threefry, the port's counter hash -- and a bf16 moment that rounds the
other way moves an Adam step by at most lr).
"""

import jax
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models.transformer import (
    CausalTransformerLM as JaxLM, TransformerConfig as JaxConfig)
from deepspeed_tpu_torch.models.transformer import (CausalTransformerLM,
                                                    TransformerConfig)
from deepspeed_tpu_torch.ops.adam import (adam_hyper, fused_adam, init_state,
                                          sr_round)
from deepspeed_tpu_torch.runtime.config import (DeepSpeedConfig,
                                                DeepSpeedConfigError)
from deepspeed_tpu_torch.runtime.optimizers import build_optimizer
from torch_threads import _one_torch_thread  # noqa: F401

SMALL = dict(hidden_size=32, n_heads=4, n_layers=2)
BATCH = np.random.default_rng(0).integers(0, 256, (4, 16))


def _run(steps, moment_dtype="float32", grad_accum_dtype=None, gas=1,
         clip=None):
    cfg = {"train_micro_batch_size_per_gpu": 4,
           "gradient_accumulation_steps": gas,
           "optimizer": {"type": "AdamW", "params": {
               "lr": 1e-2, "moment_dtype": moment_dtype}}}
    if grad_accum_dtype:
        cfg["data_types"] = {"grad_accum_dtype": grad_accum_dtype}
    if clip:
        cfg["gradient_clipping"] = clip
    eng, *_ = deepspeed_tpu_torch.initialize(
        model=CausalTransformerLM(TransformerConfig.tiny(**SMALL),
                                  device="cpu").init(0),
        config=cfg, device="cpu")
    batch = {"input_ids": np.stack([BATCH] * gas) if gas > 1 else BATCH}
    return [float(eng.train_batch(batch=batch)) for _ in range(steps)], eng


def test_bf16_moments_track_fp32_trajectory():
    l32, _ = _run(30)
    l16, eng = _run(30, "bfloat16")
    assert l16[-1] < l16[0] * 0.9
    np.testing.assert_allclose(l16[-1], l32[-1], rtol=0.1, atol=0.05)
    assert eng.opt_state.m.dtype == eng.opt_state.v.dtype == torch.bfloat16


@pytest.mark.parametrize("clip", [None, 0.5])
def test_bf16_grad_accum_tracks_fp32_trajectory(clip):
    l32, _ = _run(25, gas=2, clip=clip)
    l16, eng = _run(25, grad_accum_dtype="bfloat16", gas=2, clip=clip)
    assert l16[-1] < l16[0] * 0.9
    np.testing.assert_allclose(l16[-1], l32[-1], rtol=0.1, atol=0.05)
    assert eng.grads.dtype == torch.bfloat16
    assert eng.get_global_grad_norm() > 0


def test_three_call_api_with_bf16_state():
    """forward / backward / step with bf16 gradients and moments: each
    micro-batch's gradient is divided by gas in bf16 before the sum (the
    JAX ``backward``); the step applies and the state stays bf16."""
    _, eng = _run(1, "bfloat16", "bfloat16", gas=2)
    for i in range(2):
        eng.backward(eng.forward({"input_ids": BATCH}))
        eng.step()
    assert eng.was_step_applied() and eng.applied_steps() == 2
    assert eng.grads.dtype == eng.opt_state.m.dtype == torch.bfloat16


def test_sr_holds_the_second_moments_fixed_point():
    """Constant small gradients: each v increment is ~1e-3 relative,
    under bf16's nearest-rounding resolution near the fixed point;
    stochastic rounding must track the fp32 fixed point in expectation."""
    opt = build_optimizer("adamw", {"lr": 1e-3, "moment_dtype": "bfloat16"})
    p = torch.zeros(4096)
    st = opt.init_state(p)
    g = torch.full((4096,), 1e-2)
    for _ in range(400):
        st = opt.step(p, g, st)
    expect = (1 - 0.999 ** 400) * 1e-4
    got = st.v.float().mean().item()
    assert abs(got - expect) / expect < 0.05, (got, expect)


def test_plain_sr_round_is_unbiased():
    n = 1 << 14
    x = torch.full((n,), 0.123456776)
    lo = float(x[:1].to(torch.bfloat16).float())
    if lo > 0.123456776:                  # rounded up to the nearest
        lo = float((x[:1].view(torch.int32) & -65536).view(torch.float32))
    hi = float(torch.tensor(lo).to(torch.bfloat16).view(torch.int16).add(1)
               .view(torch.bfloat16).float())
    frac = (0.123456776 - lo) / (hi - lo)
    sigma = (hi - lo) * np.sqrt(frac * (1 - frac) / n)
    for step in (1, 2):
        got = sr_round(x, torch.tensor(step), 0).double()
        assert set(got.unique().tolist()) == {lo, hi}
        assert abs(got.mean().item() - x[0].item()) < 5 * sigma


def test_junk_names_raise():
    with pytest.raises(ValueError, match="moment_dtype"):
        build_optimizer("adamw", {"lr": 1e-3, "moment_dtype": "fp8"})
    with pytest.raises(ValueError, match="OneCycle"):
        build_optimizer("adamw", {"moment_dtype": "bf16",
                                  "_b1_schedule": lambda t: t})
    base = {"train_micro_batch_size_per_gpu": 1}
    for alias, want in [("bf16", "bfloat16"), ("bfloat16", "bfloat16"),
                        ("fp32", "float32"), ("float32", "float32")]:
        cfg = DeepSpeedConfig(dict(base, data_types={
            "grad_accum_dtype": alias}))
        assert cfg.grad_accum_dtype == want
    assert DeepSpeedConfig(base).grad_accum_dtype is None
    with pytest.raises(DeepSpeedConfigError, match="grad_accum_dtype"):
        DeepSpeedConfig(dict(base, data_types={"grad_accum_dtype": "fp8"}))
    # fp16 gradients into B3 are a form still to port
    with pytest.raises(NotImplementedError, match="ROADMAP B"):
        DeepSpeedConfig(dict(base, data_types={"grad_accum_dtype": "fp16"}))


def test_skip_leaves_bf16_moments_bit_for_bit():
    p = torch.randn(1000)
    st = init_state(p, torch.bfloat16)
    fused_adam(p, torch.randn(1000), st, adam_hyper(st.count, 1e-3, 0.9,
                                                    0.999))
    before = [t.clone() for t in (p, st.m, st.v, st.count)]
    bad = torch.full((1000,), float("nan"))
    fused_adam(p, bad, st, adam_hyper(st.count, 1e-3, 0.9, 0.999),
               torch.ones((), dtype=torch.int32))
    assert all(torch.equal(a, b) for a, b in
               zip((p, st.m, st.v, st.count), before))


def test_bf16_moments_and_gradients_match_the_jax_engine():
    kw = dict(hidden_size=64, n_heads=4, n_kv_heads=2)
    jcfg, tcfg = JaxConfig.tiny(**kw), TransformerConfig.tiny(**kw)
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(
        lambda x: (np.asarray(x) + 0.05 * rng.standard_normal(x.shape))
        .astype(np.float32), JaxLM(jcfg).init(jax.random.key(0)))

    def conf(micro):
        return {"train_micro_batch_size_per_gpu": micro,
                "gradient_accumulation_steps": 2,
                "optimizer": {"type": "AdamW", "params": {
                    "lr": 1e-3, "moment_dtype": "bfloat16"}},
                "data_types": {"grad_accum_dtype": "bfloat16"}}
    jeng, *_ = deepspeed_tpu.initialize(model=JaxLM(jcfg),
                                        model_parameters=params,
                                        config=conf(1))
    teng, *_ = deepspeed_tpu_torch.initialize(
        model=CausalTransformerLM(tcfg, device="cpu"),
        model_parameters=params, config=conf(8), device="cpu")
    batches = np.random.default_rng(5).integers(0, 256, (5, 2, 8, 16))
    for step, ids in enumerate(batches):
        np.testing.assert_allclose(
            float(teng.train_batch(batch={"input_ids": ids})),
            float(jeng.train_batch(batch={"input_ids": ids})), rtol=1e-2,
            err_msg=f"loss, step {step}")
    assert teng.grads.dtype == teng.opt_state.m.dtype == torch.bfloat16
