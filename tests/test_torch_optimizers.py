"""Port parity of the optimizers beyond Adam (ROADMAP A7): LAMB, SGD,
Adagrad, the 1-bit family, ``ops/lamb.py`` and client optimizers.

Each built-in rule is held against the JAX package's optax transform
itself (``deepspeed_tpu.runtime.optimizers.build_optimizer``: ``init`` /
``update`` / ``optax.apply_updates``, eager, on a dict of small numpy
leaves), the port's rule stepping the same leaves laid out as one flat
buffer (one ``FlatLayout`` leaf each): seeded gradients, 4 steps, the
parameters after every step and the state after the last (EF error
buffers, Adagrad's sums, LAMB's moments, SGD's trace) within atol 2e-5 +
rtol 1e-4 -- the same fp32 math in another order (XLA's fusion and
reduction order against PyTorch's).  One engine trajectory (LAMB with
gradient clipping, 3 steps) is held against the JAX engine: loss and grad
norm rtol 1e-4.  Every rule also trains 2 steps through the port's own
``initialize``; a client ``torch.optim.SGD`` is held against
``optax.sgd``; the precedence between config and client optimizers
follows the JAX engine's; ``ops/lamb.py`` matches JAX's
``reference_impl`` with segment ids.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models.transformer import (
    CausalTransformerLM as JaxLM, TransformerConfig as JaxConfig)
from deepspeed_tpu.ops import lamb as jax_lamb
from deepspeed_tpu.runtime.comm_compression import EFCompressionState
from deepspeed_tpu.runtime.optimizers import build_optimizer as jax_build
from deepspeed_tpu_torch.models.transformer import (CausalTransformerLM,
                                                    TransformerConfig)
from deepspeed_tpu_torch.ops import lamb as port_lamb
from deepspeed_tpu_torch.runtime import engine as engine_mod
from deepspeed_tpu_torch.runtime.optimizers import (ClientOptimizer,
                                                    FlatLayout, FusedAdam,
                                                    Lamb, build_optimizer,
                                                    state_tensors)
from torch_threads import _one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-4, atol=2e-5)


SHAPES = {"a": (33, 17), "b": (29,), "c": (3, 5, 7)}
STEPS = 4

# (name, params): every rule the JAX registry builds but the Adam names
# (cpuadam among them: the device Adam, tests/test_torch_adam.py)
CASES = [
    ("lamb", {"lr": 1e-2, "weight_decay": 0.01}),
    ("fusedlamb", {"lr": 1e-2}),
    ("sgd", {"lr": 5e-2}),
    ("sgd", {"lr": 5e-2, "momentum": 0.9}),
    ("sgd", {"lr": 5e-2, "momentum": 0.9, "nesterov": True,
             "weight_decay": 0.01}),
    ("adagrad", {"lr": 5e-2}),
    ("onebitadam", {"lr": 1e-2, "freeze_step": 2}),
    ("zerooneadam", {"lr": 1e-2, "freeze_step": 2, "weight_decay": 0.01}),
    ("onebitlamb", {"lr": 1e-2, "freeze_step": 2}),
]
# the port's state buffer -> (the optax / EF state class, its field)
STATE_FIELDS = {"m": (optax.ScaleByAdamState, "mu"),
                "v": (optax.ScaleByAdamState, "nu"),
                "trace": (optax.TraceState, "trace"),
                "sum_of_squares": (optax.ScaleByRssState, "sum_of_squares"),
                "error": (EFCompressionState, "error")}


def _leaves(seed):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(s).astype(np.float32)
            for k, s in SHAPES.items()}


def _flat(tree):
    return torch.as_tensor(np.concatenate(
        [np.asarray(tree[k], np.float32).ravel() for k in sorted(tree)]))


def _layout():
    return FlatLayout([int(np.prod(s)) for _, s in sorted(SHAPES.items())],
                      list(range(len(SHAPES))), "cpu")


def _find(state, cls):
    for s in jax.tree_util.tree_leaves(
            state, is_leaf=lambda x: isinstance(x, cls)):
        if isinstance(s, cls):
            return s
    raise AssertionError(f"no {cls.__name__} in {state}")


@pytest.mark.parametrize("name,params", CASES,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(CASES)])
def test_rule_matches_the_optax_transform(name, params):
    tx = jax_build(name, dict(params))
    jp = {k: jnp.asarray(v) for k, v in _leaves(0).items()}
    jst = tx.init(jp)
    opt = build_optimizer(name, dict(params))
    opt.bind(_layout())
    tp = _flat(_leaves(0))
    tst = opt.init_state(tp)
    for step in range(STEPS):
        grads = {k: v * 0.1 for k, v in _leaves(100 + step).items()}
        upd, jst = tx.update({k: jnp.asarray(v) for k, v in grads.items()},
                             jst, jp)
        jp = optax.apply_updates(jp, upd)
        tst = opt.step(tp, _flat(grads), tst)
        np.testing.assert_allclose(tp.numpy(), _flat(jp).numpy(),
                                   err_msg=f"params, step {step + 1}", **TOL)
    assert int(tst.count) == STEPS
    buffers = state_tensors(tst)
    assert buffers, name
    for key, buf in buffers.items():
        if key == "count":
            continue
        cls, field = STATE_FIELDS[key]
        want = _flat(getattr(_find(jst, cls), field)).numpy()
        np.testing.assert_allclose(buf.float().numpy(), want,
                                   err_msg=f"state {key}", **TOL)


def test_skipped_step_leaves_every_rule_as_it_was():
    """``skip`` set (an fp16 overflow): parameters, buffers and the count
    bit for bit as they were, NaN gradients held out."""
    bad = _flat(_leaves(7))
    bad[::5] = float("nan")
    for name, params in CASES:
        opt = build_optimizer(name, dict(params))
        opt.bind(_layout())
        tp = _flat(_leaves(0))
        st = opt.step(tp, _flat(_leaves(1)), opt.init_state(tp))
        before = {k: v.clone() for k, v in state_tensors(st).items()}
        p0 = tp.clone()
        st = opt.step(tp, bad, st, skip=torch.ones((), dtype=torch.int32))
        assert torch.equal(tp, p0), name
        for k, v in state_tensors(st).items():
            assert torch.equal(v, before[k]), (name, k)


def test_client_sgd_matches_optax_sgd():
    """A client ``torch.optim.SGD`` over the flat master's views against
    ``optax.sgd`` with the same momentum (and with Nesterov)."""
    for nesterov in (False, True):
        tx = optax.sgd(5e-2, momentum=0.9, nesterov=nesterov)
        jp = {k: jnp.asarray(v) for k, v in _leaves(0).items()}
        jst = tx.init(jp)
        opt = ClientOptimizer(functools.partial(
            torch.optim.SGD, lr=5e-2, momentum=0.9, nesterov=nesterov))
        layout = _layout()
        opt.bind(layout)
        tp = _flat(_leaves(0))
        opt.build([v.view(SHAPES[k]) for k, v in
                   zip(sorted(SHAPES), layout.views(tp))])
        st = opt.init_state(tp)
        for step in range(STEPS):
            grads = {k: v * 0.1 for k, v in _leaves(100 + step).items()}
            upd, jst = tx.update({k: jnp.asarray(v)
                                  for k, v in grads.items()}, jst, jp)
            jp = optax.apply_updates(jp, upd)
            st = opt.step(tp, _flat(grads), st)
            np.testing.assert_allclose(tp.numpy(), _flat(jp).numpy(),
                                       err_msg=f"step {step + 1}", **TOL)
        assert int(st.count) == STEPS


def test_ops_lamb_matches_jax_reference():
    """``ops/lamb.fused_lamb`` (trust ratio per segment, clipped to [0.01,
    10]) against the JAX ``reference_impl`` with segment ids, 3 steps."""
    rng = np.random.default_rng(3)
    n = 1000
    seg = np.repeat(np.arange(4), [100, 250, 400, 250]).astype(np.int32)
    p0 = rng.standard_normal(n).astype(np.float32)
    p0[:100] *= 1e-3          # a segment whose ratio clips at min_coeff
    jp, jst = jnp.asarray(p0), jax_lamb.init_state(jnp.asarray(p0))
    tp, tst = torch.as_tensor(p0), port_lamb.init_state(torch.as_tensor(p0))
    kw = dict(num_segments=4, lr=1e-2, weight_decay=0.01)
    for step in range(3):
        g = rng.standard_normal(n).astype(np.float32)
        jp, jst = jax_lamb.reference_impl(jp, jnp.asarray(g), jst,
                                          segment_ids=jnp.asarray(seg), **kw)
        tp, tst = port_lamb.fused_lamb(tp, torch.as_tensor(g), tst,
                                       segment_ids=torch.as_tensor(seg), **kw)
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), **TOL)
    np.testing.assert_allclose(tst.m.numpy(), np.asarray(jst.m), **TOL)
    np.testing.assert_allclose(tst.v.numpy(), np.asarray(jst.v), **TOL)
    assert int(tst.step) == int(jst.step) == 3


# ------------------------------------------------------------ engines
GPT = dict(hidden_size=64, n_heads=4, activation="gelu", use_rmsnorm=False,
           use_rope=False, norm_bias=True, tie_embeddings=True)
JAX_DEVICES, SEQ = 8, 16


def _params(jcfg, seed=0):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: (np.asarray(x) + 0.05 * rng.standard_normal(x.shape))
        .astype(np.float32), JaxLM(jcfg).init(jax.random.key(seed)))


def test_lamb_engine_with_clipping_matches_jax():
    """LAMB with gradient clipping through both engines, 3 steps (the JAX
    engine's trust ratio is per stacked layer leaf: the port's layout
    groups each weight's layers into one leaf)."""
    assert jax.device_count() == JAX_DEVICES
    jcfg, tcfg = JaxConfig.tiny(**GPT), TransformerConfig.tiny(**GPT)
    params = _params(jcfg)

    def conf(micro):
        return {"train_micro_batch_size_per_gpu": micro,
                "gradient_accumulation_steps": 2, "gradient_clipping": 0.5,
                "optimizer": {"type": "Lamb", "params": {
                    "lr": 1e-2, "weight_decay": 0.01}}}
    jeng, *_ = deepspeed_tpu.initialize(model=JaxLM(jcfg),
                                        model_parameters=params,
                                        config=conf(1))
    teng, opt, *_ = deepspeed_tpu_torch.initialize(
        model=CausalTransformerLM(tcfg, device="cpu"),
        model_parameters=params, config=conf(JAX_DEVICES), device="cpu")
    assert isinstance(opt, Lamb)
    rng = np.random.default_rng(5)
    for step in range(3):
        batch = {"input_ids": rng.integers(0, 256, (2, JAX_DEVICES, SEQ))}
        np.testing.assert_allclose(float(teng.train_batch(batch=batch)),
                                   float(jeng.train_batch(batch=batch)),
                                   rtol=1e-4, err_msg=f"loss, step {step}")
        np.testing.assert_allclose(teng.get_global_grad_norm(),
                                   jeng.get_global_grad_norm(), rtol=1e-4,
                                   err_msg=f"grad norm, step {step}")
        assert teng.get_global_grad_norm() > 0.5      # clipping acts


def _port_engine(config, optimizer=None, seed=0):
    return deepspeed_tpu_torch.initialize(
        model=CausalTransformerLM(TransformerConfig.tiny(**GPT),
                                  device="cpu").init(seed),
        config=config, optimizer=optimizer, device="cpu")


@pytest.mark.parametrize("name,params", CASES,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(CASES)])
def test_each_rule_trains_through_initialize(name, params):
    eng, opt, *_ = _port_engine({
        "train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 2,
        "optimizer": {"type": name, "params": params}})
    ids = np.random.default_rng(1).integers(0, 256, (2, 2, SEQ))
    losses = [float(eng.train_batch(batch={"input_ids": ids}))
              for _ in range(2)]
    assert np.isfinite(losses).all() and eng.applied_steps() == 2
    assert opt is eng.optimizer


def test_client_optimizer_precedence_and_warnings(monkeypatch):
    warned = []
    monkeypatch.setattr(engine_mod.logger, "warning", warned.append)
    client = functools.partial(torch.optim.SGD, lr=0.1, momentum=0.9)
    base = {"train_micro_batch_size_per_gpu": 2}
    # the config's optimizer wins
    eng, opt, *_ = _port_engine(dict(base, optimizer={"type": "Lamb"}),
                                optimizer=client)
    assert isinstance(opt, Lamb) and not warned
    # a name the registry does not know: the client's, with a warning
    eng, opt, *_ = _port_engine(dict(base, optimizer={"type": "Adafactor"}),
                                optimizer=client)
    assert isinstance(opt, ClientOptimizer) and "not built in" in warned[-1]
    assert isinstance(opt.optimizer, torch.optim.SGD)
    # a scheduler block with a client optimizer: ignored, with a warning
    eng, opt, *_ = _port_engine(dict(base, scheduler={
        "type": "WarmupLR", "params": {}}), optimizer=client)
    assert "scheduler config ignored" in warned[-1]
    assert eng.get_lr() == [0.0]        # the JAX engine's base lr
    ids = np.random.default_rng(1).integers(0, 256, (2, SEQ))
    before = eng.master.clone()
    eng.train_batch(batch={"input_ids": ids})
    assert eng.applied_steps() == 1 and not torch.equal(eng.master, before)
    # an unknown name alone, and an Optimizer instance, raise
    with pytest.raises(ValueError, match="Unknown optimizer"):
        _port_engine(dict(base, optimizer={"type": "Adafactor"}))
    with pytest.raises(TypeError, match="class"):
        _port_engine(base, optimizer=torch.optim.SGD(
            [torch.zeros(2, requires_grad=True)], lr=0.1))
    # cpuadam is the device Adam, as the JAX registry maps it
    eng, *_ = _port_engine(dict(base, optimizer={"type": "CPUAdam"}))
    assert isinstance(eng.optimizer, FusedAdam)


def test_client_optimizer_under_fp16_and_bf16_gradients():
    """A skipped fp16 step does not call the client's ``step()`` (its
    momentum buffers stay unmade, the master as it was); with bf16
    gradients the client steps from an fp32 copy."""
    client = functools.partial(torch.optim.SGD, lr=0.1, momentum=0.9)
    ids = np.random.default_rng(1).integers(0, 256, (2, SEQ))
    eng, opt, *_ = _port_engine({"train_micro_batch_size_per_gpu": 2,
                                 "fp16": {"enabled": True,
                                          "initial_scale_power": 32}},
                                optimizer=client)
    before = eng.master.clone()
    eng.train_batch(batch={"input_ids": ids})
    assert eng.last_step_overflowed() and eng.applied_steps() == 0
    assert torch.equal(eng.master, before) and not opt.optimizer.state
    eng, opt, *_ = _port_engine({"train_micro_batch_size_per_gpu": 2,
                                 "data_types": {"grad_accum_dtype": "bf16"}},
                                optimizer=client)
    assert eng.grads.dtype == torch.bfloat16
    losses = [float(eng.train_batch(batch={"input_ids": ids}))
              for _ in range(3)]
    assert losses[-1] < losses[0] and eng.applied_steps() == 3
