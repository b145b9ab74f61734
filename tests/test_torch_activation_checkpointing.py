"""Port parity of activation checkpointing (ROADMAP A6) and of the model's
``remat_policy`` (C7).

Mirrors ``tests/unit/test_activation_checkpointing.py`` on the port's
``runtime/activation_checkpointing/checkpointing.py``: a checkpointed
block gives the direct call's values and gradients under every policy,
``configure`` reads a DeepSpeed config (explicit arguments win), an
unknown policy raises, ``cpu_checkpointing`` configures (its block test:
``tests/test_torch_offload.py``) and the ``memory`` block parses (since
ROADMAP A12b), the RNG tracker is
deterministic and refuses a duplicate stream.  The model at 2 layers,
hidden 64, under each policy gives the JAX model's loss and gradients
(``jax.value_and_grad`` on the JAX model with the same ``remat_policy``,
fp32; rtol = atol = 1e-4, the training rows' limits).  C7's own test
counts the matrix products the dispatcher runs: under ``dots_saveable``
the backward recomputes none of them.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from deepspeed_tpu.models.transformer import (
    CausalTransformerLM as JaxLM, TransformerConfig as JaxConfig)
from deepspeed_tpu_torch.models.convert import (from_jax_params,
                                                to_numpy_params)
from deepspeed_tpu_torch.models.transformer import (CausalTransformerLM,
                                                    TransformerConfig)
from deepspeed_tpu_torch.runtime.activation_checkpointing import \
    checkpointing as ckpt
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
from torch_threads import _one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-4, atol=1e-4)
POLICY_NAMES = sorted(ckpt.POLICIES)
# the four distinct policies (the other two names are aliases)
DISTINCT = ["nothing_saveable", "dots_saveable",
            "dots_with_no_batch_dims_saveable", "everything_saveable"]


@pytest.fixture(autouse=True)
def _reset_ckpt_config():
    yield
    ckpt.configure(partition_activations=False, checkpoint_in_cpu=False,
                   contiguous_checkpointing=False, policy="nothing_saveable")


def _block(w):
    def f(x):
        return torch.tanh(x @ w) @ w.T
    return f


@pytest.mark.parametrize("policy", POLICY_NAMES)
def test_checkpoint_matches_direct(policy):
    gen = torch.Generator().manual_seed(0)
    w = torch.randn(16, 16, generator=gen)
    x0 = torch.randn(4, 16, generator=gen)
    f = _block(w)
    ckpt.configure(policy=policy)
    grads = []
    for via in (False, True):
        x = x0.clone().requires_grad_(True)
        y = ckpt.checkpoint(f, x) if via else f(x)
        y.sum().backward()
        grads.append((y.detach(), x.grad))
    assert torch.equal(grads[0][0], grads[1][0])
    assert torch.equal(grads[0][1], grads[1][1])
    wrapped = ckpt.checkpoint_wrapper(f)
    assert torch.equal(wrapped(x0), f(x0))


def test_configure_reads_a_deepspeed_config():
    block = {"activation_checkpointing": {
        "partition_activations": True, "contiguous_memory_optimization": True,
        "number_checkpoints": 4, "profile": True,
        "synchronize_checkpoint_boundary": True, "policy": "dots_saveable"}}
    ckpt.configure(deepspeed_config=block)
    assert ckpt.PARTITION_ACTIVATIONS and ckpt.CONTIGUOUS_CHECKPOINTING
    assert ckpt.NUM_CHECKPOINTS == 4 and ckpt.PROFILE_TIME
    assert ckpt.SYNCHRONIZE and ckpt._POLICY_NAME == "dots_saveable"
    assert ckpt.is_configured()
    # a DeepSpeedConfig too, and explicit arguments win
    cfg = DeepSpeedConfig({"train_batch_size": 2, **block})
    ckpt.configure(deepspeed_config=cfg, policy="everything_saveable",
                   partition_activations=False)
    assert ckpt._POLICY_NAME == "everything_saveable"
    assert not ckpt.PARTITION_ACTIVATIONS and ckpt.NUM_CHECKPOINTS == 4
    ckpt.reset()


def test_engine_configures_the_module_from_its_config():
    import deepspeed_tpu_torch
    deepspeed_tpu_torch.initialize(
        model=CausalTransformerLM(TransformerConfig.tiny(),
                                  device="cpu").init(0),
        config={"train_batch_size": 2, "activation_checkpointing": {
            "policy": "checkpoint_dots", "partition_activations": True}},
        device="cpu")
    assert ckpt._POLICY_NAME == "checkpoint_dots"
    assert ckpt.PARTITION_ACTIVATIONS


def test_unknown_policy_raises():
    ckpt.configure(policy="not_a_policy")
    with pytest.raises(ValueError, match="unknown activation-checkpointing"):
        ckpt.checkpoint(lambda x: x, torch.zeros(3))


def test_cpu_checkpointing_raises_naming_a12():
    """``cpu_checkpointing`` is ported (A12's first part): ``configure``
    and the config take it; the tiered ``memory`` block, which raised
    naming A12 until the parameter stream (A12b), parses as the JAX
    config parses it, and training acts on none of it."""
    try:
        ckpt.configure(checkpoint_in_cpu=True)
        assert ckpt.CPU_CHECKPOINT
        ckpt.configure(deepspeed_config={"activation_checkpointing": {
            "cpu_checkpointing": False}})
        assert not ckpt.CPU_CHECKPOINT
    finally:
        ckpt.configure(checkpoint_in_cpu=False)
    cfg = DeepSpeedConfig({"train_batch_size": 2, "activation_checkpointing":
                           {"cpu_checkpointing": True}})
    assert cfg.activation_checkpointing_config.cpu_checkpointing
    mem = DeepSpeedConfig({"train_batch_size": 2, "memory": {
        "placement_policy": "nvme", "nvme_dir": "d"}}).memory_config
    assert (mem.placement_policy, mem.nvme_dir) == ("nvme", "d")


def test_rng_tracker_fork_is_deterministic():
    tracker = ckpt.model_parallel_manual_seed(1234)
    with tracker.fork() as g1:
        a = torch.randn(4, generator=g1)
    with tracker.fork() as g2:
        b = torch.randn(4, generator=g2)
    assert not torch.equal(a, b)            # forks advance the stream
    # re-seeding reproduces the sequence
    tracker = ckpt.model_parallel_cuda_manual_seed(1234)
    assert set(tracker.get_states()) == {"default-rng", "model-parallel-rng"}
    with tracker.fork() as g1b:
        assert torch.equal(torch.randn(4, generator=g1b), a)
    # restoring the states replays the forks after them
    states = tracker.get_states()
    with tracker.fork() as g3:
        c = torch.randn(4, generator=g3)
    tracker.set_states(states)
    with tracker.fork() as g3b:
        assert torch.equal(torch.randn(4, generator=g3b), c)
    with tracker.fork("default-rng") as g4:
        assert not torch.equal(torch.randn(4, generator=g4), c)
    assert ckpt.get_cuda_rng_tracker() is ckpt.get_rng_tracker()


def test_rng_tracker_duplicate_add_raises():
    tracker = ckpt.RNGStatesTracker()
    tracker.add("s", 0)
    with pytest.raises(Exception, match="already exists"):
        tracker.add("s", 1)
    with pytest.raises(Exception, match="is not added"):
        with tracker.fork("missing"):
            pass
    ckpt.model_parallel_manual_seed(7)
    with pytest.raises(Exception, match="already exists"):
        ckpt.model_parallel_reconfigure_tp_seed(7)


# ------------------------------------------------- the model's remat_policy
MODEL = dict(hidden_size=64, n_heads=4, n_kv_heads=2, n_layers=2)


def _params(jcfg, seed=0):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: (np.asarray(x) + 0.05 * rng.standard_normal(x.shape))
        .astype(np.float32), JaxLM(jcfg).init(jax.random.key(seed)))


def test_policy_aliases():
    assert ckpt.resolve_policy("checkpoint_dots") is \
        ckpt.resolve_policy("dots_saveable")
    assert ckpt.resolve_policy("checkpoint_dots_with_no_batch_dims") is \
        ckpt.resolve_policy("dots_with_no_batch_dims_saveable")


@pytest.mark.parametrize("policy", DISTINCT + ["not_a_jax_policy"])
def test_model_policies_match_jax(policy):
    """Every policy (and a name jax.checkpoint_policies lacks, which saves
    nothing in both packages) gives the JAX model's loss and gradients."""
    kw = dict(MODEL, remat=True, remat_policy=policy, loss_chunk_size=0)
    jcfg, tcfg = JaxConfig.tiny(**kw), TransformerConfig.tiny(**kw)
    params = _params(jcfg)
    ids = np.random.default_rng(1).integers(0, 256, (2, 16))
    jloss, jgrads = jax.value_and_grad(JaxLM(jcfg).loss)(
        jax.tree_util.tree_map(jnp.asarray, params),
        {"input_ids": jnp.asarray(ids)})
    model = CausalTransformerLM(tcfg, device="cpu")
    model.load_state_dict(from_jax_params(params, tcfg), strict=True)
    loss = model.loss({"input_ids": torch.as_tensor(ids)})
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), **TOL)
    got = to_numpy_params({n: p.grad for n, p in model.named_parameters()})
    want = jax.tree_util.tree_map(np.asarray, jgrads)
    for key in got["layers"]:
        np.testing.assert_allclose(got["layers"][key], want["layers"][key],
                                   err_msg=key, **TOL)
    for key in set(got) - {"layers"}:
        np.testing.assert_allclose(got[key], want[key], err_msg=key, **TOL)


class _CountDots(TorchDispatchMode):
    """Counts the products the dispatcher runs: the 2-d ones (``mm``,
    ``addmm``: the layers' projections) and the batched ones (``bmm``:
    here the plain attention's)."""

    def __init__(self):
        super().__init__()
        self.mm = self.bmm = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
            self.mm += 1
        elif func is torch.ops.aten.bmm.default:
            self.bmm += 1
        return func(*args, **(kwargs or {}))


def _count_products(policy):
    """(forward counter, backward counter, loss, gradients) of the layers
    of a 2-layer model under ``policy``, with the recompute's early stop
    off, so a recompute reruns every product the forward ran."""
    cfg = TransformerConfig.tiny(**MODEL, remat=True, remat_policy=policy)
    model = CausalTransformerLM(cfg, device="cpu").init(0)
    ids = torch.as_tensor(np.random.default_rng(2).integers(0, 256, (2, 16)))
    w = torch.randn(2, 16, cfg.hidden_size,
                    generator=torch.Generator().manual_seed(3))
    with torch.utils.checkpoint.set_checkpoint_early_stop(False):
        with _CountDots() as fwd:
            loss = (model.apply(ids, return_hidden=True) * w).sum()
        with _CountDots() as bwd:
            loss.backward()
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    return fwd, bwd, loss.detach(), grads


def test_dots_saveable_recomputes_no_product():
    """C7: under ``dots_saveable`` the backward runs exactly the forward's
    count of the layers' products fewer than under ``nothing_saveable`` --
    no product is recomputed -- and as many as with no checkpoint at all.
    The attention is recomputed under both, as ``jax.checkpoint`` recomputes
    the Pallas call (on the CPU its plain version's batched products stand
    in for the flash kernel, which is no product to the dispatcher); the
    values are the same under every policy."""
    runs = {p: _count_products(p) for p in DISTINCT}
    fwd, b_nothing, loss, grads = runs["nothing_saveable"]
    _, b_dots, _, _ = runs["dots_saveable"]
    assert fwd.mm == 7 * MODEL["n_layers"]       # q, k, v, o, up, gate, down
    assert b_nothing.mm - b_dots.mm == fwd.mm
    assert b_dots.mm == runs["everything_saveable"][1].mm
    assert b_dots.bmm == b_nothing.bmm == \
        runs["everything_saveable"][1].bmm + fwd.bmm
    # the model's products have no batch dims: both dots policies keep them
    b_nobatch = runs["dots_with_no_batch_dims_saveable"][1]
    assert (b_nobatch.mm, b_nobatch.bmm) == (b_dots.mm, b_dots.bmm)
    for _, _, other_loss, other_grads in runs.values():
        assert torch.equal(other_loss, loss)
        assert all(torch.equal(a, b) for a, b in zip(other_grads, grads))


def test_checkpoint_keeps_the_policys_products():
    """``checkpointing.checkpoint`` on a user block (selective checkpoint
    contexts): ``dots_saveable`` keeps 2-d and batched products,
    ``dots_with_no_batch_dims_saveable`` the 2-d ones only."""
    gen = torch.Generator().manual_seed(4)
    w = torch.randn(8, 8, generator=gen)
    x0 = torch.randn(3, 4, 8, generator=gen)

    def block(x):
        return torch.bmm(torch.tanh(x @ w), x.transpose(1, 2)).sum(-1)

    counts = {}
    for policy in DISTINCT:
        ckpt.configure(policy=policy)
        x = x0.clone().requires_grad_(True)
        with torch.utils.checkpoint.set_checkpoint_early_stop(False):
            y = ckpt.checkpoint(block, x)
            with _CountDots() as bwd:
                y.sum().backward()
        counts[policy] = (bwd.mm, bwd.bmm)
    plain = counts["everything_saveable"]
    assert counts["nothing_saveable"] == (plain[0] + 1, plain[1] + 1)
    assert counts["dots_saveable"] == plain
    assert counts["dots_with_no_batch_dims_saveable"] == (plain[0],
                                                          plain[1] + 1)


def test_benchmark_defaults_to_dots_saveable():
    """``model_config`` and ``run_benchmark`` take the JAX benchmark's
    ``dots_saveable`` by default; ``remat_policy`` reaches the model."""
    import inspect
    from deepspeed_tpu_torch.benchmarks import training as bench
    assert bench.model_config("gpt_350m", 1024).remat_policy == \
        "dots_saveable"
    sig = inspect.signature(bench.run_benchmark).parameters
    assert sig["remat_policy"].default == "dots_saveable"
    cfg = bench.model_config("gpt_350m", 64, remat_policy="nothing_saveable")
    assert dataclasses.replace(cfg).remat_policy == "nothing_saveable"
