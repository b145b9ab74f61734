"""Port parity of the data loader and the engine's data path.

* ``DeepSpeedDataLoader`` yields the JAX loader's batches, bit for bit,
  for the same dataset, seed and epochs: shuffled or not, ``drop_last`` or
  not, 0 or 4 fetch threads, one process or the second of two.
* ``RepeatingLoader`` restarts its loader, as the JAX one does.
* ``initialize(training_data=...)`` returns the loader; with it the
  no-argument ``train_batch()`` takes a fresh iterator on every call -- the
  JAX engine's synchronous behaviour, so every call reads the same first
  gas micro-batches -- and ``train_batch(data_iter=...)`` walks the data;
  both trajectories match the JAX engine's within
  ``test_torch_training.py``'s tolerance (rtol 1e-4 on losses and grad
  norms).
"""

import jax
import numpy as np
import pytest

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models.transformer import (
    CausalTransformerLM as JaxLM, TransformerConfig as JaxConfig)
from deepspeed_tpu.runtime.dataloader import (
    DeepSpeedDataLoader as JaxLoader, RepeatingLoader as JaxRepeating)
from deepspeed_tpu_torch.models.transformer import (CausalTransformerLM,
                                                    TransformerConfig)
from deepspeed_tpu_torch.runtime.dataloader import (DeepSpeedDataLoader,
                                                    RepeatingLoader)
from torch_threads import _one_torch_thread  # noqa: F401

JAX_DEVICES = 8          # the harness's virtual CPU devices
GPT = dict(hidden_size=64, n_heads=4, activation="gelu", use_rmsnorm=False,
           use_rope=False, norm_bias=True, tie_embeddings=True)


def _dataset(n=22, seed=0):
    rng = np.random.default_rng(seed)
    return [{"x": rng.standard_normal(3).astype(np.float32),
             "y": np.int32(i)} for i in range(n)]


def _assert_same_batches(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in g:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


@pytest.mark.parametrize("shuffle,drop_last,workers", [
    (True, True, 0), (True, False, 0), (False, True, 0), (True, True, 4),
    (False, False, 4)])
def test_batches_equal_the_jax_loaders(shuffle, drop_last, workers):
    ds = _dataset()
    kw = dict(batch_size=4, seed=7, shuffle=shuffle, drop_last=drop_last,
              num_workers=workers, num_processes=1, process_index=0)
    port, ref = DeepSpeedDataLoader(ds, **kw), JaxLoader(ds, **kw)
    assert len(port) == len(ref) == (5 if drop_last else 6)
    for _ in range(3):           # epochs 0, 1, 2: the order moves on
        _assert_same_batches(list(port), list(ref))
    assert port.epoch == ref.epoch == 3
    port.set_epoch(1)
    ref.set_epoch(1)
    _assert_same_batches(list(port), list(ref))
    port.close()


def test_process_strided_slice_equals_the_jax_loaders():
    ds = _dataset(16)
    kw = dict(batch_size=8, seed=3, num_processes=2, process_index=1)
    port, ref = DeepSpeedDataLoader(ds, **kw), JaxLoader(ds, **kw)
    assert port.local_batch == ref.local_batch == 4
    _assert_same_batches(list(port), list(ref))
    with pytest.raises(ValueError, match="divide"):
        DeepSpeedDataLoader(ds, batch_size=3, num_processes=2,
                            process_index=0)


def test_repeating_loader_restarts_like_the_jax_one():
    ds = _dataset(8)
    kw = dict(batch_size=4, seed=1, num_processes=1, process_index=0)
    port = RepeatingLoader(DeepSpeedDataLoader(ds, **kw))
    ref = JaxRepeating(JaxLoader(ds, **kw))
    assert len(port) == len(ref) == 2
    got = [next(port) for _ in range(5)]     # 2.5 epochs, each reshuffled
    want = [next(ref) for _ in range(5)]
    _assert_same_batches(got, want)
    # epoch 1 is another order (seed + epoch)
    assert not np.array_equal(got[0]["y"], got[2]["y"])


# ------------------------------------------------------------- the engine
def _token_dataset(n, seq, vocab, seed=4):
    rng = np.random.default_rng(seed)
    return [{"input_ids": rng.integers(0, vocab, seq)} for _ in range(n)]


def _engines(training_data, gas=2):
    jcfg, tcfg = JaxConfig.tiny(**GPT), TransformerConfig.tiny(**GPT)
    params = jax.tree_util.tree_map(np.asarray,
                                    JaxLM(jcfg).init(jax.random.key(0)))

    def conf(micro):
        return {"train_micro_batch_size_per_gpu": micro,
                "gradient_accumulation_steps": gas, "seed": 11,
                "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}}}
    jeng, _, jloader, _ = deepspeed_tpu.initialize(
        model=JaxLM(jcfg), model_parameters=params, config=conf(1),
        training_data=training_data)
    teng, _, tloader, _ = deepspeed_tpu_torch.initialize(
        model=CausalTransformerLM(tcfg, device="cpu"),
        model_parameters=params, config=conf(JAX_DEVICES), device="cpu",
        training_data=training_data)
    return jeng, jloader, teng, tloader


def _assert_trajectories_match(tsteps, jsteps):
    for i, ((tl, tn), (jl, jn)) in enumerate(zip(tsteps, jsteps)):
        np.testing.assert_allclose(tl, jl, rtol=1e-4, err_msg=f"loss {i}")
        np.testing.assert_allclose(tn, jn, rtol=1e-4, err_msg=f"norm {i}")


def test_fresh_iterator_train_batch_repeats_the_jax_trajectory():
    """The JAX quirk, copied: every no-argument ``train_batch()`` reads the
    loader's first gas micro-batches of the same epoch order."""
    ds = _token_dataset(24, 16, 256)
    jeng, jloader, teng, tloader = _engines(ds)
    assert isinstance(tloader, DeepSpeedDataLoader)
    assert len(tloader) == len(jloader) == 3
    jsteps, tsteps = [], []
    for _ in range(3):
        jsteps.append((float(jeng.train_batch()),
                       jeng.get_global_grad_norm()))
        tsteps.append((float(teng.train_batch()),
                       teng.get_global_grad_norm()))
    _assert_trajectories_match(tsteps, jsteps)
    # the same data every call: the loader never finished an epoch
    assert tloader.epoch == 0
    # and the same data as an explicit iterator's first gas micro-batches
    first = next(iter(tloader))
    np.testing.assert_array_equal(
        first["input_ids"], np.stack([ds[i]["input_ids"] for i in
                                      np.random.default_rng(11).permutation(
                                          24)[:JAX_DEVICES]]))


def test_data_iter_train_batch_matches_jax():
    ds = _token_dataset(16, 16, 256, seed=6)
    jeng, jloader, teng, tloader = _engines(ds)
    jit, tit = iter(JaxRepeating(jloader)), iter(RepeatingLoader(tloader))
    jsteps, tsteps = [], []
    for _ in range(3):               # 6 micro-batches: into epoch 1
        jsteps.append((float(jeng.train_batch(data_iter=jit)),
                       jeng.get_global_grad_norm()))
        tsteps.append((float(teng.train_batch(data_iter=tit)),
                       teng.get_global_grad_norm()))
    _assert_trajectories_match(tsteps, jsteps)
    assert tsteps[0] != tsteps[1]    # the iterator moved on


def test_deepspeed_io_takes_the_engines_batch_and_workers():
    teng, *_ = deepspeed_tpu_torch.initialize(
        model=CausalTransformerLM(TransformerConfig.tiny(**GPT),
                                  device="cpu").init(0),
        config={"train_micro_batch_size_per_gpu": 8, "seed": 11},
        device="cpu")
    loader = teng.deepspeed_io(_token_dataset(20, 8, 256),
                               num_local_io_workers=3)
    assert (loader.batch_size, loader.num_workers, loader.seed) == (8, 3, 11)
    assert next(iter(loader))["input_ids"].shape == (8, 8)
    loader.close()
