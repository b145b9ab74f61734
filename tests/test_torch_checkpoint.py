"""Port parity of checkpoints: the engine's save / load and the tools.

* **Round trip on the port.** Train 2 steps, save, load into a fresh
  engine (other init weights), train 2: losses, master, m, v, the
  loss-scale state, the applied and skipped counts and the lr are
  bit-identical to an uninterrupted run -- fp32; fp16 with dynamic scaling
  and skipped steps on both sides of the save; saved at ZeRO stage 3 and
  loaded at stage 0; under an LR schedule.  ``load_module_only`` and
  ``load_optimizer_states=False`` restore the master alone.
* **Against the JAX engine.** Both start from the same params: train 2,
  save, load into a fresh engine, train 2; the resumed trajectories agree
  within ``test_torch_training.py``'s tolerances (rtol 1e-4 on losses and
  grad norms; the final weights atol 2e-5 + rtol 1e-4) and the saved
  ``client_state`` has the same keys and values.
* **Universal format both ways.** A JAX checkpoint through the JAX
  ``ds_to_universal`` loads into the port bit for bit (the params
  ``from_jax_params`` gives); a port checkpoint through the port's
  ``ds_to_universal`` loads into the JAX ``load_universal_checkpoint`` bit
  for bit, with the JAX tool's file names and meta keys.  The port's
  ``zero_to_fp32`` gives the keys and values of the JAX ``_flatten_keys``.
* **Serving from a checkpoint.** ``init_inference(config={"checkpoint":
  dir})`` on a universal dir gives greedy tokens identical to the JAX
  ``InferenceEngine`` loading the same dir; on a port training checkpoint
  the tokens of its master weights.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.checkpoint import deepspeed_checkpoint as jdc
from deepspeed_tpu.checkpoint import universal_checkpoint as juc
from deepspeed_tpu.checkpoint import zero_to_fp32 as jz
from deepspeed_tpu.models.transformer import (
    CausalTransformerLM as JaxLM, TransformerConfig as JaxConfig)
from deepspeed_tpu_torch.checkpoint import (
    DeepSpeedCheckpoint, ds_to_universal, load_checkpoint_tree,
    load_universal_checkpoint, merge_pp_layer_shards, merge_tp_shards,
    slice_tp_shards)
from deepspeed_tpu_torch.checkpoint import zero_to_fp32
from deepspeed_tpu_torch.models.convert import (from_jax_params,
                                                to_numpy_params)
from deepspeed_tpu_torch.models.transformer import (CausalTransformerLM,
                                                    TransformerConfig)

JAX_DEVICES = 8          # the harness's virtual CPU devices
KW = dict(hidden_size=64, n_heads=4, n_kv_heads=2)
CFG = TransformerConfig.tiny(**KW)
WARMUP = {"type": "WarmupLR", "params": {"warmup_min_lr": 0.0,
                                         "warmup_max_lr": 1e-3,
                                         "warmup_num_steps": 3}}


def _jax_params(seed=0):
    return jax.tree_util.tree_map(
        np.asarray, JaxLM(JaxConfig.tiny(**KW)).init(jax.random.key(seed)))


def _config(micro=JAX_DEVICES, **blocks):
    return {"train_micro_batch_size_per_gpu": micro,
            "gradient_accumulation_steps": 2,
            "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}},
            **blocks}


def _port(params=None, seed=0, **blocks):
    model = CausalTransformerLM(CFG, device="cpu")
    if params is None:
        model.init(seed)
    return deepspeed_tpu_torch.initialize(
        model=model, model_parameters=params, config=_config(**blocks),
        device="cpu")[0]


def _batches(n, seed=5):
    rng = np.random.default_rng(seed)
    return [{"input_ids": rng.integers(0, 256, (2, JAX_DEVICES, 16))}
            for _ in range(n)]


def _snapshot(eng):
    ls = eng.loss_scale_state
    return {"master": eng.master.clone(), "m": eng.opt_state.m.clone(),
            "v": eng.opt_state.v.clone(), "count": int(eng.opt_state.count),
            "skipped": int(eng.skipped_steps),
            "scale": [float(x) for x in ls], "lr": eng.get_lr(),
            "steps": eng.global_steps}


def _assert_same_snapshot(got, want):
    for k in ("master", "m", "v"):
        assert torch.equal(got[k], want[k]), k
    for k in ("count", "skipped", "scale", "lr", "steps"):
        assert got[k] == want[k], k


ROUND_TRIPS = {
    "fp32": ({}, {}),
    # skips before and after the save: [1, 1, 0, 1], the scale grows in
    # between (window 2)
    "fp16_skips": ({"fp16": {"enabled": True, "initial_scale_power": 20,
                             "hysteresis": 1, "loss_scale_window": 2}},) * 2,
    "zero3_to_zero0": ({"zero_optimization": {"stage": 3}},
                       {"zero_optimization": {"stage": 0}}),
    "lr_schedule": ({"scheduler": WARMUP},) * 2,
}


@pytest.mark.parametrize("name", list(ROUND_TRIPS))
def test_port_round_trip_is_bitwise(tmp_path, name):
    save_blocks, load_blocks = ROUND_TRIPS[name]
    batches = _batches(4)
    ref = _port(**save_blocks)
    for b in batches[:2]:
        ref.train_batch(batch=b)
    ref.save_checkpoint(str(tmp_path))
    ref_losses = [float(ref.train_batch(batch=b)) for b in batches[2:]]
    want = _snapshot(ref)

    fresh = _port(seed=1, **load_blocks)          # other init weights
    path, client = fresh.load_checkpoint(str(tmp_path))
    assert path == str(tmp_path) and client["global_steps"] == 2
    got_losses = [float(fresh.train_batch(batch=b)) for b in batches[2:]]
    assert got_losses == ref_losses
    _assert_same_snapshot(_snapshot(fresh), want)
    if name == "fp16_skips":
        assert want["skipped"] == 3 and want["count"] == 1
    # the compute-dtype weights were rebuilt from the master
    for p_got, p_want in zip(fresh.module.parameters(),
                             ref.module.parameters()):
        assert torch.equal(p_got, p_want)


@pytest.mark.parametrize("kwargs", [{"load_module_only": True},
                                    {"load_optimizer_states": False}])
def test_load_master_alone(tmp_path, kwargs):
    eng = _port()
    for b in _batches(2):
        eng.train_batch(batch=b)
    eng.save_checkpoint(str(tmp_path))
    fresh = _port(seed=1)
    fresh.load_checkpoint(str(tmp_path), **kwargs)
    assert torch.equal(fresh.master, eng.master)
    assert not fresh.opt_state.m.any() and not fresh.opt_state.v.any()
    assert int(fresh.opt_state.count) == 0 and fresh.global_steps == 2
    assert torch.equal(next(fresh.module.parameters()),
                       next(eng.module.parameters()))


def test_a_checkpoint_of_another_model_is_refused(tmp_path):
    eng = _port()
    eng.save_checkpoint(str(tmp_path))
    other = deepspeed_tpu_torch.initialize(
        model=CausalTransformerLM(TransformerConfig.tiny(hidden_size=32),
                                  device="cpu").init(0),
        config=_config(), device="cpu")[0]
    with pytest.raises(ValueError, match="not this model's"):
        other.load_checkpoint(str(tmp_path))


# ---------------------------------------------------------------- vs JAX
@pytest.fixture(scope="module")
def jax_ckpt(tmp_path_factory):
    """The JAX engine from the shared params: 2 steps, saved, then 2 more
    (losses and norms); a fresh JAX engine resumes the same 2."""
    root = tmp_path_factory.mktemp("jax_ckpt")
    params = _jax_params()
    batches = _batches(4)
    jcfg = JaxConfig.tiny(**KW)
    conf = _config(micro=1, scheduler=WARMUP)
    jeng, *_ = deepspeed_tpu.initialize(model=JaxLM(jcfg),
                                        model_parameters=params, config=conf)
    for b in batches[:2]:
        jeng.train_batch(batch=b)
    jeng.save_checkpoint(str(root))
    with open(root / "global_step2" / "client_state.json") as f:
        client = json.load(f)
    fresh, *_ = deepspeed_tpu.initialize(
        model=JaxLM(jcfg), model_parameters=_jax_params(1), config=conf)
    fresh.load_checkpoint(str(root))
    steps = [(float(fresh.train_batch(batch=b)), fresh.get_global_grad_norm())
             for b in batches[2:]]
    final = jax.tree_util.tree_map(np.asarray,
                                   jax.device_get(fresh.state.params))
    return {"root": root, "params": params, "client": client,
            "steps": steps, "final": final,
            "saved": jax.tree_util.tree_map(
                np.asarray, jax.device_get(jeng.state.params))}


def test_resumed_trajectory_and_client_state_match_jax(jax_ckpt, tmp_path):
    batches = _batches(4)
    eng = _port(params=jax_ckpt["params"], scheduler=WARMUP)
    for b in batches[:2]:
        eng.train_batch(batch=b)
    eng.save_checkpoint(str(tmp_path))
    with open(tmp_path / "global_step2" / "client_state.json") as f:
        assert json.load(f) == jax_ckpt["client"]
    fresh = _port(seed=1, scheduler=WARMUP)
    fresh.load_checkpoint(str(tmp_path))
    for i, (b, (jl, jn)) in enumerate(zip(batches[2:], jax_ckpt["steps"])):
        np.testing.assert_allclose(float(fresh.train_batch(batch=b)), jl,
                                   rtol=1e-4, err_msg=f"loss {i}")
        np.testing.assert_allclose(fresh.get_global_grad_norm(), jn,
                                   rtol=1e-4, err_msg=f"norm {i}")
    got = to_numpy_params(fresh.module_state_dict())
    want = jax_ckpt["final"]
    for key in got["layers"]:
        np.testing.assert_allclose(got["layers"][key], want["layers"][key],
                                   rtol=1e-4, atol=2e-5, err_msg=key)
    for key in set(got) - {"layers"}:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4,
                                   atol=2e-5, err_msg=key)


def test_jax_universal_dir_loads_into_the_port_bitwise(jax_ckpt, tmp_path):
    udir = str(tmp_path / "universal")
    juc.ds_to_universal(str(jax_ckpt["root"]), udir)
    template = to_numpy_params(CausalTransformerLM(CFG, device="cpu"))
    tree = load_universal_checkpoint(udir, template=template)
    eng = deepspeed_tpu_torch.initialize(
        model=CausalTransformerLM(CFG, device="cpu"), model_parameters=tree,
        config=_config(), device="cpu")[0]
    want = from_jax_params(jax_ckpt["saved"], CFG)
    for name, view in zip(eng._names, eng._master_views):
        assert torch.equal(view, want[name]), name
    flat = load_universal_checkpoint(udir)
    assert set(flat) == set(juc.load_universal_checkpoint(udir))


@pytest.fixture(scope="module")
def port_ckpt(tmp_path_factory):
    root = tmp_path_factory.mktemp("port_ckpt")
    eng = _port(params=_jax_params())
    for b in _batches(2):
        eng.train_batch(batch=b)
    eng.save_checkpoint(str(root))
    return root, to_numpy_params(eng.module_state_dict())


def test_port_universal_dir_loads_into_jax_bitwise(port_ckpt, jax_ckpt,
                                                   tmp_path):
    root, weights = port_ckpt
    udir, jdir = str(tmp_path / "port_u"), str(tmp_path / "jax_u")
    ds_to_universal(str(root), udir)
    juc.ds_to_universal(str(jax_ckpt["root"]), jdir)
    got = juc.load_universal_checkpoint(udir, template=jax_ckpt["params"])
    for key in weights["layers"]:
        np.testing.assert_array_equal(got["layers"][key],
                                      weights["layers"][key], err_msg=key)
    for key in set(weights) - {"layers"}:
        np.testing.assert_array_equal(got[key], weights[key], err_msg=key)
    with open(os.path.join(udir, juc.META_NAME)) as f:
        port_meta = json.load(f)
    with open(os.path.join(jdir, juc.META_NAME)) as f:
        jax_meta = json.load(f)
    assert port_meta["keys"] == jax_meta["keys"]   # files, shapes, dtypes
    assert port_meta["tag"] == jax_meta["tag"] == "global_step2"
    assert sorted(os.listdir(udir)) == sorted(os.listdir(jdir))


def test_zero_to_fp32_gives_the_jax_tools_keys(port_ckpt, tmp_path):
    root, weights = port_ckpt
    out = str(tmp_path / "fp32.npz")
    zero_to_fp32.main([str(root), out])
    want = jz._flatten_keys(weights)
    with np.load(out) as z:
        assert set(z.files) == set(want)
        for k in want:
            np.testing.assert_array_equal(z[k], want[k], err_msg=k)
    tree = zero_to_fp32.get_fp32_state_dict_from_zero_checkpoint(str(root))
    assert jz._flatten_keys(tree).keys() == want.keys()


def test_checkpoint_tree_and_inspection(port_ckpt):
    root, weights = port_ckpt
    state = load_checkpoint_tree(str(root))
    assert set(state) == {"params", "opt_state", "loss_scale",
                          "skipped_steps", "global_step"}
    np.testing.assert_array_equal(state["params"]["layers"]["wq"],
                                  weights["layers"]["wq"])
    assert state["opt_state"]["m"]["layers"]["wq"].shape == \
        weights["layers"]["wq"].shape
    assert int(state["opt_state"]["count"]) == 2
    ck = DeepSpeedCheckpoint(str(root), tp_degree=2)
    assert ck.get_iteration() == 2 and ck.tag == "global_step2"
    ck.validate_files()
    assert set(ck.params) == set(weights)


def test_shard_helpers_match_jax():
    rng = np.random.default_rng(0)
    w = rng.standard_normal((4, 6)).astype(np.float32)
    for dim in (0, 1):
        shards = slice_tp_shards(w, 2, dim)
        for a, b in zip(shards, jdc.slice_tp_shards(w, 2, dim)):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(merge_tp_shards(shards, dim), w)
    stages = [{"wq": rng.standard_normal((2, 3))} for _ in range(3)]
    np.testing.assert_array_equal(merge_pp_layer_shards(stages)["wq"],
                                  jdc.merge_pp_layer_shards(stages)["wq"])
    with pytest.raises(ValueError, match="divisible"):
        slice_tp_shards(w, 4, 1)


# --------------------------------------------------------------- serving
def test_serving_from_a_universal_dir_matches_jax(port_ckpt, tmp_path):
    root, weights = port_ckpt
    udir = str(tmp_path / "u")
    ds_to_universal(str(root), udir)
    prompt = np.random.default_rng(2).integers(0, CFG.vocab_size, (2, 5))
    jeng = deepspeed_tpu.init_inference(
        model=JaxLM(JaxConfig.tiny(**KW)),
        config={"dtype": "float32", "checkpoint": udir})
    want = np.asarray(jeng.generate(prompt, max_new_tokens=6))
    for ckpt in (udir, str(root)):    # a universal dir, a training tag
        teng = deepspeed_tpu_torch.init_inference(
            CausalTransformerLM(CFG, device="cpu"),
            config={"dtype": "float32", "checkpoint": ckpt}, device="cpu")
        np.testing.assert_array_equal(
            teng.generate(prompt, max_new_tokens=6).numpy(), want)
