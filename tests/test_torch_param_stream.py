"""Port parity of ZeRO-Infinity's parameter stream (ROADMAP A12b).

Mirrors ``tests/unit/test_param_stream.py`` on the port, on the CPU at a
tiny size, from numpy-seeded inputs:

* ``HostParamStore`` against the JAX one on identical trees and
  gradients, 3 steps of gas 2 with clipping: master, moments and mirror
  bit for bit for Adam (AdamW and L2), with fp32 and bf16 accumulators;
  Adagrad within 2 fp32 ulps a step (the JAX store's Adagrad runs numpy);
  the grad norm within rtol 1e-6 (a BLAS dot in each, summed in another
  order); the heterogeneous branch;
* the streamed engine against the JAX streamed engine (fp32, 3 steps; 8
  virtual devices with micro 1 each, the port micro 8): losses and grad
  norms rtol 1e-4, final parameters atol 2e-5 + rtol 1e-4, as
  ``tests/test_torch_training.py`` holds the device paths -- with gas and
  clipping on a tied GPT-2 shape, ``resident_layers`` and a deeper
  ``buffer_count`` on a Llama shape, GPT-Neo's windows, ALiBi with the
  embedding norm; an fp16 overflow's skip pattern and loss scale exact;
* the streamed engine against the port's own ``offload_optimizer``
  engine (losses rtol 1e-4), nvme bit for bit against cpu, a checkpoint's
  resume bit for bit, ``zero_to_fp32`` of a stream tag, ``eval_batch``,
  ``ds_bench train --offload-param`` and the boundary bench, and the
  refusals.
"""

import os

import jax
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models.transformer import (
    CausalTransformerLM as JaxLM, TransformerConfig as JaxConfig)
from deepspeed_tpu.runtime.zero.param_stream import \
    HostParamStore as JaxHostParamStore
from deepspeed_tpu_torch.checkpoint import zero_to_fp32
from deepspeed_tpu_torch.models.convert import to_numpy_params
from deepspeed_tpu_torch.models.transformer import (CausalTransformerLM,
                                                    TransformerConfig)
from deepspeed_tpu_torch.runtime import resilience
from deepspeed_tpu_torch.runtime.zero.param_stream import HostParamStore
from torch_threads import _one_torch_thread  # noqa: F401

F32_EPS = 2.0 ** -23
JAX_DEVICES = 8
SEQ = 16
GPT = dict(hidden_size=64, n_heads=4, n_layers=3, activation="gelu",
           use_rmsnorm=False, use_rope=False, norm_bias=True,
           tie_embeddings=True)
LLAMA = dict(hidden_size=64, n_heads=4, n_kv_heads=2, n_layers=3)


# ------------------------------------------------ the store against JAX
def _unit(rng, shapes):
    return {k: rng.normal(size=s).astype(np.float32)
            for k, s in shapes.items()}


RES_SHAPES = {"tok_embed": (50, 8), "final_norm": (8,)}
LAYER_SHAPES = {"wq": (8, 12), "w_up": (8, 20), "attn_norm": (8,)}


def _bits(t):
    """A bf16 / fp32 plane's bits as numpy, port or JAX."""
    if torch.is_tensor(t):
        t = t.contiguous()
        return (t.view(torch.int16) if t.dtype == torch.bfloat16
                else t).numpy()
    a = np.asarray(t)
    return a.view(np.int16) if a.dtype.itemsize == 2 else a


@pytest.mark.parametrize("name,params,grad_dtype", [
    ("adamw", {"lr": 1e-3, "weight_decay": 0.01}, "float32"),
    ("adam", {"lr": 1e-3, "weight_decay": 0.01}, "bfloat16"),
    ("adagrad", {"lr": 1e-2}, "float32")])
def test_host_store_matches_jax(name, params, grad_dtype):
    rng = np.random.default_rng(0)
    res = _unit(rng, RES_SHAPES)
    layers = [_unit(rng, LAYER_SHAPES) for _ in range(3)]
    jgdt = np.dtype(jax.numpy.dtype(grad_dtype))
    js = JaxHostParamStore(res, layers, opt_params=params, opt_name=name,
                           grad_dtype=jgdt)
    ts = HostParamStore({k: torch.from_numpy(v) for k, v in res.items()},
                        [{k: torch.from_numpy(v) for k, v in t.items()}
                         for t in layers], opt_params=params, opt_name=name,
                        grad_dtype=getattr(torch, grad_dtype))
    assert ts.homogeneous and js.homogeneous
    assert ts.num_params() == js.num_params()
    assert ts.res_layout.total == js.res_layout.total
    gas = 2
    for step in range(3):
        for m in range(gas):
            for l in range(-1, 3):
                n = ts.layout(l).total
                flat = rng.normal(size=n).astype(np.float32) * (1 + step)
                js.accumulate(l, flat, m == 0)
                ts.accumulate(l, torch.from_numpy(flat), m == 0)
        np.testing.assert_array_equal(_bits(ts.gaccs), _bits(js.gaccs))
        np.testing.assert_array_equal(_bits(ts.res_gacc),
                                      _bits(js.res_gacc))
        for l in range(-1, 3):
            js.cache_unit_sq(l)
            ts.cache_unit_sq(l)
        jsq, tsq = js.grad_sq_norm(), ts.grad_sq_norm()
        np.testing.assert_allclose(tsq, jsq, rtol=1e-6)
        coef = 0.5 / (np.sqrt(jsq) / gas + 1e-6)     # one coefficient
        js.begin_step()
        ts.begin_step()
        for l in range(-1, 3):
            js.apply_unit(l, 1e-3 * (step + 1), coef, gas)
            ts.apply_unit(l, 1e-3 * (step + 1), coef, gas)
    want, got = js.state_dict(), ts.state_dict()
    assert got["step"] == want["step"] == 3
    for key in set(want) - {"step"}:
        if name == "adagrad":
            w = np.asarray(want[key])
            tol = 2 * 3 * F32_EPS * (np.abs(w) + 1e-2)
            assert np.all(np.abs(got[key].numpy() - w) <= tol), key
        else:
            np.testing.assert_array_equal(got[key].numpy(), want[key],
                                          err_msg=key)
    if name != "adagrad":
        np.testing.assert_array_equal(_bits(ts.mirrors), _bits(js.mirrors))


def test_host_store_shape_mismatch_not_homogeneous():
    """Equal totals and names, other per-tensor shapes: the per-layer
    branch (layer 0's layout would unflatten wrong views)."""
    t0 = {"w": torch.ones(4, 8)}
    t1 = {"w": torch.ones(8, 4)}
    store = HostParamStore({"e": torch.ones(2)}, [t0, t1])
    assert not store.homogeneous
    assert store.layouts[1].unflatten(store.masters[1])["w"].shape == (8, 4)
    jstore = JaxHostParamStore({"e": np.ones(2, np.float32)},
                               [{"w": np.ones((4, 8), np.float32)},
                                {"w": np.ones((8, 4), np.float32)}])
    assert sorted(store.state_dict()) == sorted(jstore.state_dict())


# ----------------------------------------------------------- the engine
def _params(shape, seed=0):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: (np.asarray(x) + 0.05 * rng.standard_normal(x.shape))
        .astype(np.float32),
        JaxLM(JaxConfig.tiny(**shape)).init(jax.random.key(seed)))


def _zero(param=None, optimizer="cpu", **extra):
    zo = {"stage": 0, "offload_param": dict({"device": "cpu"},
                                            **(param or {})),
          "offload_optimizer": {"device": optimizer}}
    zo["offload_optimizer"].update(extra.pop("opt_extra", {}))
    zo.update(extra)
    return zo


def _config(micro, zero, gas=1, clip=0.0, **extra):
    return {"train_micro_batch_size_per_gpu": micro,
            "gradient_accumulation_steps": gas,
            "optimizer": {"type": "AdamW",
                          "params": {"lr": 1e-3, "weight_decay": 0.01}},
            "gradient_clipping": clip, "zero_optimization": zero, **extra}


def _port(shape, config, params=None, device_model="cpu"):
    return deepspeed_tpu_torch.initialize(
        model=CausalTransformerLM(TransformerConfig.tiny(**shape),
                                  device=device_model),
        model_parameters=params if params is not None else _params(shape),
        config=config, device="cpu")[0]


def _batches(n=3, gas=1, micro=JAX_DEVICES, seed=5):
    rng = np.random.default_rng(seed)
    shape = (gas, micro, SEQ) if gas > 1 else (micro, SEQ)
    return [{"input_ids": rng.integers(0, 256, shape)} for _ in range(n)]


def _first_grads(engine):
    """The first step's gradients, from Adam's m after it ((1 - beta1) *
    gradient), in the JAX layout."""
    store = engine._param_stream.store
    m = engine.module.stream_join(
        store.res_layout.unflatten(store.res_moments[0] / (1 - 0.9)),
        [store.layouts[l].unflatten(store.moments[0][l] / (1 - 0.9))
         for l in range(store.n_layers)])
    return to_numpy_params(m)


def _check_params(got, want, init, first, steps, atol=2e-5):
    """``tests/test_torch_training.py``'s rule: atol + rtol 1e-4, but a
    weight whose first gradient is under FIRST_GRAD_FLOOR (Adam's eps
    turns its rounding noise into a fraction of a step) is held to Adam's
    step bound on each side."""
    def close(g, w, i, g1, key):
        noise = np.abs(g1) < FIRST_GRAD_FLOOR
        for side in (g, w):
            assert np.abs(side - i)[noise].max(initial=0.0) <= \
                1.5e-3 * steps, key
        np.testing.assert_allclose(g[~noise], w[~noise], rtol=1e-4,
                                   atol=atol, err_msg=key)
    for key in got["layers"]:
        close(got["layers"][key], want["layers"][key],
              init["layers"][key], first["layers"][key], key)
    for key in set(got) - {"layers"}:
        close(got[key], want[key], init[key], first[key], key)


STREAM_CASES = {
    "gpt2_tied_gas_clip": (GPT, {}, dict(gas=2, clip=0.5)),
    "llama_resident_layers_buffer_count": (
        LLAMA, {"resident_layers": 1, "buffer_count": 3}, {}),
    "gpt_neo_windows": (dict(GPT, tie_embeddings=False, attn_scale=1.0,
                             local_attn_pattern=(0, 8, 0)), {}, {}),
    "alibi_embed_norm": (dict(GPT, use_alibi=True, embed_norm=True), {},
                         dict(clip=0.5)),
}
# tests/test_torch_training.py's PARAM_ATOL for its GPT-Neo-style config,
# for the same cause: unscaled logits give a few weights a first gradient
# near Adam's eps, whose first step is then rounding noise times lr
PARAM_ATOL = {"gpt_neo_windows": 1e-4}
# tests/test_torch_training.py's FIRST_GRAD_FLOOR (its head-dim-80 / 96
# and Gemma cases): a weight whose first gradient is under it takes a first
# Adam step set by rounding noise
FIRST_GRAD_FLOOR = 1e-7


@pytest.mark.parametrize("case", sorted(STREAM_CASES))
def test_stream_engine_matches_jax(case):
    """The port's streamed engine against the JAX streamed engine: losses
    and grad norms rtol 1e-4 over 3 steps, final parameters atol 2e-5 +
    rtol 1e-4."""
    shape, param, kw = STREAM_CASES[case]
    params = _params(shape)
    gas, clip = kw.get("gas", 1), kw.get("clip", 0.0)
    jeng, *_ = deepspeed_tpu.initialize(
        model=JaxLM(JaxConfig.tiny(**shape)), model_parameters=params,
        config=_config(1, _zero(param), gas, clip))
    teng = _port(shape, _config(JAX_DEVICES, _zero(param), gas, clip),
                 params)
    assert jeng._param_stream is not None and teng._param_stream is not None
    assert teng.master is None and teng.grads is None
    runner = teng._param_stream
    assert runner.store.homogeneous
    assert (runner.buffer_count, runner.resident_layers) == (
        jeng._param_stream.buffer_count, jeng._param_stream.resident_layers)
    first = None
    for step, batch in enumerate(_batches(gas=gas)):
        np.testing.assert_allclose(float(teng.train_batch(batch=batch)),
                                   float(jeng.train_batch(batch=batch)),
                                   rtol=1e-4, err_msg=f"loss {step}")
        np.testing.assert_allclose(teng.get_global_grad_norm(),
                                   jeng.get_global_grad_norm(), rtol=1e-4)
        if clip:
            assert teng.get_global_grad_norm() > clip    # clipping acts
        if step == 0:
            first = _first_grads(teng)
    assert teng.applied_steps() == jeng._param_stream.store.step_count == 3
    stats = runner.store.tiered.stats()
    assert stats["prefetch_hits"] > 0 and stats["prefetch_misses"] == 0
    _check_params(to_numpy_params(teng.module_state_dict()),
                  jax.tree_util.tree_map(np.asarray,
                                         jeng.module_state_dict()),
                  params, first, 3, atol=PARAM_ATOL.get(case, 2e-5))
    # the stream's own tree is the JAX layout of the same master
    tree = runner.params_tree()
    np.testing.assert_array_equal(
        tree["layers"]["wq"],
        to_numpy_params(teng.module_state_dict())["layers"]["wq"])


def test_stream_fp16_overflow_matches_jax():
    """fp16 from a loss scale that overflows (hysteresis 1): the skip
    pattern, the loss scale and the skipped count exact against the JAX
    streamed engine; a skipped step leaves the master as it was."""
    fp16 = {"enabled": True, "initial_scale_power": 22, "hysteresis": 1}
    params = _params(GPT)
    jeng, *_ = deepspeed_tpu.initialize(
        model=JaxLM(JaxConfig.tiny(**GPT)), model_parameters=params,
        config=_config(1, _zero(), fp16=fp16))
    teng = _port(GPT, _config(JAX_DEVICES, _zero(), fp16=fp16), params)
    skips = []
    for batch in _batches(8):
        before = teng._param_stream.store.masters.clone()
        teng.train_batch(batch=batch)
        jeng.train_batch(batch=batch)
        skips.append(teng.last_step_overflowed())
        assert skips[-1] == bool(jeng.state.skipped_steps - sum(skips[:-1]))
        assert teng.get_loss_scale() == float(
            jeng.state.loss_scale.cur_scale)
        assert teng._host_ls.cur_scale == teng.get_loss_scale()
        if skips[-1]:
            assert torch.equal(teng._param_stream.store.masters, before)
    assert int(teng.skipped_steps) == int(jeng.state.skipped_steps)
    assert 0 < sum(skips) < 8, skips


def test_stream_matches_own_offload_engine_and_eval():
    """The stream against the port's ``offload_optimizer`` engine (the
    JAX test's pairing; fp32, losses rtol 1e-4), ``eval_batch`` equal
    likewise; the legacy ``cpu_offload_param`` key is ``offload_param``
    cpu; a model on ``meta`` takes ``model_parameters`` into the store."""
    params = _params(GPT)
    off = _port(GPT, _config(4, {"stage": 0, "offload_optimizer": {
        "device": "cpu"}}, gas=2), params)
    legacy = _port(GPT, _config(4, {"stage": 0, "cpu_offload_param": True,
                                    "offload_optimizer": {"device": "cpu"}},
                                gas=2), params)
    meta = _port(GPT, _config(4, _zero(), gas=2), params,
                 device_model="meta")
    assert legacy._param_stream is not None and meta._param_stream is not None
    for batch in _batches(micro=4, gas=2):
        lo = float(off.train_batch(batch=batch))
        ll = float(legacy.train_batch(batch=batch))
        assert float(meta.train_batch(batch=batch)) == ll
        np.testing.assert_allclose(ll, lo, rtol=1e-4)
    ids = _batches(1, micro=4, seed=9)[0]
    np.testing.assert_allclose(float(legacy.eval_batch(ids)),
                               float(off.eval_batch(ids)), rtol=1e-4)
    # the module's own parameters are released once the store holds them
    assert all(p.numel() == 0 for p in legacy.module.parameters())


def test_stream_nvme_matches_cpu(tmp_path):
    """nvme bit for bit against cpu: param nvme with optimizer nvme, and
    param nvme with optimizer cpu, whose moments stay in RAM; param cpu
    with optimizer nvme maps the moments alone."""
    params = _params(GPT)
    cpu = _port(GPT, _config(4, _zero()), params)
    both = _port(GPT, _config(4, _zero(
        {"device": "nvme", "nvme_path": str(tmp_path / "a")}, "nvme")),
        params)
    param_only = _port(GPT, _config(4, _zero(
        {"device": "nvme", "nvme_path": str(tmp_path / "b")}, "cpu")),
        params)
    opt_only = _port(GPT, _config(4, _zero(
        {}, "nvme", opt_extra={"nvme_path": str(tmp_path / "c")})), params)

    def tiers(e):
        return {k: t for k, (t, _) in
                e._param_stream.store.tiered._planes.items()}
    assert set(tiers(both).values()) == {"nvme"}
    t = tiers(param_only)
    assert t["layer_master"] == "nvme" and t["layer_m0"] == "host"
    t = tiers(opt_only)
    assert t["layer_master"] == "host" and t["layer_m1"] == "nvme"
    files = os.listdir(tmp_path / "a" / "zero_param_stream" / "rank0")
    assert "layer_master.mm" in files and "layer_mirror.mm" in files
    for batch in _batches(2, micro=4):
        want = float(cpu.train_batch(batch=batch))
        for e in (both, param_only, opt_only):
            assert float(e.train_batch(batch=batch)) == want
    for e in (both, param_only, opt_only):
        for key, val in cpu._param_stream.store.state_dict().items():
            got = e._param_stream.store.state_dict()[key]
            assert (got == val) if key == "step" else torch.equal(got, val)


def test_stream_checkpoint_resume_and_zero_to_fp32(tmp_path):
    """A stream tag holds the sidecar and its meta, listed in the
    manifest; a fresh engine resumes bit for bit; ``load_optimizer_states
    =False`` restores the masters alone; ``zero_to_fp32`` of the tag is
    ``params_tree()``."""
    params = _params(GPT)
    batches = _batches(4, micro=4, gas=2)
    a = _port(GPT, _config(4, _zero(), gas=2, clip=0.5), params)
    for b in batches[:2]:
        a.train_batch(batch=b)
    a.save_checkpoint(str(tmp_path), tag="ck")
    status, manifest = resilience.validate_tag(str(tmp_path / "ck"))
    assert status == resilience.COMMITTED
    names = {f["path"] for f in manifest["files"]}
    assert {"zero_param_stream_rank0.npz",
            "zero_param_stream_rank0.meta.json"} <= names
    got = zero_to_fp32.get_fp32_state_dict_from_zero_checkpoint(
        str(tmp_path), "ck")
    want = a._param_stream.params_tree()
    for key in want["layers"]:
        np.testing.assert_array_equal(got["layers"][key],
                                      want["layers"][key])
    for key in set(want) - {"layers"}:
        np.testing.assert_array_equal(got[key], want[key])
    b = _port(GPT, _config(4, _zero(), gas=2, clip=0.5), params)
    b.load_checkpoint(str(tmp_path), tag="ck")
    assert b.global_steps == 2 and b.applied_steps() == 2
    for e in (a, b):
        for batch in batches[2:]:
            e.train_batch(batch=batch)
    for key, val in a._param_stream.store.state_dict().items():
        got_b = b._param_stream.store.state_dict()[key]
        assert (got_b == val) if key == "step" else torch.equal(got_b, val)
    assert torch.equal(a._param_stream.store.mirrors,
                       b._param_stream.store.mirrors)
    c = _port(GPT, _config(4, _zero(), gas=2, clip=0.5), params)
    c.load_checkpoint(str(tmp_path), tag="ck", load_optimizer_states=False)
    with np.load(str(tmp_path / "ck" / "zero_param_stream_rank0.npz")) as z:
        saved = torch.from_numpy(z["masters"])
    assert torch.equal(c._param_stream.store.masters, saved)
    assert c.applied_steps() == 0
    assert not c._param_stream.store.moments[0].any()


def test_stream_refusals():
    """The three-call API raises naming ``train_batch``; a model without
    the stream contract, an optimizer outside the host whitelist, MoE
    (A14)."""
    e = _port(GPT, _config(4, _zero()))
    for call in (lambda: e.forward(_batches(1, micro=4)[0]),
                 lambda: e.backward(None), e.step):
        with pytest.raises(NotImplementedError, match="train_batch"):
            call()

    class NotStreamable(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.ones(4))

        def loss(self, batch, attn_backend="auto"):
            return self.w.sum()
    with pytest.raises(ValueError, match="layer-streamable"):
        deepspeed_tpu_torch.initialize(
            model=NotStreamable(), config=_config(4, _zero()), device="cpu")
    lamb = _config(4, _zero())
    lamb["optimizer"] = {"type": "Lamb", "params": {}}
    with pytest.raises(ValueError, match="offload_param supports") as te:
        _port(GPT, lamb)
    with pytest.raises(ValueError) as je:
        deepspeed_tpu.initialize(model=JaxLM(JaxConfig.tiny(**GPT)),
                                 model_parameters=_params(GPT),
                                 config=dict(lamb,
                                             train_micro_batch_size_per_gpu=1))
    assert str(te.value) == str(je.value)
    with pytest.raises(NotImplementedError, match="ROADMAP A14"):
        CausalTransformerLM(TransformerConfig.tiny(moe_num_experts=4),
                            device="cpu")


def test_ds_bench_train_offload_param_on_cpu(monkeypatch, capsys):
    """``ds_bench train --offload-param cpu`` on a tiny model: the JAX
    CLI's keys (``offload_param``, ``resident_layers``, ``boundary``),
    the optimizer on the host by default, the serial boundary's losses
    equal to the pipelined one's, and the first loss the run without the
    flag's (its weights drawn as that run draws them)."""
    from deepspeed_tpu_torch.benchmarks import training
    real = training.model_config
    monkeypatch.setattr(training, "model_config", lambda model, seq, **kw:
                        real(dict(hidden_size=64, n_layers=3, n_heads=4),
                             seq, **dict(kw, vocab_size=256)))
    argv = ["--batch", "2", "--seq", "16", "--steps", "2", "--device",
            "cpu", "--json", "--offload-param", "cpu", "--resident-layers",
            "1", "--buffer-count", "3"]
    out = training.main(argv)
    printed = capsys.readouterr().out
    for key in ('"offload_param": "cpu"', '"resident_layers": 1',
                '"boundary": "pipelined"'):
        assert key in printed
    serial = training.main(argv + ["--serial-boundary"])
    assert serial["boundary"] == "serial"
    assert serial["losses"] == out["losses"]
    # the host model holds the weights a run without the flag draws: the
    # same first loss
    plain = training.main(argv[:8])
    assert plain["losses"][0] == out["losses"][0]
    assert all(np.isfinite(out["losses"]))
    assert out["offload_step"]["update_s"] > 0


def test_param_stream_boundary_bench_on_cpu(capsys):
    """The boundary bench at a tiny size: its JSON lines, pipelined and
    serial, and the writeback section."""
    import json
    from deepspeed_tpu_torch.benchmarks import param_stream_boundary
    boundary, writeback = param_stream_boundary.main(
        ["--hidden", "64", "--layers", "2", "--vocab", "256", "--numel",
         "20000", "--sub-groups", "2", "--reps", "1", "--cpu"])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()
             if x.startswith("{")]
    assert [x["section"] for x in lines] == ["boundary", "writeback",
                                             "summary"]
    assert boundary["serial_sec"] > 0 and writeback["streamed_sec"] > 0
