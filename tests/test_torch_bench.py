"""Port parity of the serving and inference benches and of the ``ds_bench``
dispatcher.

Both benches run on the CPU at ``tiny`` (head dim 16) with small
arguments, through the port (``--cpu``) and through the JAX module: the
same modes and JSON keys, the same ``gen_tokens`` and
``requests_measured``, and the same prompt mix (the prompts each engine
was handed).  The weights differ (each package seeds its own), so the
tokens are not compared here: ``tests/test_torch_serving.py`` holds them
at tiny's shape with the JAX weights.  ``print_latency`` equals JAX's on a
seeded list; the unported flags and suites raise naming their ROADMAP
item.  The host benches of ZeRO-Offload (``cpu_adam``, ``aio``,
``offload``) run tiny through the dispatcher and print the JAX modules'
rows with their keys (the comparison row of ``cpu_adam`` is the plain
PyTorch version where JAX's is its numpy fallback).
"""

import json

import numpy as np
import pytest
import torch

import deepspeed_tpu.benchmarks.aio as jax_aio
import deepspeed_tpu.benchmarks.cpu_adam as jax_cpu_adam
import deepspeed_tpu.benchmarks.inference as jax_inference
import deepspeed_tpu.benchmarks.offload as jax_offload
import deepspeed_tpu.benchmarks.serving as jax_serving
from deepspeed_tpu.inference.serving import ServingEngine as JaxServingEngine
from deepspeed_tpu_torch.benchmarks import __main__ as ds_bench
from deepspeed_tpu_torch.benchmarks import inference, serving
from deepspeed_tpu_torch.inference.serving import ServingEngine
from torch_threads import _one_torch_thread  # noqa: F401

# prompts of 4 tokens (the mix draws lengths from [max(4, 2), 4]): one
# prefill bucket, one shape for the JAX engines to compile
SERVE_ARGS = ["--model", "tiny", "--requests", "5", "--max-batch", "2",
              "--prompt-len", "4", "--gen", "3", "--page-size", "8",
              "--decode-chunk", "2", "--cpu"]


def _json_lines(text):
    return [json.loads(line) for line in text.splitlines()
            if line.startswith("{")]


def _recording(monkeypatch, cls):
    """Record the prompts every ``cls.generate`` call is handed."""
    seen, orig = [], cls.generate

    def generate(self, prompts, *a, **kw):
        seen.append([list(map(int, p)) for p in prompts])
        return orig(self, prompts, *a, **kw)
    monkeypatch.setattr(cls, "generate", generate)
    return seen


def test_serving_bench_matches_jax(capsys, monkeypatch):
    seen_jax = _recording(monkeypatch, JaxServingEngine)
    jax_serving.main(SERVE_ARGS)
    want = _json_lines(capsys.readouterr().out)
    seen_port = _recording(monkeypatch, ServingEngine)
    got = serving.main(SERVE_ARGS)
    printed = _json_lines(capsys.readouterr().out)
    assert printed == got["records"]
    assert [r["mode"] for r in printed] == [r["mode"] for r in want] == [
        "continuous_batching", "continuous_batching_chunk2",
        "sequential_single_stream"]
    for p, w in zip(printed, want):
        assert set(p) == set(w)
        for key in ("requests", "max_batch", "gen_tokens",
                    "requests_measured"):
            assert p.get(key) == w.get(key), key
    assert printed[0]["gen_tokens"] == 5 * 3
    assert printed[2]["requests_measured"] == 2
    # the same prompt mix, warm-up first, in both engines of each package
    assert seen_port == seen_jax and len(seen_port) == 4
    lens, prompts = serving.prompt_mix(5, 4, 256)
    assert seen_port[1] == prompts and list(map(len, prompts)) == \
        lens.tolist()
    # model calls: one per prefill (warm-up included) and per decode step
    calls, prefills = got["model_calls"], got["prefills"]
    assert prefills["continuous_batching"] == 6
    assert calls["sequential_single_stream"] == 2 + 2 * 3
    assert calls["continuous_batching"] > prefills["continuous_batching"]


def test_serving_bench_tiny_is_head_dim_16():
    cfg = serving.model_config("tiny")
    assert (cfg.head_dim, cfg.n_heads, cfg.kv_heads, cfg.remat) == \
        (16, 4, 4, False)
    assert serving.model_config("gpt2_125m").head_dim == 64


def test_inference_bench_matches_jax(capsys):
    args = dict(model_size="tiny", dtype="fp32", batch=1, prompt_len=8,
                max_new_tokens=3, trials=1)
    want_stats = jax_inference.run_benchmark(**args)
    want_out = capsys.readouterr().out
    got_stats, record = inference.benchmark(**args, device="cpu")
    got_out = capsys.readouterr().out
    want = _json_lines(want_out)[-1]
    assert _json_lines(got_out)[-1] == record
    assert set(record) == set(want)
    for key in ("model", "dtype", "int8", "zero_stream", "batch",
                "prompt_len", "max_new_tokens"):
        assert record[key] == want[key], key
    assert set(record["token_latency_ms"]) == set(want["token_latency_ms"])
    assert set(got_stats) == set(want_stats)
    # the human table: the same titles, line for line
    titles = [line.split(":")[0] for line in want_out.splitlines()
              if line.startswith(("==", "\t"))]
    assert [line.split(":")[0] for line in got_out.splitlines()
            if line.startswith(("==", "\t"))] == titles


def test_print_latency_matches_jax(capsys):
    lat = list(np.random.default_rng(7).uniform(0.001, 0.05, 40))
    want = jax_inference.print_latency(lat, "token latency")
    want_out = capsys.readouterr().out
    assert inference.print_latency(lat, "token latency") == want
    assert capsys.readouterr().out == want_out
    assert inference.print_latency(lat[:3], "short") is None


@pytest.mark.parametrize("argv,item", [
    (["--int8", "--cpu"], "A12"), (["--zero-stream", "--cpu"], "A12"),
    (["--tp", "2", "--cpu"], "A14")])
def test_inference_bench_refuses_unported_flags(argv, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        inference.main(argv)


@pytest.mark.parametrize("suite,item", [(None, "A8"), ("comm", "A8")])
def test_dispatcher_refuses_unported_suites(suite, item):
    """``comm`` is the default suite, as in ``bin/ds_bench``."""
    argv = [] if suite is None else [suite]
    with pytest.raises(NotImplementedError,
                       match=f"ds_bench {suite or 'comm'}.*ROADMAP {item}"):
        ds_bench.main(argv)


@pytest.mark.parametrize("suite,module", [
    ("train", "deepspeed_tpu_torch.benchmarks.training"),
    ("inference", "deepspeed_tpu_torch.benchmarks.inference"),
    ("serving", "deepspeed_tpu_torch.benchmarks.serving"),
    ("aio", "deepspeed_tpu_torch.benchmarks.aio"),
    ("cpu_adam", "deepspeed_tpu_torch.benchmarks.cpu_adam"),
    ("offload", "deepspeed_tpu_torch.benchmarks.offload")])
def test_dispatcher_runs_a_suites_main(suite, module, monkeypatch):
    import importlib
    mod = importlib.import_module(module)
    monkeypatch.setattr(mod, "main", lambda argv: ("ran", argv))
    assert ds_bench.main([suite, "--cpu"]) == ("ran", ["--cpu"])
    assert set(ds_bench.SUITES) == {"comm", "train", "inference", "serving",
                                    "aio", "cpu_adam", "offload"}


def test_benches_run_on_the_card_unless_asked(monkeypatch):
    """Without ``--cpu`` the benches go to the card, and with none they
    raise; they never carry on on the CPU."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main in (inference.main, serving.main):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main([])


def test_ds_bench_train_bf16_state_and_remat_policy_on_cpu(monkeypatch,
                                                           capsys):
    """``ds_bench train --moment-dtype bfloat16 --grad-accum-dtype bfloat16
    --remat-policy nothing_saveable`` runs (port only, a tiny model on the
    CPU): the record carries moment_dtype and grad_accum_dtype, as the JAX
    CLI's does, and the policy reaches the model."""
    from deepspeed_tpu_torch.benchmarks import training
    monkeypatch.setitem(training.MODELS, "tiny",
                        dict(hidden_size=32, n_layers=2, n_heads=4))
    built = []
    orig = training.model_config

    def model_config(*a, **kw):
        built.append(orig(*a, **kw))
        return built[-1]
    monkeypatch.setattr(training, "model_config", model_config)
    out = training.main(["--model", "tiny", "--batch", "2", "--gas", "2",
                         "--seq", "16", "--steps", "2", "--device", "cpu",
                         "--moment-dtype", "bfloat16", "--grad-accum-dtype",
                         "bfloat16", "--remat-policy", "nothing_saveable",
                         "--json"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed["moment_dtype"] == printed["grad_accum_dtype"] == \
        "bfloat16"
    assert built[-1].remat_policy == out["remat_policy"] == \
        "nothing_saveable"
    assert np.isfinite(out["losses"]).all() and len(out["losses"]) == 3
    # the default policy is the JAX benchmark's
    training.main(["--model", "tiny", "--batch", "2", "--seq", "16",
                   "--steps", "1", "--device", "cpu", "--json"])
    assert built[-1].remat_policy == "dots_saveable"
    assert "moment_dtype" not in json.loads(
        capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("suite,argv,jax_main", [
    ("cpu_adam", ["--numel", "100000", "--reps", "1"], jax_cpu_adam.main),
    ("aio", ["--size-mb", "1", "--reps", "1"], jax_aio.main),
    ("offload", ["--numel", "100000", "--reps", "1"], jax_offload.main)])
def test_host_benches_print_the_jax_rows(suite, argv, jax_main, capsys,
                                         monkeypatch, tmp_path):
    """Each host bench, tiny, through ``ds_bench``: one JSON line per row,
    the JAX module's rows and keys (``cpu_adam``'s comparison row and its
    summary's rate name the plain version, JAX's its numpy fallback)."""
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    monkeypatch.setattr("tempfile.tempdir", None)
    rows = ds_bench.main([suite, *argv])
    printed = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert printed == rows
    want = jax_main(argv)
    capsys.readouterr()
    rename = {"numpy": "plain_torch", "numpy_gbps": "plain_gbps",
              "cpu_adam_fused_vs_numpy_speedup":
                  "cpu_adam_fused_vs_plain_speedup"}
    assert [sorted(rename.get(k, k) for k in r) for r in want] == \
        [sorted(r) for r in rows]
    for w, r in zip(want, rows):
        for key in ("impl", "tier", "mode", "metric", "queue_depth",
                    "threads", "numel", "sub_groups"):
            if key in w:
                assert r[key] == rename.get(w[key], w[key]), key
    assert not list(tmp_path.iterdir())      # the benches clean up
