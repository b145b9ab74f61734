"""Training throughput benchmark on one card.

Counterpart of ``deepspeed_tpu/benchmarks/training.py``: the same
``MODELS`` table, and :func:`run_benchmark` builds the model and the
engine config as the JAX ``run_benchmark`` does at world size 1, then times
``steps`` calls of ``engine.train_batch`` on fresh random token batches
after one warm-up call.  It reports tokens/s, model TFLOP/s
(6 * N * tokens/s) and MFU against the H100's dense bf16 peak, 989
TFLOP/s (NVIDIA's data sheet, SXM, 700 W).  MFU is given only for a run
on a CUDA device.  The ``ds_bench train`` CLI is not ported (ROADMAP A9).
"""

import time

import numpy as np
import torch

H100_BF16_PEAK_TFLOPS = 989.0

MODELS = {
    "gpt2_125m": dict(hidden_size=768, n_layers=12, n_heads=12),
    "gpt_350m": dict(hidden_size=1024, n_layers=24, n_heads=16),
    "gpt_760m": dict(hidden_size=1536, n_layers=24, n_heads=16),
    # 1.01 B parameters: the repo's single-chip >= 1B training shape
    "gpt_1b": dict(hidden_size=2048, n_layers=18, n_heads=16),
    "gpt_1_1b": dict(hidden_size=2048, n_layers=20, n_heads=16),
    "gpt2_1_5b": dict(hidden_size=1600, n_layers=48, n_heads=25),
    "gpt_2_7b": dict(hidden_size=2560, n_layers=32, n_heads=32),
    "gpt_5b": dict(hidden_size=4096, n_layers=24, n_heads=32),
    "gpt_6_7b": dict(hidden_size=4096, n_layers=32, n_heads=32),
    "gpt_8b": dict(hidden_size=4096, n_layers=40, n_heads=32),
    # GQA + SwiGLU + RoPE + RMSNorm shapes (--arch llama)
    "llama_1b": dict(hidden_size=2048, n_layers=16, n_heads=16,
                     n_kv_heads=4, ffn_hidden_size=5632),
    "llama_3b": dict(hidden_size=3072, n_layers=26, n_heads=24,
                     n_kv_heads=8, ffn_hidden_size=8192),
    "llama_7b": dict(hidden_size=4096, n_layers=32, n_heads=32,
                     n_kv_heads=8, ffn_hidden_size=11008),
}


def model_config(model, seq, vocab_size=None):
    """The ``TransformerConfig`` the JAX benchmark builds for ``model`` (a
    ``MODELS`` name or a shape dict): Llama-style for a ``llama_*`` name,
    GPT-style otherwise; per-layer remat, which the port runs as
    ``nothing_saveable`` (the JAX benchmark's ``dots_saveable`` keeps other
    tensors, not other values)."""
    from deepspeed_tpu_torch.models.transformer import TransformerConfig
    shape = MODELS[model] if isinstance(model, str) else dict(model)
    if isinstance(model, str) and model.startswith("llama"):
        arch_kw = dict(activation="silu", use_rmsnorm=True, use_rope=True,
                       tie_embeddings=False, vocab_size=vocab_size or 32000)
    else:
        arch_kw = dict(activation="gelu", use_rmsnorm=False, use_rope=False,
                       tie_embeddings=True, vocab_size=vocab_size or 50304)
    return TransformerConfig(max_seq_len=seq, remat=True, **arch_kw,
                             **shape)


def ds_config(batch, gas, dtype="bf16"):
    """The engine config of the JAX benchmark at world size 1: AdamW at
    lr 1e-4 with fp32 moments.  Its ZeRO stage is left out: at world size
    1 every stage computes the same step (multi-rank ZeRO is ROADMAP
    A8)."""
    return {"train_micro_batch_size_per_gpu": batch,
            "gradient_accumulation_steps": gas,
            "optimizer": {"type": "AdamW", "params": {"lr": 1e-4}},
            dtype: {"enabled": True}}


def run_benchmark(model="gpt_350m", batch=8, gas=1, seq=1024, steps=10,
                  dtype="bf16", vocab_size=None, device=None):
    """Build ``model`` (random weights from seed 0), ``initialize`` the
    engine and time ``steps`` train_batch calls.  Returns a dict of
    results; the per-step losses are under ``losses`` (the warm-up's
    first)."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.transformer import CausalTransformerLM
    cfg = model_config(model, seq, vocab_size=vocab_size)
    module = CausalTransformerLM(cfg, device=device).init(0)
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=module, config=ds_config(batch, gas, dtype), device=device)
    del module
    dev = engine.device
    rng = np.random.default_rng(0)
    bshape = (gas, batch, seq) if gas > 1 else (batch, seq)

    def make_batch():
        return {"input_ids": rng.integers(0, cfg.vocab_size, bshape)}

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    losses = [engine.train_batch(batch=make_batch())]     # warm-up
    sync()
    t0 = time.time()
    for _ in range(steps):
        losses.append(engine.train_batch(batch=make_batch()))
    sync()
    dt = time.time() - t0

    tokens = gas * batch * seq * steps
    tps = tokens / dt
    tflops = 6.0 * cfg.num_params() * tps / 1e12
    on_card = dev.type == "cuda"
    out = {
        "model": model if isinstance(model, str) else "custom",
        "n_layers": cfg.n_layers, "n_params": cfg.num_params(),
        "batch": batch, "gas": gas, "seq": seq, "steps": steps, "dtype": dtype,
        "ms_per_train_batch": dt * 1e3 / steps,
        "tokens_per_sec": tps,
        "model_tflops": tflops,
        "mfu": tflops / H100_BF16_PEAK_TFLOPS if on_card else None,
        "losses": [float(x) for x in losses],
        "grad_norm": engine.get_global_grad_norm(),
        "device_kind": (torch.cuda.get_device_name(dev) if on_card
                        else str(dev)),
    }
    return out
