"""Training throughput benchmark on one card (``ds_bench train``).

Counterpart of ``deepspeed_tpu/benchmarks/training.py``: the same
``MODELS`` table, and :func:`run_benchmark` builds the model and the
engine config as the JAX ``run_benchmark`` does at world size 1, then times
``steps`` calls of ``engine.train_batch`` on fresh random token batches
after one warm-up call.  It reports tokens/s, model TFLOP/s
(6 * N * tokens/s) and MFU against the H100's dense peak, 989 TFLOP/s for
bf16 and fp16 alike (NVIDIA's data sheet, SXM, 700 W).  MFU is given only
for a run on a CUDA device.  Usage::

    python -m deepspeed_tpu_torch.benchmarks.training --model gpt_1b \
        --batch 2 --gas 4 --seq 1024 --dtype fp16 --steps 10 \
        [--moment-dtype bfloat16] [--grad-accum-dtype bfloat16] \
        [--remat-policy dots_saveable] [--offload cpu|nvme] \
        [--offload-param cpu|nvme [--resident-layers N] [--buffer-count N] \
        [--serial-boundary]] [--scheduler WarmupDecayLR] \
        [--initial-scale-power 16] [--json]

The flags are the JAX CLI's; those the port cannot run yet raise naming
their ROADMAP item.  Every layer is rematerialised under ``--remat-policy``
(default ``dots_saveable``, the JAX benchmark's: the matrix products'
outputs are kept, the rest recomputed in the backward).  ``--offload cpu``
or ``nvme`` runs the optimizer on the host (ZeRO-Offload; with nvme its
moments swap to files under the temp dir, ``$TMPDIR`` or ``/tmp``).
``--offload-param cpu`` or ``nvme`` streams the parameters from the host
(ZeRO-Infinity's parameter stream, with the optimizer on the host too,
``--offload cpu`` unless given): the model is built on the host at the
compute dtype, so it never lives on the card whole (its weights drawn
there a tensor at a time: those of a run without the flag);
``--resident-layers``
pins the first layers on the card, ``--buffer-count`` sets the window,
``--serial-boundary`` takes the boundary's serial walk (the ablation).
``--scheduler`` (WarmupLR or WarmupDecayLR, warming
up from 0 to the AdamW lr over a tenth of the run), ``--initial-scale-power``
(fp16's dynamic loss scale starts at 2**power) and ``--device`` (``cpu``
for a run off the card) are the port's own.  Printed: the JAX CLI's keys
(``offload_param``, ``resident_layers`` and ``boundary`` under
``--offload-param``) plus ``loss_scale`` and ``skipped_steps``.
"""

import argparse
import json
import time

import numpy as np
import torch

# dense tensor-core peak of one H100 SXM, the same for bf16 and fp16
H100_PEAK_TFLOPS = 989.0
# the AdamW lr of the JAX benchmark
LR = 1e-4

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


def model_config(model, seq, vocab_size=None, arch=None, remat=True,
                 remat_policy="dots_saveable"):
    """The ``TransformerConfig`` the JAX benchmark builds for ``model`` (a
    ``MODELS`` name or a shape dict): Llama-style for ``arch`` "llama"
    (default: a ``llama_*`` name), GPT-style otherwise; per-layer remat
    under ``remat_policy``, the JAX benchmark's ``dots_saveable`` by
    default."""
    from deepspeed_tpu_torch.models.transformer import TransformerConfig
    shape = MODELS[model] if isinstance(model, str) else dict(model)
    if arch is None:
        arch = ("llama" if isinstance(model, str)
                and model.startswith("llama") else "gpt")
    if arch == "llama":
        arch_kw = dict(activation="silu", use_rmsnorm=True, use_rope=True,
                       tie_embeddings=False, vocab_size=vocab_size or 32000)
    else:
        arch_kw = dict(activation="gelu", use_rmsnorm=False, use_rope=False,
                       tie_embeddings=True, vocab_size=vocab_size or 50304)
    return TransformerConfig(max_seq_len=seq, remat=remat,
                             remat_policy=remat_policy, **arch_kw, **shape)


def scheduler_config(name, total_steps, lr=LR):
    """The ``scheduler`` block of ``--scheduler name``: DeepSpeed's
    defaults but a warm-up from 0 to ``lr`` over a tenth of
    ``total_steps`` (at least one step), and for WarmupDecayLR a linear
    decay to 0 at ``total_steps``."""
    params = {"warmup_min_lr": 0.0, "warmup_max_lr": lr,
              "warmup_num_steps": max(1, total_steps // 10)}
    if name == "WarmupDecayLR":
        params["total_num_steps"] = total_steps
    elif name != "WarmupLR":
        raise ValueError(f"--scheduler {name!r}: expected WarmupLR or "
                         f"WarmupDecayLR")
    return {"type": name, "params": params}


def ds_config(batch, gas, dtype="bf16", scheduler=None,
              initial_scale_power=None, moment_dtype="float32",
              grad_accum_dtype=None, offload=None, offload_param=None,
              resident_layers=0, buffer_count=None):
    """The engine config of the JAX benchmark at world size 1: AdamW at
    lr 1e-4 with ``moment_dtype`` moments, ``dtype`` ("bf16" or "fp16",
    dynamic loss scaling with DeepSpeed's defaults, starting at
    2**``initial_scale_power`` when given), ``scheduler`` (a ``scheduler``
    block) when given, the optimizer offloaded to ``offload`` ("cpu" or
    "nvme") when given, the parameters streamed from ``offload_param``
    ("cpu" or "nvme", with ``resident_layers`` and ``buffer_count``; the
    optimizer on the host, cpu unless ``offload`` says otherwise) when
    given.  Its ZeRO stage is left out: at world size 1 every stage
    computes the same step (multi-rank ZeRO is ROADMAP A8)."""
    precision = {"enabled": True}
    if dtype == "fp16" and initial_scale_power is not None:
        precision["initial_scale_power"] = int(initial_scale_power)
    cfg = {"train_micro_batch_size_per_gpu": batch,
           "gradient_accumulation_steps": gas,
           "optimizer": {"type": "AdamW",
                         "params": {"lr": LR, "moment_dtype": moment_dtype}},
           dtype: precision}
    if scheduler:
        cfg["scheduler"] = scheduler
    if grad_accum_dtype:
        cfg["data_types"] = {"grad_accum_dtype": grad_accum_dtype}
    zero = {}
    if offload:
        zero["offload_optimizer"] = {"device": offload}
    if offload_param:
        pc = {"device": offload_param}
        if resident_layers:
            pc["resident_layers"] = resident_layers
        if buffer_count:
            pc["buffer_count"] = buffer_count
        zero["offload_param"] = pc
        # the stream updates on the host: its state host-side too
        zero.setdefault("offload_optimizer", {"device": "cpu"})
    if zero:
        cfg["zero_optimization"] = zero
    return cfg


def run_benchmark(model="gpt_350m", batch=8, gas=1, seq=1024, steps=10,
                  dtype="bf16", vocab_size=None, device=None, scheduler=None,
                  initial_scale_power=None, remat=True, arch=None,
                  moment_dtype="float32", grad_accum_dtype=None,
                  zero_stage=3, remat_policy="dots_saveable", offload=None,
                  offload_param=None, resident_layers=0, buffer_count=None,
                  serial_boundary=False):
    """Build ``model`` (random weights from seed 0), ``initialize`` the
    engine and time ``steps`` train_batch calls.  ``scheduler``: None or
    the name of :func:`scheduler_config`'s schedule over the run's
    ``steps + 1`` calls.  Returns a dict of results; the per-step losses
    are under ``losses`` (the warm-up's first), and under offload the host
    step's split of the last call under ``offload_step`` (under
    ``offload_param`` the stream's: its copies, host update and
    prefetches).  ``offload_param``: the model is built on the host at
    the compute dtype and streamed (``serial_boundary``: the boundary's
    serial walk).  ``zero_stage`` is recorded: at world size 1 every
    stage computes the same step."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.transformer import CausalTransformerLM
    cfg = model_config(model, seq, vocab_size=vocab_size, arch=arch,
                       remat=remat, remat_policy=remat_policy)
    if offload_param:
        # the host init of the JAX benchmark: the whole tree never lives
        # on the card, and at the compute dtype it takes half the host RAM;
        # drawn a tensor at a time on the run's device, the weights of a
        # run without --offload-param
        from deepspeed_tpu_torch.accelerator import get_accelerator
        module = CausalTransformerLM(
            cfg, device="cpu",
            dtype=torch.float16 if dtype == "fp16" else torch.bfloat16
        ).init(0, draw_device=get_accelerator().resolve_device(device))
    else:
        module = CausalTransformerLM(cfg, device=device).init(0)
    conf = ds_config(batch, gas, dtype,
                     scheduler=(scheduler_config(scheduler, steps + 1)
                                if scheduler else None),
                     initial_scale_power=initial_scale_power,
                     moment_dtype=moment_dtype,
                     grad_accum_dtype=grad_accum_dtype, offload=offload,
                     offload_param=offload_param,
                     resident_layers=resident_layers,
                     buffer_count=buffer_count)
    engine, *_ = deepspeed_tpu_torch.initialize(model=module, config=conf,
                                                device=device)
    del module
    if serial_boundary and engine._param_stream is not None:
        engine._param_stream.boundary_pipelined = False   # the ablation
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
        "batch": batch, "gas": gas, "seq": seq, "zero_stage": zero_stage,
        "steps": steps, "dtype": dtype, "remat_policy": remat_policy,
        "ms_per_train_batch": dt * 1e3 / steps,
        "tokens_per_sec": tps, "tokens_per_sec_per_chip": tps,
        "model_tflops": tflops, "model_tflops_per_chip": tflops,
        "mfu": tflops / H100_PEAK_TFLOPS if on_card else None,
        "loss": float(losses[-1]),
        "losses": [float(x) for x in losses],
        "grad_norm": engine.get_global_grad_norm(),
        "loss_scale": engine.get_loss_scale(),
        "skipped_steps": int(engine.skipped_steps),
        "device_kind": (torch.cuda.get_device_name(dev) if on_card
                        else str(dev)),
        "n_chips": 1,
    }
    if moment_dtype != "float32":
        out["moment_dtype"] = moment_dtype
    if grad_accum_dtype:
        out["grad_accum_dtype"] = grad_accum_dtype
    if arch not in (None, "gpt"):
        out["arch"] = arch
    if offload_param:
        out["offload_param"] = offload_param
        out["resident_layers"] = resident_layers
        out["boundary"] = "serial" if serial_boundary else "pipelined"
        out["offload_step"] = dict(engine._param_stream.last_step)
    elif offload:
        out["offload"] = offload
        out["offload_step"] = dict(engine._offload.last_step)
    return out


# the JAX CLI's printed keys (mfu only on the card; moment_dtype only for
# bf16 moments, grad_accum_dtype only when set), then the port's two fp16
# counters
PRINTED = ("model", "n_params", "batch", "gas", "seq", "zero_stage",
           "steps", "tokens_per_sec_per_chip", "model_tflops_per_chip",
           "loss", "device_kind", "n_chips", "moment_dtype",
           "grad_accum_dtype", "offload_param", "resident_layers",
           "boundary", "arch", "mfu", "loss_scale", "skipped_steps")


def _refuse_unported(a):
    """Raise for the JAX CLI's flags this port cannot run."""
    if a.attn_block_q or a.attn_block_k:
        raise ValueError("--attn-block-q / --attn-block-k size the TPU "
                         "kernel's blocks; the H100 kernels' tiles are "
                         "fixed")


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="ds_bench train", description=__doc__.splitlines()[0])
    p.add_argument("--model", default="gpt_350m", choices=sorted(MODELS))
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--gas", type=int, default=1)
    p.add_argument("--seq", type=int, default=1024)
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--zero-stage", type=int, default=3,
                   choices=[0, 1, 2, 3])
    p.add_argument("--offload", choices=["cpu", "nvme"], default=None)
    p.add_argument("--offload-param", choices=["cpu", "nvme"], default=None)
    p.add_argument("--resident-layers", type=int, default=0)
    p.add_argument("--buffer-count", type=int, default=None)
    p.add_argument("--serial-boundary", action="store_true")
    p.add_argument("--arch", choices=["gpt", "llama"], default=None,
                   help="default: auto from the model name")
    p.add_argument("--no-remat", action="store_true")
    p.add_argument("--remat-policy", default="dots_saveable")
    p.add_argument("--attn-block-q", type=int, default=None)
    p.add_argument("--attn-block-k", type=int, default=None)
    p.add_argument("--dtype", choices=["bf16", "fp16"], default="bf16")
    p.add_argument("--moment-dtype", choices=["float32", "bfloat16"],
                   default="float32")
    p.add_argument("--grad-accum-dtype", choices=["float32", "bfloat16"],
                   default=None)
    p.add_argument("--scheduler", choices=["WarmupLR", "WarmupDecayLR"],
                   default=None, help="an LR schedule (default: constant)")
    p.add_argument("--initial-scale-power", type=int, default=None,
                   help="fp16: the dynamic loss scale starts at 2**this "
                        "(DeepSpeed's default 16)")
    p.add_argument("--device", default=None,
                   help="default: the card; 'cpu' to run off it")
    p.add_argument("--json", action="store_true",
                   help="print one JSON line instead of a table")
    a = p.parse_args(argv)
    _refuse_unported(a)
    out = run_benchmark(
        model=a.model, batch=a.batch, gas=a.gas, seq=a.seq, steps=a.steps,
        dtype=a.dtype, device=a.device, scheduler=a.scheduler,
        initial_scale_power=a.initial_scale_power, remat=not a.no_remat,
        arch=a.arch, moment_dtype=a.moment_dtype,
        grad_accum_dtype=a.grad_accum_dtype, zero_stage=a.zero_stage,
        remat_policy=a.remat_policy, offload=a.offload,
        offload_param=a.offload_param, resident_layers=a.resident_layers,
        buffer_count=a.buffer_count, serial_boundary=a.serial_boundary)
    shown = {k: out[k] for k in PRINTED
             if k in out and not (k == "mfu" and out[k] is None)}
    if a.json:
        print(json.dumps(shown))
    else:
        width = max(len(k) for k in shown)
        for k, v in shown.items():
            print(f"  {k:<{width}}  {v}")
    return out


if __name__ == "__main__":
    main()
