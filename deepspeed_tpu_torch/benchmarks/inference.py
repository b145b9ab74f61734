"""Inference latency benchmark (gpt-bench), on one card.

Counterpart of ``deepspeed_tpu/benchmarks/inference.py``: the same
presets, flags, defaults, human table and JSON record.
``init_inference(model).generate`` on a ``batch`` x ``prompt_len`` prompt
(numpy seed 0) for ``trials`` + 3 trials (the first 3 are warm-up),
reporting the per-token and end-to-end latency percentiles and the
tokens/s.  The model is the preset at random weights from the port's
seeded generator (seed 0).  Usage::

    python -m deepspeed_tpu_torch.benchmarks.inference --model tiny \
        --dtype bf16 --batch 1 --prompt-len 128 --max-new-tokens 64 \
        --trials 10 [--cpu]

``--cpu`` runs on the CPU (the port's own flag); without it the bench
runs on the card, and raises when there is none.  ``--int8`` and
``--zero-stream`` raise naming ROADMAP A12c, ``--tp`` above 1 naming A14.
"""

import argparse
import json
import time
from typing import List

import numpy as np
import torch

PRESETS = ("tiny", "gpt2-125m", "gpt2-1.5b", "llama2-7b")


def print_latency(latency_set: List[float], title: str, warmup: int = 3):
    """Reference gpt-bench.print_latency: trim warmup, report percentiles."""
    lat = sorted(latency_set[warmup:])
    if not lat:
        return
    n = len(lat)
    avg = sum(lat) / n
    p50 = lat[int(n * 0.5)]
    p90 = lat[min(n - 1, int(n * 0.9))]
    p99 = lat[min(n - 1, int(n * 0.99))]
    print(f"== {title} =============")
    print(f"\tAvg Latency: {avg * 1000:.2f} ms")
    print(f"\tP50 Latency: {p50 * 1000:.2f} ms")
    print(f"\tP90 Latency: {p90 * 1000:.2f} ms")
    print(f"\tP99 Latency: {p99 * 1000:.2f} ms")
    return {"avg": avg, "p50": p50, "p90": p90, "p99": p99}


def _refuse_unported(quant, tp, zero_stream):
    if quant or zero_stream:
        raise NotImplementedError(
            "--int8 / --zero-stream: int8 weight-only quantization and "
            "ZeRO-Inference weight streaming are not ported yet (ROADMAP "
            "A12c)")
    if tp > 1:
        raise NotImplementedError(f"--tp {tp}: tensor-parallel inference "
                                  f"is not ported yet (ROADMAP A14)")


def _preset(model_size):
    from deepspeed_tpu_torch.models.transformer import TransformerConfig
    name = {"tiny": "tiny", "gpt2-125m": "gpt2_125m",
            "gpt2-1.5b": "gpt2_1_5b", "llama2-7b": "llama2_7b"}[model_size]
    return getattr(TransformerConfig, name)(remat=False)


def rpc_floor_s(device):
    """The host <-> device round-trip floor: a one-element op on
    ``device`` and its copy to the host, the mean of 5 after a warm-up
    (on the card it stays under 5 ms, and is then taken as 0)."""
    x = torch.ones(4, device=device)
    (x + 1).cpu()
    t0 = time.time()
    for _ in range(5):
        (x + 1).cpu()
    return (time.time() - t0) / 5


def run_benchmark(model_size="tiny", dtype="bf16", batch=1, prompt_len=128,
                  max_new_tokens=64, trials=10, quant=False, tp=1,
                  zero_stream=False, device=None):
    """Build the preset (random weights from seed 0) on ``device`` (the
    card unless named), ``init_inference`` it in ``dtype`` and time
    ``trials`` + 3 calls of ``generate``.  Prints the human table and one
    JSON line; returns the per-token latency stats."""
    return benchmark(model_size, dtype, batch, prompt_len, max_new_tokens,
                     trials, quant, tp, zero_stream, device)[0]


def benchmark(model_size="tiny", dtype="bf16", batch=1, prompt_len=128,
              max_new_tokens=64, trials=10, quant=False, tp=1,
              zero_stream=False, device=None):
    """:func:`run_benchmark`, returning (per-token stats, JSON record)."""
    _refuse_unported(quant, tp, zero_stream)
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.accelerator import get_accelerator
    from deepspeed_tpu_torch.models.transformer import CausalTransformerLM

    dev = get_accelerator().resolve_device(device)
    cfg = _preset(model_size)
    model = CausalTransformerLM(cfg, device=dev).init(0)
    engine = deepspeed_tpu_torch.init_inference(
        model=model, dtype=dtype, max_out_tokens=prompt_len + max_new_tokens,
        device=dev)
    rng = np.random.default_rng(0)
    ids = rng.integers(0, cfg.vocab_size, (batch, prompt_len))

    # calibrate the host <-> device round-trip floor (a fixed cost per
    # pulled result that is not model time)
    rpc_floor = rpc_floor_s(dev)
    if rpc_floor > 0.005:
        print(f"(host↔device round-trip floor: {rpc_floor * 1000:.1f} ms — "
              "subtracted from per-token latency)")
    else:
        rpc_floor = 0.0

    e2e, per_token = [], []
    for t in range(trials + 3):
        t0 = time.time()
        out = engine.generate(ids, max_new_tokens=max_new_tokens, seed=t)
        # the copy to the host waits for the card
        out.cpu()
        dt = time.time() - t0
        e2e.append(dt)
        per_token.append(max(0.0, dt - rpc_floor) / max_new_tokens)

    stats = print_latency(per_token, f"generation token latency "
                          f"({model_size}, {dtype}"
                          f"{', int8' if quant else ''}, bs={batch})")
    e2e_stats = print_latency(e2e, f"end-to-end latency ({max_new_tokens} "
                              "tokens)")
    tput = batch * max_new_tokens / (sum(e2e[3:]) / max(1, len(e2e[3:])))
    print(f"\tThroughput: {tput:.1f} tokens/s")
    # one machine-readable line: the JAX bench's record
    record = {"model": model_size, "dtype": dtype, "int8": bool(quant),
              "zero_stream": bool(zero_stream),
              "batch": batch, "prompt_len": prompt_len,
              "max_new_tokens": max_new_tokens,
              "rpc_floor_ms": round(rpc_floor * 1000, 2),
              "token_latency_ms": {k: round(v * 1000, 3)
                                   for k, v in (stats or {}).items()},
              "e2e_latency_ms": {k: round(v * 1000, 2)
                                 for k, v in (e2e_stats or {}).items()},
              "tokens_per_sec": round(tput, 1)}
    print(json.dumps(record))
    return stats, record


def main(argv=None):
    """``ds_bench inference``: parse the JAX bench's flags (and ``--cpu``)
    and run; returns the JSON record."""
    ap = argparse.ArgumentParser(prog="ds_bench inference",
                                 description="deepspeed_tpu_torch gpt-bench")
    ap.add_argument("--model", default="tiny", choices=list(PRESETS))
    ap.add_argument("--dtype", default="bf16")
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--prompt-len", type=int, default=128)
    ap.add_argument("--max-new-tokens", type=int, default=64)
    ap.add_argument("--trials", type=int, default=10)
    ap.add_argument("--int8", action="store_true")
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--zero-stream", action="store_true",
                    help="ZeRO-Inference: host-resident weights streamed "
                         "per layer (not ported yet: ROADMAP A12c)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the card)")
    args = ap.parse_args(argv)
    return benchmark(args.model, args.dtype, args.batch, args.prompt_len,
                     args.max_new_tokens, args.trials, quant=args.int8,
                     zero_stream=args.zero_stream, tp=args.tp,
                     device="cpu" if args.cpu else None)[1]


if __name__ == "__main__":
    main()
