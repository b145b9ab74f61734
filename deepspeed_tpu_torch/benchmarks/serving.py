"""Serving benchmark: continuous batching vs sequential generation, on one
card.

Counterpart of ``deepspeed_tpu/benchmarks/serving.py``: the same flags,
defaults, prompt mix and JSON lines, one per mode --
``continuous_batching`` (a paged ``ServingEngine``),
``continuous_batching_chunk{K}`` (the same with ``decode_chunk`` K: its
greedy tokens must equal the per-token run's) and
``sequential_single_stream`` (``init_inference(...).generate`` one prompt
at a time, over a quarter of the prompts).  The model is the preset at
random weights from the port's seeded generator (seed 0).

Run:  python -m deepspeed_tpu_torch.benchmarks.serving [--model gpt2_125m]
      [--requests 16] [--max-batch 8] [--prompt-len 128] [--gen 64]
      [--cpu]
``--cpu`` runs on the CPU in fp32; without it the bench runs on the card
in bf16, and raises when there is none.
"""

import argparse
import json
import time

import numpy as np
import torch

MODELS = ("tiny", "gpt2_125m", "gpt2_1_5b")


def model_config(name):
    """The bench's ``TransformerConfig``: the preset (``tiny`` at hidden
    64, 4 heads: head dim 16), without remat."""
    from deepspeed_tpu_torch.models.transformer import TransformerConfig
    cfg = getattr(TransformerConfig, name)() if name != "tiny" else \
        TransformerConfig.tiny(hidden_size=64, n_heads=4)
    return type(cfg)(**{**cfg.__dict__, "remat": False})


def prompt_mix(requests, prompt_len, vocab_size):
    """(lengths, prompts): ragged prompts around the nominal length, from
    ``np.random.default_rng(0)`` as the JAX bench draws them."""
    rng = np.random.default_rng(0)
    lens = rng.integers(max(4, prompt_len // 2), prompt_len + 1, requests)
    prompts = [rng.integers(0, vocab_size, (n,)).tolist() for n in lens]
    return lens, prompts


def run_benchmark(model="gpt2_125m", requests=16, max_batch=8,
                  prompt_len=128, gen=64, page_size=128, decode_chunk=8,
                  device=None):
    """Run the three modes on ``device`` (the card unless named; fp32 on
    the CPU, bf16 on the card), printing one JSON line each.  Returns
    {"records": the printed lines, "model_calls": {mode: model calls of
    its engine, warm-up included; sequential: generate's, one a token},
    "prefills": {mode: prefill calls}}."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.accelerator import get_accelerator
    from deepspeed_tpu_torch.inference.serving import ServingEngine
    from deepspeed_tpu_torch.models.transformer import CausalTransformerLM

    dev = get_accelerator().resolve_device(device)
    cpu = dev.type == "cpu"
    cfg = model_config(model)
    dtype = torch.float32 if cpu else torch.bfloat16
    lm = CausalTransformerLM(cfg, device=dev, dtype=dtype).init(0)
    lens, prompts = prompt_mix(requests, prompt_len, cfg.vocab_size)
    max_seq = prompt_len + gen + page_size
    records, calls, prefills = [], {}, {}

    def emit(record, eng_calls, eng_prefills):
        print(json.dumps(record))
        records.append(record)
        calls[record["mode"]] = eng_calls
        prefills[record["mode"]] = eng_prefills

    # -- continuous batching -------------------------------------------
    eng = ServingEngine(lm, max_batch=max_batch, page_size=page_size,
                        max_seq=max_seq, dtype=dtype)
    # warm-up (the first calls' allocations) on a throwaway request
    eng.generate([prompts[0]], max_new_tokens=2)

    t0 = time.perf_counter()
    outs = eng.generate(prompts, max_new_tokens=gen)
    dt = time.perf_counter() - t0
    gen_tokens = sum(len(o) - n for o, n in zip(outs, lens))
    emit({"mode": "continuous_batching",
          "requests": requests, "max_batch": max_batch,
          "gen_tokens": int(gen_tokens), "wall_s": round(dt, 3),
          "tokens_per_sec": round(gen_tokens / dt, 1)},
         eng.stats["model_calls"], requests + 1)
    del eng

    # -- continuous batching, chunked on-device decode -----------------
    if decode_chunk > 1:
        eng = ServingEngine(lm, max_batch=max_batch, page_size=page_size,
                            max_seq=max_seq, dtype=dtype,
                            decode_chunk=decode_chunk)
        eng.generate([prompts[0]], max_new_tokens=2)   # warm-up
        t0 = time.perf_counter()
        outs_c = eng.generate(prompts, max_new_tokens=gen)
        dt = time.perf_counter() - t0
        assert outs_c == outs, \
            "chunked greedy decode diverged from per-token decode"
        gen_tokens = sum(len(o) - n for o, n in zip(outs_c, lens))
        emit({"mode": f"continuous_batching_chunk{decode_chunk}",
              "requests": requests, "max_batch": max_batch,
              "gen_tokens": int(gen_tokens), "wall_s": round(dt, 3),
              "tokens_per_sec": round(gen_tokens / dt, 1)},
             eng.stats["model_calls"], requests + 1)
        del eng

    # -- sequential single-stream baseline (reference-style) -----------
    ie = deepspeed_tpu_torch.init_inference(
        model=lm, config={"dtype": "fp32" if cpu else "bf16",
                          "max_out_tokens": max_seq}, device=dev)
    ie.generate(np.asarray(prompts[0])[None, :], max_new_tokens=2)  # warmup
    measured = max(2, requests // 4)    # a subset: it is slow
    t0 = time.perf_counter()
    seq_tokens = 0
    for p in prompts[:measured]:
        out = ie.generate(np.asarray(p)[None, :], max_new_tokens=gen)
        seq_tokens += out.shape[1] - len(p)
    dt = time.perf_counter() - t0
    emit({"mode": "sequential_single_stream",
          "requests_measured": measured,
          "gen_tokens": int(seq_tokens), "wall_s": round(dt, 3),
          "tokens_per_sec": round(seq_tokens / dt, 1)},
         2 + measured * gen, 1 + measured)
    return {"records": records, "model_calls": calls, "prefills": prefills}


def main(argv=None):
    """``ds_bench serving``: parse the JAX bench's flags and run; returns
    :func:`run_benchmark`'s result."""
    ap = argparse.ArgumentParser(prog="ds_bench serving")
    ap.add_argument("--model", default="gpt2_125m", choices=list(MODELS))
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=128)
    ap.add_argument("--gen", type=int, default=64)
    ap.add_argument("--page-size", type=int, default=128)
    ap.add_argument("--decode-chunk", type=int, default=8,
                    help="tokens per device dispatch in the chunked mode "
                         "(0 disables the chunked measurement)")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    return run_benchmark(args.model, args.requests, args.max_batch,
                         args.prompt_len, args.gen, args.page_size,
                         args.decode_chunk,
                         device="cpu" if args.cpu else None)


if __name__ == "__main__":
    main()
