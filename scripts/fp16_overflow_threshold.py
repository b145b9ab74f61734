#!/usr/bin/env python3
"""Where fp16 gradients of a ds_bench model start to overflow.

    python3 scripts/fp16_overflow_threshold.py [--model gpt_1b] [--layers N]
        [--seq 1024] [--batch 2] [--micro 4] [--init-seed 0] [--data-seed 0]
        [--device cuda]

Builds ``--model`` from ``benchmarks.training.MODELS`` (cut to ``--layers``
when given), random weights from ``--init-seed``, in fp16, and for each of
``--micro`` micro-batches of ``--batch`` x ``--seq`` tokens drawn as
``run_benchmark`` draws them (numpy ``default_rng(--data-seed)``, shape
[micro, batch, seq]) bisects the power p (to 0.05) from which the
backward of loss * 2**p leaves a non-finite fp16 gradient -- in any
parameter, which an overflow in any intermediate tensor reaches.  A
dynamic loss scale starting at 2**P with hysteresis h skips about
h * (P - floor(min p)) steps before its first applied one.  Prints one
line per micro-batch and the card's name and power limit.
"""

import argparse
import dataclasses
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def threshold(model, ids, backend, lo=8.0, hi=31.0):
    import torch

    def overflows(power):
        model.zero_grad(set_to_none=True)
        loss = model.loss({"input_ids": ids}, attn_backend=backend)
        (loss * 2.0 ** power).backward()
        return any(not bool(torch.isfinite(p.grad).all())
                   for p in model.parameters() if p.grad is not None)

    while hi - lo > 0.05:
        mid = (lo + hi) / 2
        if overflows(mid):
            hi = mid
        else:
            lo = mid
    return hi


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="gpt_1b")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--micro", type=int, default=4)
    ap.add_argument("--init-seed", type=int, default=0)
    ap.add_argument("--data-seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    import numpy as np
    import torch
    from deepspeed_tpu_torch.benchmarks.training import model_config
    from deepspeed_tpu_torch.models.transformer import CausalTransformerLM
    if a.device == "cuda":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip())
    cfg = model_config(a.model, a.seq)
    if a.layers:
        cfg = dataclasses.replace(cfg, n_layers=a.layers)
    model = CausalTransformerLM(cfg, device=a.device).init(
        a.init_seed).to(torch.float16)
    ids = np.random.default_rng(a.data_seed).integers(
        0, cfg.vocab_size, (a.micro, a.batch, a.seq))
    for i in range(a.micro):
        t = threshold(model, torch.as_tensor(ids[i], device=a.device),
                      "auto")
        print(f"{a.model} {cfg.n_layers} layers, init seed {a.init_seed}, "
              f"data seed {a.data_seed}, micro-batch {i}: fp16 gradients "
              f"overflow from loss scale 2**{t:.2f}", flush=True)


if __name__ == "__main__":
    main()
