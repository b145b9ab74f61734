#!/usr/bin/env python3
"""A/B of the model's remat policies on the card, one engine.

``ds_bench train``'s default run (gpt_350m, micro 8, seq 1024, bf16,
AdamW; ``--model`` for another ``MODELS`` name) under three variants:

* ``nothing_saveable``: each layer's input kept, the layer recomputed;
* ``dots_saveable``, as the port runs it: the projections' outputs kept
  through ``activation_checkpointing.checkpointing.matmul``;
* ``dots_saveable_sac``: the same policy through selective-checkpoint
  contexts (``torch.utils.checkpoint.create_selective_checkpoint_contexts``
  keeping ``aten.mm`` / ``addmm`` / ``bmm``, as ``checkpointing.checkpoint``
  does for a user's block), which route every op of a layer through a
  Python dispatch mode in the forward and again in the recompute.

The variants switch on one engine (the model's ``remat_policy``, and for
the last the layers' remat function), in turns A B C C B A, each turn
``--steps`` train_batch calls on fresh random batches after one warm-up
call.  Per variant: wall ms per train_batch (the mean of its two turns),
device ms of one profiled train_batch (torch.profiler), the peak GB of a
train_batch; then, from one set of weights, the loss and gradient norm
of one fixed batch under each (the variants must agree).
Prints one JSON line (also written to ``--out``) with the card's name and
power limit.

    python3 scripts/remat_policy_ab.py [--model gpt_350m] [--steps 10]
"""

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

VARIANTS = ("nothing_saveable", "dots_saveable", "dots_saveable_sac")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="gpt_350m")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--out", default=None)
    a = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    import chip_smoke
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.benchmarks.training import (ds_config,
                                                         model_config)
    from deepspeed_tpu_torch.models import transformer
    from deepspeed_tpu_torch.runtime.activation_checkpointing import \
        checkpointing
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    batch, seq = 8, 1024
    cfg = model_config(a.model, seq)
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=transformer.CausalTransformerLM(cfg).init(0),
        config=ds_config(batch, 1))
    remat = transformer.remat

    def use(variant):
        policy = variant.replace("_sac", "")
        engine.module.config = dataclasses.replace(cfg, remat_policy=policy)
        transformer.remat = (checkpointing.run_checkpointed
                             if variant.endswith("_sac") else remat)

    rng = np.random.default_rng(0)

    def step(ids=None):
        ids = rng.integers(0, cfg.vocab_size, (batch, seq)) if ids is None \
            else ids
        return engine.train_batch(batch={"input_ids": ids})

    fixed = np.random.default_rng(1).integers(0, cfg.vocab_size,
                                              (batch, seq))
    walls = {v: [] for v in VARIANTS}
    out = {}
    for variant in VARIANTS + VARIANTS[::-1]:
        use(variant)
        step()
        torch.cuda.synchronize()
        t0 = time.time()
        for _ in range(a.steps):
            step()
        torch.cuda.synchronize()
        walls[variant].append((time.time() - t0) * 1e3 / a.steps)
    for variant in VARIANTS:
        use(variant)
        torch.cuda.reset_peak_memory_stats()
        device_ms, _, _ = chip_smoke.profile_device(step, 1)
        out[variant] = {"wall_ms": sum(walls[variant]) / 2,
                        "wall_turns_ms": walls[variant],
                        "device_ms": device_ms,
                        "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    # the same weights, one fixed batch's loss and grad norm under each
    norms = {}
    for variant in VARIANTS:
        use(variant)
        loss = engine.module.loss({"input_ids": torch.as_tensor(
            fixed, device=engine.device)})
        loss.backward()
        norms[variant] = (float(loss), float(torch.sqrt(sum(
            (p.grad.float() ** 2).sum() for p in engine.module.parameters()
            if p.grad is not None))))
        for p in engine.module.parameters():
            p.grad = None
    res = {"card": smi, "model": a.model, "batch": batch, "seq": seq,
           "steps": a.steps, "variants": out,
           "loss_and_grad_norm": norms}
    line = json.dumps(res)
    print(line)
    if a.out:
        with open(a.out, "w") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
