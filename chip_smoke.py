#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py                 # every phase, Llama-2-7B, 32 layers
    python3 chip_smoke.py --kernels-only  # build + kernel check only

Builds the port's hand-written CUDA kernels from this checkout with
``nvcc`` (into ``deepspeed_tpu_torch/_build/``), holds each kernel against
its plain PyTorch version, then serves Llama-2-7B at full width (random
bf16 weights from a seeded generator) through the port's two serving
entry points -- ``init_inference(...).generate`` and
``create_serving_engine`` -- trains gpt_1b, BLOOM-1b7, GPT-Neo-1.3B and a
Gemma-2B shape (head dim 256) at full width and depth through
``initialize(...).train_batch``, runs
``ds_bench train`` with no flags (gpt_350m, head dim 64), with ``--model
gpt_760m`` (head dim 96) and with ``--model gpt_2_7b`` (head dim 80),
serves gpt_2_7b (head dim 80), a Phi-3-mini-4k-shaped model (head dim
96) and Gemma-7B- and Gemma-2B-shaped models (head dim 256) at full width
and depth through both serving entry points, runs ``ds_report
--kernel-gate``, ``ds_bench serving`` (gpt2_125m, then ``--model tiny``:
head dim 16) and ``ds_bench inference`` (tiny) as a user types them, and
calls ``SparseSelfAttention``, checking that those runs went through the
kernels.  Phases:

  1 device   card name and power limit (nvidia-smi)
  2 build    nvcc, one process per kernel source, all at once; ptxas's
             registers and spills of every kernel, none allowed in the
             split-key decode body (every head dim), the head-dim-64
             tensor-core consumer, B2's persistent bodies at head dim
             64, the head-dim-80 and -96 flash forms,
             every head-dim-256 flash form (fp32 too), B6's fp16 form,
             B4's tensor-core prefill tiles at 80, 96 and 256 or the
             CUDA-core tiles of B4 and B5 at 80, 96 and 256 (NO_SPILL);
             the SASS of every bf16 and fp16 tensor-core kernel -- the
             flash kernels and B4's prefill kernel at head dims 64, 80,
             96, 128 and 256, B6's
             block-sparse kernel at every block and head dim -- holds
             wgmma (HGMMA) and TMA loads (UTMALDG), its wgmma waits
             (WARPGROUP.DEPBAR) printed; no head-dim-16 instantiation
             (CUDA-core only) may spill
    env      (a) ``ds_report --kernel-gate``: every library compatible,
             the build gate passes
  3 kernels  each kernel vs its plain version: fp32, bf16 and fp16 (the
             fp16 tensor-core tiles held to SDPA-fp16's error); serving
             attention MHA 32/32 and GQA 32/8 (and at the Gemma shapes'
             head dim 256, where 5-8 rows take the staged body: its chunk
             edges, Gemma-2B's step at 4096 keys, pages of 12 and 48 keys,
             and a second call bit for bit); flash attention forward and
             backward at gpt_1b's shape, at GPT-Neo's global layers' (S=2048,
             unscaled logits), GQA 32/8 and S=1000; fused Adam over
             1,000,003 elements in both modes, and with its skip flag set
             (p, m, v unchanged bit for bit), and its bf16-gradient and
             bf16-moment forms bit for bit over 3 steps at 1,000,003 and
             4,099 elements, skip flag too, with the stochastic
             rounding's mean over 65536 copies; the biased flash kernels with
             ALiBi at S=2048, windows 256 (S=2048, unscaled, GPT-Neo's local
             layers) and 100 (S=1000), ALiBi + window with GQA, a window
             past S; the flash kernels at head dim 64 too (gpt_350m's
             shape, GQA, gpt2_1_5b's 25 heads over S=1000, non-causal;
             ALiBi at BLOOM-560m's S=2048, window 256 at GPT-Neo-125M's 12
             heads, window 100, ALiBi + window with GQA); at head dims 96
             and 80 (gpt_760m's 16 heads and gpt_2_7b's 32 at B=8 S=1024,
             GQA 32/8, S=1000, non-causal; ALiBi and window 256 at
             S=2048, window 100, ALiBi + window with GQA); at head dim 256
             (Gemma-2B's 8 / 1 heads at B=2 S=2048, MHA 8 / 8, MQA over
             S=1000, non-causal; ALiBi, window 256 with MQA, window 100,
             ALiBi + window with MQA) (bf16 O, dQ, dK,
             dV of the tensor-core kernels: one
             ulp, or within 2x SDPA's error on the same inputs, both
             readings printed); the backward's delta kernel against its
             plain version on every flash case, and at gpt_2_7b's shape
             dK, dV in k's dtype from the kernel, returned as they are
             (group 1: no sum, no cast); decode attention at head dims 128 and 64
             (TinyLlama-1.1B's 32/4 heads: T=1, 5, 128), where its key
             chunks meet a sequence's length at 1, 4 and 8 rows a kv
             head; ragged paged attention's decode rows (1-8 rows a kv
             head, one ulp), bucketed prefills at 16, 512 and 1024,
             prefills after cached prefixes, pages 64 and 48, packed mixed
             batches with shared prefix pages (with 5-8-row and group-8
             decodes), a 256-token chunk at start 512, the speculative
             verify window [8, 5], GQA 32/4 (group 8) at head dims 128
             and 64; its prefill tiles at head dim 64 at groups 1, 4 and
             8 and pages 16 and 128 (prefills after prefixes with a
             ragged last tile, a chunk at start 512, packed batches
             sharing prefix pages); B5 and B4 at head dims 80 and 96 at
             groups 1, 4 and 8: every decode row count 1-8, ragged
             lengths (one chunk) and key-chunk edges (several), B5's
             prefill form at T=128 and generate's calls, B4's serve
             buckets 512 and 1024, prefills after prefixes and a chunk at
             start 512 at pages 128 and 16, packed mixed batches sharing
             prefix pages; the same at head dim 256 at Gemma's heads
             (16 / 16, 16 / 4, 8 / 1); the block-sparse kernel for layout
             blocks 16-128, head dims 64 and 128, causal, bidirectional
             and empty rows, fp32, bf16 and fp16 (bf16 B4 prefill and B6
             outputs, which round P to bf16 in the product, under the
             same SDPA witness; fp16 B6 under SDPA-fp16's); B5 and B4 at
             head dim 16 (the benches' tiny model, CUDA-core bodies only):
             1, 2, 4 and 8 rows a kv head, lengths at and one past a
             split's chunk edges, pages 16 and 128, the benches' own
             calls, each call again bit for bit
  4 generate init_inference(llama2_7b).generate, B=4, prompt 128, 32 new;
             then a TinyLlama-1.1B-shaped model (22 layers, head dim 64,
             group 8) the same way, through B5 at head dim 64
  5 serve    create_serving_engine(max_batch=8, page_size=128,
             max_seq=2048).generate on 12 mixed-length prompts
    serve-features  bf16, Llama-2-7B at 8 of its 32 layers with the
             TinyLlama draft at 6 of 22 (FEATURES_LAYERS_LLAMA): (a) the
             prefix cache on 12 prompts
             sharing a 1024-token prefix, (b) the chunked scheduler (chunks
             of 256, SLO classes) on those 12 and an 1800-token prompt,
             (c) speculative decoding with a TinyLlama-1.1B-shaped draft,
             gamma 4, (d) decode_chunk 4, greedy and sampled (the sampled
             streams the same in reverse arrival order); exact launch
             counts; tokens vs monolithic baselines by the divergence rule;
             then phases 4 and 5 in fp16 (tokens vs bf16 by the same rule)
    serve-d80-d96  gpt_2_7b (32 layers, 32 heads of 80, the ds_bench
             train CLI's config at seq 2048) through phases 4 and 5 in
             bf16 and fp16 (tokens vs bf16 by the divergence rule) and
             serve-features (a)-(d) in bf16 at 8 of its layers with the
             CLI's gpt_350m at 6 as (c)'s draft (head dim 64;
             FEATURES_LAYERS_D80); a Phi-3-mini-4k-shaped model (32
             layers, 32 heads of 96, SwiGLU, untied) through phases 4
             and 5 in bf16; exact launches, plain versions 0
    serve-d256  a Gemma-7B shape (28 layers, 16 heads of 256, d 3072,
             vocab 256000, GeGLU, embedding scale sqrt(d), tied) through
             phases 4 and 5 in bf16 and serve-features (a)-(d) at 7 of
             its layers with a Gemma-2B shape (18 layers, 8 heads of 256
             over one kv head) at 5 as (c)'s draft (FEATURES_LAYERS_GEMMA);
             Gemma-2B through phases 4 and 5 in bf16 and
             fp16 (tokens vs bf16 by the divergence rule); exact
             launches, plain versions 0
    bench    (b) ``ds_bench serving`` at its defaults (gpt2_125m, bf16, 16
             requests x 64 tokens) and with ``--model tiny --requests 8
             --gen 32`` (head dim 16); (c) ``ds_bench inference`` at its
             defaults (tiny, bf16, 10 trials); their JSON lines as they
             come, exact B4 and B5 launches, plain versions 0
  6 e2e      full width, 2 layers: paged prefill + decode, kernels vs plain;
             (a)-(d) in fp32, tokens identical to the monolithic run (the
             draft also as the target's own weights); the TinyLlama-shaped
             generate in fp32, tokens identical to the plain versions';
             at the gpt_2_7b, Phi-3-mini, Gemma-7B and Gemma-2B shapes:
             bf16 paged logits vs plain, fp32 generate and serve tokens
             identical to the plain versions'; tiny (head dim 16) at 2
             layers fp32, generate and serve tokens identical to the plain
             versions'
  7 train    run_benchmark for gpt_1b (seq 1024), bloom_1b7 (ALiBi) and
             gpt_neo_1_3b (global / local window 256), seq 2048, micro 2,
             gas 4, bf16, AdamW; exact launches counted; ``ds_bench
             train`` with no flags (gpt_350m, 24 layers of 16 heads of 64,
             micro 8, seq 1024: the flash kernels' D=64 forms), with
             --model gpt_760m (24 layers of 16 heads of 96: D=96) and with
             --model gpt_2_7b (32 layers of 32 heads of 80: D=80) (exact
             launches, peak memory, one train_batch profiled; (d) the
             no-flags run's profiled engine with steps_per_print 1 and
             wall_clock_breakdown logs the throughput and fwd / bwd /
             step lines, its device time within its reading before the
             timers were ported); the
             Gemma-2B shape (GEMMA_TRAIN: 18 layers, 8 heads of 256 over
             one kv head, vocab 256000, remat) through initialize(...)
             .train_batch at seq 2048, micro 2 x gas 4, bf16 (exact
             launches, peak memory, its fixed batch's loss falls, one
             train_batch profiled); a fixed
             batch's
             loss falls and one train_batch is profiled, for each; BLOOM's
             fixed batch again through the plain versions; 2 layers of
             each, and of gpt_350m, gpt2_1_5b (25 heads), BLOOM-560m and
             GPT-Neo-125M (head dim 64), gpt_760m and gpt_2_7b (head dims
             96 and 80) and the Gemma-2B shape (head dim 256, seq 2048),
             kernels vs plain (exact launches;
             losses, grad norm, then m and the
             update parameter by parameter; GPT-Neo in fp32 too, and two
             plain engines that split the batch differently, as a witness);
             fp16: gpt_1b through the ds_bench train CLI (--dtype fp16
             --scheduler WarmupDecayLR, the loss scale from 2**23: skipped
             steps, then applied ones; exact launches), a fixed fp16 batch
             (the loss falls over the applied steps; fp16 vs bf16 wall,
             device and busy share) and 2 layers kernels vs plain from
             2**29 (the same skip pattern and loss scales), for gpt_1b,
             gpt_350m (head dim 64), FP16_CLI_MODEL (gpt_760m, head dim
             96) and the Gemma-2B shape (head dim 256); every run but
             the Gemma-2B shape's under remat_policy dots_saveable (the
             CLI's default), each CLI run's engine also profiled under
             nothing_saveable
    train-a6a7  (a) ds_bench train --remat-policy nothing_saveable
             against the no-flags run: equal first loss, grad norms
             within 1e-3, equal exact launches; (b) ds_bench train
             --model gpt_1b --batch 2 --gas 4 --moment-dtype bfloat16
             --grad-accum-dtype bfloat16, then its config on a fixed
             batch (the loss falls; m, v and the gradients bf16; the peak
             against the fp32 run's); (c) LAMB, SGD with momentum,
             Adagrad, 1-bit Adam (freeze_step 2, bf16 moments) and a
             client torch.optim.SGD on gpt_350m at full depth, 4 fixed-
             batch steps each (the loss falls; B1, B2, B3 launches
             exact); (d) 2 layers of gpt_1b kernels vs plain with bf16
             moments and gradients, bf16 gradients, and LAMB; (f) a user
             block through activation_checkpointing.checkpoint under
             dots_saveable, bit for bit the direct call's
    train-offload  the optimizer on the host (ZeRO-Offload): (a) gpt_350m
             at the CLI's shape and full depth, 3 steps from one seed,
             with and without offload_optimizer cpu: the first loss bit
             for bit, then losses and grad norms within 1e-3, B1 / B2
             launches exact and equal, no B3, the host Adam a piece at a
             time; (b) the same with nvme (the moments swapped to files
             under .tmp/): the master's crc32 the cpu run's, the swap
             dir's fsck committed, uses_io_uring printed; (c) ds_bench
             train --model gpt_2_7b --offload cpu --steps 2: its peak at
             least 25 GB under phase 7's run without --offload, the host
             step split (host Adam, D2H, H2D GB/s); (d) the Gemma-7B shape
             (FEATURES_LAYERS_GEMMA7_OFFLOAD of its 28 layers) with bf16
             gradients, micro 2 x gas 4 x seq 2048, one step: finite
             loss, exact launches; then ds_bench cpu_adam, aio and
             offload at their defaults.  The host's facts (CPU, RAM,
             free disk, copy rate) print on an early line
    ckpt     training that survives a restart, gpt_1b through
             initialize(training_data=...) at full width, CKPT_LAYERS of
             its 18 layers, micro
             2 x gas 4, bf16, data through train_batch(data_iter=...): (a)
             2 steps, save_checkpoint with one injected write failure
             (committed, checksummed), (b) the same state through the async
             engine (manifest leaves equal), 2 more steps; the same 2 steps
             from the async tag (the witness: bitwise, or the gap a step
             that does not repeat leaves); a new process loads the sync
             tag and trains them: losses, grad norms and crc32 of master,
             m and v bit for bit (or within the witness's gap), exact B1 /
             B2 / B3 launches; (d) the tag as a universal dir served by
             init_inference(config={"checkpoint": ...}).generate, tokens
             identical to the in-memory weights', exact B5 launches; (c) 2
             layers: auto-restore after a poisoned step, fallback from a
             torn tag, a named torn tag refused, preemption -> emergency
             tag, keep_last 1, fsck over every status.  Sizes, save and
             load GB/s and the free disk are printed; it fails up front
             if the disk is short
  8 sparse   SparseSelfAttention (Fixed block 16, BigBird block 64; head
             dims 64 and 128) at B=2, S=4096, 16 heads in bf16, and two of
             them in fp16: launches counted,
             outputs vs the plain version; the key_padding_mask path and
             the refusal of a gradient request
  9 timing   each kernel at the main path's shapes vs its bound, its plain
             version and one PyTorch library call (a yardstick only), the
             flash kernels in bf16 and fp16 and at GPT-Neo's global
             layers' shape, and B2 at each training shape as a pair (dQ +
             dK/dV) and as the training path calls it (delta, dQ, dK/dV,
             a group's sum and cast), both against SDPA's backward, at head dim 64 at gpt_350m's training shape
             (bf16, fp16), at gpt_760m's and gpt_2_7b's (head dims 96
             and 80: bf16, fp16), BLOOM-560m's ALiBi and GPT-Neo-125M's
             window, ALiBi at head dims 96 and 80 (printed only: off the
             paths), at Gemma-2B's (head dim 256, 8 / 1 heads, S=2048:
             bf16, fp16) and ALiBi and window 256 at its heads (printed
             only), B6 in fp16, the decode kernel also at Llama-2's whole context
             (len 4096), the ragged kernel's prefill tiles at the serve
             run's buckets 512 and 1024 (beside B1's forward on the same
             work), B5 and B4 in fp16, the verify window, the TinyLlama
             decode step, B5 at head dim 64, the chunk at an offset at
             head dims 128 and 64, Llama-2-70B's group-8 decode step (B4,
             B5; off the paths); B5's generate step and B4's decode step
             and prefill buckets 512 and 1024 at head dims 80 (bf16,
             fp16) and 96, B4's chunk at start 512 and verify window at
             80; the same at 256 (Gemma-7B's heads in bf16, Gemma-2B's
             in bf16 and fp16; chunk and verify window at Gemma-7B's);
             fused Adam in each form held against its plain
             version over gpt_1b's 1.01 B parameters; B5 and B4 at the
             benches' shapes (tiny's head dim 16, gpt2_125m's 64); the window-256
             forward must take well under the ALiBi forward's time

The second-to-last line of stdout is the kernels JSON, the last line
``{"ok": true, "device": {...}}``.  Any failure exits non-zero before the
last line is printed.  It imports nothing of JAX or ``deepspeed_tpu``.
"""

import argparse
import dataclasses
import faulthandler
import json
import math
import os
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12,  # dense, per dtype
              "float32": 67e12}
# (atol, rtol) of a kernel against its plain version run in fp32 on the
# kernel's own inputs (see reference()):
TOL = {"float32": (1e-4, 1e-4),   # both in fp32; only the summation order
                                  # differs
       "bfloat16": (1e-5, 8e-3),  # both round one fp32 result to bf16: at
                                  # most one bf16 ulp apart (<= 2**-7 of the
                                  # value), plus fp32 order noise near 0
       "float16": (1.25e-6, 1e-3)}  # the same for fp16: one ulp is <= 2**-10
                                    # of the value (3 more mantissa bits),
                                    # the noise floor 2**-3 of bf16's
# The bf16 flash forward, dQ and dK/dV kernels, the bf16 block-sparse
# kernel and the bf16 prefill tiles of ragged paged attention run on the
# tensor cores with P (and dS) rounded to bf16 inside the products, as
# SDPA's kernels do, so their outputs may leave the one-ulp tolerance above;
# they then pass if their max abs and relative L2 errors against the exact
# fp32 answer are each within this factor of SDPA's on the same inputs (see
# check_witnessed).  The fp16 forms round P and dS to fp16 (2**-11, where
# bf16 rounds at 2**-8) and are held to the same factor of SDPA's own fp16
# error, which is about 8x smaller than its bf16 error, always: against the
# exact answer and against the plain version on the kernel's inputs.
WITNESS_FACTOR = 2.0
E2E_REL_TOL = 5e-2        # bf16 logits after 2 layers, relative to max|logit|
KERNEL_PHASES_TIMEOUT = 600   # s: phase 3's four kernel checks (~130 s)
REPO = os.path.dirname(os.path.abspath(__file__))


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


_T0 = time.time()     # the run's start, for the seconds on every line


def phase(name, msg):
    """Print ``msg`` under phase ``name``, with the seconds since the run
    began (where the time of a run goes)."""
    print(f"[{name}] (+{time.time() - _T0:.1f} s) {msg}", flush=True)


def time_ms(fn, iters=20, warmup=3):
    """Mean ms per call of fn(i) issued eagerly, by CUDA events: host
    launch overhead counts wherever the host is slower than the device."""
    import torch
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, n, reps=10):
    """Mean device ms per call of fn(i), i < n: the n calls are captured in
    one CUDA graph and replayed, so host launch overhead is left out."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(n):
            fn(i)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(n):
            fn(i)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (reps * n)


def reference(plain, q, k, v, *rest):
    """The plain version run in fp32 on the kernel's inputs, its result
    cast to their dtype: a bf16 kernel is held to the exact answer, not
    to a plain version that rounds its logits and probabilities too."""
    return plain(q.float(), k.float(), v.float(), *rest).to(q.dtype)


def _outside(name, got, want):
    """(max abs error, elements outside the tolerance of their dtype) of
    kernel output ``got`` vs ``want``; fails if ``got`` is not finite."""
    import torch
    atol, rtol = TOL[str(got.dtype).split(".")[-1]]
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        fail(f"{name}: kernel output not finite")
    err = (got - want).abs()
    return err.max().item(), int((err > atol + rtol * want.abs()).sum())


def check_close(name, got, want):
    """Max abs error of kernel output ``got`` vs ``want``; fails outside
    the tolerance of their dtype."""
    atol, rtol = TOL[str(got.dtype).split(".")[-1]]
    max_err, bad = _outside(name, got, want)
    if bad:
        fail(f"{name}: {bad} elements outside atol={atol} rtol={rtol}, max "
             f"abs err {max_err:.3e}")
    phase("kernels", f"{name}: max abs err {max_err:.3e} (atol {atol}, "
          f"rtol {rtol})")
    return max_err


def _abs_rel(got, exact):
    """(max abs error, relative L2 error) of ``got`` against ``exact``."""
    d = got.float() - exact
    return d.abs().max().item(), (d.norm() / exact.norm()).item()


def check_witnessed(name, got, want, exact, sdpa):
    """A bf16 output of the tensor-core flash kernels (O, dQ, dK, dV), which
    round P and dS to bf16 inside their products.  Passes within the
    one-ulp tolerance of ``want`` (the plain version in fp32 on the
    kernels' own O and LSE), or if its max abs error and its relative L2
    error against ``exact`` (the plain forward and backward run in fp32
    from the inputs alone) are each at most WITNESS_FACTOR times SDPA's
    (``sdpa``, the same function by scaled_dot_product_attention in bf16
    on the same inputs: a yardstick, never the port's path).  Prints both
    readings; returns the max abs error against ``want``."""
    import torch
    max_err, bad = _outside(name, got, want)
    k_abs, k_rel = _abs_rel(got, exact)
    s_abs, s_rel = _abs_rel(sdpa, exact)
    ok = k_abs <= WITNESS_FACTOR * s_abs and k_rel <= WITNESS_FACTOR * s_rel
    phase("kernels", f"{name}: one-ulp reading max abs err {max_err:.3e}, "
          f"{bad} elements outside; vs fp32 exact: kernel max abs "
          f"{k_abs:.3e} rel L2 {k_rel:.3e}, SDPA {s_abs:.3e} / {s_rel:.3e} "
          f"(kernel/SDPA {k_abs / s_abs:.2f}, {k_rel / s_rel:.2f}; limit "
          f"{WITNESS_FACTOR})")
    if got.dtype == torch.float16:
        # fp16: the SDPA rule always, against the exact answer and against
        # ``want``, the plain version in fp32 on the kernel's own inputs
        p_abs, p_rel = _abs_rel(got, want.float())
        if not ok or p_abs > WITNESS_FACTOR * s_abs or \
                p_rel > WITNESS_FACTOR * s_rel:
            fail(f"{name}: error vs exact {k_abs:.3e} / rel L2 {k_rel:.3e}, "
                 f"vs plain {p_abs:.3e} / {p_rel:.3e}, over "
                 f"{WITNESS_FACTOR} x SDPA's {s_abs:.3e} / {s_rel:.3e}")
    elif bad and not ok:
        fail(f"{name}: {bad} elements outside the one-ulp tolerance and "
             f"error {k_abs:.3e} / rel L2 {k_rel:.3e} over {WITNESS_FACTOR}"
             f" x SDPA's {s_abs:.3e} / {s_rel:.3e}")
    return max_err


def sdpa_witness(q, k, v, dout, scale, causal, alibi_slopes=None,
                 window=None):
    """O, dQ, dK, dV of scaled_dot_product_attention in q's dtype on the
    kernels' inputs ([B, S, H, D] layout; GQA by repeating k/v, whose
    gradients autograd sums back).  ALiBi goes in as the float mask
    slope * (key - query), the row-shifted form of slope * key (same
    softmax), so its rounding to bf16 is smallest where the probabilities
    are large; the window and the causal rule as -inf."""
    import torch
    import torch.nn.functional as F
    B, S, H, D = q.shape
    qt, kt, vt = (x.transpose(1, 2).detach().clone().requires_grad_()
                  for x in (q, k, v))
    rep = H // k.shape[2]
    kx, vx = kt.repeat_interleave(rep, 1), vt.repeat_interleave(rep, 1)
    mask = None
    if alibi_slopes is not None or window:
        pos = torch.arange(S, device=q.device)
        rel = pos[None, :] - pos[:, None]                 # key - query
        allowed = rel <= 0 if causal else torch.ones_like(rel, dtype=bool)
        if window:
            allowed &= -rel < window
        if alibi_slopes is not None:
            mask = (alibi_slopes[:, None, None] * rel.float()).masked_fill(
                ~allowed, float("-inf")).to(q.dtype)[None]
        else:
            mask = allowed
    out = F.scaled_dot_product_attention(
        qt, kx, vx, attn_mask=mask, is_causal=causal and mask is None,
        scale=scale)
    grads = torch.autograd.grad(out, (qt, kt, vt), dout.transpose(1, 2))
    return [x.detach().transpose(1, 2) for x in (out,) + grads]


def paged_sdpa(q, k_pages, v_pages, tables, lengths):
    """scaled_dot_product_attention in q's dtype over each sequence's
    gathered pages with the causal-ragged mask (key <= lengths - T + t):
    the yardstick of B4's bf16 error, never the port's path.  q: [B, T, H,
    D]; returns [B, T, H, D]."""
    import torch
    import torch.nn.functional as F
    B, T, H, D = q.shape
    Hkv, page = k_pages.shape[1], k_pages.shape[2]
    S = tables.shape[1] * page
    tb = tables.long()
    k, v = (x[tb].transpose(1, 2).reshape(B, Hkv, S, D).repeat_interleave(
        H // Hkv, 1) for x in (k_pages, v_pages))
    qpos = lengths.long()[:, None] - T + torch.arange(T, device=q.device)
    mask = torch.arange(S, device=q.device)[None, None] <= qpos[:, :, None]
    return F.scaled_dot_product_attention(
        q.transpose(1, 2), k, v, attn_mask=mask[:, None]).transpose(1, 2)


def sparse_sdpa(q, k, v, layout, block, causal):
    """scaled_dot_product_attention in q's dtype with the layout expanded
    to a boolean [H, S, S] mask (and causal): the yardstick of B6's bf16
    error, never the port's path.  Rows that see no key give 0, as the
    kernel's do.  q/k/v: [B, S, H, D]."""
    import torch
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops.sparse_attention import expand_layout_mask
    S = q.shape[1]
    mask = torch.as_tensor(expand_layout_mask(layout, block, S),
                           device=q.device)
    if causal:
        mask &= torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
    out = F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        attn_mask=mask[None]).transpose(1, 2)
    seen = mask.any(-1).T[None, :, :, None]               # [1, S, H, 1]
    return torch.where(seen, out, torch.zeros_like(out))


def check_output(name, got, exact, sdpa, tensor_cores=False):
    """A forward kernel's output against ``exact``, its plain version run
    in fp32 from the inputs: fp32 by check_close; bf16 -- the tensor-core
    kernels round P to bf16 inside the product -- by check_witnessed,
    with ``sdpa`` (a callable: the same function by SDPA in the kernel's
    dtype) as the yardstick; fp16 by check_close (TOL["float16"]), or by
    the fp16 witness rule where ``tensor_cores`` says the output came from
    tiles that round P to fp16."""
    import torch
    if got.dtype == torch.bfloat16 or (got.dtype == torch.float16 and
                                       tensor_cores):
        return check_witnessed(name, got, exact.to(got.dtype), exact, sdpa())
    return check_close(name, got, exact.to(got.dtype))


# ----------------------------------------------------------------------
def phase_device():
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a "
             "CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    phase("device", f"{card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | devices {torch.cuda.device_count()}")
    return card


def ptxas_usage(log):
    """{kernel (demangled where c++filt is there): (registers, spill store
    bytes, spill load bytes)} from an ``nvcc -Xptxas -v`` log."""
    import re
    import shutil
    usage, name, spills = {}, None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name, spills = m.group(1), (0, 0)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            spills = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            usage[name] = (int(m.group(1)),) + spills
            name = None
    tool = shutil.which("c++filt")
    if tool and usage:
        out = subprocess.run([tool], input="\n".join(usage),
                             capture_output=True, text=True, timeout=60)
        names = out.stdout.splitlines()
        if out.returncode == 0 and len(names) == len(usage):
            usage = dict(zip(names, usage.values()))
    return usage


# kernels that must not spill (ptxas): the split-key decode bodies, whose
# registers hold the loads in flight or the operands of the products
# (every row count, dtype and head dim, the staged body included) and
# their combines, the shared tensor-core consumer of B1's forward and B4's prefill tiles at 64,
# 80, 96 and 256 (wgmma_attention.cuh: S, P and O in registers while
# products run), the persistent bodies of B2 (dQ and dK/dV) at head dims
# 64, 80 and 96, the head-dim-80 and -96 tensor-core forms of B1, and the
# head-dim-16, -80, -96 and -256 CUDA-core tiles of B4 and B5
# (attention_tile.cuh); every form of B1 and B2 at head dim 256 (fp32
# included) and B6's fp16 form; by demangled or mangled name.  Head dim
# 16 (the benches' tiny model) has only CUDA-core forms, every one held
NO_SPILL = (r"split_kernel|split_tc_kernel|split_staged_kernel|"
            r"combine_kernel|"
            r"flash_(fwd|bwd_dq|bwd_dkv)_kernel("
            r"<(__nv_bfloat16|__half), \w+, \w+, (64|80|96)>|"
            r"I(13__nv_bfloat16|6__half)Lb[01]ELb[01]ELi(64|80|96)E)|"
            r"flash_(fwd|bwd_dq|bwd_dkv)_kernel(<\w+, \w+, \w+, 256>|"
            r"I\w+Lb[01]ELb[01]ELi256E)|"
            r"sparse_tc_kernel(<__half, |I6__half)|"
            r"ragged_prefill_tc_kernel(<(__nv_bfloat16|__half), "
            r"(64|80|96|256)>|I(13__nv_bfloat16|6__half)Li(64|80|96|256)E)|"
            r"(ragged_paged|decode)_attention_kernel("
            r"<\w+, (16|80|96|256), 16>|I\w+Li(16|80|96|256)ELi16E)")


# the head-dim-16 instantiations (the benches' tiny model): the split-key
# body and its combine over ContiguousSeqs<16> / PagedSeqs<16>, and the
# CUDA-core tiles <T, 16, 16>, by demangled or mangled name
HEAD_DIM_16 = (r"Seqs<16>|SeqsILi16E|attention_kernel<\w+, 16, 16>|"
               r"attention_kernelI\w+Li16ELi16E")


def must_not_spill(kernel):
    """Whether kernel (a name from :func:`ptxas_usage`) is one that
    NO_SPILL names."""
    import re
    return re.search(NO_SPILL, kernel) is not None


def phase_build():
    """Builds every kernel source; prints each kernel's registers and
    spills (ptxas), and fails if an instantiation NO_SPILL names -- the
    split-key decode body, the head-dim-64 tensor-core consumer --
    spills."""
    from deepspeed_tpu_torch.ops import op_builder
    t0 = time.time()
    logs = op_builder.build()
    dt = time.time() - t0
    phase("build", f"nvcc sm_90a, {len(logs)} kernel sources built in "
          f"{dt:.1f} s")
    import re
    spilled, d16 = [], []
    for source, log in logs.items():
        for kernel, (regs, st, ld) in ptxas_usage(log).items():
            phase("build", f"{source}: {kernel[:150]}: {regs} registers, "
                  f"spill stores {st} B, loads {ld} B")
            if (st or ld) and must_not_spill(kernel):
                spilled.append(kernel)
            if re.search(HEAD_DIM_16, kernel):
                d16.append((regs, st + ld, must_not_spill(kernel)))
    if spilled:
        fail(f"instantiations that must not spill do: {spilled[:4]}")
    # 3 dtypes x (8 row counts x (split + combine) + tiles) x 2 kernels
    if logs and (len(d16) != 2 * 3 * (8 * 2 + 1) or not all(
            held for _, _, held in d16)):
        fail(f"head dim 16: {len(d16)} instantiations found, expected "
             f"{2 * 3 * 17}, each held to no spill")
    if d16:
        phase("build", f"head dim 16: {len(d16)} instantiations (B4's and "
              f"B5's split-key body and combine at 1-8 rows and CUDA-core "
              f"tiles, fp32 / bf16 / fp16), {min(r for r, _, _ in d16)}-"
              f"{max(r for r, _, _ in d16)} registers, spill bytes "
              f"{sum(b for _, b, _ in d16)}")
    return dt


# the tensor-core kernels: (library source, kernel template); every bf16
# and fp16 instantiation must issue wgmma (HGMMA) and TMA loads (UTMALDG)
TENSOR_CORE_KERNELS = [("flash_attention_fwd", "flash_fwd_kernel"),
                       ("flash_attention_bwd", "flash_bwd_dq_kernel"),
                       ("flash_attention_bwd", "flash_bwd_dkv_kernel"),
                       ("sparse_attention", "sparse_tc_kernel"),
                       ("ragged_paged_attention", "ragged_prefill_tc_kernel")]
# kernel template -> (regex of its tensor-core instantiations' template
# arguments in the mangled name, the arguments' reading, how many it has):
# the flash kernels' <bf16 or fp16, alibi, window, head dim 64, 80, 96,
# 128 or 256>, B6's <bf16 or fp16, block, head dim>, and B4's prefill
# kernel's <bf16 or fp16, head dim 64, 80, 96, 128 or 256>
_DTYPE_ARG = {"13__nv_bfloat16": "bf16", "6__half": "fp16"}


def _flash_arg(x):
    """A flash kernel's mangled template argument: its dtype, a bias flag
    (0 / 1) or its head dim."""
    if x in _DTYPE_ARG:
        return _DTYPE_ARG[x]
    return bool(int(x)) if x in ("0", "1") else int(x)


_FLASH_ARGS = (r"I(13__nv_bfloat16|6__half)Lb([01])ELb([01])ELi(\d+)E",
               _flash_arg, 40)
SASS_TEMPLATES = {
    "flash_fwd_kernel": _FLASH_ARGS,
    "flash_bwd_dq_kernel": _FLASH_ARGS,
    "flash_bwd_dkv_kernel": _FLASH_ARGS,
    "sparse_tc_kernel": (r"I(13__nv_bfloat16|6__half)Li(\d+)ELi(\d+)E",
                         _flash_arg, 16),
    "ragged_prefill_tc_kernel": (r"I(13__nv_bfloat16|6__half)Li(\d+)E",
                                 _flash_arg, 10),
}


def sass_counts(sass, kernel):
    """{template arguments: (HGMMA count, UTMALDG count, WARPGROUP.DEPBAR
    count)} of the tensor-core instantiations of template ``kernel`` in
    ``cuobjdump -sass`` output, read by SASS_TEMPLATES: e.g. the flash
    kernels' names end ``<kernel>I13__nv_bfloat16Lb<0|1>ELb<0|1>ELi<64|
    128>E`` (``I6__half...`` for fp16) and give keys (dtype, alibi, window,
    head dim).  A DEPBAR after every HGMMA means ptxas serialised the
    wgmma pipeline."""
    import re
    args, conv, _ = SASS_TEMPLATES[kernel]
    pat = re.compile(r"\d" + re.escape(kernel) + args)
    counts = {}
    for part in sass.split("Function : ")[1:]:
        m = pat.search(part.split("\n", 1)[0])
        if m:
            counts[tuple(conv(x) for x in m.groups())] = (
                len(re.findall(r"\bHGMMA\b", part)),
                len(re.findall(r"\bUTMALDG\b", part)),
                len(re.findall(r"\bWARPGROUP\.DEPBAR\b", part)))
    return counts


def phase_sass():
    """Counts HGMMA and UTMALDG (and prints WARPGROUP.DEPBAR) in the SASS
    (cuobjdump -sass) of each bf16 and fp16 instantiation of the
    tensor-core kernels; fails if one lacks either or an instantiation is
    missing."""
    import shutil
    import tempfile
    from deepspeed_tpu_torch.ops import op_builder
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    # one cuobjdump a library, all started together, each into a file
    sass = {}
    with tempfile.TemporaryDirectory() as tmp:
        procs = {}
        for source in dict.fromkeys(s for s, _ in TENSOR_CORE_KERNELS):
            out = open(os.path.join(tmp, source), "w+")
            procs[source] = (subprocess.Popen(
                [tool, "-sass", str(op_builder._lib_path(source))],
                stdout=out, stderr=subprocess.STDOUT, text=True), out)
        for source, (proc, out) in procs.items():
            proc.wait(timeout=300)
            out.seek(0)
            sass[source] = out.read()
            out.close()
            if proc.returncode != 0:
                fail(f"cuobjdump -sass {source}: {sass[source][:300]}")
    for source, kernel in TENSOR_CORE_KERNELS:
        lib = op_builder._lib_path(source)
        counts = sass_counts(sass[source], kernel)
        for args, (n_mma, n_tma, n_bar) in sorted(counts.items()):
            phase("build", f"SASS {kernel}{list(args)}: {n_mma} HGMMA, "
                  f"{n_tma} UTMALDG, {n_bar} WARPGROUP.DEPBAR")
            if not n_mma or not n_tma:
                fail(f"{kernel}{list(args)} issues no wgmma or no TMA load")
        want = SASS_TEMPLATES[kernel][2]
        if len(counts) != want:
            fail(f"{kernel}: {len(counts)} of its {want} tensor-core "
                 f"instantiations found in {lib.name}")


def _rand(shape, dtype, gen):
    import torch
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def _paged_state(ctx_lens, page, Hkv, D, dtype, gen, shared_pages=0):
    """K/V pools and allocator-made block tables for the kernel phase's
    edge cases (prefix pages shared across sequences when
    ``shared_pages`` > 0); :func:`_engine_state` builds the serve run's.
    Tables hold at least 16 pages, pools at least 160: more where small
    pages need them."""
    import torch
    from deepspeed_tpu_torch.ops.paged_attention import PagedAllocator
    per_seq = max(16, -(-max(ctx_lens) // page))
    n_pages = max(160, sum(-(-c // page) for c in ctx_lens) + shared_pages + 1)
    alloc = PagedAllocator(n_pages, page, max_pages_per_seq=per_seq,
                           reserve_scratch=True)
    shared = []
    if shared_pages:
        shared = alloc.allocate("__prefix__",
                                shared_pages * page)[:shared_pages]
    for s, c in enumerate(ctx_lens):
        n_shared = min(shared_pages, max(0, (c - 1) // page))
        alloc.allocate(s, c, shared=shared[:n_shared])
    if alloc.audit():
        fail(f"allocator audit: {alloc.audit()}")
    tables = torch.as_tensor(alloc.block_table(list(range(len(ctx_lens)))),
                             device="cuda")
    kp = _rand((n_pages, Hkv, page, D), dtype, gen)
    vp = _rand((n_pages, Hkv, page, D), dtype, gen)
    return tables, kp, vp


# phase 5: create_serving_engine(max_batch, page_size, max_seq), prompts
# of these lengths with SERVE_NEW new tokens each
SERVE_SLOTS, SERVE_PAGE, SERVE_MAX_SEQ, SERVE_NEW = 8, 128, 2048, 32
SERVE_PROMPTS = [16, 600, 37, 250, 128, 511, 64, 300, 90, 450, 200, 23]
# the serving kernels' (B4, B5) head dims beside 64 and 128: GPT-3 2.7B's
# 80 and Phi-3-mini's 96
HEAD_DIMS_80_96 = (80, 96)
# (query heads, kv heads) of the head-dim-256 cases: Gemma-7B's 16 / 16,
# a group of 4, and Gemma-2B's 8 / 1
GEMMA_HEADS = ((16, 16), (16, 4), (8, 1))


def _engine_state(needs, Hkv, D, dtype, gen, max_seq=SERVE_MAX_SEQ):
    """K/V pools and block tables as the serving engine of phase 5 builds
    them (``ServingEngine.__init__`` / ``_admit``): 8 slots x 16 pages + the
    scratch page 0 in the pool, tables of max_seq/page columns plus the
    overrun column, which stays 0 (``max_seq``: another engine's, e.g. a
    bench's, rounded up to whole pages).  Slot s reserves ``needs[s]``
    tokens; None is an idle slot, a row of zeros.  Pages recycled from a
    finished request come first, as mid-run."""
    import torch
    from deepspeed_tpu_torch.ops.paged_attention import PagedAllocator
    page, mpps = SERVE_PAGE, -(-max_seq // SERVE_PAGE)
    n_pages = SERVE_SLOTS * mpps + 1
    alloc = PagedAllocator(n_pages, page, mpps, reserve_scratch=True)
    alloc.allocate("finished", min(3 * page + 1, mpps * page))
    alloc.allocate("busy", min(5 * page, mpps * page))
    alloc.free_sequence("finished")
    tables = torch.zeros((len(needs), mpps + 1), dtype=torch.int32)
    for s, n in enumerate(needs):
        if n is not None:
            pages = alloc.allocate(s, n)
            tables[s, :len(pages)] = torch.as_tensor(pages)
    if alloc.audit():
        fail(f"allocator audit: {alloc.audit()}")
    kp = _rand((n_pages, Hkv, page, D), dtype, gen)
    vp = _rand((n_pages, Hkv, page, D), dtype, gen)
    return tables.cuda(), kp, vp


def _prefill_need(prompt):
    """Tokens ``_admit`` reserves for a prompt: its budget or its padded
    prefill bucket, whichever is larger."""
    bucket = min(1 << max(3, math.ceil(math.log2(prompt))), SERVE_MAX_SEQ)
    return bucket, min(max(prompt + SERVE_NEW, bucket), SERVE_MAX_SEQ)


def chunk_edge_lengths(n, c, T, S, B):
    """Lengths where a decode plan's n key chunks of c keys meet a
    sequence's end over S_max S: T, around one, two and n chunks (the mask
    kpos <= len - T + t across the edge when T > 1), S - 1; padded with S -
    1 to a multiple of B (the calls' batch)."""
    edges = [x for x in (T, c - 1, c, c + 1, c + 3, 2 * c - 1, 2 * c,
                         2 * c + 1, n * c - 1, n * c + 1, S - 1)
             if T <= x <= S]
    return edges + [S - 1] * (-len(edges) % B)


def phase_kernels():
    """Each kernel vs its plain version, at the main path's shapes and at
    edge cases; returns max abs err per kernel and dtype."""
    import torch
    from deepspeed_tpu_torch.ops.cuda.decode_attention import (
        DECODE_MIN_CHUNK, DECODE_ROWS, _DTYPE_CODES, _decode_slots,
        decode_attention_cuda, decode_attention_plain, decode_plan,
        min_chunk, staged)
    from deepspeed_tpu_torch.ops.cuda.ragged_paged_attention import (
        decode_rows_splits, paged_attention_plain, ragged_paged_attention,
        ragged_paged_attention_rect, tensor_core_prefill)
    gen = torch.Generator(device="cuda").manual_seed(1234)
    D, H, page = 128, 32, 128
    errs = {}

    def note(kernel, dn, e):
        errs[(kernel, dn)] = max(errs.get((kernel, dn), 0.0), e)

    def i32(x):
        return torch.tensor(x, dtype=torch.int32, device="cuda")

    def tiles(dtype, D, group, pg, q_lens):
        """Whether a B4 call's output came (in part) from the tensor-core
        prefill tiles: some sequence has more than DECODE_ROWS rows."""
        return tensor_core_prefill(dtype, D, group, pg) and \
            any(ql * group > DECODE_ROWS for ql in q_lens)

    def check_b4(name, got, exact, sdpa, tc):
        """A B4 output: the tensor-core prefill tiles' (P rounded inside
        the product) by check_output's SDPA rule; every other form -- the
        decode rows, whose P enters the product as two terms, and the
        CUDA-core tiles -- by the one-ulp rule."""
        if tc:
            return check_output(name, got, exact, sdpa, True)
        return check_close(name, got, exact.to(got.dtype))

    def packed_b4(label, q_lens, ctx, Hkv, Dh, pg=page, Hq=H):
        """B4's packed front-end on one mixed batch, prefix pages shared
        by the sequences past two pages."""
        tb, kk, vv = _paged_state(ctx, pg, Hkv, Dh, dtype, gen,
                                  shared_pages=2)
        if not (tb[1, 0] == tb[2, 0] and tb[1, 1] == tb[2, 1]):
            fail("packed case: prefix pages are not shared")
        qp = _rand((sum(q_lens), Hq, Dh), dtype, gen)
        got = ragged_paged_attention(qp, kk, vv, tb, ctx, q_lens)
        seqs, off = [], 0
        for s, ql in enumerate(q_lens):
            seqs.append((qp[off:off + ql][None], tb[s:s + 1], i32([ctx[s]])))
            off += ql
        kf, vf = kk.float(), vv.float()
        exact = torch.cat([paged_attention_plain(x.float(), kf, vf, t, c)[0]
                           for x, t, c in seqs])
        note("ragged_paged_attention", dn, check_b4(
            f"ragged_paged_attention {dn} {label} D={Dh} packed mixed "
            f"q_lens {q_lens}", got, exact,
            lambda: torch.cat([paged_sdpa(x, kk, vv, t, c)[0]
                               for x, t, c in seqs]),
            tiles(dtype, Dh, Hq // Hkv, pg, q_lens)))

    def check_b5(label, B, T, Hkv, S, lens, Dh=D, Hq=H):
        q = _rand((B, T, Hq, Dh), dtype, gen)
        k = _rand((B, Hkv, S, Dh), dtype, gen)
        v = _rand((B, Hkv, S, Dh), dtype, gen)
        got = decode_attention_cuda(q, k, v, lens)
        want = reference(decode_attention_plain, q, k, v, lens)
        n, c = decode_plan(B, T, Hq, Hkv, S, Dh, dtype, "cuda")
        how = f"length {lens}" if isinstance(lens, int) else \
            f"lengths {lens.tolist()}"
        form = "decode" if T * Hq // Hkv <= DECODE_ROWS else "prefill"
        note("decode_attention", dn, check_close(
            f"decode_attention {dn} H{Hq}/{Hkv} D={Dh} {label} B={B} T={T} "
            f"S_max={S} {how} ({form} form, {n} x {c} keys)", got, want))

    def edge_cache(rows, Dh=D):
        """S_max at which the decode form splits: 2048, or 8192 where the
        tensor-core body's longer chunks need it (head dims 64-128)."""
        return 8192 if min_chunk(rows, dtype, Dh) > DECODE_MIN_CHUNK else \
            2048

    def chunk_edges(B, T, Hkv, Dh, S, Hq=H):
        """:func:`chunk_edge_lengths` at the wrapper's own plan for S_max
        S, B lengths a call; fails if the plan takes one chunk (the cases
        would check nothing)."""
        n, c = decode_plan(B, T, Hq, Hkv, S, Dh, dtype, "cuda")
        if T * Hq // Hkv > DECODE_ROWS:        # the prefill form
            n, c = 1, DECODE_MIN_CHUNK
        elif n == 1:
            fail(f"decode_attention B={B} T={T} H{Hq}/{Hkv} D={Dh}: the "
                 f"chunk-edge cases take one chunk; they check nothing")
        edges = chunk_edge_lengths(n, c, T, S, B)
        return [i32(edges[i:i + B]) for i in range(0, len(edges), B)]

    def check_repeat(label, fn):
        """A second call on the same inputs gives the same output bit for
        bit: the warps and the chunks merge in a fixed order."""
        a, b = fn(), fn()
        if not torch.equal(a, b):
            fail(f"{label}: a second call differs by up to "
                 f"{(a.float() - b.float()).abs().max().item():.3e}")
        phase("kernels", f"{label}: a second call is bit for bit the same")

    def check_staged(Dn, Hq, T=1):
        """The staged body at T rows a kv head (MHA: T tokens a sequence)
        in B4 and B5: one row (the MHA decode steps of gpt_2_7b,
        Phi-3-mini and Gemma-7B) and, at 80 and 96, 5 and 8 rows
        (gpt_2_7b's verify window of 5): contexts of T keys, at a page
        edge (127-129) and around a split plan's chunk edges, over pages
        of 16, 48 and 128 keys (B4: many sequences, one chunk each, and
        one alone, split; pages of 48 keys take 16-row TMA boxes), B5
        unsplit and split (B=1 over S_max 2048), and a second call of each
        bit for bit.  (Over a 160-key cache one row keeps the CUDA-core
        body: phase 3's generate steps.)"""
        rows = "one-row" if T == 1 else f"{T}-row"
        n, c = decode_plan(1, T, Hq, Hq, 2048, Dn, dtype, "cuda")
        if n == 1 or not staged(T, dtype, Dn, c):
            fail(f"{rows} decode {dn} D={Dn}: plan {n} x {c} keys is not "
                 f"the staged body's split")
        ctx = sorted({T, 127, 128, 129, c - 1, c, c + 1, 2 * c, 2 * c + 3,
                      600})
        # B4: many sequences (one chunk each) and one alone (split)
        for pg, cs in ((pg, cs) for pg in (16, 48, 128)
                       for cs in (ctx, [2 * c + 3])):
            tb, kk, vv = _paged_state(cs, pg, Hq, Dn, dtype, gen)
            qq = _rand((len(cs), T, Hq, Dn), dtype, gen)
            lens = i32(cs)
            got = ragged_paged_attention_rect(qq, kk, vv, tb, lens)
            exact = paged_attention_plain(qq.float(), kk.float(), vv.float(),
                                          tb, lens)
            label = (f"ragged_paged_attention {dn} H{Hq}/{Hq} D={Dn} "
                     f"{rows} decode page {pg} ctx {cs}")
            note("ragged_paged_attention", dn,
                 check_close(label, got, exact.to(dtype)))
            check_repeat(label, lambda: ragged_paged_attention_rect(
                qq, kk, vv, tb, lens))
            del tb, kk, vv, qq, exact
        for S, lens in ((2048, i32(ctx)), (2048, i32([c + 1])),
                        (2048, i32([2 * c + 3]))):
            check_b5(rows, len(lens), T, Hq, S, lens, Dh=Dn, Hq=Hq)
            qq = _rand((len(lens), T, Hq, Dn), dtype, gen)
            kk = _rand((len(lens), Hq, S, Dn), dtype, gen)
            vv = _rand((len(lens), Hq, S, Dn), dtype, gen)
            check_repeat(
                f"decode_attention {dn} H{Hq}/{Hq} D={Dn} {rows} S_max={S} "
                f"{decode_plan(len(lens), T, Hq, Hq, S, Dn, dtype, 'cuda')}",
                lambda: decode_attention_cuda(qq, kk, vv, lens))
            del qq, kk, vv

    def check_prefill_walks(Dn, Hq, Hkv):
        """B4's tensor-core prefill tiles at head dim Dn (bf16 / fp16, on
        the shared consumer), pages of 16 and 128 keys: causal frontiers on
        a K/V tile's edge (a chunk at start 512) and a key past it (start
        513), and a long walk (128 tokens at start 1900).  Each against
        the plain version in fp32 and again bit for bit."""
        for pg in (16, 128):
            for T, start in ((256, 512), (200, 513), (128, 1900)):
                ctx = [start + T]
                tb, kk, vv = _paged_state(ctx, pg, Hkv, Dn, dtype, gen)
                qq = _rand((1, T, Hq, Dn), dtype, gen)
                lens = i32(ctx)
                label = (f"ragged_paged_attention {dn} H{Hq}/{Hkv} D={Dn} "
                         f"page {pg} prefill T={T} at start {start}")
                got = ragged_paged_attention_rect(qq, kk, vv, tb, lens)
                exact = paged_attention_plain(qq.float(), kk.float(),
                                              vv.float(), tb, lens)
                note("ragged_paged_attention", dn, check_b4(
                    label, got, exact,
                    lambda: paged_sdpa(qq, kk, vv, tb, lens), True))
                check_repeat(label, lambda: ragged_paged_attention_rect(
                    qq, kk, vv, tb, lens))
                del tb, kk, vv, qq, exact

    def check_head_dim_16():
        """Head dim 16 (the benches' tiny model, 4 heads of 16) on the
        CUDA-core bodies, which take it at every row count and dtype: B5
        and B4's decode rows at 1, 2, 4 and 8 rows a kv head (MHA at T =
        1, 2, 4, 8; group 4 at T = 1, 2) over lengths at and one past a
        split plan's chunk edges (B4 at pages 16 and 128), the inference
        bench's own calls (its 128-token prompt over a 192-key cache and
        steps over 129-192 keys), B4's CUDA-core prefill tiles at pages 16
        and 128 (the serving bench's bucket 128, prefills after cached
        prefixes, a packed mixed batch sharing prefix pages), and each
        call again bit for bit."""
        Dn, Hq = 16, 4
        for Hkv, Ts in ((4, (1, 2, 4, 8)), (1, (1, 2))):
            group = Hq // Hkv
            for pg in (16, 128):
                if tensor_core_prefill(dtype, Dn, group, pg):
                    fail(f"tensor_core_prefill({dn}, 16, {group}, {pg}) "
                         f"holds: head dim 16 has no tensor-core tile")
            if Hkv == Hq:
                check_b5("inference bench prompt", 1, 128, Hkv, 192, 128,
                         Dh=Dn, Hq=Hq)
                check_b5("inference bench steps", 3, 1, Hkv, 192,
                         i32([129, 160, 192]), Dh=Dn, Hq=Hq)
            for T in Ts:
                rows = T * group
                edges = chunk_edges(4, T, Hkv, Dn, 2048, Hq=Hq)
                for lens in edges:
                    check_b5("chunk edges", 4, T, Hkv, 2048, lens, Dh=Dn,
                             Hq=Hq)
                qq = _rand((4, T, Hq, Dn), dtype, gen)
                kk = _rand((4, Hkv, 2048, Dn), dtype, gen)
                vv = _rand((4, Hkv, 2048, Dn), dtype, gen)
                check_repeat(
                    f"decode_attention {dn} H{Hq}/{Hkv} D=16 {rows} rows "
                    f"chunk edges {edges[0].tolist()} "
                    f"{decode_plan(4, T, Hq, Hkv, 2048, Dn, dtype, 'cuda')}",
                    lambda: decode_attention_cuda(qq, kk, vv, edges[0]))
                del qq, kk, vv
                # B4's decode rows: six sequences, keys split at the plan's
                # chunk edges (a table of 2048 keys at both pages)
                slots = _decode_slots("cuda", rows, Dn, _DTYPE_CODES[dtype],
                                      entry="ragged_decode_slots")
                n, c = decode_rows_splits(6, Hkv, 2048, slots, rows, dtype,
                                          Dn)
                if n == 1:
                    fail(f"ragged_paged_attention {dn} D=16 {rows} rows: "
                         f"the chunk-edge cases take one chunk")
                ctx = [T, c - 1, c, c + 1, 2 * c + 1, 2047]
                for pg in (16, 128):
                    tb, kk, vv = _paged_state(ctx, pg, Hkv, Dn, dtype, gen)
                    qq = _rand((len(ctx), T, Hq, Dn), dtype, gen)
                    lens = i32(ctx)
                    label = (f"ragged_paged_attention {dn} H{Hq}/{Hkv} D=16 "
                             f"{rows}-row decode page {pg} ctx {ctx} "
                             f"({n} x {c} keys)")
                    exact = paged_attention_plain(qq.float(), kk.float(),
                                                  vv.float(), tb, lens)
                    note("ragged_paged_attention", dn, check_close(
                        label, ragged_paged_attention_rect(qq, kk, vv, tb,
                                                          lens),
                        exact.to(dtype)))
                    check_repeat(label, lambda: ragged_paged_attention_rect(
                        qq, kk, vv, tb, lens))
                    del tb, kk, vv, qq, exact
            # B4's CUDA-core prefill tiles
            for pg in (16, 128):
                for label, T, ctx in (
                        ("serving bench prefill B=1 T=128", 128, [128]),
                        ("prefill B=2 T=200 after prefixes, ctx 300/457",
                         200, [300, 457])):
                    tb, kk, vv = _paged_state(ctx, pg, Hkv, Dn, dtype, gen)
                    qq = _rand((len(ctx), T, Hq, Dn), dtype, gen)
                    lens = i32(ctx)
                    label = (f"ragged_paged_attention {dn} H{Hq}/{Hkv} D=16 "
                             f"page {pg} {label}")
                    exact = paged_attention_plain(qq.float(), kk.float(),
                                                  vv.float(), tb, lens)
                    note("ragged_paged_attention", dn, check_close(
                        label, ragged_paged_attention_rect(qq, kk, vv, tb,
                                                          lens),
                        exact.to(dtype)))
                    check_repeat(label, lambda: ragged_paged_attention_rect(
                        qq, kk, vv, tb, lens))
                    del tb, kk, vv, qq, exact
                packed_b4(f"H{Hq}/{Hkv} page {pg}", [37, 1, 130, 2, 1],
                          [37, 300, 1000, 521, 257], Hkv, Dn, pg, Hq=Hq)

    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        dn = str(dtype).split(".")[-1]
        # (the draws of the earlier head dims' cases stay as they were)
        state = gen.get_state()
        check_head_dim_16()
        gen.set_state(state)
        for Hkv in (32, 8):
            # B5: ragged lengths over S_max 2048, and generate's own calls
            # (B=4, cache 128 + 32, one int length for every sequence):
            # its prefill (T=128, length 128) and a decode (length 144)
            for T in (1, 128):
                check_b5("ragged", 4, T, Hkv, 2048, i32([T + 5, 700, 1500,
                                                          2048]))
            check_b5("generate prefill", 4, 128, Hkv, 160, 128)
            check_b5("generate decode", 4, 1, Hkv, 160, 144)
            # then lengths where the decode form's key chunks meet a
            # sequence's end -- one sequence for MHA, four (a ragged
            # batch) for GQA, so that the keys are split: T=1, T=4 (4 rows
            # at MHA), and 8 rows (T=8 at MHA, T=2 at group 4, the
            # tensor-core form); and one int length over S_max 1536
            Be = 1 if Hkv == H else 4
            for T in (1, 4, 8 * Hkv // H):
                S = edge_cache(T * H // Hkv)
                for lens in chunk_edges(Be, T, Hkv, D, S):
                    check_b5("chunk edges", Be, T, Hkv, S, lens)
            check_b5("int length", Be, 1, Hkv, 1536, 1529)
            # B4 rect front-end: decode rows (the split-key form), then
            # prefill tiles (bf16: the tensor-core form at pages 128 and
            # 64; page 48 keeps the CUDA-core tiles)
            ctx = [1, 17, 128, 129, 300, 640, 1000, 2047]
            tables, kp, vp = _paged_state(ctx, page, Hkv, D, dtype, gen)
            cases = [("decode B=8 T=1 ragged", 1, tables, kp, vp, ctx)]
            t1, kp1, vp1 = _paged_state([128], page, Hkv, D, dtype, gen)
            cases.append(("prefill B=1 T=128", 128, t1, kp1, vp1, [128]))
            # prefills after cached prefixes: ragged last tiles, the first
            # query past a page edge
            cases.append(("prefill B=2 T=200 after prefixes, ctx 300/457",
                           200, *_paged_state([300, 457], page, Hkv, D,
                                              dtype, gen), [300, 457]))
            if Hkv == H:
                for pg in (64, 48):
                    cases.append((f"prefill page {pg} B=2 T=130, ctx "
                                  f"130/700", 130, *_paged_state(
                                      [130, 700], pg, Hkv, D, dtype, gen),
                                  [130, 700]))
            # the serve run's own calls: bucketed prefills of its 16-, 511-
            # and 600-token prompts, and a decode step with two idle slots
            for prompt in (16, 511, 600):
                bucket, need = _prefill_need(prompt)
                cases.append((f"serve prefill B=1 T={bucket} "
                              f"(prompt {prompt})", bucket,
                              *_engine_state([need], Hkv, D, dtype, gen),
                              [bucket]))
            active = SERVE_PROMPTS[:6]
            needs = [p + SERVE_NEW for p in active] + [None, None]
            cases.append(("serve decode B=8 T=1, 2 idle slots", 1,
                          *_engine_state(needs, Hkv, D, dtype, gen),
                          [p + 16 for p in active] + [1, 1]))
            # the chunked scheduler's and the verify window's dispatches: a
            # 256-token prefill chunk at start 512 over cached pages, and
            # the speculative verify window [8, 5] of 8 slots mid-decode
            cases.append(("chunk B=1 T=256 at start 512", 256,
                          *_engine_state([1024 + SERVE_NEW], Hkv, D, dtype,
                                         gen), [768]))
            cases.append(("verify window B=8 T=5", 5,
                          *_engine_state([p + SERVE_NEW for p in
                                          SERVE_PROMPTS[:8]], Hkv, D,
                                         dtype, gen),
                          [p + 9 for p in SERVE_PROMPTS[:8]]))
            for label, T, tb, kk, vv, ctx in cases:
                qq = _rand((len(ctx), T, H, D), dtype, gen)
                lens = i32(ctx)
                got = ragged_paged_attention_rect(qq, kk, vv, tb, lens)
                exact = paged_attention_plain(qq.float(), kk.float(),
                                              vv.float(), tb, lens)
                note("ragged_paged_attention", dn, check_b4(
                    f"ragged_paged_attention {dn} H{H}/{Hkv} {label}", got,
                    exact, lambda: paged_sdpa(qq, kk, vv, tb, lens),
                    tiles(dtype, D, H // Hkv, kk.shape[2], [T])))
            # B4 packed front-end, mixed batches in one call: prefills,
            # decodes sharing prefix pages, partial pages; then decode rows
            # of 1-4 tokens (MHA: one decode launch of 4-row blocks) beside
            # a prefill, and of 5-8 tokens (MHA: 5-8 rows a kv head, one
            # launch of the tensor-core body at 8 rows) beside a prefill
            packed_b4(f"H{H}/{Hkv}", [37, 1, 1, 128, 9, 1],
                      [37, 300, 1000, 400, 521, 257], Hkv, D)
            if Hkv == H:
                packed_b4(f"H{H}/{Hkv}", [3, 1, 4, 2, 200],
                          [3, 640, 300, 1001, 329], Hkv, D)
                packed_b4(f"H{H}/{Hkv}", [5, 8, 6, 200, 7, 1],
                          [5, 640, 300, 1001, 329, 2047], Hkv, D)
        # GQA 32/4 (group 8): Llama-2's width at head dim 128, then the
        # TinyLlama-1.1B draft's shape, head dim 64: the decode step (8
        # rows a kv head: the decode form's tensor-core body in bf16 and
        # fp16) and a 256-token chunk at start 512 (prefill tiles), then a
        # packed batch of group-8 decodes beside a prefill
        needs = [p + SERVE_NEW for p in SERVE_PROMPTS[:8]]
        for Dg in (128, 64):
            for label, T, st, ctx in (
                    ("decode B=8 T=1", 1, needs,
                     [p + 16 for p in SERVE_PROMPTS[:8]]),
                    ("chunk B=1 T=256 at start 512", 256,
                     [1024 + SERVE_NEW], [768])):
                tb, kk, vv = _engine_state(st, 4, Dg, dtype, gen)
                qq = _rand((len(ctx), T, H, Dg), dtype, gen)
                lens = i32(ctx)
                got = ragged_paged_attention_rect(qq, kk, vv, tb, lens)
                exact = paged_attention_plain(qq.float(), kk.float(),
                                              vv.float(), tb, lens)
                note("ragged_paged_attention", dn, check_b4(
                    f"ragged_paged_attention {dn} H{H}/4 D={Dg} {label}",
                    got, exact, lambda: paged_sdpa(qq, kk, vv, tb, lens),
                    tiles(dtype, Dg, H // 4, kk.shape[2], [T])))
            packed_b4(f"H{H}/4 D={Dg}", [1, 1, 37, 1, 1],
                      [300, 1000, 400, 17, 2047], 4, Dg)
        # B4's prefill tiles at head dim 64 -- the tensor-core tiles in bf16
        # and fp16, the CUDA-core ones in fp32 -- at groups 1, 4 and 8 (32
        # query heads over 32, 8 and 4 kv heads) and pages 16 and 128:
        # prefills after cached prefixes whose q_len leaves a ragged last
        # tile (200 tokens: 72 past one 128-token tile, 8 past 32- and
        # 16-token ones), a 256-token chunk at start 512, and a packed
        # batch whose sequences share prefix pages
        for Hkv64 in (32, 8, 4):
            for pg in (16, 128):
                group = H // Hkv64
                tc = tensor_core_prefill(dtype, 64, group, pg)
                if tc != (dtype != torch.float32):
                    fail(f"tensor_core_prefill({dn}, 64, {group}, {pg}) is "
                         f"{tc}")
                for label, T, ctx in (
                        ("prefill B=2 T=200 after prefixes, ctx 300/457",
                         200, [300, 457]),
                        ("chunk B=1 T=256 at start 512", 256, [768])):
                    tb, kk, vv = _paged_state(ctx, pg, Hkv64, 64, dtype,
                                              gen)
                    qq = _rand((len(ctx), T, H, 64), dtype, gen)
                    lens = i32(ctx)
                    got = ragged_paged_attention_rect(qq, kk, vv, tb, lens)
                    exact = paged_attention_plain(qq.float(), kk.float(),
                                                  vv.float(), tb, lens)
                    note("ragged_paged_attention", dn, check_b4(
                        f"ragged_paged_attention {dn} H{H}/{Hkv64} D=64 "
                        f"page {pg} {label}", got, exact,
                        lambda: paged_sdpa(qq, kk, vv, tb, lens), tc))
                packed_b4(f"H{H}/{Hkv64} page {pg}", [37, 1, 130, 9, 1],
                          [37, 300, 1000, 521, 257], Hkv64, 64, pg)
        # B5 at head dim 64, TinyLlama-1.1B's 32/4 heads (group 8): T=1 (8
        # rows, the decode form), T=5 and T=128 (the prefill form) over
        # ragged lengths, generate's own calls and key-chunk edges at 8
        # rows; and group 8 at head dim 128
        for T in (1, 5, 128):
            check_b5("ragged", 4, T, 4, 2048, i32([T + 5, 700, 1500, 2048]),
                     Dh=64)
        check_b5("generate prefill", 4, 128, 4, 160, 128, Dh=64)
        check_b5("generate decode", 4, 1, 4, 160, 144, Dh=64)
        for Dg in (64, 128):
            S = edge_cache(8)
            for lens in chunk_edges(4, 1, 4, Dg, S):
                check_b5("chunk edges", 4, 1, 4, S, lens, Dh=Dg)
        # head dims 80 (GPT-3 2.7B's) and 96 (Phi-3-mini's) at groups 1, 4
        # and 8 (32 query heads over 32, 8 and 4 kv heads)
        for Dn, Hkv in ((Dn, Hkv) for Dn in HEAD_DIMS_80_96
                        for Hkv in (32, 8, 4)):
            group = H // Hkv
            for pg in (16, 128):
                tc = tensor_core_prefill(dtype, Dn, group, pg)
                if tc != (dtype != torch.float32):
                    fail(f"tensor_core_prefill({dn}, {Dn}, {group}, {pg}) "
                         f"is {tc}")
            # B5: every row count of the decode form, 1-8 rows a kv head
            # (T = 1..8 at group 1, 1-2 at group 4, 1 at group 8) over
            # ragged lengths -- at B=4 one chunk a sequence at MHA --
            # generate's own calls (its T=128 prefill takes the prefill
            # form), and lengths where several key chunks meet a
            # sequence's end (B=1 at MHA, B=4 at GQA)
            for T in range(1, DECODE_ROWS // group + 1):
                check_b5("ragged", 4, T, Hkv, 2048, i32(
                    [T + 5, 700, 1500, 2048]), Dh=Dn)
            check_b5("generate prefill", 4, 128, Hkv, 160, 128, Dh=Dn)
            check_b5("generate decode", 4, 1, Hkv, 160, 144, Dh=Dn)
            Be = 1 if group == 1 else 4
            for T in sorted({1, 4 // group or 1, DECODE_ROWS // group}):
                S = edge_cache(T * group)
                for lens in chunk_edges(Be, T, Hkv, Dn, S):
                    check_b5("chunk edges", Be, T, Hkv, S, lens, Dh=Dn)
            # B4: the decode rows at every row count over the serve run's
            # 8 slots (T = 5 at group 1 is the verify window), its
            # bucketed prefills at 512 and 1024 (page 128), and at pages
            # 128 and 16 prefills after cached prefixes (a ragged last
            # tile), a 256-token chunk at start 512 and a packed mixed
            # batch sharing prefix pages, with 5-row and 1-row decodes
            slots = _engine_state([p + SERVE_NEW for p in
                                   SERVE_PROMPTS[:8]], Hkv, Dn, dtype, gen)
            cases = [(f"decode rows B=8 T={T}", T, *slots,
                      [p + 9 for p in SERVE_PROMPTS[:8]])
                     for T in range(1, DECODE_ROWS // group + 1)]
            for prompt in (511, 600):
                bucket, need = _prefill_need(prompt)
                cases.append((f"serve prefill B=1 T={bucket} (prompt "
                              f"{prompt})", bucket, *_engine_state(
                                  [need], Hkv, Dn, dtype, gen), [bucket]))
            for pg in (128, 16):
                for label, T, ctx in (
                        ("prefill B=2 T=200 after prefixes, ctx 300/457",
                         200, [300, 457]),
                        ("chunk B=1 T=256 at start 512", 256, [768])):
                    cases.append((f"page {pg} {label}", T, *_paged_state(
                        ctx, pg, Hkv, Dn, dtype, gen), ctx))
            for label, T, tb, kk, vv, ctx in cases:
                qq = _rand((len(ctx), T, H, Dn), dtype, gen)
                lens = i32(ctx)
                got = ragged_paged_attention_rect(qq, kk, vv, tb, lens)
                exact = paged_attention_plain(qq.float(), kk.float(),
                                              vv.float(), tb, lens)
                note("ragged_paged_attention", dn, check_b4(
                    f"ragged_paged_attention {dn} H{H}/{Hkv} D={Dn} "
                    f"{label}", got, exact,
                    lambda: paged_sdpa(qq, kk, vv, tb, lens),
                    tiles(dtype, Dn, group, kk.shape[2], [T])))
            del cases, slots
            for pg in (128, 16):
                packed_b4(f"H{H}/{Hkv} page {pg}", [37, 1, 130, 5, 1],
                          [37, 300, 1000, 521, 257], Hkv, Dn, pg)
        # head dim 256 (Gemma's) at the Gemma shapes' groups: 16 heads over
        # 16 (Gemma-7B: group 1), over 4 (group 4), and 8 over 1 (Gemma-2B:
        # MQA, group 8); the same cases as at 80 and 96
        for Hq, Hkv in GEMMA_HEADS:
            group, Dn = Hq // Hkv, 256
            for pg in (16, 128):
                tc = tensor_core_prefill(dtype, Dn, group, pg)
                if tc != (dtype != torch.float32):
                    fail(f"tensor_core_prefill({dn}, {Dn}, {group}, {pg}) "
                         f"is {tc}")
            for T in range(1, DECODE_ROWS // group + 1):
                check_b5("ragged", 4, T, Hkv, 2048, i32(
                    [T + 5, 700, 1500, 2048]), Dh=Dn, Hq=Hq)
            check_b5("generate prefill", 4, 128, Hkv, 160, 128, Dh=Dn, Hq=Hq)
            check_b5("generate decode", 4, 1, Hkv, 160, 144, Dh=Dn, Hq=Hq)
            Be = 1 if group == 1 else 4
            for T in sorted({1, 4 // group or 1, DECODE_ROWS // group}):
                S = edge_cache(T * group, Dn)
                for lens in chunk_edges(Be, T, Hkv, Dn, S, Hq=Hq):
                    check_b5("chunk edges", Be, T, Hkv, S, lens, Dh=Dn,
                             Hq=Hq)
            if group == 8:
                # Gemma-2B: generate's step at 4096 cached tokens, then a
                # second call of each form bit for bit -- the 4096-token
                # step and ragged lengths (40 fits one chunk: unsplit)
                check_b5("len 4096", 4, 1, Hkv, 4096, 4096, Dh=Dn, Hq=Hq)
                for S, lens in ((4096, 4096),
                                (2048, i32([40, 700, 1500, 2048]))):
                    qq = _rand((4, 1, Hq, Dn), dtype, gen)
                    kk = _rand((4, Hkv, S, Dn), dtype, gen)
                    vv = _rand((4, Hkv, S, Dn), dtype, gen)
                    check_repeat(
                        f"decode_attention {dn} H{Hq}/{Hkv} D={Dn} B=4 "
                        f"S_max={S} "
                        f"{decode_plan(4, 1, Hq, Hkv, S, Dn, dtype, 'cuda')}",
                        lambda: decode_attention_cuda(qq, kk, vv, lens))
                    del qq, kk, vv
            slots = _engine_state([p + SERVE_NEW for p in
                                   SERVE_PROMPTS[:8]], Hkv, Dn, dtype, gen)
            cases = [(f"decode rows B=8 T={T}", T, *slots,
                      [p + 9 for p in SERVE_PROMPTS[:8]])
                     for T in range(1, DECODE_ROWS // group + 1)]
            if group == 8:
                # Gemma-2B's 8-slot step twice: its short sequences fit
                # one chunk, its long ones span several
                qq = _rand((8, 1, Hq, Dn), dtype, gen)
                lens = i32([p + 16 for p in SERVE_PROMPTS[:8]])
                check_repeat(
                    f"ragged_paged_attention {dn} H{Hq}/{Hkv} D={Dn} 8-slot "
                    f"decode step", lambda: ragged_paged_attention_rect(
                        qq, slots[1], slots[2], slots[0], lens))
            # the most rows a kv head at pages of 12 and 48 keys: the
            # staged body's boxes of 4 and 16 rows (the largest power of
            # 2 dividing the page), swizzled as whole 64-row tiles are
            for pg in (12, 48):
                T, ctx = DECODE_ROWS // group, [300, 37, 129]
                cases.append((f"page {pg} decode rows B=3 T={T}", T,
                              *_paged_state(ctx, pg, Hkv, Dn, dtype, gen),
                              ctx))
            for prompt in (511, 600):
                bucket, need = _prefill_need(prompt)
                cases.append((f"serve prefill B=1 T={bucket} (prompt "
                              f"{prompt})", bucket, *_engine_state(
                                  [need], Hkv, Dn, dtype, gen), [bucket]))
            for pg in (128, 16):
                for label, T, ctx in (
                        ("prefill B=2 T=200 after prefixes, ctx 300/457",
                         200, [300, 457]),
                        ("chunk B=1 T=256 at start 512", 256, [768])):
                    cases.append((f"page {pg} {label}", T, *_paged_state(
                        ctx, pg, Hkv, Dn, dtype, gen), ctx))
            for label, T, tb, kk, vv, ctx in cases:
                qq = _rand((len(ctx), T, Hq, Dn), dtype, gen)
                lens = i32(ctx)
                got = ragged_paged_attention_rect(qq, kk, vv, tb, lens)
                exact = paged_attention_plain(qq.float(), kk.float(),
                                              vv.float(), tb, lens)
                note("ragged_paged_attention", dn, check_b4(
                    f"ragged_paged_attention {dn} H{Hq}/{Hkv} D={Dn} "
                    f"{label}", got, exact,
                    lambda: paged_sdpa(qq, kk, vv, tb, lens),
                    tiles(dtype, Dn, group, kk.shape[2], [T])))
            del cases, slots
            for pg in (128, 16):
                packed_b4(f"H{Hq}/{Hkv} page {pg}", [37, 1, 130, 5, 1],
                          [37, 300, 1000, 521, 257], Hkv, Dn, pg, Hq=Hq)
            _free()
        # the staged body at its head dims: one row at gpt_2_7b's and
        # Phi-3-mini's 32 heads of 80 and 96 and Gemma-7B's 16 of 256, and
        # 5 and 8 rows at 80 and 96; the tensor-core prefill tiles on the
        # shared consumer at 80 and 96 (group 1) and 256 (groups 1, 4, 8)
        if dtype != torch.float32:
            for Dn, Hq in ((80, H), (96, H), (256, 16)):
                check_staged(Dn, Hq)
            for Dn, T in ((Dn, T) for Dn in HEAD_DIMS_80_96 for T in (5, 8)):
                check_staged(Dn, H, T)
            for Dn, Hq, Hkv in ((80, H, H), (96, H, H)) + tuple(
                    (256, hq, hkv) for hq, hkv in GEMMA_HEADS):
                check_prefill_walks(Dn, Hq, Hkv)
            _free()
    return errs


# B1/B2 cases: (label, B, S, H, Hkv, causal, softmax scale; None =
# 1/sqrt(D)) -- gpt_1b's training shape, GPT-Neo-1.3B's global layers
# (unscaled logits, S=2048), GQA, and a sequence length that does not tile
# the kernels' 64-row tiles
FLASH_CASES = [("path B=2 S=1024 H16/16", 2, 1024, 16, 16, True, None),
               ("gpt_neo_1_3b global B=2 S=2048 H16/16 scale 1", 2, 2048,
                16, 16, True, 1.0),
               ("GQA B=2 S=128 H32/8", 2, 128, 32, 8, True, None),
               ("non-tiling B=2 S=1000 H16/16", 2, 1000, 16, 16, True, None),
               ("non-tiling non-causal B=1 S=1000 H4/2", 1, 1000, 4, 2,
                False, None)]
# the same at head dim 64: gpt_350m's training shape (the CLI's default),
# GQA, gpt2_1_5b's 25 heads (B * H odd) over a length that does not
# tile, and for the persistent walks (pairs of 128-row tiles, head by
# head) an odd tile count over an odd B * H: 9 tiles, the last ragged, 5
# heads
FLASH_CASES_D64 = [("gpt_350m B=8 S=1024 H16/16", 8, 1024, 16, 16, True,
                    None),
                   ("GQA B=2 S=256 H16/4", 2, 256, 16, 4, True, None),
                   ("gpt2_1_5b heads non-tiling B=1 S=1000 H25/25", 1, 1000,
                    25, 25, True, None),
                   ("non-tiling non-causal B=1 S=1000 H4/2", 1, 1000, 4, 2,
                    False, None),
                   ("odd q tiles, odd B*H B=1 S=1100 H5/5", 1, 1100, 5, 5,
                    True, None)]
# the same at head dims 96 and 80: gpt_760m's and gpt_2_7b's training
# shapes (B=8, S=1024, 16 heads of 96, 32 of 80), GQA 32/8, a length that
# does not tile, non-causal, and for the persistent walks an odd tile
# count over an odd B * H
FLASH_CASES_D96 = [("gpt_760m B=8 S=1024 H16/16", 8, 1024, 16, 16, True,
                    None),
                   ("GQA B=2 S=256 H32/8", 2, 256, 32, 8, True, None),
                   ("non-tiling B=1 S=1000 H16/16", 1, 1000, 16, 16, True,
                    None),
                   ("non-tiling non-causal B=1 S=1000 H4/2", 1, 1000, 4, 2,
                    False, None),
                   ("odd q tiles, odd B*H B=1 S=1100 H5/5", 1, 1100, 5, 5,
                    True, None)]
FLASH_CASES_D80 = [("gpt_2_7b B=8 S=1024 H32/32", 8, 1024, 32, 32, True,
                    None)] + FLASH_CASES_D96[1:]
# and at head dim 256: Gemma-2B's training shape (B=2, S=2048, 8 heads of
# 256 over one kv head: MQA, a group of 8), the same heads without the
# group (MHA 8/8), MQA over a length that does not tile, non-causal GQA,
# and MQA at a group of 16 (dK/dV's cluster of 8 blocks, two query heads
# a block)
FLASH_CASES_D256 = [("gemma_2b B=2 S=2048 H8/1", 2, 2048, 8, 1, True, None),
                    ("MHA B=2 S=1024 H8/8", 2, 1024, 8, 8, True, None),
                    ("non-tiling MQA B=1 S=1000 H8/1", 1, 1000, 8, 1, True,
                     None),
                    ("non-tiling non-causal B=1 S=1000 H4/2", 1, 1000, 4, 2,
                     False, None),
                    ("MQA group 16 B=1 S=1024 H16/1", 1, 1024, 16, 1, True,
                     None)]
ADAM_N = 1_000_003
# the fused Adam kernel and its plain version round the same operations
# in the same order: they should agree to the last bit; allow 1e-6
ADAM_TOL = (1e-12, 1e-6)


def check_adam(label, got, want):
    """Max abs error of the fused Adam kernel's (p, m, v) against the
    plain version's; fails outside ADAM_TOL."""
    import torch
    atol, rtol = ADAM_TOL
    worst = 0.0
    for name, a, b in zip(("p", "m", "v"), got, want):
        err = (a - b).abs()
        bad = err > atol + rtol * b.abs()
        if not torch.isfinite(a).all() or bad.any():
            fail(f"{label} {name}: {int(bad.sum())} elements outside rtol "
                 f"{rtol}, max abs err {err.max().item():.3e}")
        worst = max(worst, err.max().item())
        del err, bad
    phase("kernels", f"{label}: max abs err {worst:.3e} (rtol {rtol})")
    return worst


# the delta kernel against its plain version (both fp32 sums of the same
# products, in another order): |kernel - plain| <= atol + rtol * sum_d
# |dO * O|, the scale of a reordered sum's rounding
DELTA_TOL = (1e-6, 1e-6)


def check_delta(name, got, out, dout):
    """The delta kernel's fp32 [B, H, S] ``got`` against its plain version
    on the same O and dO, within DELTA_TOL; returns the max abs error."""
    import torch
    from deepspeed_tpu_torch.ops.flash_attention import \
        flash_attention_bwd_delta_plain
    want = flash_attention_bwd_delta_plain(out, dout)
    if got.dtype != want.dtype or got.shape != want.shape or \
            not torch.isfinite(got).all():
        fail(f"{name}: {got.dtype} {tuple(got.shape)}, finite "
             f"{bool(torch.isfinite(got).all())}; want {want.dtype} "
             f"{tuple(want.shape)}")
    mag = (dout.float() * out.float()).abs().sum(-1).transpose(1, 2)
    err = (got - want).abs()
    atol, rtol = DELTA_TOL
    bad = int((err > atol + rtol * mag).sum())
    if bad:
        fail(f"{name}: {bad} elements outside atol {atol} + rtol {rtol} x "
             f"sum|dO O|, max abs err {err.max().item():.3e}")
    phase("kernels", f"{name}: max abs err {err.max().item():.3e} (atol "
          f"{atol} + rtol {rtol} x sum|dO O|)")
    return err.max().item()


def check_dkv_outputs(label, q, k, v, out, lse, dout, scale, causal=True):
    """Where the dK/dV kernel returns the function's outputs -- at group 1,
    and at every group where it sums the group on the card
    (``dkv_sums_group``: bf16 / fp16 at head dim 256) -- its wrapper returns
    dK and dV in k's dtype at k's shape, and ``flash_attention_bwd_cuda``
    returns those very tensors: no group sum and no cast runs after the
    kernel.  A second call on the same inputs gives the same bits (no
    atomics: the cluster sums in rank order)."""
    import torch
    from deepspeed_tpu_torch.ops.cuda import flash_attention as fa
    group = q.shape[2] // k.shape[2]
    if group != 1 and not fa.dkv_sums_group(q.shape[3], q.dtype):
        fail(f"{label}: the dK/dV kernel does not return k's dtype here")
    made = []
    dkv = fa.flash_attention_bwd_dkv_cuda

    def spy(*a, **kw):
        made.append(dkv(*a, **kw))
        return made[-1]

    spy.launches = 0
    fa.flash_attention_bwd_dkv_cuda = spy
    try:
        runs = [fa.flash_attention_bwd_cuda(q, k, v, out, lse, dout, scale,
                                            causal) for _ in range(2)]
    finally:
        fa.flash_attention_bwd_dkv_cuda = dkv
    (_, dk, dv), again = runs
    kdk, kdv = made[0]
    if (kdk.dtype, kdv.dtype) != (k.dtype, v.dtype) or \
            kdk.shape != k.shape or kdv.shape != v.shape:
        fail(f"{label}: the dK/dV kernel returned {kdk.dtype} "
             f"{tuple(kdk.shape)}, not k's {k.dtype} {tuple(k.shape)}")
    if dk is not kdk or dv is not kdv:
        fail(f"{label}: flash_attention_bwd_cuda did not return the dK/dV "
             f"kernel's own outputs (a sum or cast ran)")
    for name, a, b in zip(("dQ", "dK", "dV"), runs[0], again):
        if not torch.equal(a, b):
            fail(f"{label}: a second backward on the same inputs changed "
                 f"{name}")
    phase("kernels", f"{label}: dK, dV in {k.dtype} at {tuple(k.shape)} "
          f"from the kernel (group {group}), returned as they are; a "
          f"second call bit for bit")


def phase_train_kernels():
    """B1, B2 (dQ and dK/dV) and B3 vs their plain versions run in fp32
    on the kernels' own inputs: O and LSE of the forward; dQ, dK, dV of
    the backward from the kernel's own (O, LSE) and one dO (check_flash:
    bf16 and fp16 O, dQ, dK and dV also against SDPA's error); the delta
    kernel against its plain version on every case (check_delta), and at
    gpt_2_7b's shape and every head-dim-256 case in bf16 and fp16 dK/dV
    in k's dtype from the kernel, bit for bit again (check_dkv_outputs).
    B3 with its skip flag 0 against the plain version, and with the flag
    1: p, m, v and the count unchanged, bit for bit; B3's forms with bf16
    gradients or bf16 moments (:func:`check_adam_forms`)."""
    import torch
    from deepspeed_tpu_torch.ops.adam import (AdamState, adam_hyper,
                                              fused_adam, reference_impl)
    from deepspeed_tpu_torch.ops.cuda.flash_attention import (
        flash_attention_bwd_cuda, flash_attention_bwd_delta_cuda,
        flash_attention_fwd_cuda)
    gen = torch.Generator(device="cuda").manual_seed(4321)
    errs = {}

    def note(kernel, dn, e):
        errs[(kernel, dn)] = max(errs.get((kernel, dn), 0.0), e)

    for D, cases in ((128, FLASH_CASES), (64, FLASH_CASES_D64),
                     (96, FLASH_CASES_D96), (80, FLASH_CASES_D80),
                     (256, FLASH_CASES_D256)):
        for dtype in (torch.float32, torch.bfloat16, torch.float16):
            dn = str(dtype).split(".")[-1]
            for label, B, S, H, Hkv, causal, scale in cases:
                scale = scale or 1.0 / math.sqrt(D)
                q = _rand((B, S, H, D), dtype, gen)
                k = _rand((B, S, Hkv, D), dtype, gen)
                v = _rand((B, S, Hkv, D), dtype, gen)
                dout = _rand((B, S, H, D), dtype, gen)
                out, lse = flash_attention_fwd_cuda(q, k, v, scale, causal)
                got = flash_attention_bwd_cuda(q, k, v, out, lse, dout,
                                               scale, causal)
                check_flash(note, d_suffix(D), f"{dn} {label} D={D} "
                            f"causal={causal}", (q, k, v, dout), scale,
                            causal, {}, out, lse, got)
                note("flash_attention_bwd_delta", dn, check_delta(
                    f"flash_attention_bwd_delta {dn} {label} D={D}",
                    flash_attention_bwd_delta_cuda(out, dout), out, dout))
                if (D == 80 and dtype == torch.bfloat16 and H == Hkv and
                        label.startswith("gpt_2_7b")) or \
                        (D == 256 and dtype != torch.float32):
                    check_dkv_outputs(f"{dn} {label} D={D}", q, k, v, out,
                                      lse, dout, scale, causal)
                del q, k, v, dout, out, lse, got

    for g_dtype in (torch.float32, torch.bfloat16):
        for adamw in (True, False):
            for bc in (True, False):
                p = torch.randn(ADAM_N, generator=gen, device="cuda")
                g = torch.randn(ADAM_N, generator=gen,
                                device="cuda").to(g_dtype)
                m = torch.randn(ADAM_N, generator=gen, device="cuda") * 0.1
                v = torch.rand(ADAM_N, generator=gen, device="cuda") * 0.01
                kw = dict(weight_decay=0.01, adamw_mode=adamw)
                count = torch.full((), 2, dtype=torch.int32, device="cuda")
                hyper = adam_hyper(count, 1e-3, 0.9, 0.999, bc)
                ref = [t.clone() for t in (p, m, v)]
                fused_adam(p, g, AdamState(m, v, count.clone()), hyper,
                           backend="cuda", **kw)
                reference_impl(ref[0], g, AdamState(ref[1], ref[2],
                                                    count.clone()), hyper,
                               **kw)
                dn = str(g_dtype).split(".")[-1]
                note("fused_adam", dn, check_adam(
                    f"fused_adam n={ADAM_N} g={dn} adamw={adamw} "
                    f"bias_correction={bc}", (p, m, v), ref))
                if adamw and bc:
                    check_adam_skip(p, g, m, v, hyper, f"g={dn}")
    check_adam_forms(gen)
    return errs


# B3's forms (gradient dtype, moment dtype) beside the fp32 / fp32 one:
# bf16 gradients (data_types.grad_accum_dtype) and bf16 moments
# (moment_dtype, stored by stochastic rounding), each held bit for bit to
# its plain version over ADAM_FORM_STEPS consecutive steps at ADAM_N and
# at ADAM_N_TAIL (the kernel's blocks take 1024 elements: both leave a
# ragged last block)
ADAM_NEW_FORMS = (("bfloat16", "float32"), ("float32", "bfloat16"),
                  ("bfloat16", "bfloat16"))
ADAM_N_TAIL = 4099
ADAM_FORM_STEPS = 3
# stochastic rounding's mean over SR_COPIES copies of one fp32 value must
# lie within SR_SIGMAS standard errors of the value
SR_COPIES = 1 << 16
SR_SIGMAS = 5.0


def adam_form_name(g_dtype, m_dtype):
    """B3's kernels-JSON row of a form: ``fused_adam`` for fp32 / fp32."""
    if (g_dtype, m_dtype) == ("float32", "float32"):
        return "fused_adam"
    return (f"fused_adam_g_{'bf16' if g_dtype == 'bfloat16' else 'fp32'}"
            f"_m_{'bf16' if m_dtype == 'bfloat16' else 'fp32'}")


def check_adam_forms(gen):
    """B3's new forms against the plain version on the card: p, m and v
    bit for bit after each of ADAM_FORM_STEPS steps from one state, at
    ADAM_N and ADAM_N_TAIL; with the skip flag set (NaN gradients) nothing
    changes, kernel and plain (:func:`check_adam_skip`); and the bf16
    moments' stochastic rounding is unbiased (:func:`check_sr_unbiased`)."""
    import torch
    from deepspeed_tpu_torch.ops.adam import (AdamState, adam_hyper,
                                              fused_adam, reference_impl)
    kw = dict(weight_decay=0.01, adamw_mode=True)
    for g_name, m_name in ADAM_NEW_FORMS:
        g_dtype, m_dtype = getattr(torch, g_name), getattr(torch, m_name)
        label = adam_form_name(g_name, m_name)
        for n in (ADAM_N, ADAM_N_TAIL):
            p = torch.randn(n, generator=gen, device="cuda")
            m = (torch.randn(n, generator=gen, device="cuda") * 0.1).to(
                m_dtype)
            v = (torch.rand(n, generator=gen, device="cuda") * 0.01).to(
                m_dtype)
            count = torch.full((), 2, dtype=torch.int32, device="cuda")
            kern = AdamState(m, v, count)
            plain = AdamState(m.clone(), v.clone(), count.clone())
            pp = p.clone()
            for step in range(ADAM_FORM_STEPS):
                g = torch.randn(n, generator=gen, device="cuda").to(g_dtype)
                fused_adam(p, g, kern, adam_hyper(kern.count, 1e-3, 0.9,
                                                  0.999), backend="cuda",
                           **kw)
                reference_impl(pp, g, plain, adam_hyper(
                    plain.count, 1e-3, 0.9, 0.999), **kw)
                same = [torch.equal(a, b) for a, b in
                        ((p, pp), (kern.m, plain.m), (kern.v, plain.v),
                         (kern.count, plain.count))]
                if not all(same):
                    fail(f"{label} n={n} step {step + 1}: kernel and plain "
                         f"differ (p, m, v, count equal: {same})")
            if m.dtype != m_dtype or kern.m.dtype != m_dtype:
                fail(f"{label}: the moments left {m_name}")
            phase("kernels", f"{label} n={n}: p, m, v and the count bit for "
                  f"bit against the plain version after each of "
                  f"{ADAM_FORM_STEPS} steps")
            if n == ADAM_N:
                check_adam_skip(p, g, m, v, adam_hyper(
                    count, 1e-3, 0.9, 0.999), label)
    check_sr_unbiased()


def check_sr_unbiased(g0=1.2345678):
    """SR_COPIES copies of one gradient ``g0`` through B3 with bf16 moments
    from zero state: every element's fp32 m is fl(g0 (1 - beta1)) and its
    fp32 v fl(fl(g0 g0)(1 - beta2)), neither a bf16 value; the mean of the
    stochastically rounded m (and v) must lie within SR_SIGMAS standard
    errors of it -- a rounding to one of the two neighbours with the
    probability of its distance -- and equal the plain version's bits."""
    import torch
    from deepspeed_tpu_torch.ops.adam import (adam_hyper, fused_adam,
                                              init_state, reference_impl)
    n = SR_COPIES
    g = torch.full((n,), g0, device="cuda")
    outs = []
    for run in ("kernel", "plain"):
        p = torch.zeros(n, device="cuda")
        st = init_state(p, torch.bfloat16)
        hyper = adam_hyper(st.count, 1e-3, 0.9, 0.999)
        if run == "kernel":
            fused_adam(p, g, st, hyper, backend="cuda")
        else:
            reference_impl(p, g, st, hyper)
        outs.append(st)
    if not (torch.equal(outs[0].m, outs[1].m) and
            torch.equal(outs[0].v, outs[1].v)):
        fail("stochastic rounding: kernel and plain bits differ")
    omb1 = torch.tensor(1.0 - 0.9, dtype=torch.float32, device="cuda")
    omb2 = torch.tensor(1.0 - 0.999, dtype=torch.float32, device="cuda")
    g1 = g[:1]
    for name, exact, got in (("m", g1 * omb1, outs[0].m),
                             ("v", (g1 * g1) * omb2, outs[0].v)):
        x = exact.double().item()
        lo = (exact.view(torch.int32) & -65536).view(torch.float32)
        lo = lo.double().item()
        hi = float(torch.tensor(lo).to(torch.bfloat16).view(torch.int16)
                   .add(1).view(torch.bfloat16).float())
        frac = (x - lo) / (hi - lo)
        if not 0.0 < frac < 1.0:
            fail(f"stochastic rounding check: {name} = {x!r} is a bf16 value")
        sigma = (hi - lo) * math.sqrt(frac * (1.0 - frac) / n)
        mean = got.double().mean().item()
        if abs(mean - x) > SR_SIGMAS * sigma:
            fail(f"stochastic rounding of {name}: mean {mean!r} over {n} "
                 f"copies of {x!r}, {abs(mean - x) / sigma:.2f} standard "
                 f"errors off (limit {SR_SIGMAS})")
        phase("kernels", f"fused_adam bf16 {name}: mean of {n} stochastic "
              f"roundings of {x:.9g} is {mean:.9g} ({abs(mean - x) / sigma:.2f}"
              f" standard errors; {frac:.3f} of the way from {lo:.9g} to "
              f"{hi:.9g}), bits equal to the plain version's")


def check_adam_skip(p, g, m, v, hyper, label):
    """B3 with its skip flag set (an fp16 overflow): p, m, v and the count
    must come back bit for bit, the count too through the plain version;
    a NaN gradient, as an overflowed step has, must not leak in."""
    import torch
    from deepspeed_tpu_torch.ops.adam import (AdamState, fused_adam,
                                              reference_impl)
    skip = torch.ones((), dtype=torch.int32, device="cuda")
    bad = g.clone()
    bad[::7] = float("nan")
    for name, fn in (("kernel", lambda st: fused_adam(
            p, bad, st, hyper, skip, backend="cuda", weight_decay=0.01)),
                     ("plain", lambda st: reference_impl(
                         p, bad, st, hyper, skip, weight_decay=0.01))):
        before = [t.clone() for t in (p, m, v)]
        count = torch.full((), 5, dtype=torch.int32, device="cuda")
        fn(AdamState(m, v, count))
        if not all(torch.equal(a, b) for a, b in zip((p, m, v), before)) or \
                int(count) != 5:
            fail(f"fused_adam {label} skip=1 ({name}): p, m, v or the count "
                 f"changed")
    phase("kernels", f"fused_adam n={ADAM_N} {label} skip=1: p, m, v and "
          f"the count unchanged bit for bit (kernel and plain), NaN "
          f"gradients held out")


# biased B1/B2 cases: (label, B, S, H, Hkv, ALiBi, window, softmax scale;
# None = 1/sqrt(D)) -- BLOOM-1b7's and GPT-Neo-1.3B's local layers'
# training inputs (the latter unscaled), a window that is no multiple of
# the 64-row tile over a ragged last tile, ALiBi and a window with GQA (the
# slope is per QUERY head), and a window past S
BIASED_CASES = [("ALiBi B=2 S=2048 H16/16 (bloom_1b7)", 2, 2048, 16, 16,
                 True, None, None),
                ("window 256 scale 1 B=2 S=2048 H16/16 (gpt_neo_1_3b "
                 "local)", 2, 2048, 16, 16, False, 256, 1.0),
                ("window 100 B=2 S=1000 H16/16", 2, 1000, 16, 16, False,
                 100, None),
                ("ALiBi+window 200 GQA B=2 S=640 H32/8", 2, 640, 32, 8, True,
                 200, None),
                ("ALiBi+window 4096 >= S B=1 S=1000 H4/2", 1, 1000, 4, 2,
                 True, 4096, None)]
# the same at head dim 64: BLOOM-560m's training inputs (ALiBi, S=2048),
# GPT-Neo-125M's local layers' (12 heads, window 256, unscaled), a window
# over a ragged last tile, ALiBi and a window with GQA
BIASED_CASES_D64 = [("ALiBi B=2 S=2048 H16/16 (bloom_560m)", 2, 2048, 16, 16,
                     True, None, None),
                    ("window 256 scale 1 B=2 S=2048 H12/12 (gpt_neo_125m "
                     "local)", 2, 2048, 12, 12, False, 256, 1.0),
                    ("window 100 B=2 S=1000 H16/16", 2, 1000, 16, 16, False,
                     100, None),
                    ("ALiBi+window 200 GQA B=2 S=640 H16/4", 2, 640, 16, 4,
                     True, 200, None)]
# the same at head dims 96 and 80 (no model of the repo has ALiBi or
# windows at these head dims; the biased forms are held all the same):
# ALiBi at S=2048, window 256 at S=2048, a window over a ragged last tile,
# ALiBi and a window with GQA 32/8
BIASED_CASES_D80_96 = [("ALiBi B=2 S=2048 H16/16", 2, 2048, 16, 16, True,
                        None, None),
                       ("window 256 B=2 S=2048 H16/16", 2, 2048, 16, 16,
                        False, 256, None),
                       ("window 100 B=2 S=1000 H16/16", 2, 1000, 16, 16,
                        False, 100, None),
                       ("ALiBi+window 200 GQA B=2 S=640 H32/8", 2, 640, 32,
                        8, True, 200, None)]
# and at head dim 256, with Gemma-2B's heads, MQA (8/1) and MHA (8/8): no
# Gemma model has ALiBi or windows; the biased forms are held all the same
BIASED_CASES_D256 = [("ALiBi B=2 S=2048 H8/8", 2, 2048, 8, 8, True, None,
                      None),
                     ("window 256 B=2 S=2048 H8/1", 2, 2048, 8, 1, False,
                      256, None),
                     ("window 100 B=2 S=1000 H8/8", 2, 1000, 8, 8, False,
                      100, None),
                     ("ALiBi+window 200 MQA B=2 S=640 H8/1", 2, 640, 8, 1,
                      True, 200, None)]


def d_suffix(D):
    """The kernels-JSON suffix of a flash form's head dim: "" at 128, the
    head dim the flash rows were first measured at, else "_d<D>" ("_d64",
    "_d80", "_d96", "_d256")."""
    return "" if D == 128 else f"_d{D}"


def phase_biased_kernels():
    """Biased B1 and B2 (ALiBi slopes, sliding windows) vs their plain
    versions run in fp32 on the kernels' own inputs, fp32, bf16 and fp16
    (check_flash); at head dim 256 in bf16 and fp16 a second backward bit
    for bit."""
    import torch
    from deepspeed_tpu_torch.models.transformer import alibi_slopes
    from deepspeed_tpu_torch.ops.cuda.flash_attention import (
        flash_attention_bwd_cuda, flash_attention_fwd_biased_cuda)
    gen = torch.Generator(device="cuda").manual_seed(5678)
    errs = {}

    def note(kernel, dn, e):
        errs[(kernel, dn)] = max(errs.get((kernel, dn), 0.0), e)

    for D, cases in ((128, BIASED_CASES), (64, BIASED_CASES_D64),
                     (96, BIASED_CASES_D80_96), (80, BIASED_CASES_D80_96),
                     (256, BIASED_CASES_D256)):
        for dtype in (torch.float32, torch.bfloat16, torch.float16):
            dn = str(dtype).split(".")[-1]
            for label, B, S, H, Hkv, alibi, window, scale in cases:
                scale = scale or 1.0 / math.sqrt(D)
                bias = dict(alibi_slopes=alibi_slopes(H).cuda() if alibi
                            else None, window=window)
                q = _rand((B, S, H, D), dtype, gen)
                k = _rand((B, S, Hkv, D), dtype, gen)
                v = _rand((B, S, Hkv, D), dtype, gen)
                dout = _rand((B, S, H, D), dtype, gen)
                out, lse = flash_attention_fwd_biased_cuda(q, k, v, scale,
                                                           True, **bias)
                got = flash_attention_bwd_cuda(q, k, v, out, lse, dout,
                                               scale, True, **bias)
                check_flash(note, "_biased" + d_suffix(D), f"{dn} {label} "
                            f"D={D}", (q, k, v, dout), scale, True, bias,
                            out, lse, got)
                if D == 256 and dtype != torch.float32:
                    again = flash_attention_bwd_cuda(q, k, v, out, lse, dout,
                                                     scale, True, **bias)
                    for name, a, b in zip(("dQ", "dK", "dV"), got, again):
                        if not torch.equal(a, b):
                            fail(f"{dn} {label} D={D}: a second backward "
                                 f"on the same inputs changed {name}")
                    phase("kernels", f"{dn} {label} D={D}: a second "
                          f"backward bit for bit")
                    del again
                del q, k, v, dout, out, lse, got
    return errs


def check_flash(note, kind, label, inputs, scale, causal, bias, out, lse,
                got):
    """The flash kernels' (O, LSE) and (dQ, dK, dV) on ``inputs`` (q, k, v,
    dO) vs the plain versions run in fp32 on the kernels' own inputs, O and
    LSE.  fp32 and LSE: check_close.  bf16 and fp16 O, dQ, dK, dV (the
    tensor-core kernels): check_witnessed, against SDPA in their dtype on
    the same inputs and the exact fp32 answer.  ``kind``: the kernels'
    names' suffix: "" or "_biased", then "_d64" at head dim 64."""
    import torch
    from deepspeed_tpu_torch.ops.flash_attention import (
        flash_attention_bwd_plain, flash_attention_fwd_plain)
    q, k, v, dout = inputs
    dtype = q.dtype
    dn = str(dtype).split(".")[-1]
    f32 = [x.float() for x in inputs]
    want_o, want_lse = flash_attention_fwd_plain(*f32[:3], scale, causal,
                                                 **bias)
    want = flash_attention_bwd_plain(*f32[:3], out.float(), lse, f32[3],
                                     scale, causal, **bias)
    names = ("O", "dQ", "dK", "dV")
    kernels = [f"flash_attention_{n}{kind}" for n in
               ("fwd", "bwd_dq", "bwd_dkv", "bwd_dkv")]
    if dtype != torch.float32:
        exact = [want_o] + list(flash_attention_bwd_plain(
            *f32[:3], want_o, want_lse, f32[3], scale, causal, **bias))
        sdpa = sdpa_witness(q, k, v, dout, scale, causal, **bias)
    for i, (name, kernel, g, w) in enumerate(zip(
            names, kernels, (out,) + tuple(got), (want_o,) + tuple(want))):
        tag = f"{kernel} {label} {name}"
        if dtype != torch.float32:
            # bf16: the one-ulp reading against the plain version rounded
            # as the kernel rounds; fp16 holds the unrounded plain version
            # to the SDPA rule too
            want = w if dtype == torch.float16 else w.to(dtype)
            note(kernel, dn, check_witnessed(tag, g, want, exact[i],
                                             sdpa[i]))
        else:
            note(kernel, dn, check_close(tag, g, w.to(dtype)))
        if name == "O":
            note(kernel, dn, check_close(f"{kernel} {label} LSE", lse,
                                         want_lse))


def _sparsity_config(kind, H, block):
    """Sparsity configs of the B6 checks, as a user builds them: Fixed
    (unidirectional), BigBird and BSLongformer (bidirectional), Variable
    (unidirectional, random blocks)."""
    from deepspeed_tpu_torch.ops import sparse_attention as sa
    return {"fixed": lambda: sa.FixedSparsityConfig(
                H, block, attention="unidirectional"),
            "bigbird": lambda: sa.BigBirdSparsityConfig(H, block, seed=1),
            "longformer": lambda: sa.BSLongformerSparsityConfig(
                H, block, global_block_indices=[0, 5]),
            "variable": lambda: sa.VariableSparsityConfig(
                H, block, different_layout_per_head=True,
                num_random_blocks=1, attention="unidirectional",
                seed=2)}[kind]()


def _sparse_layout(kind, H, block, S):
    """(layout [H, S/block, S/block], causal) of a :func:`_sparsity_config`
    at length S."""
    cfg = _sparsity_config(kind, H, block)
    return cfg.make_layout(S), cfg.attention == "unidirectional"


# B6 cases: (layout kind, block, S); each at head dims 64 and 128.  S=1040
# leaves the bf16 kernel's last 64-row tile a quarter full
SPARSE_CASES = [("fixed", 16, 1024), ("longformer", 32, 1024),
                ("bigbird", 64, 1024), ("variable", 128, 1024),
                ("empty rows", 64, 512), ("fixed", 16, 1040)]


def phase_sparse_kernels():
    """B6 vs its plain version run in fp32 on the kernel's inputs: every
    layout block (16, 32, 64, 128), head dims 64 and 128, fp32 (the
    CUDA-core form), bf16 and fp16 (the tensor-core form, check_witnessed
    against SDPA in the same dtype with the expanded mask), causal and
    bidirectional layouts, and q blocks that see no key."""
    import numpy as np
    import torch
    from deepspeed_tpu_torch.ops.cuda.sparse_attention import \
        sparse_attention_cuda
    from deepspeed_tpu_torch.ops.sparse_attention import \
        sparse_attention_plain
    gen = torch.Generator(device="cuda").manual_seed(8765)
    B, H = 2, 16
    worst = {}
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        dn = str(dtype).split(".")[-1]
        for kind, block, S in SPARSE_CASES:
            if kind == "empty rows":
                nb = S // block
                layout = np.zeros((H, nb, nb), bool)
                layout[:, :, 0] = True
                layout[:, 2:5] = False            # q blocks 2-4 see nothing
                layout[3, 1, 1] = True
                causal = False
            else:
                layout, causal = _sparse_layout(kind, H, block, S)
            for D in (64, 128):
                q, k, v = (_rand((B, S, H, D), dtype, gen) for _ in range(3))
                with torch.no_grad():
                    got = sparse_attention_cuda(q, k, v, layout, block,
                                                causal=causal)
                    exact = sparse_attention_plain(
                        q.float(), k.float(), v.float(), layout, block,
                        causal=causal)
                if kind == "empty rows" and got[:, 2 * block:5 * block].abs(
                        ).max().item() != 0.0:
                    fail("sparse_attention: rows that see no key are not 0")
                e = check_output(
                    f"sparse_attention {dn} {kind} block {block} D={D} B={B} "
                    f"S={S} H={H} causal={causal}", got, exact,
                    lambda: sparse_sdpa(q, k, v, layout, block, causal),
                    tensor_cores=True)
                worst[("sparse_attention", dn)] = max(
                    worst.get(("sparse_attention", dn), 0.0), e)
    return worst


# the block-sparse entry point's calls, and B6's timing cases: (layout
# kind, block, head dim) at bf16 B=2 S=4096 16 heads -- Fixed (block 16,
# unidirectional) and BigBird (block 64, bidirectional), each at head dim
# 64 (the reference's BERT-style users) and 128 (BLOOM's width)
SPARSE_PATH = [("fixed", 16, 64), ("fixed", 16, 128), ("bigbird", 64, 64),
               ("bigbird", 64, 128)]
# the entry point's fp16 calls (a form the card once refused), and the fp16
# row's timing case (the first)
SPARSE_PATH_FP16 = [("fixed", 16, 64), ("bigbird", 64, 128)]
SPARSE_B, SPARSE_S, SPARSE_H = 2, 4096, 16


def phase_sparse_path():
    """The block-sparse entry point as a user calls it: one
    ``SparseSelfAttention(config)`` per SPARSE_PATH case, called under
    ``torch.no_grad()`` on bf16 [B, S, H, D] CUDA tensors, and per
    SPARSE_PATH_FP16 case on fp16 ones, counters read around the calls
    (each call launches the kernel once, no plain version runs).  Then each output is held against the plain version run in fp32
    on its inputs; a call with a ``key_padding_mask`` takes the dense path
    (the JAX package's rule) and launches nothing; and a call whose inputs
    need a gradient raises (the kernel is forward only)."""
    import torch
    from deepspeed_tpu_torch.ops.sparse_attention import (
        SparseSelfAttention, sparse_attention_plain)
    gen = torch.Generator(device="cuda").manual_seed(2468)
    B, S, H = SPARSE_B, SPARSE_S, SPARSE_H
    calls = []
    for dtype, cases in ((torch.bfloat16, SPARSE_PATH),
                         (torch.float16, SPARSE_PATH_FP16)):
        for kind, block, D in cases:
            attn = SparseSelfAttention(_sparsity_config(kind, H, block),
                                       max_seq_length=S)
            calls.append((f"{kind} block {block} D={D}", attn,
                          *(_rand((B, S, H, D), dtype, gen)
                            for _ in range(3))))
    reset_counters()
    torch.cuda.synchronize()
    t0 = time.time()
    with torch.no_grad():
        outs = [attn(q, k, v) for _, attn, q, k, v in calls]
    torch.cuda.synchronize()
    dt = time.time() - t0
    counts = read_counters()
    want = {k: 0 for k in counts if not k.endswith("_plain")}
    want["sparse_attention"] = len(calls)
    got = {k: counts[k] for k in want}
    if got != want or plain_calls(counts):
        fail(f"SparseSelfAttention: launches {got}, expected {want}; plain "
             f"versions {plain_calls(counts)}")
    errs = {torch.bfloat16: 0.0, torch.float16: 0.0}
    for (label, attn, q, k, v), out in zip(calls, outs):
        if tuple(out.shape) != (B, S, H, q.shape[-1]) or \
                out.dtype != q.dtype:
            fail(f"SparseSelfAttention {label}: output {out.dtype} "
                 f"{tuple(out.shape)}")
        causal = attn.sparsity_config.attention == "unidirectional"
        layout, block = attn.get_layout(S), attn.sparsity_config.block
        exact = sparse_attention_plain(q.float(), k.float(), v.float(),
                                       layout, block, causal=causal)
        errs[q.dtype] = max(errs[q.dtype], check_output(
            f"SparseSelfAttention {label} B={B} S={S} H={H} "
            f"{str(q.dtype).split('.')[-1]} causal={causal}", out, exact,
            lambda: sparse_sdpa(q, k, v, layout, block, causal),
            tensor_cores=True))
        del exact
    _, attn, q, k, v = calls[0]
    keep = torch.ones((B, S), dtype=torch.bool, device="cuda")
    keep[:, -attn.sparsity_config.block:] = False
    before = read_counters()
    with torch.no_grad():
        padded = attn(q, k, v, key_padding_mask=keep)
    after = read_counters()
    if after["sparse_attention"] != before["sparse_attention"] or \
            after["sparse_attention_plain"] != \
            before["sparse_attention_plain"] + 1 or \
            not torch.isfinite(padded).all():
        fail("SparseSelfAttention with a key_padding_mask did not take the "
             "dense path")
    try:
        attn(q.detach().requires_grad_(), k, v)
    except NotImplementedError:
        pass
    else:
        fail("SparseSelfAttention on inputs that need a gradient did not "
             "raise")
    del calls, outs, padded
    _free()
    return counts, dt, errs[torch.bfloat16], errs[torch.float16]


def _counted():
    """{counter name: (function, attribute)}: each kernel wrapper's
    ``launches`` and each plain version's ``calls``."""
    from deepspeed_tpu_torch.ops import adam, flash_attention
    from deepspeed_tpu_torch.ops.cuda import decode_attention as da
    from deepspeed_tpu_torch.ops.cuda import flash_attention as fa
    from deepspeed_tpu_torch.ops.cuda import fused_adam as fadam
    from deepspeed_tpu_torch.ops.cuda import ragged_paged_attention as rp
    from deepspeed_tpu_torch.ops.cuda import sparse_attention as spa
    from deepspeed_tpu_torch.ops.sparse_attention import \
        sparse_self_attention as ssa
    return {
        "decode_attention": (da.decode_attention_cuda, "launches"),
        "ragged_paged_attention": (rp.ragged_paged_attention_cuda,
                                   "launches"),
        "flash_attention_fwd": (fa.flash_attention_fwd_cuda, "launches"),
        "flash_attention_bwd_dq": (fa.flash_attention_bwd_dq_cuda,
                                   "launches"),
        "flash_attention_bwd_dkv": (fa.flash_attention_bwd_dkv_cuda,
                                    "launches"),
        "fused_adam": (fadam.fused_adam_cuda, "launches"),
        "flash_attention_fwd_biased": (fa.flash_attention_fwd_biased_cuda,
                                       "launches"),
        "flash_attention_bwd_dq_biased": (
            fa.flash_attention_bwd_dq_biased_cuda, "launches"),
        "flash_attention_bwd_dkv_biased": (
            fa.flash_attention_bwd_dkv_biased_cuda, "launches"),
        "flash_attention_bwd_delta": (fa.flash_attention_bwd_delta_cuda,
                                      "launches"),
        "sparse_attention": (spa.sparse_attention_cuda, "launches"),
        "decode_attention_plain": (da.decode_attention_plain, "calls"),
        "paged_attention_plain": (rp.paged_attention_plain, "calls"),
        "flash_attention_fwd_plain": (
            flash_attention.flash_attention_fwd_plain, "calls"),
        "flash_attention_bwd_plain": (
            flash_attention.flash_attention_bwd_plain, "calls"),
        "flash_attention_bwd_delta_plain": (
            flash_attention.flash_attention_bwd_delta_plain, "calls"),
        "fused_adam_plain": (adam.reference_impl, "calls"),
        "sparse_attention_plain": (ssa.sparse_attention_plain, "calls"),
    }


def reset_counters():
    for fn, attr in _counted().values():
        setattr(fn, attr, 0)


def read_counters():
    return {name: getattr(fn, attr)
            for name, (fn, attr) in _counted().items()}


def plain_calls(counts):
    return {k: v for k, v in counts.items() if k.endswith("_plain") and v}


def build_model(n_layers, seed, dtype=None, cfg=None):
    """Llama-2-7B (or ``cfg``) at ``n_layers`` layers, random weights from
    ``seed`` (drawn in fp32 and rounded to ``dtype``, bf16 by default: a
    seed gives the same weights in every dtype, up to rounding)."""
    import dataclasses
    import torch
    from deepspeed_tpu_torch.models.transformer import (CausalTransformerLM,
                                                        TransformerConfig)
    cfg = dataclasses.replace(cfg or TransformerConfig.llama2_7b(),
                              n_layers=n_layers)
    t0 = time.time()
    model = scale_embedding(CausalTransformerLM(
        cfg, device="cuda", dtype=dtype or torch.bfloat16).init(seed))
    torch.cuda.synchronize()
    return cfg, model, time.time() - t0


def scale_embedding(model):
    """``model`` with its token embedding at 1 / embed_scale of the seeded
    init when its config scales embeddings (Gemma), else as it is.  Random
    rows of norm ~1 times sqrt(d) would outweigh every layer's output in
    the residual, and the tied head would give the input token the top
    logit at every step -- greedy decoding would echo the last prompt
    token and every token check would pass vacuously; a training loss
    would say as little.  Rows of norm 1 / sqrt(d), scaled, carry the
    embedding other models start from."""
    import torch
    if model.config.embed_scale:
        with torch.no_grad():
            model.tok_embed.mul_(1.0 / model.config.embed_scale)
    return model


def phase_generate(model, cfg, B=4, S=128, new=32, dtype="bf16"):
    import numpy as np
    import torch
    import deepspeed_tpu_torch as dst
    eng = dst.init_inference(model, dtype=dtype)
    ids = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, S))
    torch.cuda.synchronize()
    t0 = time.time()
    out = eng.generate(ids, max_new_tokens=new)
    torch.cuda.synchronize()
    dt = time.time() - t0
    if tuple(out.shape) != (B, S + new):
        fail(f"generate returned shape {tuple(out.shape)}")
    if not ((out >= 0) & (out < cfg.vocab_size)).all():
        fail("generate returned out-of-vocab tokens")
    if not torch.equal(out[:, :S].cpu(), torch.as_tensor(ids)):
        fail("generate altered the prompt")
    return eng, ids, dt, out


def phase_generate_vs_plain(model, B=4, S=128, new=32):
    """Greedy tokens of ``init_inference(model).generate`` (the kernels)
    against the same loop through the plain versions
    (``apply_with_cache(..., attn_backend="plain")``); fails unless they
    are identical and each path ran only its own attention.  Returns
    (identical rows, B5 launches)."""
    import numpy as np
    import torch
    import deepspeed_tpu_torch as dst
    cfg = model.config
    ids = np.random.default_rng(4).integers(0, cfg.vocab_size, (B, S))
    reset_counters()
    got = dst.init_inference(model, dtype="fp32").generate(ids, new)
    k_counts = read_counters()
    reset_counters()
    with torch.no_grad():
        x = torch.as_tensor(ids, device="cuda")
        caches = model.init_caches(B, S + new, torch.float32)
        toks = []
        for _ in range(new):
            logits, caches = model.apply_with_cache(x, caches,
                                                    attn_backend="plain")
            x = logits[:, -1].argmax(-1)[:, None]
            toks.append(x)
        want = torch.cat([torch.as_tensor(ids, device="cuda")] + toks, 1)
    p_counts = read_counters()
    calls = cfg.n_layers * new
    if k_counts["decode_attention"] != calls or plain_calls(k_counts):
        fail(f"generate (kernels) launches {k_counts}, expected "
             f"decode_attention {calls} and no plain version")
    if p_counts["decode_attention_plain"] != calls or \
            p_counts["decode_attention"]:
        fail(f"generate (plain) counts {p_counts}, expected "
             f"decode_attention_plain {calls} and no kernel")
    same = int((got == want).all(-1).sum())
    if same != B:
        fail(f"generate through the kernels differs from the plain "
             f"versions in {B - same} of {B} rows (fp32)")
    return same, calls


def phase_serve(eng, cfg):
    import numpy as np
    import torch
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, (n,)).tolist()
               for n in SERVE_PROMPTS]
    se = eng.create_serving_engine(max_batch=SERVE_SLOTS,
                                   page_size=SERVE_PAGE,
                                   max_seq=SERVE_MAX_SEQ)
    se.margins = record_margins(se)
    torch.cuda.synchronize()
    t0 = time.time()
    outs = se.generate(prompts, max_new_tokens=SERVE_NEW)
    torch.cuda.synchronize()
    dt = time.time() - t0
    for p, o in zip(prompts, outs):
        if o[:len(p)] != p or len(o) != len(p) + SERVE_NEW:
            fail("serving output does not extend its prompt by 32 tokens")
        if not all(0 <= t < cfg.vocab_size for t in o):
            fail("serving returned out-of-vocab tokens")
    leaks = se.leak_report()
    if leaks:
        fail(f"leak_report() = {leaks}")
    if se.stats["finished"] != len(prompts):
        fail(f"{se.stats['finished']} of {len(prompts)} requests finished")
    return se, prompts, dt, outs


def phase_e2e(B=4, T=128, steps=4, cfg=None, seed=7):
    """2 layers at full width of Llama-2-7B (or ``cfg``): paged prefill +
    decode through the kernels and through the plain versions, from
    identical states."""
    import numpy as np
    import torch
    cfg, model, _ = build_model(2, seed=seed, cfg=cfg)
    page, P = 128, 1 + B * 2
    tables = torch.zeros((B, 3), dtype=torch.int32, device="cuda")
    tables[:, :2] = torch.arange(1, P, dtype=torch.int32,
                                 device="cuda").reshape(B, 2)
    rng = np.random.default_rng(2)
    ids = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, T)),
                          device="cuda")
    nxt = torch.as_tensor(rng.integers(0, cfg.vocab_size, (steps, B, 1)),
                          device="cuda")
    logits = {}
    for backend in ("cuda", "plain"):
        caches = model.init_paged_caches(P, page, dtype=torch.bfloat16)
        lengths = torch.zeros(B, dtype=torch.int32, device="cuda")
        outs = []
        lg, caches, lengths = model.apply_with_paged_cache(
            ids, caches, tables, lengths, attn_backend=backend)
        outs.append(lg)
        for s in range(steps):
            lg, caches, lengths = model.apply_with_paged_cache(
                nxt[s], caches, tables, lengths, attn_backend=backend)
            outs.append(lg)
        logits[backend] = torch.cat([o.reshape(-1, o.shape[-1])
                                     for o in outs])
    a, b = logits["cuda"], logits["plain"]
    if not torch.isfinite(a).all():
        fail("e2e: kernel logits not finite")
    rel = ((a - b).abs().max() / b.abs().max()).item()
    agree = (a.argmax(-1) == b.argmax(-1)).float().mean().item()
    if rel > E2E_REL_TOL:
        fail(f"e2e: kernel vs plain logits rel err {rel:.3e} > "
             f"{E2E_REL_TOL}")
    del model
    torch.cuda.empty_cache()
    return rel, agree


def _bound(bytes_moved, flops, dtype_name):
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype_name]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


# graph replays of a plain version's timing: it is the slow yardstick, so
# it takes fewer repeats than the kernels' 10
PLAIN_REPS = 3


def _measure(fns, copies):
    """Device time (CUDA-graph replay) of each fn(i), and the kernel's
    ("ms") eager time too."""
    out = {}
    for key, fn in fns.items():
        out[key] = graph_ms(fn, copies,
                            reps=PLAIN_REPS if key == "plain_ms" else 10)
    out["ms_eager"] = time_ms(fns["ms"])
    return out


def phase_timing(cfg, serve_prompts):
    """Each kernel at the main path's decode shapes (bf16), B5 again at
    Llama-2's whole context (len 4096), and B4's prefill tiles at the serve
    run's buckets 512 and 1024: kernel, plain version and library time,
    plus the bound and the kernel's share of it.  Buffers rotate over more
    than the 50 MB L2 so each call reads its cache cold, as a layer of the
    decode loop does."""
    import torch
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops.cuda.decode_attention import (
        decode_attention_cuda, decode_attention_plain)
    from deepspeed_tpu_torch.ops.cuda.flash_attention import \
        flash_attention_fwd_cuda
    from deepspeed_tpu_torch.ops.cuda.ragged_paged_attention import (
        paged_attention_plain, ragged_paged_attention_rect)
    gen = torch.Generator(device="cuda").manual_seed(99)
    dt = torch.bfloat16
    H, Hkv, D = cfg.n_heads, cfg.kv_heads, cfg.head_dim
    item = 2
    res = {}

    # B5: generate's decode step -- B=4, cache 128+32, mid-run length 144
    B, S, L = 4, 160, 144
    copies = 12
    q = _rand((copies, B, 1, H, D), dt, gen)
    k = _rand((copies, B, Hkv, S, D), dt, gen)
    v = _rand((copies, B, Hkv, S, D), dt, gen)
    err = check_close(
        "timing decode_attention", decode_attention_cuda(q[0], k[0], v[0], L),
        reference(decode_attention_plain, q[0], k[0], v[0], L))
    qs = q.transpose(2, 3).contiguous()        # [c, B, H, 1, D]
    times = _measure({
        "ms": lambda i: decode_attention_cuda(q[i % copies], k[i % copies],
                                              v[i % copies], L),
        "plain_ms": lambda i: decode_attention_plain(
            q[i % copies], k[i % copies], v[i % copies], L),
        "library_ms": lambda i: F.scaled_dot_product_attention(
            qs[i % copies], k[i % copies][:, :, :L],
            v[i % copies][:, :, :L])}, copies)
    nbytes = B * (2 * Hkv * L * D + 2 * H * D) * item
    flops = B * 4 * H * D * L
    bound_ms, bound_by = _bound(nbytes, flops, "bfloat16")
    res["decode_attention"] = dict(
        max_abs_err=err, **times, bound_ms=bound_ms, bound_by=bound_by,
        shape=f"B={B} T=1 H={H} Hkv={Hkv} D={D} len={L} S_max={S} bf16")
    del q, k, v, qs

    # B5 at Llama-2's whole context: B=4, len 4096 (268 MB of K/V, two
    # copies: each call reads its cache cold)
    B, S, L = 4, 4096, 4096
    copies = 2
    q = _rand((copies, B, 1, H, D), dt, gen)
    k = _rand((copies, B, Hkv, S, D), dt, gen)
    v = _rand((copies, B, Hkv, S, D), dt, gen)
    err = check_close(
        "timing decode_attention len 4096",
        decode_attention_cuda(q[0], k[0], v[0], L),
        reference(decode_attention_plain, q[0], k[0], v[0], L))
    qs = q.transpose(2, 3).contiguous()
    times = _measure({
        "ms": lambda i: decode_attention_cuda(q[i % copies], k[i % copies],
                                              v[i % copies], L),
        "plain_ms": lambda i: decode_attention_plain(
            q[i % copies], k[i % copies], v[i % copies], L),
        "library_ms": lambda i: F.scaled_dot_product_attention(
            qs[i % copies], k[i % copies], v[i % copies])}, copies)
    nbytes = B * (2 * Hkv * L * D + 2 * H * D) * item
    bound_ms, bound_by = _bound(nbytes, B * 4 * H * D * L, "bfloat16")
    res["decode_attention_4096"] = dict(
        max_abs_err=err, **times, bound_ms=bound_ms, bound_by=bound_by,
        shape=f"B={B} T=1 H={H} Hkv={Hkv} D={D} len={L} S_max={S} bf16")
    del q, k, v, qs
    _free()

    # B4: the serving decode step -- 8 slots of the serve run's first 8
    # prompts, 16 tokens into their 32, T=1, page 128
    page = SERVE_PAGE
    ctx = [p + 16 for p in serve_prompts]
    B = len(ctx)
    copies = 4
    states = [_engine_state([p + SERVE_NEW for p in serve_prompts], Hkv, D,
                            dt, gen) for _ in range(copies)]
    tables = states[0][0]
    lens = torch.tensor(ctx, dtype=torch.int32, device="cuda")
    q = _rand((copies, B, 1, H, D), dt, gen)
    err = check_close(
        "timing ragged_paged_attention",
        ragged_paged_attention_rect(q[0], states[0][1], states[0][2], tables,
                                    lens),
        reference(paged_attention_plain, q[0], states[0][1], states[0][2],
                  tables, lens))
    # library yardstick: SDPA over the gathered dense K/V with a mask
    Smax = tables.shape[1] * page
    dense = []
    for tb, kp, vp in states:
        t = tb.long()
        dense.append((kp[t].transpose(1, 2).reshape(B, Hkv, Smax, D),
                      vp[t].transpose(1, 2).reshape(B, Hkv, Smax, D)))
    mask = (torch.arange(Smax, device="cuda")[None, :] <
            lens[:, None].long())[:, None, None, :]
    qs = q.transpose(2, 3).contiguous()
    times = _measure({
        "ms": lambda i: ragged_paged_attention_rect(
            q[i % copies], states[i % copies][1], states[i % copies][2],
            states[i % copies][0], lens),
        "plain_ms": lambda i: paged_attention_plain(
            q[i % copies], states[i % copies][1], states[i % copies][2],
            states[i % copies][0], lens),
        "library_ms": lambda i: F.scaled_dot_product_attention(
            qs[i % copies], dense[i % copies][0], dense[i % copies][1],
            attn_mask=mask)}, copies)
    nbytes = sum(2 * Hkv * c * D + 2 * H * D for c in ctx) * item
    flops = sum(4 * H * D * c for c in ctx)
    bound_ms, bound_by = _bound(nbytes, flops, "bfloat16")
    res["ragged_paged_attention"] = dict(
        max_abs_err=err, **times, bound_ms=bound_ms, bound_by=bound_by,
        shape=f"B={B} T=1 H={H} Hkv={Hkv} D={D} page={page} "
              f"ctx={ctx} bf16")
    del states, dense, q, qs
    _free()

    # B4 prefill tiles: the serve run's bucketed prefills at 512 (its 511-
    # token prompt) and 1024 (600), one prompt a call, length = bucket;
    # the library yardstick is SDPA causal over the dense K/V
    for prompt in (511, 600):
        bucket, need = _prefill_need(prompt)
        copies = 4
        states = [_engine_state([need], Hkv, D, dt, gen)
                  for _ in range(copies)]
        lens = torch.tensor([bucket], dtype=torch.int32, device="cuda")
        q = _rand((copies, 1, bucket, H, D), dt, gen)
        tb, kp, vp = states[0]
        exact = paged_attention_plain(q[0].float(), kp.float(), vp.float(),
                                      tb, lens)
        err = check_output(
            f"timing ragged_paged_attention prefill T={bucket}",
            ragged_paged_attention_rect(q[0], kp, vp, tb, lens), exact,
            lambda: paged_sdpa(q[0], kp, vp, tb, lens))
        del exact
        dense = []
        for tb, kp, vp in states:
            t = tb.long()
            dense.append(tuple(
                x[t].transpose(1, 2).reshape(1, Hkv, -1, D)[:, :, :bucket]
                .contiguous() for x in (kp, vp)))
        qs = q.transpose(2, 3).contiguous()        # [c, 1, H, T, D]
        times = _measure({
            "ms": lambda i: ragged_paged_attention_rect(
                q[i % copies], *states[i % copies][1:], states[i % copies][0],
                lens),
            "plain_ms": lambda i: paged_attention_plain(
                q[i % copies], *states[i % copies][1:], states[i % copies][0],
                lens),
            "library_ms": lambda i: F.scaled_dot_product_attention(
                qs[i % copies], *dense[i % copies], is_causal=True,
                enable_gqa=Hkv != H)}, copies)
        # B1's forward on the same work: the same q and the dense K/V
        kb1 = [tuple(x.transpose(1, 2).contiguous() for x in kv)
               for kv in dense]
        b1_ms = graph_ms(lambda i: flash_attention_fwd_cuda(
            q[i], kb1[i][0], kb1[i][1], 1.0 / math.sqrt(D)), copies)
        pairs = bucket * (bucket + 1) // 2
        nbytes = (2 * bucket * H * D + 2 * Hkv * bucket * D) * item
        bound_ms, bound_by = _bound(nbytes, 4 * H * D * pairs, "bfloat16")
        res[f"ragged_paged_attention_prefill_{bucket}"] = dict(
            max_abs_err=err, **times, bound_ms=bound_ms, bound_by=bound_by,
            b1_ms=b1_ms,
            shape=f"prefill B=1 T={bucket} H={H} Hkv={Hkv} D={D} "
                  f"page={page} len={bucket} causal bf16")
        phase("timing", f"ragged_paged_attention prefill T={bucket}: "
              f"{times['ms']:.4f} ms, B1's forward on the same work "
              f"{b1_ms:.4f} ms: {times['ms'] / b1_ms:.2f}x")
        del states, dense, q, qs, kb1
        _free()
    for name, r in res.items():
        phase("timing", f"{name} [{r['shape']}]: device ms (graph replay) "
              f"kernel {r['ms']:.4f}, plain {r['plain_ms']:.4f}, library "
              f"{r['library_ms']:.4f}; eager ms per call (host included) "
              f"kernel {r['ms_eager']:.4f}; bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}), "
              f"{r['bound_ms'] / r['ms']:.3f} of bound, max abs err "
              f"{r['max_abs_err']:.3e}")
    return res


def _time_decode(name, dtype, B, S, L, copies, gen, H=32, Hkv=32, D=128,
                 T=1):
    """B5 at [B, T], one int length L over S_max S (T > 1: the prefill
    form, the last T of the L tokens the queries, SDPA under the causal
    mask): kernel, plain and SDPA device times, bound and error (a
    phase_timing row)."""
    import torch
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops.cuda.decode_attention import (
        decode_attention_cuda, decode_attention_plain)
    dn = str(dtype).split(".")[-1]
    q = _rand((copies, B, T, H, D), dtype, gen)
    k = _rand((copies, B, Hkv, S, D), dtype, gen)
    v = _rand((copies, B, Hkv, S, D), dtype, gen)
    err = check_close(f"timing {name}",
                      decode_attention_cuda(q[0], k[0], v[0], L),
                      reference(decode_attention_plain, q[0], k[0], v[0], L))
    qs = q.transpose(2, 3).contiguous()
    # query t sees keys up to L - T + t (None at T = 1: every key)
    mask = None if T == 1 else (
        torch.arange(L, device="cuda")[None] <=
        (L - T + torch.arange(T, device="cuda"))[:, None])
    times = _measure({
        "ms": lambda i: decode_attention_cuda(q[i % copies], k[i % copies],
                                              v[i % copies], L),
        "plain_ms": lambda i: decode_attention_plain(
            q[i % copies], k[i % copies], v[i % copies], L),
        "library_ms": lambda i: F.scaled_dot_product_attention(
            qs[i % copies], k[i % copies][:, :, :L],
            v[i % copies][:, :, :L], attn_mask=mask,
            enable_gqa=Hkv != H)}, copies)
    bound_ms, bound_by = _bound(*decode_work(B, H, Hkv, L, D,
                                             q.element_size(), T), dn)
    return dict(max_abs_err=err, **times, bound_ms=bound_ms,
                bound_by=bound_by,
                shape=f"B={B} T={T} H={H} Hkv={Hkv} D={D} len={L} "
                      f"S_max={S} {dn}")


def _time_paged(name, dtype, needs, ctx, T, Hkv, D, copies, gen, H=32,
                max_seq=SERVE_MAX_SEQ):
    """B4's rect front-end at [len(ctx), T] over the serve run's page pools
    (slot s reserves needs[s] tokens, holds ctx[s] with its last T the
    queries; ``max_seq``: the engine's): kernel, plain and SDPA device
    times (SDPA over the gathered dense K/V with the causal-ragged mask),
    bound and error."""
    import torch
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops.cuda.decode_attention import DECODE_ROWS
    from deepspeed_tpu_torch.ops.cuda.ragged_paged_attention import (
        paged_attention_plain, ragged_paged_attention_rect,
        tensor_core_prefill)
    dn = str(dtype).split(".")[-1]
    B, group = len(ctx), H // Hkv
    states = [_engine_state(needs, Hkv, D, dtype, gen, max_seq)
              for _ in range(copies)]
    lens = torch.tensor(ctx, dtype=torch.int32, device="cuda")
    q = _rand((copies, B, T, H, D), dtype, gen)
    tb, kp, vp = states[0]
    exact = paged_attention_plain(q[0].float(), kp.float(), vp.float(), tb,
                                  lens)
    tc = tensor_core_prefill(dtype, D, group, SERVE_PAGE) and \
        T * group > DECODE_ROWS
    got = ragged_paged_attention_rect(q[0], kp, vp, tb, lens)
    err = check_output(f"timing {name}", got, exact,
                       lambda: paged_sdpa(q[0], kp, vp, tb, lens), tc) \
        if tc else check_close(f"timing {name}", got, exact.to(dtype))
    del exact
    Smax = tb.shape[1] * SERVE_PAGE
    dense = []
    for t, kx, vx in states:
        dense.append(tuple(x[t.long()].transpose(1, 2).reshape(
            B, Hkv, Smax, D) for x in (kx, vx)))
    qpos = lens.long()[:, None] - T + torch.arange(T, device="cuda")
    mask = (torch.arange(Smax, device="cuda")[None, None] <=
            qpos[:, :, None])[:, None]                  # [B, 1, T, Smax]
    qs = q.transpose(2, 3).contiguous()                 # [c, B, H, T, D]
    times = _measure({
        "ms": lambda i: ragged_paged_attention_rect(
            q[i % copies], states[i % copies][1], states[i % copies][2],
            states[i % copies][0], lens),
        "plain_ms": lambda i: paged_attention_plain(
            q[i % copies], states[i % copies][1], states[i % copies][2],
            states[i % copies][0], lens),
        "library_ms": lambda i: F.scaled_dot_product_attention(
            qs[i % copies], *dense[i % copies], attn_mask=mask,
            enable_gqa=Hkv != H)}, copies)
    bound_ms, bound_by = _bound(*paged_work(ctx, T, H, Hkv, D,
                                            q.element_size()), dn)
    return dict(max_abs_err=err, **times, bound_ms=bound_ms,
                bound_by=bound_by,
                shape=f"B={B} T={T} H={H} Hkv={Hkv} D={D} page={SERVE_PAGE}"
                      f" ctx={ctx} {dn}")


def phase_timing_serving():
    """This slice's forms and PR 8's at the shapes their main paths give
    them: B5 and B4 in fp16 (generate's decode step, the serve run's
    decode step and its 512 / 1024 prefills), and, in bf16, the
    speculative verify window [8, 5] and the TinyLlama draft's decode step
    (group 8, head dim 64: both decode rows), B5 at head dim 64 (the
    TinyLlama-shaped generate's decode step), a 256-token chunk at start
    512 at head dims 128 and 64, and, off the main paths, Llama-2-70B's
    attention shape (64 / 8 heads of 128: group 8) in B4's 8-slot decode
    step and B5's generate step."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(98)
    fp16, bf16 = torch.float16, torch.bfloat16
    prompts = SERVE_PROMPTS[:SERVE_SLOTS]
    needs = [p + SERVE_NEW for p in prompts]
    d_kv = DRAFT_SHAPE["n_kv_heads"]
    d_dim = DRAFT_SHAPE["hidden_size"] // DRAFT_SHAPE["n_heads"]
    rows = {"decode_attention_fp16": _time_decode(
        "decode_attention fp16", fp16, 4, 160, 144, 12, gen)}
    rows["ragged_paged_attention_fp16"] = _time_paged(
        "ragged_paged_attention fp16 decode", fp16, needs,
        [p + 16 for p in prompts], 1, 32, 128, 4, gen)
    _free()
    for prompt in (511, 600):
        bucket, need = _prefill_need(prompt)
        rows[f"ragged_paged_attention_prefill_{bucket}_fp16"] = _time_paged(
            f"ragged_paged_attention fp16 prefill T={bucket}", fp16, [need],
            [bucket], bucket, 32, 128, 4, gen)
        _free()
    rows["ragged_paged_attention_verify"] = _time_paged(
        "ragged_paged_attention verify window [8, 5]", bf16, needs,
        [p + 9 for p in prompts], SPEC_GAMMA + 1, 32, 128, 4, gen)
    rows["ragged_paged_attention_draft_gqa8"] = _time_paged(
        "ragged_paged_attention TinyLlama decode step (group 8, D=64)", bf16,
        needs, [p + 16 for p in prompts], 1, d_kv, d_dim, 4, gen)
    rows["decode_attention_d64"] = _time_decode(
        "decode_attention TinyLlama generate step (group 8, D=64)", bf16, 4,
        160, 144, 12, gen, Hkv=d_kv, D=d_dim)
    rows["ragged_paged_attention_chunk_at_offset"] = _time_paged(
        "ragged_paged_attention chunk T=256 at start 512", bf16,
        [1024 + SERVE_NEW], [768], CHUNK_TOKENS, 32, 128, 4, gen)
    rows["ragged_paged_attention_draft_chunk_at_offset"] = _time_paged(
        "ragged_paged_attention TinyLlama chunk T=256 at start 512 (D=64)",
        bf16, [1024 + SERVE_NEW], [768], CHUNK_TOKENS, d_kv, d_dim, 4, gen)
    _free()
    # off the main paths: Llama-2-70B's 64 / 8 heads of 128
    rows["ragged_paged_attention_gqa8_d128"] = _time_paged(
        "ragged_paged_attention Llama-2-70B-shaped decode step (group 8, "
        "D=128)", bf16, needs, [p + 16 for p in prompts], 1, 8, 128, 4, gen,
        H=64)
    rows["decode_attention_gqa8_d128"] = _time_decode(
        "decode_attention Llama-2-70B-shaped generate step (group 8, "
        "D=128)", bf16, 4, 160, 144, 12, gen, H=64, Hkv=8)
    _free()
    for name, r in rows.items():
        phase("timing", f"{name} [{r['shape']}]: device ms (graph replay) "
              f"kernel {r['ms']:.4f}, plain {r['plain_ms']:.4f}, SDPA "
              f"{r['library_ms']:.4f}; eager ms per call (host included) "
              f"kernel {r['ms_eager']:.4f}; bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}), {r['bound_ms'] / r['ms']:.3f} of bound, "
              f"max abs err {r['max_abs_err']:.3e}")
    return rows


def profile_device(fn, reps):
    """Device time of ``reps`` calls of fn() by kernel (torch.profiler):
    returns (device ms per call, top kernels [(name, ms per call)], every
    kernel {name: ms per call})."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    per_kernel = {}
    for ev in prof.key_averages():
        # device-side kernel entries only: a CPU op (aten::mm) also
        # reports the device time of the kernels it launched
        if not str(getattr(ev, "device_type", "")).endswith("CUDA"):
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0)
        if us:
            per_kernel[ev.key] = per_kernel.get(ev.key, 0.0) + \
                us / 1e3 / reps
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:8]
    return sum(per_kernel.values()), top, per_kernel


def decode_step_ms(eng, cfg, steps=16, profiled=4):
    """Wall ms of a pure decode step with all 8 serving slots busy, then
    the device time of ``profiled`` more steps by kernel (torch.profiler):
    returns (step ms, device ms per step, top kernels [(name, ms/step)],
    B4's device ms per step: its decode kernels and their combine)."""
    import numpy as np
    import torch
    se = eng.create_serving_engine(max_batch=8, page_size=128, max_seq=2048)
    rng = np.random.default_rng(3)
    for i in range(8):
        se.add_request(i, rng.integers(0, cfg.vocab_size, (128,)).tolist(),
                       max_new_tokens=steps + profiled + 4)
    se.step()
    torch.cuda.synchronize()
    t0 = time.time()
    for _ in range(steps):
        se.step()
    torch.cuda.synchronize()
    ms = (time.time() - t0) * 1e3 / steps
    device_ms, top, per_kernel = profile_device(se.step, profiled)
    b4_ms = sum(v for k, v in per_kernel.items() if "PagedSeqs" in k or
                "ragged_" in k)
    del se
    torch.cuda.empty_cache()
    return ms, device_ms, top, b4_ms


# ----------------------------------------------------------------------
# serving as users configure it (phase serve-features, and its fp32
# 2-layer twin in phase e2e): the prefix cache, the chunked scheduler
# with SLO classes, speculative decoding with a draft model, and
# decode_chunk > 1, each through create_serving_engine at the serve run's
# geometry (8 slots, page 128, max_seq 2048)

# The divergence rule.  A feature run reaches the same token positions
# through other kernel forms and GEMM shapes than the baseline monolithic
# run (a suffix prefill at an offset, 256-token chunks, the [8, 5] verify
# window on prefill tiles, fp16 against bf16), so its logits differ from
# the baseline's by rounding, and a greedy token may flip where the
# baseline's top-2 margin is small.  The 2-layer kernel-vs-plain e2e run
# measures a bf16 logit gap of 1.3e-2 of max|logit| (about 3 ulps of
# 2**-8, on an H100 at 700 W); at 4 ulps for 2 layers, growing as a random
# walk, 32 layers give 4 * sqrt(16) = 16 ulps, and a flip needs the two
# top logits to move apart by twice that.  So the first divergence of a
# request must sit where the baseline's top-2 margin is under
# DIVERGENCE_ULPS ulps of the coarser dtype of the two runs times the
# position's max|logit|.  fp32 runs (2 layers) must match exactly.
UNIT_ROUNDOFF = {"bfloat16": 2.0 ** -8, "float16": 2.0 ** -11,
                 "float32": 2.0 ** -24}
DIVERGENCE_ULPS = 32
# TinyLlama/TinyLlama-1.1B-intermediate-step-1431k-3T config.json:
# hidden_size 2048, num_hidden_layers 22, num_attention_heads 32,
# num_key_value_heads 4, intermediate_size 5632, vocab_size 32000,
# RMSNorm eps 1e-5, rope_theta 10000 -- head dim 64, GQA group 8
DRAFT_SHAPE = dict(vocab_size=32000, hidden_size=2048, n_layers=22,
                   n_heads=32, n_kv_heads=4, ffn_hidden_size=5632,
                   max_seq_len=2048, rope_theta=10000.0, norm_eps=1e-5)
SPEC_GAMMA = 4
# serve-features' depth (target, draft), cut so that the whole smoke stays
# under 900 s (a run of the uncut phases read 919.4 s; with Gemma-2B
# training added, 881.3 s): the gpt_2_7b run at a quarter of its 32
# layers with gpt_350m's 24 at a quarter; since PR 25 (the smoke passed
# its 1200 s on a slow host with the offload phase added) the Llama-2-7B
# run at a quarter of its 32 with TinyLlama's 22 at about a quarter, the
# Gemma-7B run at a quarter of its 28 with Gemma-2B's 18 at about a
# quarter (before: half each).  Every form each run drives still runs.
FEATURES_LAYERS_LLAMA = (8, 6)
FEATURES_LAYERS_D80 = (8, 6)
FEATURES_LAYERS_GEMMA = (7, 5)
CHUNK_TOKENS = 256
DECODE_CHUNK = 4
PREFIX_TOKENS = 1024          # the shared system prefix of run (a)
PREFIX_SUFFIXES = [16, 400, 37, 250, 128, 311, 64, 300, 90, 350, 200, 23]
LONG_PROMPT = 1800            # run (b)'s long prompt


def divergence_limit(dtype_name, max_abs_logit):
    """The largest top-2 margin at which a greedy token may flip between
    two runs of ``dtype_name`` (the coarser dtype of the two)."""
    return DIVERGENCE_ULPS * UNIT_ROUNDOFF[dtype_name] * max_abs_logit


def record_margins(se):
    """Wraps ``se._sample`` (the host sampler every monolithic prefill and
    decode step calls) to record, per (request id, generated index), the
    baseline's top-2 logit margin and max|logit|; fails on a non-finite
    logit.  Returns the dict it fills."""
    import numpy as np
    margins = {}
    real = se._sample

    def sample(req, logits):
        if not np.isfinite(logits).all():
            fail(f"request {req.req_id!r}: non-finite logits at generated "
                 f"index {len(req.out)}")
        top2 = np.partition(logits, -2)[-2:]
        margins[(req.req_id, len(req.out))] = (
            float(top2[1] - top2[0]), float(np.abs(logits).max()))
        return real(req, logits)

    se._sample = sample
    return margins


def first_divergence(base, got, n_prompt):
    """Generated index of the first token where ``got`` leaves ``base``
    (None when they agree)."""
    for i, (a, b) in enumerate(zip(base[n_prompt:], got[n_prompt:])):
        if a != b:
            return i
    if len(base) != len(got):
        return min(len(base), len(got)) - n_prompt
    return None


def divergences(base_outs, outs, prompts, margins, dtype_name):
    """(identical requests, [(request, index, margin, limit)] of every
    first divergence) of ``outs`` against the baseline's ``base_outs``,
    with the baseline's ``margins`` (``record_margins``)."""
    same, rows = 0, []
    for rid, (b, g, p) in enumerate(zip(base_outs, outs, prompts)):
        i = first_divergence(b, g, len(p))
        if i is None:
            same += 1
            continue
        margin, top = margins.get((rid, i), (float("inf"), 0.0))
        rows.append((rid, i, margin, divergence_limit(dtype_name, top)))
    return same, rows


def check_divergence(label, base_outs, outs, prompts, margins, dtype_name):
    """Fails unless every request matches the baseline or first leaves it
    at a near-tie of the baseline (:func:`divergences`); prints each
    divergence's margin and limit and the count of identical requests."""
    same, rows = divergences(base_outs, outs, prompts, margins, dtype_name)
    phase("serve-features", f"{label}: {same} of {len(outs)} requests "
          f"identical to the baseline; first divergences (request, index, "
          f"margin, limit): {[(r, i, f'{m:.4g}', f'{l:.4g}') for r, i, m, l in rows]}")
    bad = [r for r in rows if not r[2] < r[3]]
    if bad:
        fail(f"{label}: tokens leave the baseline where its top-2 margin is "
             f"at or over the {dtype_name} limit ({DIVERGENCE_ULPS} ulps x "
             f"max|logit|): {bad}")
    return same, rows


def prefill_chunks(prompt_lens, chunk, cached=None):
    """Prefill-chunk dispatches of the chunked scheduler: each prompt's
    uncached suffix in ``chunk``-token pieces."""
    cached = cached or [0] * len(prompt_lens)
    return sum(-(-(p - c) // chunk) for p, c in zip(prompt_lens, cached))


def expected_b4_launches(n_layers, stats, n_prefills=0, decode_chunk=1,
                         draft_layers=0, gamma=0, draft_chunks=0):
    """(B4 launches, target model calls, draft model calls) of a serve run
    from its dispatch shapes: the target's model calls are one monolithic
    prefill per request (``n_prefills``) or the scheduler's prefill chunks
    (``stats["prefill_chunks"]``), plus ``decode_chunk`` calls per decode
    dispatch (a verify window is one); the draft's are its own prefill
    chunks plus gamma + 1 single-token decodes per verify window.  Every
    model call launches B4 once per layer."""
    target = stats.get("prefill_chunks", 0) + n_prefills + \
        decode_chunk * stats["decode_steps"]
    draft = draft_chunks + (gamma + 1) * stats.get("spec_windows", 0)
    return n_layers * target + draft_layers * draft, target, draft


def _drive(se, items, max_new):
    """Adds ``items`` [(request id, prompt, add_request kwargs)] and steps
    until every request is out; returns {request id: tokens}."""
    for rid, prompt, kw in items:
        se.add_request(rid, prompt, max_new_tokens=max_new, **kw)
    out, steps = {}, 0
    limit = 3 * (max(len(p) for _, p, _ in items) + max_new + 4) * \
        (len(items) + 1)
    while se.queue or se.n_active:
        out.update(se.step())
        steps += 1
        if steps > limit:
            fail(f"serving stalled after {steps} steps")
    return out


def serve_run(label, model, items, max_new, dtype, serving=None,
              draft=None, **kw):
    """One counted serve run through create_serving_engine: counters set
    to 0 just before, read just after; no plain version may run and
    leak_report() must be {}.  Returns (engine, {id: tokens}, counts,
    wall s)."""
    import torch
    from deepspeed_tpu_torch.inference.serving import create_serving_engine
    _free()         # the engines before: each holds its page pools
    se = create_serving_engine(
        model, {"serving": dict(serving or {})}, max_batch=SERVE_SLOTS,
        page_size=SERVE_PAGE, max_seq=SERVE_MAX_SEQ, dtype=dtype,
        draft_model=draft, **kw)
    torch.cuda.synchronize()
    reset_counters()
    t0 = time.time()
    out = _drive(se, items, max_new)
    torch.cuda.synchronize()
    dt = time.time() - t0
    counts = read_counters()
    if plain_calls(counts):
        fail(f"{label}: plain versions ran: {plain_calls(counts)}")
    leaks = se.leak_report()
    if leaks:
        fail(f"{label}: leak_report() = {leaks}")
    if se.stats["finished"] != len(items):
        fail(f"{label}: {se.stats['finished']} of {len(items)} requests "
             f"finished")
    return se, out, counts, dt


def check_launches(label, counts, want, se, target):
    """The run's B4 launches and the engine's model calls against
    :func:`expected_b4_launches`; B5 must not launch in serving."""
    got = counts["ragged_paged_attention"]
    if got != want or se.stats["model_calls"] != target:
        fail(f"{label}: ragged kernel launched {got} times over "
             f"{se.stats['model_calls']} target model calls, expected "
             f"{want} over {target}")
    if counts["decode_attention"]:
        fail(f"{label}: the decode kernel launched in serving")


def _items(prompts, **kw):
    return [(i, p, dict(kw)) for i, p in enumerate(prompts)]


def _outs(out, n):
    return [out[i] for i in range(n)]


def feature_prompts(vocab, seed):
    """(the (a) prompts: PREFIX_TOKENS shared + PREFIX_SUFFIXES, the
    (b)-(d) prompts: the serve run's 12 and one LONG_PROMPT-token one)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, vocab, (PREFIX_TOKENS,)).tolist()
    shared = [prefix + rng.integers(0, vocab, (n,)).tolist()
              for n in PREFIX_SUFFIXES]
    rng = np.random.default_rng(1)          # phase 5's prompts, then one
    mixed = [rng.integers(0, vocab, (n,)).tolist() for n in SERVE_PROMPTS]
    mixed.append(rng.integers(0, vocab, (LONG_PROMPT,)).tolist())
    return shared, mixed


def phase_serve_features(model, cfg, draft, dtype, exact, label):
    """Runs (a)-(d) on ``model`` (and ``draft`` models for (c): a list of
    (name, model)) against monolithic baselines, through the kernels.
    ``exact``: tokens must equal the baseline's (fp32); else the
    divergence rule.  Returns a summary dict for the timing rows and the
    kernels JSON."""
    import numpy as np
    import torch
    from deepspeed_tpu_torch.ops.cuda.ragged_paged_attention import \
        tensor_core_prefill
    dn = str(dtype).split(".")[-1]
    L, N = cfg.n_layers, SERVE_NEW
    shared, mixed = feature_prompts(cfg.vocab_size, seed=11)
    res = {}

    def compare(name, base, outs, prompts, margins):
        if exact:
            same = sum(b == g for b, g in zip(base, outs))
            if same != len(outs):
                fail(f"{label} {name}: {len(outs) - same} requests differ "
                     f"from the monolithic fp32 run")
            phase("e2e", f"{label} {name}: tokens identical to the "
                  f"monolithic run, {same} of {len(outs)} requests")
        else:
            check_divergence(f"{label} {name}", base, outs, prompts,
                             margins, dn)

    def baseline(name, prompts):
        from deepspeed_tpu_torch.inference.serving import \
            create_serving_engine
        _free()
        se = create_serving_engine(
            model, {}, max_batch=SERVE_SLOTS, page_size=SERVE_PAGE,
            max_seq=SERVE_MAX_SEQ, dtype=dtype)
        margins = record_margins(se)
        torch.cuda.synchronize()
        t0 = time.time()
        out = _drive(se, _items(prompts), N)
        torch.cuda.synchronize()
        phase("serve-features", f"{label} baseline {name}, monolithic: "
              f"{time.time() - t0:.3f} s")
        if se.leak_report():
            fail(f"{label} baseline {name}: {se.leak_report()}")
        return _outs(out, len(prompts)), margins

    # (a) the prefix cache: cache off (the baseline) vs on.  Each run's
    # engine is dropped (se = None) before the next one is built.
    base_a, margins_a = baseline("(a)", shared)
    se, out, counts, dt = serve_run(
        f"{label} (a) prefix cache", model, _items(shared), N, dtype,
        serving={"prefix_cache": {"enabled": True}})
    want, target, _ = expected_b4_launches(
        L, se.scheduler.sched_stats, n_prefills=len(shared))
    check_launches(f"{label} (a)", counts, want, se, target)
    pc = se.prefix_cache
    if pc.audit():
        fail(f"{label} (a): prefix cache audit {pc.audit()}")
    suffix = sum(len(p) for p in shared) - pc.stats["tokens_reused"]
    phase("serve-features", f"{label} (a) prefix cache, 12 prompts of "
          f"{PREFIX_TOKENS} shared + {PREFIX_SUFFIXES} tokens x {N} new: "
          f"{dt:.3f} s; hits {pc.stats['hits']}, cached pages "
          f"{pc.cached_page_count}, tokens reused "
          f"{pc.stats['tokens_reused']}, suffix tokens prefilled {suffix} "
          f"of {sum(len(p) for p in shared)}; B4 launches {want} = {L} x "
          f"{target}; audit {{}}, leak_report {{}}")
    if pc.stats["hits"] < len(shared) - 1:
        fail(f"{label} (a): {pc.stats['hits']} prefix hits, expected "
             f"{len(shared) - 1}")
    compare("(a) prefix cache", base_a, _outs(out, len(shared)), shared,
            margins_a)
    res["prefix"] = dict(launches=want, hits=pc.stats["hits"], dt=dt)

    # the (b)-(d) baseline: monolithic on the 13 mixed prompts
    se = pc = None
    base, margins = baseline("(b)-(d)", mixed)
    lens = [len(p) for p in mixed]

    # (b) chunked prefill, SLO classes alternating latency / throughput
    items = [(i, p, {"slo_class": ("latency", "throughput")[i % 2]})
             for i, p in enumerate(mixed)]
    sched = {"policy": "chunked", "prefill_chunk_tokens": CHUNK_TOKENS,
             "max_prefill_chunks_per_step": 1}
    se = None
    se, out, counts, dt = serve_run(f"{label} (b) chunked", model, items,
                                    N, dtype, serving={"scheduler": sched})
    st = se.scheduler.sched_stats
    if st["prefill_chunks"] != prefill_chunks(lens, CHUNK_TOKENS):
        fail(f"{label} (b): {st['prefill_chunks']} prefill chunks, "
             f"expected {prefill_chunks(lens, CHUNK_TOKENS)}")
    want, target, _ = expected_b4_launches(L, st)
    check_launches(f"{label} (b)", counts, want, se, target)
    ttft = {"latency": [], "throughput": []}
    for tr in se.tracer.completed:
        ttft[items[tr.req_id][2]["slo_class"]].append(tr.ttft_ms())
    offset = sum(max(0, -(-n // CHUNK_TOKENS) - 1) for n in lens)
    phase("serve-features", f"{label} (b) chunked, {len(mixed)} prompts "
          f"{lens} x {N} new, chunks of {CHUNK_TOKENS}, one a step: "
          f"{dt:.3f} s; {st['prefill_chunks']} prefill chunks "
          f"({offset} at a start offset), {st['decode_steps']} decode "
          f"steps; mean TTFT latency class "
          f"{np.mean(ttft['latency']):.1f} ms, throughput class "
          f"{np.mean(ttft['throughput']):.1f} ms; B4 launches {want} = "
          f"{L} x {target}")
    compare("(b) chunked", base, _outs(out, len(mixed)), mixed, margins)
    res["chunk"] = dict(launches=L * offset, dt=dt)

    # (c) speculative decoding, gamma SPEC_GAMMA, per draft model
    spec = dict(sched, speculative={"enabled": True,
                                    "num_draft_tokens": SPEC_GAMMA})
    for name, dmodel in draft:
        # a bf16 / fp16 draft's prefills and chunks take B4's tensor-core
        # tiles at its head dim (64 for TinyLlama-1.1B), group and page
        dc = dmodel.config
        if dtype != torch.float32 and not tensor_core_prefill(
                dtype, dc.head_dim, dc.n_heads // dc.kv_heads, SERVE_PAGE):
            fail(f"{label} (c) {name}: its prefills would not take the "
                 f"tensor-core tiles (head dim {dc.head_dim}, group "
                 f"{dc.n_heads // dc.kv_heads}, page {SERVE_PAGE})")
        se = None
        se, out, counts, dt = serve_run(
            f"{label} (c) speculative, draft {name}", model,
            _items(mixed), N, dtype, serving={"scheduler": spec},
            draft=dmodel)
        st = se.scheduler.sched_stats
        Ld = dmodel.config.n_layers
        dchunks = prefill_chunks(lens, CHUNK_TOKENS)
        want, target, dcalls = expected_b4_launches(
            L, st, draft_layers=Ld, gamma=SPEC_GAMMA, draft_chunks=dchunks)
        check_launches(f"{label} (c) {name}", counts, want, se, target)
        if st["draft_calls"] != dcalls:
            fail(f"{label} (c) {name}: {st['draft_calls']} draft calls, "
                 f"expected {dcalls}")
        snap = se.scheduler.snapshot()
        phase("serve-features", f"{label} (c) speculative gamma "
              f"{SPEC_GAMMA}, draft {name}: {dt:.3f} s; acceptance rate "
              f"{snap['spec_acceptance_rate']:.4f} ({st['spec_accepted']} "
              f"of {st['spec_proposed']}), {st['spec_windows']} verify "
              f"windows; B4 launches {want}: target {L} x {target}, "
              f"draft {Ld} x {dcalls}")
        compare(f"(c) speculative, draft {name}", base,
                _outs(out, len(mixed)), mixed, margins)
        res[f"spec_{name}"] = dict(
            verify_launches=L * st["spec_windows"],
            draft_decode_launches=Ld * (SPEC_GAMMA + 1) *
            st["spec_windows"], draft_chunk_launches=Ld * offset,
            acceptance=snap["spec_acceptance_rate"], dt=dt)

    # (d) decode_chunk: greedy, then sampled (temperature 0.8, top-p 0.9)
    # twice, the second time with the requests added in reverse order
    se = None
    se, out, counts, dt = serve_run(f"{label} (d) decode_chunk greedy",
                                    model, _items(mixed), N, dtype,
                                    decode_chunk=DECODE_CHUNK)
    want, target, _ = expected_b4_launches(
        L, se.scheduler.sched_stats, n_prefills=len(mixed),
        decode_chunk=DECODE_CHUNK)
    check_launches(f"{label} (d) greedy", counts, want, se, target)
    phase("serve-features", f"{label} (d) decode_chunk {DECODE_CHUNK} "
          f"greedy: {dt:.3f} s, {se.scheduler.sched_stats['decode_steps']}"
          f" decode dispatches")
    compare(f"(d) decode_chunk {DECODE_CHUNK} greedy", base,
            _outs(out, len(mixed)), mixed, margins)
    runs = []
    for order in (1, -1):
        items = [(i, p, dict(temperature=0.8, top_p=0.9, seed=1000 + i))
                 for i, p in enumerate(mixed)][::order]
        se = None
        se, out, counts, dt = serve_run(
            f"{label} (d) decode_chunk sampled", model, items, N, dtype,
            decode_chunk=DECODE_CHUNK)
        want, target, _ = expected_b4_launches(
            L, se.scheduler.sched_stats, n_prefills=len(mixed),
            decode_chunk=DECODE_CHUNK)
        check_launches(f"{label} (d) sampled", counts, want, se, target)
        runs.append((out, dt, se.scheduler.sched_stats["decode_steps"]))
    if runs[0][0] != runs[1][0]:
        diff = [i for i in runs[0][0] if runs[0][0][i] != runs[1][0][i]]
        fail(f"{label} (d): sampled streams changed with the arrival "
             f"order, requests {diff}")
    phase("serve-features", f"{label} (d) decode_chunk {DECODE_CHUNK}: "
          f"sampled (T 0.8, top-p 0.9) {len(mixed) * N / runs[0][1]:.1f} "
          f"new tokens/s ({runs[0][1]:.3f} s, {runs[0][2]} decode "
          f"dispatches of {DECODE_CHUNK} tokens); the rerun in reverse "
          f"arrival order gave the same {len(mixed)} streams")
    res["decode_chunk"] = dict(dt=runs[0][1])
    se = None
    _free()
    return res


def teacher_margins(eng, outs, n_prompt):
    """{(row, generated index): (top-2 margin, max|logit|)} of ``outs``
    scored by one forward of the whole sequences (the margins behind
    ``InferenceEngine.generate``'s greedy tokens)."""
    import torch
    logits, _ = eng.forward(outs[:, :-1])
    lg = logits[:, n_prompt - 1:].float()
    if not torch.isfinite(lg).all():
        fail("teacher-forced logits not finite")
    top2 = lg.topk(2, dim=-1).values
    marg = (top2[..., 0] - top2[..., 1]).cpu().numpy()
    top = lg.abs().amax(-1).cpu().numpy()
    return {(b, i): (float(marg[b, i]), float(top[b, i]))
            for b in range(marg.shape[0]) for i in range(marg.shape[1])}


# ----------------------------------------------------------------------
# serving at head dims 80 and 96 (phase serve-d80-d96): gpt_2_7b -- the
# ds_bench train CLI's GPT-3 2.7B shape (GPT-3 paper, Table 2.1: 32 layers,
# d 2560, 32 heads of 80), built as the CLI builds it at GPT-3's context
# of 2048 -- and a Phi-3-mini-4k-shaped model, each at full width and
# depth, random weights from a seed, through both serving entry points
SERVE_D80_MODEL, SERVE_D80_SEQ = "gpt_2_7b", 2048
# serve-features (c)'s draft for gpt_2_7b: the CLI's gpt_350m at the same
# context, head dim 64 and the same vocab of 50304
SERVE_D80_DRAFT = "gpt_350m"
# microsoft/Phi-3-mini-4k-instruct config.json as the injection policy maps
# it (deepspeed_tpu/module_inject/policies.py Phi3Policy.build): vocab_size
# 32064, hidden_size 3072, num_hidden_layers 32, num_attention_heads 32,
# num_key_value_heads 32, intermediate_size 8192, max_position_embeddings
# 4096, rope_theta 10000, rms_norm_eps 1e-5, untied; llama wiring (SwiGLU,
# RMSNorm, RoPE) -- head dim 96, 3.82 B parameters.  The policy ignores
# config.json's sliding_window of 2047, which no sequence here reaches.
PHI3_MINI = dict(vocab_size=32064, hidden_size=3072, n_layers=32, n_heads=32,
                 ffn_hidden_size=8192, max_seq_len=4096, rope_theta=10000.0,
                 norm_eps=1e-5, activation="silu", use_rmsnorm=True,
                 use_rope=True, tie_embeddings=False, remat=False)
# serving at head dim 256 (phase serve-d256): Gemma-7B and Gemma-2B
# shapes.  google/gemma-7b config.json as the injection policy maps it
# (deepspeed_tpu/module_inject/policies.py GemmaPolicy.build): vocab_size
# 256000, hidden_size 3072, num_hidden_layers 28, num_attention_heads 16,
# num_key_value_heads 16, head_dim 256 (H * dh = 4096 != d = 3072),
# intermediate_size 24576, max_position_embeddings 8192, rope_theta 10000,
# rms_norm_eps 1e-6; GeGLU (tanh GELU), its (1 + w) RMSNorm folded into
# the weights, input embeddings times sqrt(3072), tied head -- 8.54 B
# parameters
GEMMA_7B = dict(vocab_size=256000, hidden_size=3072, n_layers=28,
                n_heads=16, head_dim_override=256, ffn_hidden_size=24576,
                max_seq_len=8192, rope_theta=10000.0, norm_eps=1e-6,
                activation="gelu", gated_mlp=True, embed_scale=3072 ** 0.5,
                use_rmsnorm=True, use_rope=True, tie_embeddings=True,
                remat=False)
# google/gemma-2b config.json, mapped the same way: hidden_size 2048,
# num_hidden_layers 18, num_attention_heads 8, num_key_value_heads 1 (MQA:
# a group of 8), head_dim 256 (= d / H, so the policy sets no override),
# intermediate_size 16384, embeddings times sqrt(2048) -- 2.51 B
GEMMA_2B = dict(GEMMA_7B, hidden_size=2048, n_layers=18, n_heads=8,
                n_kv_heads=1, head_dim_override=None, ffn_hidden_size=16384,
                embed_scale=2048 ** 0.5)
GEMMA_PARAMS = {"Gemma-7B": 8_537_680_896, "Gemma-2B": 2_506_172_416}
GEN_NEW = 32            # generate's new tokens: its prompt's prefill and
                        # 31 decode steps, one model call each
TIMED_BUCKETS = (512, 1024)   # the serve run's prefill buckets phase 9
                              # times (its 511- and 600-token prompts)


def generate_launches(n_layers, new=GEN_NEW):
    """B5 launches of ``init_inference(model).generate(ids, new)``: one a
    layer a model call -- the prompt's prefill and new - 1 decode steps."""
    return n_layers * new


def b4_form_launches(n_layers, decode_steps, prompts, suffix="",
                     buckets=None):
    """B4's launches on a monolithic serve run (phase 5's engine) by form,
    keyed by the kernels JSON's rows: one a layer a decode step (the decode
    rows) and a layer a prompt's bucketed prefill (the prefill tiles), by
    bucket -- only the ``buckets`` given, where given; ``suffix`` names the
    rows' head dim and dtype."""
    out = {f"ragged_paged_attention{suffix}": n_layers * decode_steps}
    for prompt in prompts:
        bucket = _prefill_need(prompt)[0]
        if buckets is None or bucket in buckets:
            key = f"ragged_paged_attention_prefill_{bucket}{suffix}"
            out[key] = out.get(key, 0) + n_layers
    return out


def decode_work(B, H, Hkv, L, D, item, T=1):
    """(bytes, operations) of one B5 call: B sequences of T query tokens
    (the last T of L; T = 1: a decode step) over L cached keys -- every K
    and V byte of the L keys read once, q read and o written once -- and
    4 D operations a head per (query, key at or before it) pair."""
    pairs = sum(L - T + t + 1 for t in range(T))
    return (B * (2 * Hkv * L * D + 2 * H * T * D) * item,
            B * 4 * H * D * pairs)


def paged_work(ctx, T, H, Hkv, D, item):
    """(bytes, operations) of one B4 call over sequences holding ctx[s]
    tokens, the last T of them the queries: each sequence's K and V read
    once, q read and o written once, and 4 D operations a head per (query,
    key at or before its position) pair."""
    pairs = sum(c - T + t + 1 for c in ctx for t in range(T))
    nbytes = (sum(2 * Hkv * c * D for c in ctx) + 2 * len(ctx) * T * H * D)
    return nbytes * item, 4 * H * D * pairs


def serve_entry_points(label, model, cfg, dtype_name):
    """``init_inference(model).generate`` (phase 4's B=4, prompt 128, 32
    new), then its ``create_serving_engine`` on phase 5's 12 prompts, each
    counted on its own: B5 exactly :func:`generate_launches` times in
    generate and B4 a layer a model call in serving, nothing else, no plain
    version; logits finite (the serve run's sampler fails on one that is
    not; generate's are scored by one forward).  Returns what the fp16
    comparison, the kernels JSON and the printout need."""
    L = cfg.n_layers
    reset_counters()
    eng, ids, t_gen, gen_out = phase_generate(model, cfg, dtype=dtype_name)
    g = read_counters()
    want = generate_launches(L)
    if g["decode_attention"] != want or g["ragged_paged_attention"] or \
            plain_calls(g):
        fail(f"{label} generate launches {g}, expected decode_attention "
             f"{L} x {GEN_NEW} and nothing else")
    margins = teacher_margins(eng, gen_out, ids.shape[1])
    reset_counters()
    se, prompts, t_serve, outs = phase_serve(eng, cfg)
    c = read_counters()
    calls = se.stats["model_calls"]
    if c["ragged_paged_attention"] != L * calls or c["decode_attention"] \
            or plain_calls(c):
        fail(f"{label} serve launches {c}, expected ragged_paged_attention "
             f"{L} x {calls} and nothing else")
    steps = se.scheduler.sched_stats["decode_steps"]
    phase("serve", f"{label}: generate B=4 prompt 128 + {GEN_NEW} "
          f"new {t_gen:.3f} s, decode kernel launches {want} = {L} x "
          f"{GEN_NEW}; serve 12 prompts x {SERVE_NEW} new, 8 slots "
          f"{t_serve:.3f} s ({len(prompts) * SERVE_NEW / t_serve:.1f} new "
          f"tokens/s), ragged kernel launches {L * calls} = {L} x {calls} "
          f"model calls ({steps} decode steps); plain versions 0, logits "
          f"finite, leak_report {{}}")
    res = dict(gen_launches=want, decode_steps=steps, gen_out=gen_out,
               gen_margins=margins, ids=ids, prompts=prompts,
               serve_outs=outs, serve_margins=se.margins, L=L)
    del se, eng
    _free()
    return res


def phase_serve_head_dims():
    """gpt_2_7b (head dim 80) through both entry points in bf16 and fp16
    (tokens vs bf16 by the divergence rule) and serve-features (a)-(d) in
    bf16 with the gpt_350m draft, both at FEATURES_LAYERS_D80's depth;
    then the Phi-3-mini-4k shape (head dim 96) through both in bf16.
    Full width, full depth but in serve-features.  Returns {kernels JSON
    row: launches} and the two configs."""
    import torch
    from deepspeed_tpu_torch.benchmarks.training import model_config
    from deepspeed_tpu_torch.models.transformer import TransformerConfig
    t0 = time.time()
    cfg80 = model_config(SERVE_D80_MODEL, SERVE_D80_SEQ, remat=False)
    _, model, t_init = build_model(cfg80.n_layers, seed=2, cfg=cfg80)
    n_params = sum(p.numel() for p in model.parameters()) / 1e9
    if cfg80.head_dim != 80:
        fail(f"{SERVE_D80_MODEL} has head dim {cfg80.head_dim}")
    phase("model", f"{SERVE_D80_MODEL} ({cfg80.n_layers} layers, "
          f"{cfg80.n_heads} heads of {cfg80.head_dim}, vocab "
          f"{cfg80.vocab_size}, seq {SERVE_D80_SEQ}), {n_params:.3f} B "
          f"params, bf16, init {t_init:.1f} s")
    bf = serve_entry_points(f"{SERVE_D80_MODEL} bf16", model, cfg80, "bf16")
    L = bf["L"]
    launches = {"decode_attention_d80": bf["gen_launches"]}
    launches.update(b4_form_launches(L, bf["decode_steps"], SERVE_PROMPTS,
                                     "_d80", TIMED_BUCKETS))
    del model
    _free()
    # serve-features at the cut depth of FEATURES_LAYERS_D80
    fcfg, fmodel, _ = build_model(FEATURES_LAYERS_D80[0], seed=2, cfg=cfg80)
    dcfg, draft, _ = build_model(FEATURES_LAYERS_D80[1], seed=3,
                                 cfg=model_config(SERVE_D80_DRAFT,
                                                  SERVE_D80_SEQ, remat=False))
    t1 = time.time()
    feat = phase_serve_features(fmodel, fcfg, [(SERVE_D80_DRAFT, draft)],
                                torch.bfloat16, exact=False,
                                label=f"{SERVE_D80_MODEL} bf16")
    phase("serve-features", f"{SERVE_D80_MODEL} bf16 (a)-(d), "
          f"{fcfg.n_layers} of {L} layers, draft {SERVE_D80_DRAFT} "
          f"{dcfg.n_layers} layers: {time.time() - t1:.1f} s")
    launches["ragged_paged_attention_chunk_at_offset_d80"] = \
        feat["chunk"]["launches"]
    launches["ragged_paged_attention_verify_d80"] = \
        feat[f"spec_{SERVE_D80_DRAFT}"]["verify_launches"]
    del fmodel, draft
    _free()
    _, model16, _ = build_model(cfg80.n_layers, seed=2, dtype=torch.float16,
                                cfg=cfg80)
    f16 = serve_entry_points(f"{SERVE_D80_MODEL} fp16", model16, cfg80,
                             "fp16")
    del model16
    _free()
    check_divergence(
        f"{SERVE_D80_MODEL} fp16 generate vs bf16",
        [r.tolist() for r in bf["gen_out"].cpu()],
        [r.tolist() for r in f16["gen_out"].cpu()],
        [bf["ids"][0]] * len(bf["ids"]), bf["gen_margins"], "bfloat16")
    check_divergence(f"{SERVE_D80_MODEL} fp16 serve vs bf16",
                     bf["serve_outs"], f16["serve_outs"], bf["prompts"],
                     bf["serve_margins"], "bfloat16")
    launches["decode_attention_d80_fp16"] = f16["gen_launches"]
    launches.update(b4_form_launches(L, f16["decode_steps"], SERVE_PROMPTS,
                                     "_d80_fp16", TIMED_BUCKETS))
    cfg96 = TransformerConfig(**PHI3_MINI)
    _, phi, t_init = build_model(cfg96.n_layers, seed=4, cfg=cfg96)
    n_params = sum(p.numel() for p in phi.parameters()) / 1e9
    phase("model", f"Phi-3-mini-4k shape ({cfg96.n_layers} layers, "
          f"{cfg96.n_heads} heads of {cfg96.head_dim}, ffn "
          f"{cfg96.ffn_hidden_size}, vocab {cfg96.vocab_size}, untied), "
          f"{n_params:.3f} B params, bf16, init {t_init:.1f} s")
    ph = serve_entry_points("Phi-3-mini-4k shape bf16", phi, cfg96, "bf16")
    del phi
    _free()
    launches["decode_attention_d96"] = ph["gen_launches"]
    launches.update(b4_form_launches(ph["L"], ph["decode_steps"],
                                     SERVE_PROMPTS, "_d96", TIMED_BUCKETS))
    phase("serve-d80-d96", f"done in {time.time() - t0:.1f} s; launches by "
          f"kernels JSON row {launches}")
    return launches, cfg80, cfg96


def gemma_configs():
    """(Gemma-7B, Gemma-2B) TransformerConfigs; fails unless each has
    head dim 256 and its published parameter count."""
    from deepspeed_tpu_torch.models.transformer import TransformerConfig
    cfgs = (TransformerConfig(**GEMMA_7B), TransformerConfig(**GEMMA_2B))
    for (name, n), cfg in zip(GEMMA_PARAMS.items(), cfgs):
        if cfg.head_dim != 256 or cfg.num_params() != n:
            fail(f"{name}: head dim {cfg.head_dim}, {cfg.num_params()} "
                 f"parameters, expected 256 and {n}")
    return cfgs


def phase_serve_gemma():
    """Gemma-7B (16 heads of 256, group 1) through both entry points in
    bf16, and serve-features (a)-(d) in bf16 with Gemma-2B as (c)'s draft
    at FEATURES_LAYERS_GEMMA's depth; then Gemma-2B (8 heads of 256 over
    one kv head: group 8) through both in bf16 and fp16 (tokens vs bf16
    by the divergence rule).  Full width, full depth but for
    serve-features, each model freed before the next.  Returns {kernels
    JSON row: launches} and the two configs."""
    import torch
    t0 = time.time()
    cfg7, cfg2 = gemma_configs()
    _, g7, t_init = build_model(cfg7.n_layers, seed=5, cfg=cfg7)
    phase("model", f"Gemma-7B shape ({cfg7.n_layers} layers, "
          f"{cfg7.n_heads} heads of {cfg7.head_dim}, d {cfg7.hidden_size}, "
          f"GeGLU ffn {cfg7.ffn_hidden_size}, vocab {cfg7.vocab_size}, "
          f"embed scale {cfg7.embed_scale:.4f}, tied), "
          f"{cfg7.num_params() / 1e9:.3f} B params, bf16, init "
          f"{t_init:.1f} s")
    g7_bf = serve_entry_points("Gemma-7B bf16", g7, cfg7, "bf16")
    L7 = g7_bf["L"]
    launches = {"decode_attention_d256": g7_bf["gen_launches"]}
    launches.update(b4_form_launches(L7, g7_bf["decode_steps"],
                                     SERVE_PROMPTS, "_d256", TIMED_BUCKETS))
    del g7
    _free()
    # serve-features at the cut depth of FEATURES_LAYERS_GEMMA
    t1 = time.time()
    fcfg, g7f, _ = build_model(FEATURES_LAYERS_GEMMA[0], seed=5, cfg=cfg7)
    fdcfg, g2f, _ = build_model(FEATURES_LAYERS_GEMMA[1], seed=6, cfg=cfg2)
    feat = phase_serve_features(g7f, fcfg, [("Gemma-2B", g2f)],
                                torch.bfloat16, exact=False,
                                label="Gemma-7B bf16")
    phase("serve-features", f"Gemma-7B bf16 (a)-(d), {fcfg.n_layers} of "
          f"{L7} layers, draft Gemma-2B {fdcfg.n_layers} of "
          f"{cfg2.n_layers} layers: {time.time() - t1:.1f} s")
    spec = feat["spec_Gemma-2B"]
    launches["ragged_paged_attention_chunk_at_offset_d256"] = \
        feat["chunk"]["launches"]
    launches["ragged_paged_attention_verify_d256"] = spec["verify_launches"]
    del g7f, g2f
    _free()
    _, g2, _ = build_model(cfg2.n_layers, seed=6, cfg=cfg2)
    phase("model", f"Gemma-2B shape ({cfg2.n_layers} layers, "
          f"{cfg2.n_heads}/{cfg2.kv_heads} heads of {cfg2.head_dim}, d "
          f"{cfg2.hidden_size}, ffn {cfg2.ffn_hidden_size}), "
          f"{cfg2.num_params() / 1e9:.3f} B params, bf16")
    g2_bf = serve_entry_points("Gemma-2B bf16", g2, cfg2, "bf16")
    del g2
    _free()
    _, g2h, _ = build_model(cfg2.n_layers, seed=6, dtype=torch.float16,
                            cfg=cfg2)
    g2_h = serve_entry_points("Gemma-2B fp16", g2h, cfg2, "fp16")
    del g2h
    _free()
    check_divergence(
        "Gemma-2B fp16 generate vs bf16",
        [r.tolist() for r in g2_bf["gen_out"].cpu()],
        [r.tolist() for r in g2_h["gen_out"].cpu()],
        [g2_bf["ids"][0]] * len(g2_bf["ids"]), g2_bf["gen_margins"],
        "bfloat16")
    check_divergence("Gemma-2B fp16 serve vs bf16", g2_bf["serve_outs"],
                     g2_h["serve_outs"], g2_bf["prompts"],
                     g2_bf["serve_margins"], "bfloat16")
    L2 = g2_bf["L"]
    for sfx, r in (("_d256_gqa8", g2_bf), ("_d256_gqa8_fp16", g2_h)):
        launches[f"decode_attention{sfx}"] = r["gen_launches"]
        launches.update(b4_form_launches(L2, r["decode_steps"],
                                         SERVE_PROMPTS, sfx, TIMED_BUCKETS))
    # the draft's group-8 decode steps in (c) take the same form as
    # Gemma-2B's own serve run: their launches join its row
    launches["ragged_paged_attention_d256_gqa8"] += \
        spec["draft_decode_launches"]
    phase("serve-d256", f"done in {time.time() - t0:.1f} s; launches by "
          f"kernels JSON row {launches}")
    return launches, cfg7, cfg2


def phase_serve_vs_plain(model, n_prompts=6):
    """Greedy tokens of ``create_serving_engine(model)`` in fp32 through
    B4 against the same engine with ``attention_backend`` "plain" (phase
    5's geometry, its first ``n_prompts`` prompt lengths); fails unless
    they are identical and each ran only its own attention.  Returns
    (identical requests, B4 launches)."""
    import numpy as np
    import torch
    from deepspeed_tpu_torch.inference.serving import create_serving_engine
    cfg = model.config
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, cfg.vocab_size, (n,)).tolist()
               for n in SERVE_PROMPTS[:n_prompts]]
    outs, counts, calls = [], [], []
    for serving in ({}, {"attention_backend": "plain"}):
        _free()
        se = create_serving_engine(
            model, {"serving": serving}, max_batch=SERVE_SLOTS,
            page_size=SERVE_PAGE, max_seq=SERVE_MAX_SEQ,
            dtype=torch.float32)
        reset_counters()
        outs.append(se.generate(prompts, max_new_tokens=SERVE_NEW))
        counts.append(read_counters())
        calls.append(cfg.n_layers * se.stats["model_calls"])
        if se.leak_report():
            fail(f"serve vs plain: leak_report() = {se.leak_report()}")
        se = None
    (k, p), (nk, n_p) = counts, calls
    if k["ragged_paged_attention"] != nk or plain_calls(k):
        fail(f"serve (kernels) counts {k}, expected ragged_paged_attention "
             f"{nk} and no plain version")
    if p["paged_attention_plain"] != n_p or p["ragged_paged_attention"]:
        fail(f"serve (plain) counts {p}, expected paged_attention_plain "
             f"{n_p} and no kernel")
    same = sum(a == b for a, b in zip(*outs))
    if same != len(prompts):
        fail(f"serving through the kernels differs from the plain "
             f"versions in {len(prompts) - same} of {len(prompts)} "
             f"requests (fp32)")
    return same, nk


def phase_timing_head_dims():
    """B5 and B4 at head dims 80 and 96 at the shapes the new serving
    phases give them: generate's decode step (B=4, length 144), the serve
    run's 8-slot decode step and its prefill buckets 512 and 1024, in bf16
    at both head dims and in fp16 at 80 (gpt_2_7b's fp16 run), and at 80
    the 256-token chunk at start 512 and the verify window [8, 5] of
    serve-features (b) and (c)."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(97)
    prompts = SERVE_PROMPTS[:SERVE_SLOTS]
    needs = [p + SERVE_NEW for p in prompts]
    rows = {}
    for D, dtype in ((80, torch.bfloat16), (80, torch.float16),
                     (96, torch.bfloat16)):
        dn = str(dtype).split(".")[-1]
        sfx = d_suffix(D) + ("_fp16" if dtype == torch.float16 else "")
        rows[f"decode_attention{sfx}"] = _time_decode(
            f"decode_attention generate step D={D} {dn}", dtype, 4, 160,
            144, 12, gen, D=D)
        rows[f"ragged_paged_attention{sfx}"] = _time_paged(
            f"ragged_paged_attention 8-slot decode step D={D} {dn}", dtype,
            needs, [p + 16 for p in prompts], 1, 32, D, 4, gen)
        _free()
        for prompt in (511, 600):       # their buckets: TIMED_BUCKETS
            bucket, need = _prefill_need(prompt)
            rows[f"ragged_paged_attention_prefill_{bucket}{sfx}"] = \
                _time_paged(f"ragged_paged_attention prefill T={bucket} "
                            f"D={D} {dn}", dtype, [need], [bucket], bucket,
                            32, D, 4, gen)
            _free()
    rows["ragged_paged_attention_chunk_at_offset_d80"] = _time_paged(
        "ragged_paged_attention chunk T=256 at start 512 D=80",
        torch.bfloat16, [1024 + SERVE_NEW], [768], CHUNK_TOKENS, 32, 80, 4,
        gen)
    rows["ragged_paged_attention_verify_d80"] = _time_paged(
        "ragged_paged_attention verify window [8, 5] D=80", torch.bfloat16,
        needs, [p + 9 for p in prompts], SPEC_GAMMA + 1, 32, 80, 4, gen)
    _free()
    for name, r in rows.items():
        phase("timing", f"{name} [{r['shape']}]: device ms (graph replay) "
              f"kernel {r['ms']:.4f}, plain {r['plain_ms']:.4f}, SDPA "
              f"{r['library_ms']:.4f}; eager ms per call (host included) "
              f"kernel {r['ms_eager']:.4f}; bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}), {r['bound_ms'] / r['ms']:.3f} of bound, "
              f"max abs err {r['max_abs_err']:.3e}")
    return rows


# the kernels JSON's row off the paths (launches 0): Gemma-2B's B5 step at
# 4096 cached tokens, the context where the register body lost most to SDPA
OFF_PATH_D256 = "decode_attention_d256_gqa8_len4096"


def phase_timing_head_dim_256():
    """B5 and B4 at head dim 256 at the shapes phase serve-d256 gives
    them: generate's decode step (B=4, length 144), the serve run's 8-slot
    decode step and its prefill buckets 512 and 1024 -- Gemma-7B's 16 / 16
    heads in bf16, Gemma-2B's 8 / 1 in bf16 and fp16 -- and at Gemma-7B's
    heads the 256-token chunk at start 512 and the verify window [8, 5]
    of serve-features (b) and (c); and, off the paths, Gemma-2B's
    generate step at 4096 cached tokens (bf16)."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(96)
    prompts = SERVE_PROMPTS[:SERVE_SLOTS]
    needs = [p + SERVE_NEW for p in prompts]
    rows, D = {}, 256
    for sfx, H, Hkv, dtype in (("_d256", 16, 16, torch.bfloat16),
                               ("_d256_gqa8", 8, 1, torch.bfloat16),
                               ("_d256_gqa8_fp16", 8, 1, torch.float16)):
        dn = str(dtype).split(".")[-1]
        heads = f"H{H}/{Hkv} D={D} {dn}"
        rows[f"decode_attention{sfx}"] = _time_decode(
            f"decode_attention generate step {heads}", dtype, 4, 160, 144,
            12, gen, H=H, Hkv=Hkv, D=D)
        rows[f"ragged_paged_attention{sfx}"] = _time_paged(
            f"ragged_paged_attention 8-slot decode step {heads}", dtype,
            needs, [p + 16 for p in prompts], 1, Hkv, D, 4, gen, H=H)
        _free()
        for prompt in (511, 600):       # their buckets: TIMED_BUCKETS
            bucket, need = _prefill_need(prompt)
            rows[f"ragged_paged_attention_prefill_{bucket}{sfx}"] = \
                _time_paged(f"ragged_paged_attention prefill T={bucket} "
                            f"{heads}", dtype, [need], [bucket], bucket, Hkv,
                            D, 4, gen, H=H)
            _free()
    rows["ragged_paged_attention_chunk_at_offset_d256"] = _time_paged(
        "ragged_paged_attention chunk T=256 at start 512 H16/16 D=256",
        torch.bfloat16, [1024 + SERVE_NEW], [768], CHUNK_TOKENS, 16, D, 4,
        gen, H=16)
    rows["ragged_paged_attention_verify_d256"] = _time_paged(
        "ragged_paged_attention verify window [8, 5] H16/16 D=256",
        torch.bfloat16, needs, [p + 9 for p in prompts], SPEC_GAMMA + 1, 16,
        D, 4, gen, H=16)
    _free()
    rows[OFF_PATH_D256] = _time_decode(
        "decode_attention len 4096 H8/1 D=256 bfloat16", torch.bfloat16, 4,
        4096, 4096, 4, gen, H=8, Hkv=1, D=D)
    _free()
    for name, r in rows.items():
        phase("timing", f"{name} [{r['shape']}]: device ms (graph replay) "
              f"kernel {r['ms']:.4f}, plain {r['plain_ms']:.4f}, SDPA "
              f"{r['library_ms']:.4f}; eager ms per call (host included) "
              f"kernel {r['ms_eager']:.4f}; bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}), {r['bound_ms'] / r['ms']:.3f} of bound, "
              f"max abs err {r['max_abs_err']:.3e}")
    return rows


# ----------------------------------------------------------------------
# this slice's entry points as a user runs them: ``ds_report`` and the
# serving and inference benches (``python -m deepspeed_tpu_torch.benchmarks
# serving | inference``), B4 and B5 at head dim 16 (their tiny model)

# ``ds_bench serving --model tiny`` as the smoke runs it (the defaults'
# 16 requests of 64 tokens cut to 8 of 32: tiny's two layers finish in a
# few seconds either way; its prompt mix is the defaults' first 8)
BENCH_TINY_ARGS = ["--model", "tiny", "--requests", "8", "--gen", "32"]
# phase (d): the ds_bench train CLI's gpt_350m, its profiled train_batch
# with the timers' lines on (steps_per_print 1, wall_clock_breakdown):
# its device time stays within its reading before the timers were ported
# (102.4 ms on an NVIDIA H100 80GB HBM3 at 700 W, PERF.md) times this
# factor -- the timers record CUDA events and add no kernel and no host
# sync to a step that does not log
CLI_DEVICE_MS = 102.4
TIMER_DEVICE_FACTOR = 1.15


def _bucket(n, max_seq):
    """The serving engine's prefill bucket of an n-token prompt
    (``ServingEngine._bucket`` capped at max_seq)."""
    return min(1 << max(3, math.ceil(math.log2(max(n, 1)))), max_seq)


def serving_bench_launches(n_layers, result, prompt_lens, max_seq,
                           suffix=""):
    """Launches by kernels JSON row of one ``ds_bench serving`` run
    (``result``: ``run_benchmark``'s return, ``prompt_lens``: its prompt
    mix): B4 once a layer a model call of the continuous-batching engines
    -- each engine's prefills (the warm-up's first prompt, then every
    prompt: one call each) by bucket, ``ragged_paged_attention_prefill_
    {bucket}{suffix}``, its other calls decode rows,
    ``ragged_paged_attention{suffix}`` -- and B5 once a layer a call of
    the sequential generates, its prompts' prefills (``decode_attention
    {suffix}_prefill``) apart from its steps (``decode_attention
    {suffix}``)."""
    calls, prefills = result["model_calls"], result["prefills"]
    rows = {f"ragged_paged_attention{suffix}": 0}
    for mode in calls:
        if mode.startswith("continuous"):
            for n in [prompt_lens[0]] + list(prompt_lens):
                key = (f"ragged_paged_attention_prefill_"
                       f"{_bucket(n, max_seq)}{suffix}")
                rows[key] = rows.get(key, 0) + n_layers
            rows[f"ragged_paged_attention{suffix}"] += n_layers * (
                calls[mode] - prefills[mode])
    seq = "sequential_single_stream"
    rows[f"decode_attention{suffix}_prefill"] = n_layers * prefills[seq]
    rows[f"decode_attention{suffix}"] = n_layers * (calls[seq] -
                                                    prefills[seq])
    return rows


def inference_bench_launches(n_layers, trials, max_new_tokens, suffix=""):
    """B5's launches of one ``ds_bench inference`` run: trials + 3
    generates, each one call a layer for the prompt (the prefill form)
    and max_new_tokens - 1 decode steps."""
    gens = trials + 3
    return {f"decode_attention{suffix}_prefill": n_layers * gens,
            f"decode_attention{suffix}": n_layers * gens *
            (max_new_tokens - 1)}


def _kernel_totals(rows):
    """{kernel counter: launches} summed over kernels JSON rows."""
    out = {"decode_attention": 0, "ragged_paged_attention": 0}
    for name, n in rows.items():
        out[name.split("_attention")[0] + "_attention"] += n
    return out


def phase_env_report():
    """``ds_report --kernel-gate`` (``deepspeed_tpu_torch.env_report``):
    every library row compatible, one card of compute capability 9.0, and
    the build gate passes (the libraries phase 2 built)."""
    import contextlib
    import io
    from deepspeed_tpu_torch import env_report
    rc = env_report.main(kernel_gate=True)     # its report, printed
    with contextlib.redirect_stdout(io.StringIO()):
        rows = env_report.op_report()
        info = dict(env_report.debug_report())
    bad = [name for name, _, ok in rows if not ok]
    if rc != 0 or bad or info.get("compute capability") != "9.0" or \
            not info.get("device count"):
        fail(f"ds_report --kernel-gate: rc {rc}, not compatible {bad}, "
             f"{info}")
    phase("env", f"ds_report --kernel-gate: {len(rows)} kernel entries of "
          f"{len({src for _, src, _ in rows})} libraries compatible, build "
          f"gate rc 0; nvcc {info['nvcc version']}, torch "
          f"{info['torch version']} CUDA {info['torch CUDA version']}, "
          f"{info['device name']} {info['memory per device']}, power limit "
          f"{info['power limit']}")


def phase_bench_serving(argv):
    """``python -m deepspeed_tpu_torch.benchmarks serving`` + argv through
    the dispatcher's ``main`` (its JSON lines printed as they come),
    counters read around it: B4 and B5 exactly
    :func:`serving_bench_launches`, nothing else, no plain version.
    Returns (result, {kernels JSON row: launches}, the model's head dim,
    the prompt mix's lengths, the engine's max_seq)."""
    from deepspeed_tpu_torch.benchmarks import __main__ as ds_bench
    from deepspeed_tpu_torch.benchmarks import serving
    a = {"model": "gpt2_125m", "requests": 16, "gen": 64, "prompt_len": 128,
         "page_size": 128}
    for flag, value in zip(argv[::2], argv[1::2]):
        key = flag.lstrip("-").replace("-", "_")
        a[key] = value if key == "model" else int(value)
    cfg = serving.model_config(a["model"])
    lens, _ = serving.prompt_mix(a["requests"], a["prompt_len"],
                                 cfg.vocab_size)
    max_seq = a["prompt_len"] + a["gen"] + a["page_size"]
    label = " ".join(["ds_bench serving"] + argv)
    t0 = time.time()
    reset_counters()
    result = ds_bench.main(["serving"] + argv)
    counts = read_counters()
    dt = time.time() - t0
    suffix = "_d16" if cfg.head_dim == 16 else f"_{a['model']}"
    rows = serving_bench_launches(cfg.n_layers, result, lens, max_seq,
                                  suffix)
    want = _kernel_totals(rows)
    got = {k: counts[k] for k in want}
    others = {k: v for k, v in counts.items()
              if v and k not in want and not k.endswith("_plain")}
    if got != want or others or plain_calls(counts):
        fail(f"{label}: launches {got}, others {others}, plain "
             f"{plain_calls(counts)}; expected {want} ({cfg.n_layers} "
             f"layers x model calls {result['model_calls']})")
    for rec in result["records"]:
        if not rec["gen_tokens"] or not rec["tokens_per_sec"] > 0:
            fail(f"{label}: {rec}")
    phase("bench", f"{label}: {a['model']} ({cfg.n_layers} layers, "
          f"{cfg.n_heads} heads of {cfg.head_dim}), bf16, "
          f"{a['requests']} requests x {a['gen']} tokens, {dt:.1f} s with "
          f"the model's init; tokens/s " +
          ", ".join(f"{r['mode']} {r['tokens_per_sec']}"
                    for r in result["records"]) +
          f"; launches {want} = {cfg.n_layers} layers x model calls "
          f"{result['model_calls']}, by row {rows}; plain versions 0")
    _free()
    return result, rows, cfg.head_dim, lens, max_seq


def phase_bench_inference():
    """``python -m deepspeed_tpu_torch.benchmarks inference`` at its
    defaults (tiny, bf16, B=1, a 128-token prompt, 64 new tokens, 10
    trials after 3 warm-up ones) through the dispatcher's ``main``,
    counters read around it: B5 exactly :func:`inference_bench_launches`,
    nothing else.  Returns (the JSON record, {kernels JSON row:
    launches})."""
    from deepspeed_tpu_torch.benchmarks import __main__ as ds_bench
    from deepspeed_tpu_torch.benchmarks.inference import _preset
    cfg = _preset("tiny")
    t0 = time.time()
    reset_counters()
    rec = ds_bench.main(["inference"])
    counts = read_counters()
    dt = time.time() - t0
    defaults = dict(model="tiny", dtype="bf16", batch=1, prompt_len=128,
                    max_new_tokens=64)
    if {k: rec[k] for k in defaults} != defaults or cfg.head_dim != 16:
        fail(f"ds_bench inference: {rec}, head dim {cfg.head_dim}: "
             f"expected {defaults} at head dim 16")
    rows = inference_bench_launches(cfg.n_layers, 10, 64, "_d16")
    want = _kernel_totals(rows)
    got = {k: counts[k] for k in want}
    others = {k: v for k, v in counts.items()
              if v and k not in want and not k.endswith("_plain")}
    if got != want or others or plain_calls(counts):
        fail(f"ds_bench inference: launches {got}, others {others}, plain "
             f"{plain_calls(counts)}; expected {want}")
    if rec["rpc_floor_ms"] != 0.0:
        fail(f"ds_bench inference: round-trip floor {rec['rpc_floor_ms']} "
             f"ms on the card (over 5 ms)")
    phase("bench", f"ds_bench inference (defaults): tiny (2 layers, 4 heads "
          f"of 16), bf16, B=1, prompt 128 + 64 new, 10 trials, {dt:.1f} s; "
          f"token latency ms {rec['token_latency_ms']}, e2e ms "
          f"{rec['e2e_latency_ms']}, {rec['tokens_per_sec']} tokens/s; "
          f"launches {want} by row {rows}; plain versions 0")
    return rec, rows


def phase_timing_benches(serve_tiny, serve_gpt2):
    """B5 and B4 at the shapes the benches give them (bf16): tiny's
    (head dim 16, 4 / 4 heads) B5 prompt (T=128 over a 192-key cache) and
    step (B=1, 160 of 192 keys: the middle of 129-192), B4's 8-slot
    decode rows (the tiny run's first 8 prompts 16 tokens into their 32)
    and its prefill bucket(s); gpt2_125m's (12 / 12 heads of 64) B4
    decode rows (8 slots, 32 tokens into their 64) and prefill bucket(s),
    and B5's step (B=1, prompt 128 + 32).  ``serve_*``: (prompt lengths,
    max_seq, gen, launches by row) of each serving run."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(96)
    bf16 = torch.bfloat16
    rows = {"decode_attention_d16_prefill": _time_decode(
        "decode_attention tiny prompt (D=16)", bf16, 1, 192, 128, 12, gen,
        H=4, Hkv=4, D=16, T=128)}
    rows["decode_attention_d16"] = _time_decode(
        "decode_attention tiny step (D=16)", bf16, 1, 192, 160, 12, gen,
        H=4, Hkv=4, D=16)
    rows["decode_attention_gpt2_125m"] = _time_decode(
        "decode_attention gpt2_125m step (D=64)", bf16, 1, 320, 160, 12, gen,
        H=12, Hkv=12, D=64)
    for (lens, max_seq, new, launched), H, D, sfx in (
            (serve_tiny, 4, 16, "_d16"), (serve_gpt2, 12, 64, "_gpt2_125m")):
        slots = [int(n) for n in lens[:SERVE_SLOTS]]
        rows[f"ragged_paged_attention{sfx}"] = _time_paged(
            f"ragged_paged_attention 8-slot decode step ({sfx[1:]})", bf16,
            [n + new for n in slots], [n + new // 2 for n in slots], 1, H, D,
            4, gen, H=H, max_seq=max_seq)
        for key in launched:
            if "prefill" not in key or not key.startswith("ragged"):
                continue
            bucket = int(key.split("_prefill_")[1].split("_")[0])
            rows[key] = _time_paged(
                f"ragged_paged_attention prefill T={bucket} ({sfx[1:]})",
                bf16, [max(bucket, int(max(lens)) + new)], [bucket], bucket,
                H, D, 4, gen, H=H, max_seq=max_seq)
        _free()
    for name, r in rows.items():
        phase("timing", f"{name} [{r['shape']}]: device ms (graph replay) "
              f"kernel {r['ms']:.4f}, plain {r['plain_ms']:.4f}, SDPA "
              f"{r['library_ms']:.4f}; eager ms per call (host included) "
              f"kernel {r['ms_eager']:.4f}; bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}), {r['bound_ms'] / r['ms']:.3f} of bound, "
              f"max abs err {r['max_abs_err']:.3e}")
    return rows


# ----------------------------------------------------------------------
# training: run_benchmark(TRAIN_MODEL, ...) is the main path, nothing cut
TRAIN_MODEL, TRAIN_BATCH, TRAIN_GAS, TRAIN_SEQ = "gpt_1b", 2, 4, 1024
# BLOOM-1b7 and GPT-Neo-1.3B at their published shapes: the
# TransformerConfig fields run_benchmark's shape dict adds to the GPT-style
# defaults of benchmarks.training.model_config (LayerNorm, tanh-GELU, no
# RoPE, tied embeddings), as the injection policies set them
# (deepspeed_tpu/module_inject/policies.py BloomPolicy, GPTNeoPolicy).
# bigscience/bloom-1b7 config.json: hidden_size 2048, n_layer 24, n_head
# 16, vocab_size 250880, layer_norm_epsilon 1e-5; ALiBi (no position
# table), word_embeddings_layernorm, biases; trained at seq 2048.
BLOOM_1B7 = dict(hidden_size=2048, n_layers=24, n_heads=16, norm_eps=1e-5,
                 use_alibi=True, embed_norm=True, use_bias=True,
                 norm_bias=True)
# EleutherAI/gpt-neo-1.3B config.json: hidden_size 2048, num_layers 24,
# num_heads 16, vocab_size 50257, max_position_embeddings 2048,
# attention_types [[["global", "local"], 12]], window_size 256,
# layer_norm_epsilon 1e-5; unscaled attention logits, biases.
GPT_NEO_1_3B = dict(hidden_size=2048, n_layers=24, n_heads=16,
                    norm_eps=1e-5, use_bias=True, norm_bias=True,
                    attn_scale=1.0, local_attn_pattern=(0, 256) * 12)
# name -> (run_benchmark's model, seq, vocab_size): nothing cut
TRAIN_MODELS = {TRAIN_MODEL: (TRAIN_MODEL, TRAIN_SEQ, None),
                "bloom_1b7": (BLOOM_1B7, 2048, 250880),
                "gpt_neo_1_3b": (GPT_NEO_1_3B, 2048, 50257)}
# This slice's main path: ``ds_bench train`` with no flags, as a user runs
# it -- gpt_350m (1024 wide, 24 layers, 16 heads of 64: the flash kernels'
# D=64 forms), micro 8, gas 1, seq 1024, bf16, ZeRO 3, AdamW, 10 timed
# steps after one warm-up; nothing cut.  The CLI's own defaults, checked
# against its printout.
CLI_DEFAULTS = dict(model="gpt_350m", batch=8, gas=1, seq=1024, steps=10)
# its remat policy, the JAX benchmark's (--remat-policy's default)
CLI_POLICY = "dots_saveable"
# The slices that follow: ``ds_bench train --model gpt_760m`` and
# ``--model gpt_2_7b`` with the CLI's other defaults, at full width and
# depth: the JAX benchmark's shapes (deepspeed_tpu/benchmarks/training.py
# :27, :35; 0.758 B and 2.648 B parameters), nothing cut.  Each CLI run's
# model -> the head dim of its flash forms (D=64 on the default run, D=96
# and D=80 on these).
CLI_HEAD_DIMS = {"gpt_350m": 64, "gpt_760m": 96, "gpt_2_7b": 80}
# Head-dim-64 models held kernels vs plain at 2 layers of full width (their
# own seq), random weights from a seed: name -> (run_benchmark's model, seq,
# vocab_size).  bigscience/bloom-560m config.json: hidden_size 1024,
# n_layer 24, n_head 16, vocab_size 250880, layer_norm_epsilon 1e-5;
# ALiBi, word_embeddings_layernorm, biases; seq 2048.  EleutherAI/
# gpt-neo-125M config.json: hidden_size 768, num_layers 12, num_heads 12,
# vocab_size 50257, max_position_embeddings 2048, attention_types
# [[["global", "local"], 6]], window_size 256, layer_norm_epsilon 1e-5;
# unscaled logits, biases.  These add shapes, not features: BLOOM's ALiBi
# and GPT-Neo's windows train at head dim 128 above.
BLOOM_560M = dict(BLOOM_1B7, hidden_size=1024)
GPT_NEO_125M = dict(GPT_NEO_1_3B, hidden_size=768, n_layers=12, n_heads=12,
                    local_attn_pattern=(0, 256) * 6)
D64_MODELS = {"gpt_350m": ("gpt_350m", 1024, None),
              "gpt2_1_5b": ("gpt2_1_5b", 1024, None),
              "bloom_560m": (BLOOM_560M, 2048, 250880),
              "gpt_neo_125m": (GPT_NEO_125M, 2048, 50257)}
# the CLI models at head dims 96 and 80, held kernels vs plain the same way
# (2 layers of full width, seq 1024); FP16_CLI_MODEL also in fp16
D80_96_MODELS = {"gpt_760m": ("gpt_760m", 1024, None),
                 "gpt_2_7b": ("gpt_2_7b", 1024, None)}
FP16_CLI_MODEL = "gpt_760m"
# Training at head dim 256: the Gemma-2B shape (GEMMA_2B, google/gemma-2b's
# config.json as GemmaPolicy.build maps it: 18 layers, 8 heads of 256
# over one kv head, GeGLU, vocab 256000, tied, embeddings times sqrt(d);
# 2,506,172,416 parameters) with per-layer remat, at seq 2048, micro
# TRAIN_BATCH x gas TRAIN_GAS, bf16, AdamW (benchmarks.training.ds_config)
# through initialize(...).train_batch, random weights from a seed (the
# embedding as build_model draws it for Gemma); nothing cut.  Gemma-7B's
# 8.54 B parameters would need ~137 GB of fp32 master weights, gradients
# and moments on the card: it trains with its optimizer offloaded (phase
# train-offload (d)).
GEMMA_TRAIN = dict(GEMMA_2B, remat=True)
GEMMA_TRAIN_SEQ = 2048
TRAIN_STEPS = 4            # timed steps after run_benchmark's warm-up step
FIXED_STEPS = 4            # steps on one fixed batch: the loss must fall
# BLOOM's fixed-batch loss does not fall at every step; the same 4 steps
# through the plain versions must give the kernels' losses within 1e-2
# relative -- a fifth of its rise at step 4 (12.12 -> 12.78) -- so a wrong
# gradient in the kernels would show, not the model's own path
FIXED_PLAIN = ("bloom_1b7",)
FIXED_PLAIN_REL_TOL = 1e-2
# kernels vs plain training e2e (2 layers, bf16, 2 steps).  The two
# attention paths round their bf16 outputs and gradients at different
# places (one bf16 ulp, 2**-8 relative).  Losses and the first grad norm
# agree within E2E_TRAIN_REL_TOL relative.  The engines' states are
# compared parameter by parameter, by relative L2 norm: the first moment m
# after each step (a sum of the gradients, so it holds B1 and B2 in every
# layer) and the update after the last step, master minus the shared init
# (it holds B3 too; a
# per-element limit could not: Adam's first step moves each weight by
# lr * sign(g), so any two updates differ by at most 2 lr per step).  A
# small gradient whose sign differs between the paths flips its update,
# so the update's limit is looser than m's.
E2E_TRAIN_REL_TOL = 1e-3
E2E_M_REL_TOL = 5e-2
E2E_UPDATE_REL_TOL = 3e-1
# m after the first step is the gradient at identical weights, which the
# kernels alone decide; after the second it also carries how far the
# first update moved the two engines apart, which the model scales.  m is
# held to E2E_M_REL_TOL after every step, but in bf16 with GPT-Neo's
# unscaled logits (attn_scale 1) after the first only.  There a witness,
# two plain engines that differ only in how the batch is split (micro 2 x
# gas 2 against micro 1 x gas 4), shows how far the model alone grows a
# rounding gap: on an H100 its bf16 m gap went 3.6e-3 -> 6.2e-2 (17x), the
# kernels' 1.9e-2 -> 9.1e-2 (4.7x).  The later steps' m is held to
# E2E_WITNESS_FACTOR times the witness's gap at that step.  In fp32 the
# kernels and the plain versions differ only in summation order: m within
# 1e-3 after every step (GPT-Neo's readings 2.1e-5, then 8.3e-4).
E2E_WITNESS_FACTOR = 2.0
E2E_FP32_M_REL_TOL = 1e-3
# The key bias (BLOOM, GPT-Neo) adds q . b_k to every score of a row, which
# the softmax drops: its exact gradient is 0, each path's is rounding
# noise, and Adam turns that noise into steps of up to ~lr.  Those weights
# are held only to that bound (1.5 lr per step, for Adam's later steps),
# not to the relative limits above.
ZERO_GRAD = ("wk_b",)
E2E_LR = 1e-4             # benchmarks.training.ds_config's AdamW lr
# fp16: gpt_1b with dynamic loss scaling (DeepSpeed's defaults:
# hysteresis 2, so each halving of the scale takes two skipped steps;
# window 1000; min scale 1) and WarmupDecayLR.  At init its fp16 gradients
# overflow from a loss scale of about 2**21.4 at full depth and 2**23.1
# with 2 layers (scripts/fp16_overflow_threshold.py on an H100, the
# smoke's seeds and batches).  The full-depth runs start at 2**23: two
# halvings, 4 skipped steps, then applied ones at 2**21 (0.4 below the
# threshold, a 30% margin).  The 2-layer comparison starts where the
# first step overflows by construction: the logits' fp16 gradient of the
# target token is about scale / tokens per micro-batch, and 2**29 / 2048 =
# 262144 is 4x fp16's largest value 65504; 12 skipped steps take it to
# 2**23.
FP16_SCALE_POWER = 23
FP16_STEPS = 12
FP16_E2E_SCALE_POWER = 29
FP16_E2E_STEPS = 18
FP16_SCHEDULER = "WarmupDecayLR"
# the 2-layer fp16 comparison (kernels vs plain, same batches): the skip
# pattern and the loss scale after every step must be identical; losses,
# the first applied step's grad norm, m after each applied step and the
# update keep the bf16 limits above.  fp16 rounds 8x finer than bf16
# (2**-11 vs 2**-8), so the same limits hold with that margin, which the
# longer run (3 or more applied steps where bf16 takes 2) spends on the
# gap's growth from step to step.


def _train_model(name):
    """(run_benchmark's model, seq, vocab_size) of a phase-7 model."""
    return {**TRAIN_MODELS, **D64_MODELS, **D80_96_MODELS}[name]


def _free():
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def train_launches(cfg, gas, calls, adam=True):
    """Kernel launches of ``calls`` train_batch calls of a model with
    config ``cfg``: per layer and micro-batch the flash forward twice
    (remat recomputes it in the backward, under ``dots_saveable`` too: the
    kernel is no matrix product to the dispatcher) and each backward
    kernel once (the delta kernel beside dQ, biased or not), then fused
    Adam once per call (``adam``; 0 for an optimizer that does not run
    B3).  A layer with ALiBi slopes or a window
    > 0 takes the biased kernels; the others -- GPT-Neo's global layers,
    window 0, among them -- the unbiased ones, which compute the same
    values.  Every other kernel launches 0 times."""
    windows = cfg.local_attn_pattern or (0,) * cfg.n_layers
    biased = sum(1 for w in windows if cfg.use_alibi or w > 0)
    dense = cfg.n_layers - biased
    n = gas * calls
    want = {name: 0 for name in _counted() if not name.endswith("_plain")}
    want.update({"flash_attention_fwd": 2 * dense * n,
                 "flash_attention_bwd_dq": dense * n,
                 "flash_attention_bwd_dkv": dense * n,
                 "flash_attention_fwd_biased": 2 * biased * n,
                 "flash_attention_bwd_dq_biased": biased * n,
                 "flash_attention_bwd_dkv_biased": biased * n,
                 "flash_attention_bwd_delta": cfg.n_layers * n,
                 "fused_adam": calls if adam else 0})
    return want


def check_train_launches(counts, cfg, gas, calls, where, adam=True):
    """Fails unless every kernel launched exactly :func:`train_launches`
    times and no plain version ran."""
    want = train_launches(cfg, gas, calls, adam)
    got = {k: counts[k] for k in want}
    if got != want:
        fail(f"{where}: kernel launches {got}, expected {want} "
             f"({cfg.n_layers} layers x gas {gas} x {calls} train_batch "
             f"calls)")
    if plain_calls(counts):
        fail(f"{where}: plain versions ran: {plain_calls(counts)}")
    return {k: v for k, v in got.items() if v}


def phase_train(name):
    """A training main path: run_benchmark(model) -> initialize ->
    train_batch for TRAIN_MODELS[name], full width and depth, micro
    TRAIN_BATCH x gas TRAIN_GAS, counters read around it.  Returns the
    benchmark's results (with the peak device memory), the counts and the
    kernels launched."""
    import torch
    from deepspeed_tpu_torch.benchmarks.training import (model_config,
                                                         run_benchmark)
    model, seq, vocab_size = TRAIN_MODELS[name]
    cfg = model_config(model, seq, vocab_size=vocab_size)
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    out = run_benchmark(model, batch=TRAIN_BATCH, gas=TRAIN_GAS, seq=seq,
                        steps=TRAIN_STEPS, vocab_size=vocab_size)
    counts = read_counters()
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    _free()
    if not all(math.isfinite(x) for x in out["losses"]):
        fail(f"train {name}: non-finite loss {out['losses']}")
    launched = check_train_launches(counts, cfg, TRAIN_GAS, TRAIN_STEPS + 1,
                                    f"run_benchmark({name})")
    return out, counts, launched


def phase_train_fixed(name):
    """TRAIN_MODELS[name] through initialize(...).train_batch on ONE fixed
    batch: the loss must fall.  Then one step timed on the wall clock and
    one profiled (device time by kernel)."""
    import numpy as np
    import torch
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.benchmarks.training import (ds_config,
                                                         model_config)
    from deepspeed_tpu_torch.models.transformer import CausalTransformerLM
    model, seq, vocab_size = TRAIN_MODELS[name]
    cfg = model_config(model, seq, vocab_size=vocab_size)
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=CausalTransformerLM(cfg, device="cuda").init(1),
        config=ds_config(TRAIN_BATCH, TRAIN_GAS))
    batch = {"input_ids": np.random.default_rng(11).integers(
        0, cfg.vocab_size, (TRAIN_GAS, TRAIN_BATCH, seq))}
    reset_counters()
    losses = [float(engine.train_batch(batch=batch))
              for _ in range(FIXED_STEPS)]
    check_train_launches(read_counters(), cfg, TRAIN_GAS, FIXED_STEPS,
                         f"fixed batch {name}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail(f"fixed batch {name}: losses {losses} are not finite and "
             f"falling")
    torch.cuda.synchronize()
    t0 = time.time()
    engine.train_batch(batch=batch)
    torch.cuda.synchronize()
    step_ms = (time.time() - t0) * 1e3
    device_ms, top, _ = profile_device(
        lambda: engine.train_batch(batch=batch), 1)
    del engine
    _free()
    return losses, step_ms, device_ms, top


def phase_train_fp16_cli():
    """The slice's main path: ``python -m deepspeed_tpu_torch.benchmarks
    .training --model gpt_1b --batch 2 --gas 4 --seq 1024 --dtype fp16``
    with WarmupDecayLR and the loss scale starting at 2**FP16_SCALE_POWER,
    through the CLI's ``main`` (its printout captured), counters read
    around it.  Exact launches; at least one skipped and three applied
    steps."""
    import contextlib
    import io
    import torch
    from deepspeed_tpu_torch.benchmarks.training import main, model_config
    cfg = model_config(TRAIN_MODEL, TRAIN_SEQ)
    argv = ["--model", TRAIN_MODEL, "--batch", str(TRAIN_BATCH), "--gas",
            str(TRAIN_GAS), "--seq", str(TRAIN_SEQ), "--dtype", "fp16",
            "--steps", str(FP16_STEPS - 1), "--scheduler", FP16_SCHEDULER,
            "--initial-scale-power", str(FP16_SCALE_POWER), "--json"]
    torch.cuda.reset_peak_memory_stats()
    buf = io.StringIO()
    reset_counters()
    with contextlib.redirect_stdout(buf):
        out = main(argv)
    counts = read_counters()
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    _free()
    phase("train", f"ds_bench train {' '.join(argv)}: "
          f"{buf.getvalue().strip()}")
    if not all(math.isfinite(x) for x in out["losses"]):
        fail(f"fp16 {TRAIN_MODEL}: non-finite loss {out['losses']}")
    skipped = out["skipped_steps"]
    if skipped < 1 or FP16_STEPS - skipped < 3:
        fail(f"fp16 {TRAIN_MODEL}: {skipped} of {FP16_STEPS} steps skipped;"
             f" at least 1 skipped and 3 applied are required")
    launched = check_train_launches(counts, cfg, TRAIN_GAS, FP16_STEPS,
                                    f"ds_bench train --dtype fp16 "
                                    f"({TRAIN_MODEL})")
    return out, counts, launched


def cli_label(model=None, policy=None):
    """How the smoke names a ``ds_bench train`` run: "(no flags)" or its
    ``--model`` and ``--remat-policy`` flags."""
    flags = (f"--model {model}" if model else "") + \
        (f" --remat-policy {policy}" if policy else "")
    return flags.strip() or "(no flags)"


class _LogLines:
    """Collects the port logger's messages while in a ``with``."""

    def __enter__(self):
        import logging

        class Handler(logging.Handler):
            def emit(h, record):
                self.lines.append(record.getMessage())
        self.lines, self.handler = [], Handler()
        self.logger = logging.getLogger("deepspeed_tpu_torch")
        self.logger.addHandler(self.handler)
        return self

    def __exit__(self, *exc):
        self.logger.removeHandler(self.handler)


def phase_train_cli(model=None, timers=False, policy=None):
    """A training main path as a user runs it: ``python -m
    deepspeed_tpu_torch.benchmarks.training`` with no flags (gpt_350m,
    the D=64 flash forms) or with ``--model model`` alone (gpt_760m,
    gpt_2_7b: the D=96 and D=80 forms), or with ``--remat-policy policy``
    too, through the CLI's ``main`` (its
    printout captured), counters read around it, at full width and depth.
    The printout must show the CLI's defaults (CLI_DEFAULTS, the model
    replaced) and the model's head dim CLI_HEAD_DIMS; exact launches,
    plain versions 0, finite losses; the peak device memory is recorded.
    Then one train_batch of the same config timed on the wall clock and
    one profiled (a fresh engine from the same seed, after the CLI's is
    freed): the busy share.  ``timers``: that engine with
    ``steps_per_print`` 1 and ``wall_clock_breakdown`` on (phase (d)):
    its profiled train_batch (the third: the first that logs) must log
    the throughput line, a three-call step after it the fwd / bwd / step
    line, and its device time stay within CLI_DEVICE_MS times
    TIMER_DEVICE_FACTOR.  Last, that engine's train_batch profiled again
    under the other remat policy (``dots_saveable`` / ``nothing_saveable``,
    the model's config switched in place): {policy: (device ms, peak GB
    of that train_batch)} for both."""
    import contextlib
    import dataclasses
    import io
    import numpy as np
    import torch
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.benchmarks.training import (ds_config, main,
                                                         model_config)
    from deepspeed_tpu_torch.models.transformer import CausalTransformerLM
    d = dict(CLI_DEFAULTS, **({"model": model} if model else {}))
    label = cli_label(model, policy)
    this = policy or CLI_POLICY
    cfg = model_config(d["model"], d["seq"], remat_policy=this)
    torch.cuda.reset_peak_memory_stats()
    buf = io.StringIO()
    reset_counters()
    with contextlib.redirect_stdout(buf):
        out = main((["--model", model] if model else []) +
                   (["--remat-policy", policy] if policy else []))
    counts = read_counters()
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    _free()
    phase("train", f"ds_bench train {label}: " +
          " | ".join(buf.getvalue().split()))
    got = {k: out[k] for k in d}
    want_d = CLI_HEAD_DIMS[d["model"]]
    if got != d or out["dtype"] != "bf16" or cfg.head_dim != want_d or \
            out["remat_policy"] != this:
        fail(f"ds_bench train {label}: {got}, {out['dtype']}, head dim "
             f"{cfg.head_dim}, {out['remat_policy']}: expected {d}, bf16, "
             f"{want_d}, {this}")
    if not all(math.isfinite(x) for x in out["losses"]):
        fail(f"ds_bench train {label}: non-finite loss {out['losses']}")
    launched = check_train_launches(counts, cfg, d["gas"], d["steps"] + 1,
                                    f"ds_bench train {label}")
    conf = ds_config(d["batch"], d["gas"])
    if timers:
        conf.update(steps_per_print=1, wall_clock_breakdown=True)
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=CausalTransformerLM(cfg, device="cuda").init(0), config=conf)
    batch = {"input_ids": np.random.default_rng(14).integers(
        0, cfg.vocab_size, (d["batch"], d["seq"]))}
    engine.train_batch(batch=batch)
    torch.cuda.synchronize()
    t0 = time.time()
    engine.train_batch(batch=batch)
    torch.cuda.synchronize()
    step_ms = (time.time() - t0) * 1e3
    with _LogLines() as log:
        torch.cuda.reset_peak_memory_stats()
        device_ms, top, _ = profile_device(
            lambda: engine.train_batch(batch=batch), 1)
        policies = {this: (device_ms, torch.cuda.max_memory_allocated() / 1e9)}
        if timers:
            engine.backward(engine.forward(batch))
            engine.step()
    if timers:
        tput = [x for x in log.lines if "epoch=0/micro_step=3/global_step=3, "
                "RunningAvgSamplesPerSec=" in x]
        wall = [x for x in log.lines if "time (ms) | fwd: " in x and
                " | bwd: " in x and " | step: " in x]
        limit = CLI_DEVICE_MS * TIMER_DEVICE_FACTOR
        if len(tput) != 1 or len(wall) != 1 or device_ms > limit:
            fail(f"ds_bench train {label} with the timers on: throughput "
                 f"lines {tput}, breakdown lines {wall}, device "
                 f"{device_ms:.1f} ms (limit {limit:.1f}): expected one "
                 f"of each line within the limit")
        phase("train", f"{d['model']} with steps_per_print 1 and "
              f"wall_clock_breakdown: the third train_batch logged "
              f"'{tput[0]}', a forward / backward / step '{wall[0]}'; "
              f"device {device_ms:.1f} ms a train_batch (before the "
              f"timers {CLI_DEVICE_MS}, limit {limit:.1f})")
    other = "nothing_saveable" if this == CLI_POLICY else CLI_POLICY
    engine.module.config = dataclasses.replace(engine.module.config,
                                               remat_policy=other)
    torch.cuda.reset_peak_memory_stats()
    other_ms, _, _ = profile_device(lambda: engine.train_batch(batch=batch),
                                    1)
    policies[other] = (other_ms, torch.cuda.max_memory_allocated() / 1e9)
    del engine
    _free()
    return out, counts, launched, step_ms, device_ms, top, policies


def phase_train_fixed_fp16():
    """gpt_1b in fp16 (the CLI's config) on ONE fixed batch: skips while
    the loss scale comes down, then the loss must fall over the applied
    steps.  Per step (read on the host, outside the engine's step): the
    loss, whether it was skipped, the scale.  Then one step timed on the
    wall clock and one profiled, as for bf16."""
    import numpy as np
    import torch
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.benchmarks.training import (ds_config,
                                                         model_config,
                                                         scheduler_config)
    from deepspeed_tpu_torch.models.transformer import CausalTransformerLM
    cfg = model_config(TRAIN_MODEL, TRAIN_SEQ)
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=CausalTransformerLM(cfg, device="cuda").init(1),
        config=ds_config(TRAIN_BATCH, TRAIN_GAS, "fp16",
                         scheduler=scheduler_config(FP16_SCHEDULER,
                                                    FP16_STEPS),
                         initial_scale_power=FP16_SCALE_POWER))
    batch = {"input_ids": np.random.default_rng(11).integers(
        0, cfg.vocab_size, (TRAIN_GAS, TRAIN_BATCH, TRAIN_SEQ))}
    reset_counters()
    losses, skips, scales = [], [], []
    for _ in range(FP16_STEPS):
        losses.append(float(engine.train_batch(batch=batch)))
        skips.append(engine.last_step_overflowed())
        scales.append(engine.get_loss_scale())
    check_train_launches(read_counters(), cfg, TRAIN_GAS, FP16_STEPS,
                         f"fixed batch fp16 {TRAIN_MODEL}")
    applied = [x for x, s in zip(losses, skips) if not s]
    if not any(skips) or len(applied) < 3 or \
            not all(np.isfinite(losses)) or not applied[-1] < applied[0]:
        fail(f"fixed batch fp16 {TRAIN_MODEL}: losses {losses}, skipped "
             f"{skips}: need a skip, 3 applied steps and a falling loss "
             f"over them")
    torch.cuda.synchronize()
    t0 = time.time()
    engine.train_batch(batch=batch)
    torch.cuda.synchronize()
    step_ms = (time.time() - t0) * 1e3
    device_ms, top, _ = profile_device(
        lambda: engine.train_batch(batch=batch), 1)
    del engine
    _free()
    return losses, skips, scales, step_ms, device_ms, top


# ---- phase train-a6a7: activation checkpointing and the rest of the
# optimizers (A6, A7) ----------------------------------------------------
# (a) the extra CLI run: gpt_350m under --remat-policy nothing_saveable,
# the policy every CLI run had before the CLI honoured dots_saveable.
# Between it and the no-flags run the first loss must be equal (the same
# forward), the final grad norms within A6A7_NORM_REL_TOL (phase 7's 1e-3:
# only what is kept differs) and the launches equal and exact.
A6A7_POLICY = "nothing_saveable"
A6A7_NORM_REL_TOL = 1e-3
# (b) gpt_1b with bf16 moments and bf16 gradients, through the CLI as
# typed and then A6A7_STEPS steps on one fixed batch (the loss must fall)
A6A7_BF16_ARGV = ["--model", TRAIN_MODEL, "--batch", str(TRAIN_BATCH),
                  "--gas", str(TRAIN_GAS), "--moment-dtype", "bfloat16",
                  "--grad-accum-dtype", "bfloat16", "--steps", "3"]
A6A7_STEPS = 4
# (c) the other optimizers on gpt_350m (the CLI's model and micro-batch)
# at full width and depth, A6A7_STEPS steps each on one fixed batch from
# one model build: label -> (the config's optimizer block, or None for a
# client torch.optim.SGD at the lr given, momentum 0.9; the B3 form it
# runs, or None).  The lrs are each rule's own scale for a loss that
# falls within 4 steps: LAMB's step is lr times each leaf's norm, SGD's
# and Adagrad's (initial accumulator 0.1) lr times the gradient, which is
# small at init; 1-bit Adam's the Adam lr of the CLI.
A6A7_OPTIMIZERS = {
    "LAMB lr 1e-3": ({"type": "Lamb", "params": {"lr": 1e-3}}, None),
    "SGD lr 1e-1 momentum 0.9": ({"type": "SGD", "params": {
        "lr": 1e-1, "momentum": 0.9}}, None),
    "Adagrad lr 1e-2": ({"type": "Adagrad", "params": {"lr": 1e-2}}, None),
    "1-bit Adam lr 1e-4 freeze_step 2, bf16 moments": (
        {"type": "OneBitAdam", "params": {"lr": 1e-4, "freeze_step": 2,
                                          "moment_dtype": "bfloat16"}},
        ("float32", "bfloat16")),
    "client torch.optim.SGD lr 1e-1 momentum 0.9": (1e-1, None),
}
# (d) 2 layers of gpt_1b at full width, kernels vs plain by phase 7's
# rules: label -> (config blocks, the B3 form or None)
A6A7_E2E = {
    "AdamW bf16 moments, bf16 gradients": (
        {"optimizer": {"type": "AdamW", "params": {
            "lr": E2E_LR, "moment_dtype": "bfloat16"}},
         "data_types": {"grad_accum_dtype": "bfloat16"}},
        ("bfloat16", "bfloat16")),
    "AdamW bf16 gradients": (
        {"data_types": {"grad_accum_dtype": "bfloat16"}},
        ("bfloat16", "float32")),
    "LAMB": ({"optimizer": {"type": "Lamb", "params": {"lr": 1e-3}}}, None),
}
# (f) a user block through activation_checkpointing.checkpoint: x ->
# attention(x wq, x wk, x wv) wo + tanh(x w1) w2, bf16, on the flash
# kernels, at B=2 S=512, 8 heads of 64
CKPT_BLOCK = dict(B=2, S=512, H=8, D=64)


def check_cli_policies(dots, nothing):
    """(a): the no-flags run and the nothing_saveable run, each (record,
    counts): equal first loss, final grad norms within A6A7_NORM_REL_TOL,
    equal launches."""
    (d_out, d_counts), (n_out, n_counts) = dots, nothing
    rel = abs(d_out["grad_norm"] - n_out["grad_norm"]) / n_out["grad_norm"]
    kernels = {k: v for k, v in d_counts.items() if not k.endswith("_plain")}
    if d_out["losses"][0] != n_out["losses"][0] or \
            rel > A6A7_NORM_REL_TOL or \
            kernels != {k: n_counts[k] for k in kernels}:
        fail(f"ds_bench train under {CLI_POLICY} vs {A6A7_POLICY}: first "
             f"losses {d_out['losses'][0]} vs {n_out['losses'][0]}, grad "
             f"norms {d_out['grad_norm']} vs {n_out['grad_norm']} (rel "
             f"{rel:.2e}, tol {A6A7_NORM_REL_TOL}), launches {kernels} vs "
             f"{n_counts}")
    return rel


def phase_train_bf16_state():
    """(b): ``ds_bench train`` as typed with A6A7_BF16_ARGV (gpt_1b, bf16
    moments and gradients) through the CLI's ``main``, counters read
    around it: exact launches, B3's in its <bf16 g, bf16 M> form, the
    record's moment_dtype and grad_accum_dtype; then the same config on
    one fixed batch for A6A7_STEPS steps: the loss falls, m and v are
    bf16, the gradients bf16.  Returns (record, its launches, the fixed
    run's losses and peak GB, launches of B3 in all)."""
    import contextlib
    import io
    import numpy as np
    import torch
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.benchmarks.training import (ds_config, main,
                                                         model_config)
    from deepspeed_tpu_torch.models.transformer import CausalTransformerLM
    cfg = model_config(TRAIN_MODEL, TRAIN_SEQ)
    torch.cuda.reset_peak_memory_stats()
    buf = io.StringIO()
    reset_counters()
    with contextlib.redirect_stdout(buf):
        out = main(A6A7_BF16_ARGV + ["--json"])
    counts = read_counters()
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    _free()
    phase("train-a6a7", f"(b) ds_bench train {' '.join(A6A7_BF16_ARGV)}: "
          f"{buf.getvalue().strip()}")
    if out.get("moment_dtype") != "bfloat16" or \
            out.get("grad_accum_dtype") != "bfloat16" or \
            not all(math.isfinite(x) for x in out["losses"]):
        fail(f"(b) ds_bench train bf16 state: record {out}")
    launched = check_train_launches(counts, cfg, TRAIN_GAS,
                                    len(out["losses"]), "(b) ds_bench train "
                                    "--moment-dtype bfloat16")
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=CausalTransformerLM(cfg, device="cuda").init(1),
        config=ds_config(TRAIN_BATCH, TRAIN_GAS, moment_dtype="bfloat16",
                         grad_accum_dtype="bfloat16"))
    if (engine.opt_state.m.dtype, engine.opt_state.v.dtype,
            engine.grads.dtype) != (torch.bfloat16,) * 3:
        fail(f"(b) m, v, gradients are {engine.opt_state.m.dtype}, "
             f"{engine.opt_state.v.dtype}, {engine.grads.dtype}: expected "
             f"bf16")
    batch = {"input_ids": np.random.default_rng(11).integers(
        0, cfg.vocab_size, (TRAIN_GAS, TRAIN_BATCH, TRAIN_SEQ))}
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    losses = [float(engine.train_batch(batch=batch))
              for _ in range(A6A7_STEPS)]
    fixed_counts = read_counters()
    peak = torch.cuda.max_memory_allocated() / 1e9
    check_train_launches(fixed_counts, cfg, TRAIN_GAS, A6A7_STEPS,
                         "(b) bf16 state fixed batch")
    del engine
    _free()
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail(f"(b) bf16 state fixed batch: losses {losses} are not finite "
             f"and falling")
    return (out, launched, losses, peak,
            counts["fused_adam"] + fixed_counts["fused_adam"])


def phase_train_optimizers():
    """(c): each of A6A7_OPTIMIZERS on gpt_350m at full width and depth,
    A6A7_STEPS steps on one fixed batch, the module's weights reset to one
    init before each engine: the loss finite and falling, B1 and B2
    launches exact, B3's as the rule runs it.  Returns {label: losses}
    and B3's launches by form."""
    import functools
    import numpy as np
    import torch
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.benchmarks.training import (ds_config,
                                                         model_config)
    from deepspeed_tpu_torch.models.transformer import CausalTransformerLM
    d = CLI_DEFAULTS
    cfg = model_config(d["model"], d["seq"])
    model = CausalTransformerLM(cfg, device="cuda").init(0)
    init = {n: p.detach().clone() for n, p in model.named_parameters()}
    batch = {"input_ids": np.random.default_rng(15).integers(
        0, cfg.vocab_size, (d["batch"], d["seq"]))}
    losses, forms = {}, {}
    for label, (block, form) in A6A7_OPTIMIZERS.items():
        with torch.no_grad():
            for n, p in model.named_parameters():
                p.data = init[n].clone()
        conf = ds_config(d["batch"], d["gas"])
        client = None
        if isinstance(block, dict):
            conf["optimizer"] = block
        else:
            del conf["optimizer"]
            client = functools.partial(torch.optim.SGD, lr=block,
                                       momentum=0.9)
        engine, *_ = deepspeed_tpu_torch.initialize(model=model, config=conf,
                                                    optimizer=client)
        reset_counters()
        got = [float(engine.train_batch(batch=batch))
               for _ in range(A6A7_STEPS)]
        counts = read_counters()
        check_train_launches(counts, cfg, d["gas"], A6A7_STEPS,
                             f"(c) {label}", adam=form is not None)
        if form is not None:
            forms[form] = forms.get(form, 0) + counts["fused_adam"]
            m_dtype = engine.opt_state.inner.m.dtype
            if str(m_dtype).split(".")[-1] != form[1]:
                fail(f"(c) {label}: moments {m_dtype}, expected {form[1]}")
        del engine
        _free()
        if not all(np.isfinite(got)) or not got[-1] < got[0]:
            fail(f"(c) {label}: losses {got} are not finite and falling")
        losses[label] = got
        phase("train-a6a7", f"(c) {label}: gpt_350m {cfg.n_layers} layers, "
              f"micro {d['batch']} x seq {d['seq']}, {A6A7_STEPS} steps on "
              f"a fixed batch: losses {[round(x, 4) for x in got]} "
              f"(falling); B1, B2 launches exact, B3 "
              f"{counts['fused_adam']}")
    del model, init
    _free()
    return losses, forms


def phase_checkpoint_block():
    """(f): a user block through ``activation_checkpointing.checkpoint``
    under ``dots_saveable`` on the card (bf16, the flash kernels): its
    output and the gradients of its input and weights equal to the direct
    call's, bit for bit."""
    import torch
    from deepspeed_tpu_torch.ops.attention import attention
    from deepspeed_tpu_torch.runtime.activation_checkpointing import \
        checkpointing
    c = CKPT_BLOCK
    B, S, H, D = c["B"], c["S"], c["H"], c["D"]
    gen = torch.Generator(device="cuda").manual_seed(31)
    d = H * D
    x0 = torch.randn(B, S, d, generator=gen, device="cuda",
                     dtype=torch.bfloat16)
    ws = [(torch.randn(d, d, generator=gen, device="cuda") / math.sqrt(d))
          .to(torch.bfloat16) for _ in range(6)]

    def block(x, wq, wk, wv, wo, w1, w2):
        q, k, v = (torch.matmul(x, w).view(B, S, H, D)
                   for w in (wq, wk, wv))
        a = attention(q, k, v, causal=True).reshape(B, S, d)
        return a @ wo + torch.tanh(x @ w1) @ w2

    outs = []
    for via in (False, True):
        args = [t.clone().requires_grad_(True) for t in [x0] + ws]
        checkpointing.configure(policy="dots_saveable")
        try:
            y = checkpointing.checkpoint(block, *args) if via else \
                block(*args)
        finally:
            checkpointing.configure(policy="nothing_saveable")
        y.float().square().sum().backward()
        outs.append([y.detach()] + [a.grad for a in args])
    same = [torch.equal(a, b) for a, b in zip(*outs)]
    if not all(same):
        diff = max((a.float() - b.float()).abs().max().item()
                   for a, b in zip(*outs))
        fail(f"(f) checkpointing.checkpoint under dots_saveable: output and "
             f"gradients equal to the direct call's {same}, max abs diff "
             f"{diff:.3e}")
    phase("train-a6a7", f"(f) a user block (3 projections, flash "
          f"attention, a tanh MLP; bf16 B={B} S={S} {H}x{D}) through "
          f"activation_checkpointing.checkpoint under dots_saveable: output "
          f"and the 7 gradients bit for bit the direct call's")


def phase_train_gemma():
    """The Gemma-2B shape's training path (GEMMA_TRAIN): initialize ->
    train_batch, one warm-up call and TRAIN_STEPS timed ones on fresh
    random batches (as run_benchmark times them), then FIXED_STEPS on one
    fixed batch (the loss must fall), one step on the wall clock and one
    profiled; counters read around the first two runs, which must launch
    exactly :func:`train_launches` and no plain version.  Prints the run
    and returns {"counts": the launches of both runs, "fused_adam": its
    launches}."""
    import numpy as np
    import torch
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.benchmarks.training import (H100_PEAK_TFLOPS,
                                                         ds_config)
    from deepspeed_tpu_torch.models.transformer import (CausalTransformerLM,
                                                        TransformerConfig)
    cfg = TransformerConfig(**GEMMA_TRAIN)
    n, seq = cfg.num_params(), GEMMA_TRAIN_SEQ
    if cfg.head_dim != 256 or n != GEMMA_PARAMS["Gemma-2B"]:
        fail(f"Gemma-2B training shape: head dim {cfg.head_dim}, {n} "
             f"parameters")
    _free()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=scale_embedding(CausalTransformerLM(cfg, device="cuda").init(0)),
        config=ds_config(TRAIN_BATCH, TRAIN_GAS))
    torch.cuda.synchronize()
    t_init = time.time() - t0
    rng = np.random.default_rng(0)
    shape = (TRAIN_GAS, TRAIN_BATCH, seq)

    def batch():
        return {"input_ids": rng.integers(0, cfg.vocab_size, shape)}

    reset_counters()
    losses = [engine.train_batch(batch=batch())]          # warm-up
    torch.cuda.synchronize()
    t0 = time.time()
    for _ in range(TRAIN_STEPS):
        losses.append(engine.train_batch(batch=batch()))
    torch.cuda.synchronize()
    dt = time.time() - t0
    counts = read_counters()
    losses = [float(x) for x in losses]
    launched = check_train_launches(counts, cfg, TRAIN_GAS, TRAIN_STEPS + 1,
                                    "Gemma-2B train_batch")
    if not all(math.isfinite(x) for x in losses):
        fail(f"Gemma-2B training: non-finite loss {losses}")
    peak = torch.cuda.max_memory_allocated() / 1e9
    tps = TRAIN_GAS * TRAIN_BATCH * seq * TRAIN_STEPS / dt
    tflops = 6.0 * n * tps / 1e12
    phase("train", f"Gemma-2B shape ({cfg.n_layers} layers, {cfg.n_heads}/"
          f"{cfg.kv_heads} heads of {cfg.head_dim}, vocab {cfg.vocab_size}, "
          f"{n / 1e9:.3f} B params) through initialize(...).train_batch: "
          f"micro {TRAIN_BATCH} x gas {TRAIN_GAS} x seq {seq}, bf16, AdamW "
          f"lr 1e-4, remat; init {t_init:.1f} s; {dt * 1e3 / TRAIN_STEPS:.1f}"
          f" ms per train_batch, {tps:.1f} tokens/s, {tflops:.2f} TFLOP/s, "
          f"MFU {tflops / H100_PEAK_TFLOPS:.4f} of 989 TFLOP/s; peak memory "
          f"{peak:.1f} GB; losses {[round(x, 4) for x in losses]}")
    phase("train", f"launches in {TRAIN_STEPS + 1} Gemma-2B train_batch "
          f"calls: {launched}; every other kernel 0, plain versions 0")
    fixed = {"input_ids": np.random.default_rng(11).integers(
        0, cfg.vocab_size, shape)}
    reset_counters()
    f_losses = [float(engine.train_batch(batch=fixed))
                for _ in range(FIXED_STEPS)]
    f_counts = read_counters()
    check_train_launches(f_counts, cfg, TRAIN_GAS, FIXED_STEPS,
                         "Gemma-2B fixed batch")
    if not all(np.isfinite(f_losses)) or not f_losses[-1] < f_losses[0]:
        fail(f"Gemma-2B fixed batch: losses {f_losses} are not finite and "
             f"falling")
    torch.cuda.synchronize()
    t0 = time.time()
    engine.train_batch(batch=fixed)
    torch.cuda.synchronize()
    step_ms = (time.time() - t0) * 1e3
    device_ms, top, _ = profile_device(
        lambda: engine.train_batch(batch=fixed), 1)
    peak = torch.cuda.max_memory_allocated() / 1e9
    phase("train", f"Gemma-2B fixed batch, {FIXED_STEPS} steps: losses "
          f"{[round(x, 4) for x in f_losses]} (falling); one train_batch "
          f"{step_ms:.1f} ms wall, device {device_ms:.1f} ms (profiler), "
          f"busy share {device_ms / step_ms:.3f}; peak memory over the "
          f"phase {peak:.1f} GB")
    for kname, k_ms in top:
        phase("train", f"  Gemma-2B device ms/train_batch {k_ms:.3f}  "
              f"{kname[:90]}")
    del engine
    _free()
    both = {k: counts[k] + f_counts[k] for k in counts}
    return {"counts": both, "fused_adam": both["fused_adam"]}


def phase_train_fixed_plain(name, kernel_losses):
    """The fixed batch of :func:`phase_train_fixed` again, at full width and
    depth, from the same init, through an engine that runs the plain
    versions of attention and Adam: a witness of the kernels' trajectory.
    Each loss must lie within FIXED_PLAIN_REL_TOL of the kernels'."""
    import numpy as np
    from deepspeed_tpu_torch.benchmarks.training import (ds_config,
                                                         model_config)
    from deepspeed_tpu_torch.models.transformer import CausalTransformerLM
    from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
    from deepspeed_tpu_torch.runtime.engine import DeepSpeedEngine
    model, seq, vocab_size = TRAIN_MODELS[name]
    cfg = model_config(model, seq, vocab_size=vocab_size)
    engine = DeepSpeedEngine(CausalTransformerLM(cfg, device="cuda").init(1),
                             DeepSpeedConfig(ds_config(TRAIN_BATCH,
                                                       TRAIN_GAS)),
                             backend="plain")
    batch = {"input_ids": np.random.default_rng(11).integers(
        0, cfg.vocab_size, (TRAIN_GAS, TRAIN_BATCH, seq))}
    reset_counters()
    losses = [float(engine.train_batch(batch=batch))
              for _ in range(FIXED_STEPS)]
    counts = read_counters()
    del engine
    _free()
    launched = {k: v for k, v in counts.items()
                if not k.endswith("_plain") and v}
    if launched:
        fail(f"fixed batch {name} plain: kernels launched {launched}")
    rel = max(abs(a - b) / abs(b) for a, b in zip(kernel_losses, losses))
    if not all(np.isfinite(losses)) or rel > FIXED_PLAIN_REL_TOL:
        fail(f"fixed batch {name}: plain versions' losses {losses} vs the "
             f"kernels' {kernel_losses} (max rel {rel:.3e}, tol "
             f"{FIXED_PLAIN_REL_TOL})")
    return losses, rel


def phase_train_e2e(name=TRAIN_MODEL, bf16=True, steps=2, witness=False,
                    cfg=None, seq=None, blocks=None, adam=True):
    """TRAIN_MODELS[name] (or the config ``cfg``, named ``name``, at seq
    ``seq``) at full width and its own seq, cut to its first
    2 layers (GPT-Neo: one global and one local layer), micro 2, gas 2,
    bf16 (or fp32): one engine through the kernels and one through the
    plain versions of attention and Adam, from one init, on the same
    batches.  Held: losses and the first grad norm; m after each step (see
    E2E_M_REL_TOL); the update after the last step; the key bias's moves.
    With ``witness`` a third engine runs the plain versions over the same
    batches split as micro 1 x gas 4, and its m is compared with the
    micro 2 x gas 2 plain engine's, step by step (see
    E2E_WITNESS_FACTOR).  ``blocks``: config blocks over
    ``benchmarks.training.ds_config``'s (another optimizer, bf16 moments or
    gradients); ``adam``: whether the optimizer launches B3."""
    import dataclasses
    import numpy as np
    import torch
    from deepspeed_tpu_torch.benchmarks.training import (ds_config,
                                                         model_config)
    from deepspeed_tpu_torch.models.transformer import CausalTransformerLM
    from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
    from deepspeed_tpu_torch.runtime.engine import DeepSpeedEngine
    if cfg is None:
        model, seq, vocab_size = _train_model(name)
        cfg = model_config(model, seq, vocab_size=vocab_size)
    cfg = dataclasses.replace(cfg, n_layers=2, local_attn_pattern=(
        cfg.local_attn_pattern[:2] if cfg.local_attn_pattern else None))
    rng = np.random.default_rng(12)
    batches = [{"input_ids": rng.integers(0, cfg.vocab_size, (2, 2, seq))}
               for _ in range(steps)]
    runs = [("cuda", 2, 2), ("plain", 2, 2)] + (
        [("plain", 1, 4)] if witness else [])
    res, state, init = {}, {}, None
    for backend, micro, gas in runs:
        conf = dict(ds_config(micro, gas), **(blocks or {}))
        if not bf16:
            del conf["bf16"]
        engine = DeepSpeedEngine(
            scale_embedding(CausalTransformerLM(cfg, device="cuda").init(5)),
            DeepSpeedConfig(conf), backend=backend)
        if init is None:
            init = engine.master.clone()
        elif not torch.equal(engine.master, init):
            fail("train e2e: the engines start from different weights")
        losses, norms, moments = [], [], []
        reset_counters()
        for b in batches:
            ids = b["input_ids"].reshape(gas, micro, seq)
            losses.append(float(engine.train_batch(batch={"input_ids": ids})))
            norms.append(engine.get_global_grad_norm())
            moments.append(engine.opt_state.m.to(torch.float32, copy=True))
        if backend == "cuda":
            counts = read_counters()
            check_train_launches(counts, cfg, gas, steps,
                                 f"train e2e {name} 2 layers", adam=adam)
        res[backend, micro] = (losses, norms)
        state[backend, micro] = (engine.master.clone(), moments)
        names, sizes = zip(*[(n, p.numel())
                             for n, p in engine.module.named_parameters()])
        del engine
        _free()
    (lk, nk), (lp, n_p) = res["cuda", 2], res["plain", 2]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(lk, lp))
    norm_rel = abs(nk[0] - n_p[0]) / abs(n_p[0])
    label = f"{name} {'bf16' if bf16 else 'fp32'}"
    if not np.isfinite(lk + nk).all() or loss_rel > E2E_TRAIN_REL_TOL or \
            norm_rel > E2E_TRAIN_REL_TOL:
        fail(f"train e2e {label}: kernels {lk} / norm {nk[0]} vs plain {lp} "
             f"/ norm {n_p[0]} (tol {E2E_TRAIN_REL_TOL} relative)")

    def worst(a, b):
        """Largest ||a - b|| / ||b|| over the parameters whose gradient is
        not 0 in exact arithmetic, and its name."""
        rels = [((x - y).norm() / y.norm()).item() if not
                n.endswith(ZERO_GRAD) else 0.0
                for n, x, y in zip(names, a.split(sizes), b.split(sizes))]
        i = max(range(len(rels)), key=rels.__getitem__)
        return rels[i], names[i]

    (mk, mom_k), (mp, mom_p) = state["cuda", 2], state["plain", 2]
    if not (torch.isfinite(mk).all() and torch.isfinite(mom_k[-1]).all()):
        fail(f"train e2e {label}: the kernels' master or m is not finite")
    for n, xk, xp, x0 in zip(names, mk.split(sizes), mp.split(sizes),
                             init.split(sizes)):
        moved = max((xk - x0).abs().max().item(),
                    (xp - x0).abs().max().item())
        if n.endswith(ZERO_GRAD) and moved > 1.5 * E2E_LR * steps:
            fail(f"train e2e {label}: {n} moved {moved:.3e}, more than "
                 f"Adam's {steps} steps of lr {E2E_LR} allow")
    m_rels = [worst(a, b) for a, b in zip(mom_k, mom_p)]
    upd_rel = worst(mk - init, mp - init)
    master_err = (mk - mp).abs().max().item()
    m_tol = E2E_M_REL_TOL if bf16 else E2E_FP32_M_REL_TOL
    witness_rels = None
    if witness:
        mw, mom_w = state["plain", 1]
        if not (torch.isfinite(mw).all() and torch.isfinite(mom_w[-1]).all()):
            fail(f"train e2e {label}: the witness's master or m is not "
                 f"finite")
        witness_rels = [worst(a, b) for a, b in zip(mom_w, mom_p)]
    # m's limit by step: m_tol, but after the first step of a bf16 run with
    # unscaled logits E2E_WITNESS_FACTOR times the witness's gap
    m_tols = [m_tol] * steps
    if bf16 and cfg.attn_scale == 1.0:
        if not witness:
            fail(f"train e2e {label}: unscaled logits in bf16 need the "
                 f"witness to hold m after step 1")
        m_tols[1:] = [E2E_WITNESS_FACTOR * w for w, _ in witness_rels[1:]]
    if any(r > t for (r, _), t in zip(m_rels, m_tols)) or \
            upd_rel[0] > E2E_UPDATE_REL_TOL:
        fail(f"train e2e {label}: m differs by {m_rels} (relative L2, worst "
             f"parameter, by step; tol {m_tols}), the update after {steps} "
             f"steps by {upd_rel[0]:.3e} in {upd_rel[1]} (tol "
             f"{E2E_UPDATE_REL_TOL})")
    return dict(label=label, lk=lk, lp=lp, nk=nk[0], n_p=n_p[0],
                loss_rel=loss_rel, norm_rel=norm_rel, m_rels=m_rels,
                m_tols=m_tols, upd_rel=upd_rel, master_err=master_err,
                witness_rels=witness_rels, counts=counts)


def phase_train_e2e_fp16(name=TRAIN_MODEL, seq=TRAIN_SEQ,
                         steps=FP16_E2E_STEPS, cfg=None):
    """``name`` (gpt_1b; gpt_350m at head dim 64; or the config ``cfg``,
    named ``name``) at full width and seq ``seq``, cut to 2 layers, micro
    2 x gas 2, in fp16 with
    the CLI's loss scaling and WarmupDecayLR: one engine through the
    kernels, one through the plain versions, from one init, on the same
    batches.  Held exactly: the skip pattern and the loss scale after every
    step (any step where the two disagree on overflow is named); the first
    step skipped; at least 3 applied.  Held to the bf16 limits: the losses,
    the first applied step's grad norm, m after each applied step, the
    update after the last step."""
    import dataclasses
    import numpy as np
    import torch
    from deepspeed_tpu_torch.benchmarks.training import (ds_config,
                                                         model_config,
                                                         scheduler_config)
    from deepspeed_tpu_torch.models.transformer import CausalTransformerLM
    from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
    from deepspeed_tpu_torch.runtime.engine import DeepSpeedEngine
    cfg = dataclasses.replace(cfg or model_config(name, seq), n_layers=2)
    rng = np.random.default_rng(13)
    batches = [{"input_ids": rng.integers(0, cfg.vocab_size, (2, 2, seq))}
               for _ in range(steps)]
    conf = ds_config(2, 2, "fp16",
                     scheduler=scheduler_config(FP16_SCHEDULER, steps),
                     initial_scale_power=FP16_E2E_SCALE_POWER)
    def worst(a, b):
        rels = [((x - y).norm() / y.norm()).item()
                for x, y in zip(a.split(sizes), b.split(sizes))]
        i = max(range(len(rels)), key=rels.__getitem__)
        return rels[i], names[i]

    # the kernel engine's m after each applied step waits on the host (a
    # 2-layer Gemma-2B shape's is 3 GB); the plain engine's is compared
    # with it as each step ends: the entry is (rel L2, parameter)
    runs, init = {}, None
    for backend in ("cuda", "plain"):
        engine = DeepSpeedEngine(
            scale_embedding(CausalTransformerLM(cfg, device="cuda").init(5)),
            DeepSpeedConfig(conf), backend=backend)
        names, sizes = zip(*[(n, p.numel())
                             for n, p in engine.module.named_parameters()])
        if init is None:
            init = engine.master.clone()
        elif not torch.equal(engine.master, init):
            fail("train e2e fp16: the engines start from different weights")
        rec = dict(losses=[], skips=[], scales=[], norms=[], m=[])
        reset_counters()
        for i, b in enumerate(batches):
            rec["losses"].append(float(engine.train_batch(batch=b)))
            rec["skips"].append(engine.last_step_overflowed())
            rec["scales"].append(engine.get_loss_scale())
            rec["norms"].append(engine.get_global_grad_norm())
            m = None
            if not rec["skips"][-1] and backend == "cuda":
                m = engine.opt_state.m.to("cpu", copy=True)
            elif not rec["skips"][-1] and runs["cuda"]["m"][i] is not None:
                m = worst(runs["cuda"]["m"][i].to(engine.opt_state.m.device),
                          engine.opt_state.m)
            rec["m"].append(m)
        rec["master"] = engine.master.clone()
        if backend == "cuda":
            rec["counts"] = read_counters()
            check_train_launches(rec["counts"], cfg, 2, steps,
                                 f"train e2e fp16 {name} 2 layers")
        runs[backend] = rec
        del engine
        _free()
    k, p = runs["cuda"], runs["plain"]
    differ = [i for i in range(steps) if k["skips"][i] != p["skips"][i]]
    if differ:
        fail(f"train e2e fp16 {name}: kernels and plain disagree on "
             f"overflow at steps {differ}: kernels {k['skips']}, plain "
             f"{p['skips']}")
    if k["scales"] != p["scales"]:
        fail(f"train e2e fp16 {name}: loss scales {k['scales']} vs plain "
             f"{p['scales']}")
    applied = [i for i, s in enumerate(k["skips"]) if not s]
    if not k["skips"][0] or len(applied) < 3:
        fail(f"train e2e fp16 {name}: skip pattern {k['skips']}: the first "
             f"step must overflow and 3 or more must apply")
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(k["losses"],
                                                       p["losses"]))
    first = applied[0]
    norm_rel = abs(k["norms"][first] - p["norms"][first]) / \
        abs(p["norms"][first])

    m_rels = [p["m"][i] for i in applied]
    upd_rel = worst(k["master"] - init, p["master"] - init)
    if not np.isfinite(k["losses"]).all() or loss_rel > E2E_TRAIN_REL_TOL \
            or norm_rel > E2E_TRAIN_REL_TOL or \
            any(r > E2E_M_REL_TOL for r, _ in m_rels) or \
            upd_rel[0] > E2E_UPDATE_REL_TOL:
        fail(f"train e2e fp16 {name}: losses {k['losses']} vs plain "
             f"{p['losses']} "
             f"(max rel {loss_rel:.2e}), grad norm rel {norm_rel:.2e} (tol "
             f"{E2E_TRAIN_REL_TOL}); m by applied step {m_rels} (tol "
             f"{E2E_M_REL_TOL}); update {upd_rel} (tol {E2E_UPDATE_REL_TOL})")
    return dict(k=k, p=p, applied=applied, loss_rel=loss_rel,
                norm_rel=norm_rel, m_rels=m_rels, upd_rel=upd_rel)


def backward_factors(called_ms, pair_ms, sdpa_bwd_ms):
    """B2 against the one library call that computes the same function --
    SDPA's backward, which returns dQ, dK and dV together: the backward as
    the training path calls it (delta, dQ, dK/dV, a group's sum and cast)
    and the pair of kernels dQ + dK/dV, each over SDPA's time."""
    return {"called": called_ms / sdpa_bwd_ms, "pair": pair_ms / sdpa_bwd_ms}


def flash_timing(errs, B, S, H, Hkv, D, gen):
    """B1 and B2 (dQ, dK/dV) at one causal training shape [B, S, H (Hkv),
    D] in bf16 and in fp16: kernel, plain version, library call (SDPA in
    the same dtype) and bound, by CUDA-graph replay over 4 rotating input
    sets (more than the 50 MB L2); and the backward as the training path
    calls it (``flash_attention_bwd_cuda``) and the pair dQ + dK/dV, each
    against SDPA's backward (:func:`backward_factors`).  Returns {kernel:
    row} for bf16 and {(kernel, "fp16"): row} for fp16, the kernels named
    with d_suffix(D)."""
    import torch
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops.cuda.flash_attention import (
        dkv_sums_group, flash_attention_bwd_cuda,
        flash_attention_bwd_dkv_cuda, flash_attention_bwd_dq_cuda,
        flash_attention_fwd_cuda)
    from deepspeed_tpu_torch.ops.flash_attention import (
        flash_attention_bwd_plain, flash_attention_fwd_plain)
    c = 4
    scale = 1.0 / math.sqrt(D)
    flops = {"fwd": 2 * B * H * S * S * D, "dq": 3 * B * H * S * S * D,
             "dkv": 4 * B * H * S * S * D}
    # each input read once, each output written once in the function's
    # dtype: O and dQ like q; dK and dV like k, at Hkv heads (where the
    # kernel writes fp32 per query head, that is its own layout, not the
    # function's)
    e, ekv, f4 = B * S * H * D * 2, B * S * Hkv * D * 2, B * H * S * 4
    nbytes = {"fwd": 2 * e + 2 * ekv + f4, "dq": 3 * e + 2 * ekv + 2 * f4,
              "dkv": 2 * e + 4 * ekv + 2 * f4}
    res = {}
    for dt in (torch.bfloat16, torch.float16):
        dn = str(dt).split(".")[-1]
        q, do = (_rand((c, B, S, H, D), dt, gen) for _ in range(2))
        k, v = (_rand((c, B, S, Hkv, D), dt, gen) for _ in range(2))
        outs = [flash_attention_fwd_cuda(q[i], k[i], v[i], scale) for i in
                range(c)]
        o = torch.stack([x[0] for x in outs])
        lse = torch.stack([x[1] for x in outs])
        delta = (do.float() * o.float()).sum(-1).transpose(2, 3).contiguous()
        # library yardstick: SDPA in [B, H, S, D], forward and backward;
        # a GQA group's kv heads repeated for it (made before the timing)
        qt, kt, vt, dot = (x.transpose(2, 3).contiguous()
                           for x in (q, k, v, do))
        if H != Hkv:
            kt, vt = (x.repeat_interleave(H // Hkv, 2) for x in (kt, vt))
        leaves = [[x[i].clone().requires_grad_() for x in (qt, kt, vt)]
                  for i in range(c)]

        def sdpa_fwd_bwd(i):
            a, b_, v_ = leaves[i]
            out = F.scaled_dot_product_attention(a, b_, v_, is_causal=True)
            torch.autograd.grad(out, (a, b_, v_), dot[i])

        fwd_ms = graph_ms(lambda i: flash_attention_fwd_cuda(
            q[i], k[i], v[i], scale), c)
        plain_fwd_ms = graph_ms(lambda i: flash_attention_fwd_plain(
            q[i], k[i], v[i], scale), c, reps=PLAIN_REPS)
        plain_bwd_ms = graph_ms(lambda i: flash_attention_bwd_plain(
            q[i], k[i], v[i], o[i], lse[i], do[i], scale), c,
            reps=PLAIN_REPS)
        lib_fwd_ms = graph_ms(lambda i: F.scaled_dot_product_attention(
            qt[i], kt[i], vt[i], is_causal=True), c)
        lib_bwd_ms = graph_ms(sdpa_fwd_bwd, c) - lib_fwd_ms
        dq_ms = graph_ms(lambda i: flash_attention_bwd_dq_cuda(
            q[i], k[i], v[i], do[i], lse[i], delta[i], scale), c)
        dkv_ms = graph_ms(lambda i: flash_attention_bwd_dkv_cuda(
            q[i], k[i], v[i], do[i], lse[i], delta[i], scale), c)
        pair_ms = graph_ms(lambda i: (
            flash_attention_bwd_dq_cuda(q[i], k[i], v[i], do[i], lse[i],
                                        delta[i], scale),
            flash_attention_bwd_dkv_cuda(q[i], k[i], v[i], do[i], lse[i],
                                         delta[i], scale)), c)
        called_ms = graph_ms(lambda i: flash_attention_bwd_cuda(
            q[i], k[i], v[i], o[i], lse[i], do[i], scale), c)
        shape = f"B={B} S={S} H={H}/{Hkv} D={D} causal {dn}"
        f = backward_factors(called_ms, pair_ms, lib_bwd_ms)
        glue = ", group sum and cast" if H != Hkv and \
            not dkv_sums_group(D, dt) else ""
        phase("timing", f"B2 backward as called [{shape}]: "
              f"flash_attention_bwd_cuda {called_ms:.4f} ms (delta, dQ, "
              f"dK/dV{glue}) = "
              f"{f['called']:.2f}x SDPA's backward {lib_bwd_ms:.4f} ms; "
              f"pair dQ + dK/dV {pair_ms:.4f} ms (dQ {dq_ms:.4f}, dK/dV "
              f"{dkv_ms:.4f}) = {f['pair']:.2f}x")
        for base, key, ms, plain_ms, lib_ms in (
                ("flash_attention_fwd", "fwd", fwd_ms, plain_fwd_ms,
                 lib_fwd_ms),
                ("flash_attention_bwd_dq", "dq", dq_ms, plain_bwd_ms,
                 lib_bwd_ms),
                ("flash_attention_bwd_dkv", "dkv", dkv_ms, plain_bwd_ms,
                 lib_bwd_ms)):
            name = base + d_suffix(D)
            bound_ms, bound_by = _bound(nbytes[key], flops[key], dn)
            row = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                       bound_ms=bound_ms, bound_by=bound_by, shape=shape,
                       max_abs_err=errs[(name, dn)])
            res[name if dt == torch.bfloat16 else (name, "fp16")] = row
        del q, k, v, do, o, lse, delta, qt, kt, vt, dot, leaves, outs
        _free()
    for base in ("flash_attention_fwd", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv"):
        name = base + d_suffix(D)
        phase("timing", f"{name}: fp16 {res[(name, 'fp16')]['ms']:.4f} ms "
              f"vs bf16 {res[name]['ms']:.4f} ms "
              f"({res[(name, 'fp16')]['ms'] / res[name]['ms']:.3f}x); "
              f"SDPA fp16 {res[(name, 'fp16')]['library_ms']:.4f} ms")
    for key, r in res.items():
        name = key if isinstance(key, str) else f"{key[0]} {key[1]}"
        # B2's kernels are each half of the library call's function: their
        # factor is the pair's, printed above
        versus = (f", {r['ms'] / r['library_ms']:.2f}x the library's time"
                  if name.startswith("flash_attention_fwd") else "")
        phase("timing", f"{name} [{r['shape']}]: device ms kernel "
              f"{r['ms']:.4f}, plain {r['plain_ms']:.4f}, library "
              f"{r['library_ms']:.4f}; bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}), {r['bound_ms'] / r['ms']:.3f} of "
              f"bound{versus}")
    return res


def phase_train_timing(errs):
    """B1, B2 (dQ, dK/dV) and B3 at the training paths' shapes: attention
    at gpt_1b's (B=2 S=1024 16 heads of 128 causal), at the ds_bench
    train CLI models' (B=8 S=1024): gpt_350m's 16 heads of 64, gpt_760m's
    16 of 96, gpt_2_7b's 32 of 80, and at Gemma-2B's (B=2 S=2048 8 heads
    of 256 over one kv head), each in bf16 and fp16
    (:func:`flash_timing`); Adam over gpt_1b's parameter count (held
    against its plain version there first, then timed with its skip flag 0
    and 1; ms-scale, so by CUDA events, eagerly): kernel, plain version,
    library call and bound.  Returns {kernel: row} for bf16 and {(kernel,
    "fp16"): row} for fp16."""
    import torch
    from deepspeed_tpu_torch.benchmarks.training import model_config
    from deepspeed_tpu_torch.ops.adam import (AdamState, adam_hyper,
                                              fused_adam, reference_impl)
    from deepspeed_tpu_torch.ops.cuda.fused_adam import fused_adam_cuda
    cfg = model_config(TRAIN_MODEL, TRAIN_SEQ)
    gen = torch.Generator(device="cuda").manual_seed(77)
    res = flash_timing(errs, TRAIN_BATCH, TRAIN_SEQ, cfg.n_heads,
                       cfg.kv_heads, cfg.head_dim, gen)
    d = CLI_DEFAULTS
    for model in CLI_HEAD_DIMS:       # gpt_350m, gpt_760m, gpt_2_7b
        c = model_config(model, d["seq"])
        res.update(flash_timing(errs, d["batch"], d["seq"], c.n_heads,
                                c.kv_heads, c.head_dim, gen))
    g = GEMMA_TRAIN
    res.update(flash_timing(errs, TRAIN_BATCH, GEMMA_TRAIN_SEQ,
                            g["n_heads"], g["n_kv_heads"], 256, gen))

    # B3 over gpt_1b's flat fp32 buffers (28 bytes per parameter), first
    # held against its plain version at this n, from the same inputs
    n = cfg.num_params()
    p = torch.randn(n, generator=gen, device="cuda") * 0.02
    g = torch.randn(n, generator=gen, device="cuda") * 1e-3
    m = torch.randn(n, generator=gen, device="cuda") * 1e-4
    v = torch.rand(n, generator=gen, device="cuda") * 1e-6
    kw = dict(beta2=0.999, eps=1e-8, weight_decay=0.01, adamw_mode=True)
    count = torch.zeros((), dtype=torch.int32, device="cuda")
    hyper = adam_hyper(count, 1e-4, 0.9, 0.999)
    ref = [t.clone() for t in (p, m, v)]
    fused_adam(p, g, AdamState(m, v, count.clone()), hyper, backend="cuda",
               **kw)
    reference_impl(ref[0], g, AdamState(ref[1], ref[2], count.clone()),
                   hyper, **kw)
    adam_err = check_adam(f"fused_adam n={n} ({TRAIN_MODEL}) g=float32 "
                          f"adamw=True bias_correction=True", (p, m, v), ref)
    del ref
    _free()
    # timed from zero moments, as training starts: m and v then follow g;
    # then with the skip flag set (an fp16 overflow: nothing is moved)
    m.zero_()
    v.zero_()
    flags = [torch.full((), f, dtype=torch.int32, device="cuda")
             for f in (0, 1)]
    ms = time_ms(lambda i: fused_adam_cuda(p, g, m, v, hyper, flags[0],
                                           count, **kw), iters=5, warmup=1)
    skip_ms = time_ms(lambda i: fused_adam_cuda(p, g, m, v, hyper,
                                                flags[1], count, **kw),
                      iters=5, warmup=1)
    plain_ms = time_ms(lambda i: reference_impl(
        p, g, AdamState(m, v, count.clone()), hyper, **kw), iters=3,
        warmup=1)
    steps = [torch.ones((), device="cuda")]
    lib_ms = time_ms(lambda i: torch._fused_adamw_(
        [p], [g], [m], [v], [], steps, lr=1e-4, beta1=0.9, beta2=0.999,
        weight_decay=0.01, eps=1e-8, amsgrad=False, maximize=False),
        iters=5, warmup=1)
    if not torch.isfinite(p).all():
        fail("fused Adam timing: parameters not finite")
    bound_ms, bound_by = _bound(28 * n, 20 * n, "float32")
    res["fused_adam"] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                             bound_ms=bound_ms, bound_by=bound_by,
                             skip_ms=skip_ms,
                             shape=f"n={n} fp32 p/g/m/v AdamW, scalars "
                                   f"from the card",
                             max_abs_err=max(adam_err,
                                             errs[("fused_adam", "float32")]))
    del p, g, m, v
    _free()
    r = res["fused_adam"]
    phase("timing", f"fused_adam [{r['shape']}]: device ms kernel "
          f"{r['ms']:.4f}, plain {r['plain_ms']:.4f}, library "
          f"{r['library_ms']:.4f}; bound {r['bound_ms']:.4f} ms "
          f"({r['bound_by']}), {r['bound_ms'] / r['ms']:.3f} of bound")
    phase("timing", f"fused_adam with its skip flag set: {skip_ms:.4f} ms "
          f"(nothing read or written)")
    for form in ADAM_NEW_FORMS:
        res[adam_form_name(*form)] = time_adam_form(*form, n, gen)
    return res


def time_adam_form(g_name, m_name, n, gen):
    """B3's <g_name g, m_name M> form over ``n`` parameters (gpt_1b's):
    first held bit for bit to its plain version on one step, then timed
    by CUDA events -- kernel, plain version -- from zero moments, as
    training starts.  The library call: ``torch._fused_adamw_`` takes
    neither bf16 moments nor stochastic rounding, so the bf16-moment forms
    have none; with fp32 moments it is timed on the bf16 gradients when it
    takes them, else there is none.  Bound: p read and written (8 B), g
    read, m and v read and written, by parameter."""
    import torch
    from deepspeed_tpu_torch.ops.adam import (AdamState, adam_hyper,
                                              fused_adam, reference_impl)
    from deepspeed_tpu_torch.ops.cuda.fused_adam import fused_adam_cuda
    g_dtype, m_dtype = getattr(torch, g_name), getattr(torch, m_name)
    name = adam_form_name(g_name, m_name)
    kw = dict(beta2=0.999, eps=1e-8, weight_decay=0.01, adamw_mode=True)
    p = torch.randn(n, generator=gen, device="cuda") * 0.02
    g = (torch.randn(n, generator=gen, device="cuda") * 1e-3).to(g_dtype)
    m = (torch.randn(n, generator=gen, device="cuda") * 1e-4).to(m_dtype)
    v = (torch.rand(n, generator=gen, device="cuda") * 1e-6).to(m_dtype)
    count = torch.zeros((), dtype=torch.int32, device="cuda")
    hyper = adam_hyper(count, 1e-4, 0.9, 0.999)
    ref = [t.clone() for t in (p, m, v)]
    fused_adam(p, g, AdamState(m, v, count.clone()), hyper, backend="cuda",
               **kw)
    reference_impl(ref[0], g, AdamState(ref[1], ref[2], count.clone()),
                   hyper, **kw)
    if not all(torch.equal(a, b) for a, b in zip((p, m, v), ref)):
        fail(f"{name} n={n}: kernel and plain differ")
    del ref
    _free()
    m.zero_()
    v.zero_()
    skip = torch.zeros((), dtype=torch.int32, device="cuda")
    ms = time_ms(lambda i: fused_adam_cuda(p, g, m, v, hyper, skip, count,
                                           **kw), iters=5, warmup=1)
    plain_ms = time_ms(lambda i: reference_impl(
        p, g, AdamState(m, v, count.clone()), hyper, **kw), iters=2,
        warmup=1)
    lib_ms, lib_note = None, "none: no bf16 moments, no stochastic rounding"
    if m_dtype == torch.float32:
        steps = [torch.ones((), device="cuda")]
        try:
            lib_ms = time_ms(lambda i: torch._fused_adamw_(
                [p], [g], [m], [v], [], steps, lr=1e-4, beta1=0.9,
                beta2=0.999, weight_decay=0.01, eps=1e-8, amsgrad=False,
                maximize=False), iters=5, warmup=1)
            lib_note = f"{lib_ms:.4f}"
        except (RuntimeError, TypeError) as exc:
            lib_note = f"none: _fused_adamw_ refuses bf16 gradients ({exc})"
    if not torch.isfinite(p).all():
        fail(f"{name} timing: parameters not finite")
    g_b, m_b = g.element_size(), m.element_size()
    bound_ms, bound_by = _bound((8 + g_b + 4 * m_b) * n, 20 * n, "float32")
    del p, g, m, v
    _free()
    phase("timing", f"{name} [n={n} fp32 p, {g_name} g, {m_name} m/v AdamW]"
          f": device ms kernel {ms:.4f}, plain {plain_ms:.4f}, library "
          f"{lib_note[:160]}; bound {bound_ms:.4f} ms ({bound_by}), "
          f"{bound_ms / ms:.3f} of bound; bit for bit vs plain")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=bound_ms, bound_by=bound_by, max_abs_err=0.0,
                shape=f"n={n} fp32 p, {g_name} g, {m_name} m/v")


# the timing cases at S=2048: (label, ALiBi, window, softmax scale) at
# bf16 B=2 S=2048 16 heads of 128 causal -- BLOOM-1b7's layers, GPT-Neo-
# 1.3B's local layers and its global layers (unscaled logits; no bias: the
# unbiased kernels); the first is the kernels JSON row of the biased ones
BIASED_TIMING = [("ALiBi (bloom_1b7)", True, None, 1.0 / math.sqrt(128)),
                 ("window 256 (gpt_neo_1_3b local)", False, 256, 1.0),
                 ("global (gpt_neo_1_3b)", False, None, 1.0)]
# the same at head dim 64, each case with its model's heads: BLOOM-560m's
# layers (16 heads) and GPT-Neo-125M's local layers (12 heads); the first
# is the kernels JSON row of the biased D=64 forms
BIASED_TIMING_D64 = [("ALiBi (bloom_560m)", True, None, 1.0 / 8.0, 16),
                     ("window 256 (gpt_neo_125m local)", False, 256, 1.0,
                      12)]
# and at head dims 96 and 80 with gpt_760m's and gpt_2_7b's heads: ALiBi,
# the biased forms' heaviest case, and at 256 with Gemma-2B's 8 heads
# (MHA) ALiBi and a window of 256 (off every main path: no model of the
# repo has ALiBi or windows at these head dims; printed, not in the JSON)
BIASED_TIMING_D96 = [("ALiBi (gpt_760m heads)", True, None,
                      1.0 / math.sqrt(96), 16)]
BIASED_TIMING_D80 = [("ALiBi (gpt_2_7b heads)", True, None,
                      1.0 / math.sqrt(80), 32)]
BIASED_TIMING_D256 = [("ALiBi (Gemma-2B heads)", True, None, 1.0 / 16.0, 8),
                      ("window 256 (Gemma-2B heads)", False, 256, 1.0 / 16.0,
                       8)]


def phase_biased_timing(errs, cases=BIASED_TIMING, D=128, seed=78):
    """B1 and B2 (dQ, dK/dV) at the S=2048 training paths' shapes
    (``cases``, 16 heads of ``D`` unless a case names its heads; biased
    kernels where there is a bias, named with d_suffix(D)): kernel, plain
    version, library call and bound.  The library call is SDPA with ALiBi
    as a float ``attn_mask`` (slope * key, -inf above the diagonal), the
    window as a boolean one, or causal.  The bound
    counts the operations of the (q, k) pairs the function must visit
    (causal and in the window), each input read once and each output
    written once.  CUDA-graph replay over 4 rotating input sets."""
    import torch
    import torch.nn.functional as F
    from deepspeed_tpu_torch.models.transformer import alibi_slopes
    from deepspeed_tpu_torch.ops.cuda import flash_attention as fa
    from deepspeed_tpu_torch.ops.flash_attention import (
        flash_attention_bwd_plain, flash_attention_fwd_plain)
    B, S = TRAIN_BATCH, 2048
    dt, c = torch.bfloat16, 4
    gen = torch.Generator(device="cuda").manual_seed(seed)
    pos = torch.arange(S, device="cuda")
    res = {}
    for label, alibi, window, scale, *heads in cases:
        H = heads[0] if heads else 16
        q, k, v, do = (_rand((c, B, S, H, D), dt, gen) for _ in range(4))
        qt, kt, vt, dot = (x.transpose(2, 3).contiguous()
                           for x in (q, k, v, do))
        e, f4 = B * S * H * D * 2, B * H * S * 4
        slopes = alibi_slopes(H).cuda() if alibi else None
        kw = dict(alibi_slopes=slopes, window=window)
        kind = "_biased" if fa.is_biased(slopes, window) else ""
        bkw = kw if kind else {}
        fwd, dq, dkv = (getattr(fa, f"flash_attention_{n}{kind}_cuda")
                        for n in ("fwd", "bwd_dq", "bwd_dkv"))
        outs = [fwd(q[i], k[i], v[i], scale, True, **bkw) for i in range(c)]
        o = torch.stack([x[0] for x in outs])
        lse = torch.stack([x[1] for x in outs])
        delta = (do.float() * o.float()).sum(-1).transpose(2, 3).contiguous()
        allowed = pos[:, None] >= pos[None, :]
        if window:
            allowed &= pos[:, None] - pos[None, :] < window
        pairs = int(allowed.sum())
        if alibi:
            mask = (slopes[:, None, None] * pos.float()[None, None, :]
                    ).masked_fill(~allowed, float("-inf")).to(dt)[None]
        else:
            mask = allowed if window else None
        leaves = [[x[i].clone().requires_grad_() for x in (qt, kt, vt)]
                  for i in range(c)]

        def sdpa_fwd_bwd(i):
            a, b_, v_ = leaves[i]
            out = F.scaled_dot_product_attention(
                a, b_, v_, attn_mask=mask, is_causal=mask is None,
                scale=scale)
            torch.autograd.grad(out, (a, b_, v_), dot[i])

        times = {
            "fwd": graph_ms(lambda i: fwd(q[i], k[i], v[i], scale, True,
                                          **bkw), c),
            "dq": graph_ms(lambda i: dq(q[i], k[i], v[i], do[i], lse[i],
                                        delta[i], scale, True, **bkw), c),
            "dkv": graph_ms(lambda i: dkv(q[i], k[i], v[i], do[i], lse[i],
                                          delta[i], scale, True, **bkw), c)}
        plain_fwd = graph_ms(lambda i: flash_attention_fwd_plain(
            q[i], k[i], v[i], scale, True, **kw), c, reps=PLAIN_REPS)
        plain_bwd = graph_ms(lambda i: flash_attention_bwd_plain(
            q[i], k[i], v[i], o[i], lse[i], do[i], scale, True, **kw), c,
            reps=PLAIN_REPS)
        lib_fwd = graph_ms(lambda i: F.scaled_dot_product_attention(
            qt[i], kt[i], vt[i], attn_mask=mask, is_causal=mask is None,
            scale=scale), c)
        lib_bwd = graph_ms(sdpa_fwd_bwd, c) - lib_fwd
        extra = H * 4 if alibi else 0           # the slopes
        flops = {"fwd": 4 * B * H * pairs * D, "dq": 6 * B * H * pairs * D,
                 "dkv": 8 * B * H * pairs * D}
        nbytes = {"fwd": 4 * e + f4 + extra, "dq": 5 * e + 2 * f4 + extra,
                  "dkv": 6 * e + 2 * f4 + extra}
        for key, plain_ms, lib_ms in (("fwd", plain_fwd, lib_fwd),
                                      ("dq", plain_bwd, lib_bwd),
                                      ("dkv", plain_bwd, lib_bwd)):
            name = f"flash_attention_{'bwd_' if key != 'fwd' else ''}" \
                   f"{key}{kind}{d_suffix(D)}"
            bound_ms, bound_by = _bound(nbytes[key], flops[key], "bfloat16")
            res[(name, label)] = dict(
                ms=times[key], plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=bound_ms, bound_by=bound_by,
                max_abs_err=errs[(name, "bfloat16")],
                shape=f"B={B} S={S} H={H}/{H} D={D} {label}, {pairs} (q, k) "
                      f"pairs, bf16")
        del outs, o, lse, delta, mask, leaves, q, k, v, do, qt, kt, vt, dot
        _free()
    for (name, _), r in res.items():
        phase("timing", f"{name} [{r['shape']}]: device ms kernel "
              f"{r['ms']:.4f}, plain {r['plain_ms']:.4f}, library "
              f"{r['library_ms']:.4f}; bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}), {r['bound_ms'] / r['ms']:.3f} of bound")
    return res


def phase_sparse_timing(err, err16):
    """B6 at the entry point's shapes (SPARSE_PATH in bf16, the first of
    SPARSE_PATH_FP16 in fp16; ``err``, ``err16``: the max abs errors of
    each dtype): the kernel by
    CUDA-graph replay over 4 rotating input sets; the plain version
    eagerly by CUDA events (it expands the layout on the host at every
    call); the library call, SDPA with the expanded layout (and causal)
    mask as a boolean ``attn_mask``; the bound, B * sparse_flops
    operations on q, k, v, o and the two tables moved once."""
    import torch
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops.cuda.sparse_attention import (
        card_steps, layout_tables, sparse_attention_cuda, sparse_flops,
        step_overhead)
    from deepspeed_tpu_torch.ops.sparse_attention import (
        expand_layout_mask, sparse_attention_plain)
    B, S, H = SPARSE_B, SPARSE_S, SPARSE_H
    c = 4
    gen = torch.Generator(device="cuda").manual_seed(79)
    res = {}
    for dt, (kind, block, D) in [(torch.bfloat16, x) for x in SPARSE_PATH] + [
            (torch.float16, SPARSE_PATH_FP16[0])]:
        dn = str(dt).split(".")[-1]
        name = "sparse_attention" + ("_fp16" if dt == torch.float16 else "")
        layout, causal = _sparse_layout(kind, H, block, S)
        q, k, v = (_rand((c, B, S, H, D), dt, gen) for _ in range(3))
        qt, kt, vt = (x.transpose(2, 3).contiguous() for x in (q, k, v))
        mask = torch.as_tensor(expand_layout_mask(layout, block, S),
                               device="cuda")
        if causal:
            mask &= torch.ones((S, S), dtype=torch.bool,
                               device="cuda").tril()
        # the tensor-core kernel's step tables on the card, made once, as
        # SparseSelfAttention keeps them (a host-to-card copy cannot run
        # inside a graph capture)
        steps = card_steps(layout, block, causal, "cuda")
        ms = graph_ms(lambda i: sparse_attention_cuda(
            q[i], k[i], v[i], layout, block, causal=causal, steps=steps),
            c)
        plain_ms = time_ms(lambda i: sparse_attention_plain(
            q[i % c], k[i % c], v[i % c], layout, block, causal=causal),
            iters=3, warmup=1)
        lib_ms = graph_ms(lambda i: F.scaled_dot_product_attention(
            qt[i], kt[i], vt[i], attn_mask=mask), c)
        table, counts, _ = layout_tables(layout, causal)
        flops = B * sparse_flops(layout, block, causal, D)
        nbytes = 4 * B * S * H * D * 2 + table.nbytes + counts.nbytes
        bound_ms, bound_by = _bound(nbytes, flops, dn)
        label = f"{kind} block {block} D={D}"
        res[(name, label)] = dict(
            ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
            bound_by=bound_by,
            max_abs_err=err16 if dt == torch.float16 else err,
            shape=f"B={B} S={S} H={H} {label} causal={causal}, "
                  f"{int(counts.sum())} of {H * (S // block) ** 2} blocks "
                  f"set, steps' union x{step_overhead(layout, block, causal):.3f}"
                  f" of their work, {dn}")
        del q, k, v, qt, kt, vt, mask, steps
        _free()
    for (name, _), r in res.items():
        phase("timing", f"{name} [{r['shape']}]: device ms kernel "
              f"{r['ms']:.4f}, plain {r['plain_ms']:.4f} (eager), library "
              f"{r['library_ms']:.4f}; bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}), {r['bound_ms'] / r['ms']:.3f} of bound")
    return res


# ----------------------------------------------------------------------
# phase ckpt: training that survives a restart (the module docstring's
# "ckpt").  gpt_1b at full width, micro TRAIN_BATCH x gas TRAIN_GAS, seq
# TRAIN_SEQ, bf16, as in phase 7, cut to CKPT_LAYERS of its 18 layers
# since PR 25: a 4.9 GB tag where the full depth's 12.13 GB took the
# phase 150-179 s, and the smoke passed its 1200 s on a slow host (PERF.md
# section 4).
CKPT_LAYERS = 6
CKPT_SAMPLES = 16          # token sequences of the phase's dataset
CKPT_STEPS = 2             # train_batch calls before the save, and after
CKPT_SEED = 21             # the engine's init (the new process: +1)
CKPT_DATA_SEED = 22
CKPT_SMALL_LAYERS = 2
CKPT_DIR = os.path.join(REPO, ".tmp", "ckpt_smoke")   # gitignored
# on disk at once, in bytes per parameter: (a)/(b)/(d) hold the sync tag
# and the async tag (fp32 master, m and v: 12 each) and the universal dir
# (fp32 weights: 4); (c) holds at most 5 tags of the 2-layer model
CKPT_FULL_BYTES = 2 * 12 + 4
CKPT_SMALL_TAGS = 5
CKPT_DISK_MARGIN = 1.1
CKPT_CHILD_TIMEOUT = 600


def ckpt_disk_need(n_params, n_params_small):
    """Bytes the phase needs free: the larger of its two stages' peaks,
    with a 10% margin."""
    return int(CKPT_DISK_MARGIN * max(CKPT_FULL_BYTES * n_params,
                                      CKPT_SMALL_TAGS * 12 * n_params_small))


def check_disk(free, need, where):
    if free < need:
        fail(f"phase ckpt needs {need / 1e9:.1f} GB free under {where}, "
             f"the disk has {free / 1e9:.1f} GB")


def ckpt_resume_launches(cfg):
    """The kernel launches of the resumed run: phase 7's formula for
    CKPT_STEPS train_batch calls."""
    return train_launches(cfg, TRAIN_GAS, CKPT_STEPS)


def resume_verdict(ref, got, witness_gap):
    """The bitwise / witness rule.  ``ref`` and ``got``: {"losses",
    "norms": [float], "crc": {buffer: crc32}} of the uninterrupted and the
    resumed run.  ``witness_gap``: None when two runs of the same steps in
    one process were bitwise equal, else their largest relative gap in
    loss or grad norm.  Returns (ok, how): bitwise equality when the
    witness was bitwise; else losses and norms within WITNESS_FACTOR times
    the witness's gap (the buffers' crcs cannot be held to a gap)."""
    if witness_gap is None:
        same = (got["losses"] == ref["losses"] and
                got["norms"] == ref["norms"] and got["crc"] == ref["crc"])
        return same, "bitwise"
    gap = max(abs(a - b) / max(abs(b), 1e-30)
              for a, b in zip(got["losses"] + got["norms"],
                              ref["losses"] + ref["norms"]))
    return gap <= WITNESS_FACTOR * witness_gap, \
        f"rel gap {gap:.3e} vs witness {witness_gap:.3e}"


def ckpt_dataset(cfg, seed=CKPT_DATA_SEED, n=CKPT_SAMPLES):
    import numpy as np
    rng = np.random.default_rng(seed)
    return [{"input_ids": rng.integers(0, cfg.vocab_size, cfg.max_seq_len)}
            for _ in range(n)]


def ckpt_engine(cfg, seed, resilience, device="cuda", training_data=None):
    """initialize() on CausalTransformerLM(cfg) (random weights from
    ``seed``), phase 7's bf16 AdamW config plus ``resilience``."""
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.benchmarks.training import ds_config
    from deepspeed_tpu_torch.models.transformer import CausalTransformerLM
    conf = dict(ds_config(TRAIN_BATCH, TRAIN_GAS), resilience=resilience)
    module = CausalTransformerLM(cfg, device=device).init(seed)
    engine, _, loader, _ = dst.initialize(model=module, config=conf,
                                          training_data=training_data,
                                          device=device)
    return engine, loader


def state_crcs(engine):
    from deepspeed_tpu_torch.runtime.resilience import leaf_crc32
    return {"master": leaf_crc32(engine.master),
            "m": leaf_crc32(engine.opt_state.m),
            "v": leaf_crc32(engine.opt_state.v)}


def skipped_iter(engine, dataset, n_micro):
    """A fresh loader over ``dataset`` (the engine's seed), repeating,
    with its first ``n_micro`` micro-batches taken."""
    from deepspeed_tpu_torch.runtime.dataloader import RepeatingLoader
    it = iter(RepeatingLoader(engine.deepspeed_io(dataset)))
    for _ in range(n_micro):
        next(it)
    return it


def ckpt_steps(engine, it, steps=CKPT_STEPS):
    """``steps`` train_batch(data_iter=it) calls: losses and grad norms."""
    losses, norms = [], []
    for _ in range(steps):
        losses.append(float(engine.train_batch(data_iter=it)))
        norms.append(engine.get_global_grad_norm())
    return {"losses": losses, "norms": norms}


def _sync(device):
    import torch
    if str(device).startswith("cuda"):
        torch.cuda.synchronize()


def _spec_cfg(spec):
    from deepspeed_tpu_torch.models.transformer import TransformerConfig
    return TransformerConfig(**spec["cfg"])


def ckpt_child(root):
    """The resumed run, in a new process: build the engine as the parent
    did (other init weights), load ``root/train`` (its latest tag), take a
    fresh loader past the micro-batches the parent used, train CKPT_STEPS
    calls; prints one line "CKPT_CHILD {json}"."""
    with open(os.path.join(root, "child.json")) as f:
        spec = json.load(f)
    cfg, device = _spec_cfg(spec), spec["device"]
    ds = ckpt_dataset(cfg)
    t0 = time.perf_counter()
    engine, loader = ckpt_engine(cfg, CKPT_SEED + 1, {}, device=device,
                                 training_data=ds)
    _sync(device)
    t_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    path, client = engine.load_checkpoint(os.path.join(root, "train"))
    _sync(device)
    t_load = time.perf_counter() - t0
    if path is None:
        fail("ckpt child: nothing to load")
    from deepspeed_tpu_torch.runtime.dataloader import RepeatingLoader
    it = iter(RepeatingLoader(loader))
    for _ in range(CKPT_STEPS * TRAIN_GAS):
        next(it)
    reset_counters()
    run = ckpt_steps(engine, it)
    _sync(device)
    counts = read_counters()
    run.update(crc=state_crcs(engine), counts=counts,
               global_steps=engine.global_steps, client_state=client,
               build_s=t_build, load_s=t_load,
               load_bytes=engine.num_params * 12)
    print("CKPT_CHILD " + json.dumps(run), flush=True)


def _equal_or_gap(a, b):
    """(bitwise equal, max abs difference) of two tensors."""
    import torch
    if torch.equal(a, b):
        return True, 0.0
    return False, float((a.double() - b.double()).abs().max())


def phase_ckpt(cfg, cfg_small, device="cuda", root=CKPT_DIR):
    """Phase ckpt (see the comment above CKPT_SAMPLES).  Returns the
    kernel launch counts of its main paths (the parent's 2 resumed-equal
    steps, the new process's 2 steps, the 2 generates) and its numbers."""
    import shutil
    import subprocess as sp
    import numpy as np
    import torch
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.checkpoint import ds_to_universal
    from deepspeed_tpu_torch.checkpoint import fsck as port_fsck
    from deepspeed_tpu_torch.models.transformer import CausalTransformerLM
    from deepspeed_tpu_torch.runtime.checkpoint_engine import \
        get_checkpoint_engine
    from deepspeed_tpu_torch.runtime.dataloader import RepeatingLoader
    from deepspeed_tpu_torch.runtime.resilience import (
        BAD_MANIFEST, COMMITTED, LEGACY, NO_MARKER, PARTIAL,
        CheckpointCorruptError, TrainingPreempted, validate_tag)
    t_phase = time.time()
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    free = shutil.disk_usage(root).free
    need = ckpt_disk_need(cfg.num_params(), cfg_small.num_params())
    check_disk(free, need, root)
    phase("ckpt", f"free disk {free / 1e9:.1f} GB under {root}, the phase "
          f"needs {need / 1e9:.1f} GB")
    out, launches = {"free_gb": free / 1e9}, {}
    train_dir = os.path.join(root, "train")
    ds = ckpt_dataset(cfg)

    # ---- (a) save with an injected failure, keep training --------------
    res = {"checksum": True, "retry_backoff_secs": 0, "retry_jitter": 0,
           "fault_injection": {"ckpt_save": {"fail_times": 1}}}
    engine, loader = ckpt_engine(cfg, CKPT_SEED, res, device=device,
                                 training_data=ds)
    it = iter(RepeatingLoader(loader))
    ckpt_steps(engine, it)
    engine.save_checkpoint(train_dir)
    tag = f"global_step{CKPT_STEPS}"
    status, manifest = validate_tag(os.path.join(train_dir, tag))
    calls = engine._injector.calls("ckpt_save")
    if status != COMMITTED or calls != 2:
        fail(f"ckpt (a): tag {tag} {status}, ckpt_save called {calls} "
             f"times (expected committed after one injected failure: 2)")
    sync_t = engine.last_checkpoint_timing
    tag_bytes = sum(f["bytes"] for f in manifest["files"])
    phase("ckpt", f"(a) {cfg.n_layers} layers, 2 train_batch calls, "
          f"save_checkpoint -> {tag} committed after 1 injected write "
          f"failure (ckpt_save called {calls} times): {tag_bytes / 1e9:.2f} "
          f"GB, sync engine: staged {sync_t['staged_s']:.2f} s, written "
          f"{sync_t['written_s']:.2f} s, committed {sync_t['committed_s']:.2f}"
          f" s, save_checkpoint returned {sync_t['returned_s']:.2f} s "
          f"({tag_bytes / 1e9 / sync_t['returned_s']:.2f} GB/s)")

    # ---- (b) the same state through the async engine -------------------
    atag = "async_" + tag
    get_checkpoint_engine({"checkpoint": {"engine": "async"}})
    engine.save_checkpoint(train_dir, tag=atag, save_latest=False)
    get_checkpoint_engine({"checkpoint": {"engine": "sync"}})
    async_t = engine.last_checkpoint_timing
    status, amanifest = validate_tag(os.path.join(train_dir, atag))
    if status != COMMITTED or amanifest["leaves"] != manifest["leaves"]:
        fail(f"ckpt (b): async tag {status}; its manifest leaves (with "
             f"crc32) differ from the sync tag's")
    phase("ckpt", f"(b) async engine, the same state: manifest leaves "
          f"(crc32) equal the sync tag's; staged (the engine's save "
          f"returns) {async_t['staged_s']:.2f} s, written "
          f"{async_t['written_s']:.2f} s, committed "
          f"{async_t['committed_s']:.2f} s, save_checkpoint returned "
          f"{async_t['returned_s']:.2f} s "
          f"({tag_bytes / 1e9 / async_t['returned_s']:.2f} GB/s)")

    # the weights the tags hold, in memory, for (d)
    state = engine.module_state_dict()

    # ---- (a) the uninterrupted steps, then the same from the tags ------
    reset_counters()
    ref = ckpt_steps(engine, it)
    _sync(device)
    counts = read_counters()
    check_train_launches(counts, cfg, TRAIN_GAS, CKPT_STEPS,
                         "ckpt (a) uninterrupted steps")
    ref["crc"] = state_crcs(engine)
    ref_state = [engine.master.clone(), engine.opt_state.m.clone(),
                 engine.opt_state.v.clone()]
    launches = {k: v for k, v in counts.items() if not k.endswith("_plain")}

    def from_tag(t):
        """The 2 steps again from tag ``t``: (run, load seconds,
        [(bitwise equal, max abs gap)] of master/m/v vs the
        uninterrupted run's)."""
        t0 = time.perf_counter()
        engine.load_checkpoint(train_dir, tag=t)
        _sync(device)
        dt = time.perf_counter() - t0
        run = ckpt_steps(engine, skipped_iter(engine, ds,
                                              CKPT_STEPS * TRAIN_GAS))
        run["state"] = [engine.master.clone(), engine.opt_state.m.clone(),
                        engine.opt_state.v.clone()]
        return run, dt, [_equal_or_gap(a, b)
                         for a, b in zip(run["state"], ref_state)]

    def same_steps(a, b):
        return a["losses"] == b["losses"] and a["norms"] == b["norms"]

    # the witness: the uninterrupted steps and the same steps from the
    # async tag, two runs from one saved state in one process.  Only if
    # they differ, a third run from the sync tag tells a step that does
    # not repeat (the two loaded runs differ too: the witness's gap) from
    # a load that is not exact (the two loaded runs agree)
    w1, load_s, gaps = from_tag(atag)
    bitwise = same_steps(w1, ref) and all(s_ for s_, _ in gaps)
    witness_gap = None
    if not bitwise:
        w2, _, _ = from_tag(tag)
        wit = [_equal_or_gap(a, b) for a, b in zip(w1["state"],
                                                   w2["state"])]
        if same_steps(w1, w2) and all(s_ for s_, _ in wit):
            fail(f"ckpt (a): both tags load to the same run, which is not "
                 f"the uninterrupted one (master/m/v gaps {gaps})")
        witness_gap = max(abs(a - b) / max(abs(b), 1e-30)
                          for a, b in zip(w1["losses"] + w1["norms"],
                                          w2["losses"] + w2["norms"]))
        gaps = wit
        del w2
    phase("ckpt", f"(a) witness, the uninterrupted steps and the same steps "
          f"from {atag} in one process: "
          f"{'bitwise equal' if bitwise else 'NOT bitwise'} (losses "
          f"{ref['losses']} / {w1['losses']}, master/m/v max abs gap "
          f"{[g for _, g in gaps]}); (b) the async tag loaded in "
          f"{load_s:.2f} s ({tag_bytes / 1e9 / load_s:.2f} GB/s)")
    del w1, ref_state

    # the new process
    with open(os.path.join(root, "child.json"), "w") as f:
        json.dump({"cfg": dataclasses.asdict(cfg), "device": device}, f)
    t0 = time.perf_counter()
    proc = sp.run([sys.executable, os.path.abspath(__file__),
                   "--ckpt-child", root], capture_output=True, text=True,
                  timeout=CKPT_CHILD_TIMEOUT, cwd=REPO)
    t_child = time.perf_counter() - t0
    line = [ln for ln in proc.stdout.splitlines()
            if ln.startswith("CKPT_CHILD ")]
    if proc.returncode != 0 or not line:
        fail(f"ckpt (a): the new process exited {proc.returncode}: "
             f"{proc.stdout[-2000:]} {proc.stderr[-2000:]}")
    child = json.loads(line[-1][len("CKPT_CHILD "):])
    child_launched = check_train_launches(
        child["counts"], cfg, TRAIN_GAS, CKPT_STEPS,
        "ckpt (a) the new process's steps")
    for k in launches:
        launches[k] += child["counts"][k]
    ok, how = resume_verdict(ref, child, witness_gap)
    phase("ckpt", f"(a) new process ({t_child:.1f} s in all; "
          f"load_checkpoint {child['load_s']:.2f} s = "
          f"{tag_bytes / 1e9 / child['load_s']:.2f} GB/s): global_steps "
          f"{child['global_steps']}, losses {child['losses']} vs "
          f"{ref['losses']}, grad norms {child['norms']} vs {ref['norms']}, "
          f"crc32 master/m/v {child['crc']} vs {ref['crc']}: {how}; "
          f"launches {child_launched}, plain versions 0")
    if not ok or child["global_steps"] != 2 * CKPT_STEPS:
        fail(f"ckpt (a): the resumed run differs from the uninterrupted "
             f"one ({how})")
    out.update(tag_gb=tag_bytes / 1e9, sync=sync_t, async_=async_t,
               load_s=load_s, child_load_s=child["load_s"],
               bitwise=bitwise, witness_gap=witness_gap)

    # ---- (d) the trained weights, served from a universal dir ----------
    udir = os.path.join(root, "universal")
    t0 = time.perf_counter()
    ds_to_universal(train_dir, udir, tag=tag)
    t_univ = time.perf_counter() - t0
    u_bytes = sum(os.path.getsize(os.path.join(udir, n))
                  for n in os.listdir(udir))
    del engine, loader
    _free_if(device)
    ids = np.random.default_rng(3).integers(0, cfg.vocab_size, (4, 128))
    toks, b5 = [], []
    for kw in ({"config": {"checkpoint": udir}},
               {"params": state}):
        model = CausalTransformerLM(cfg, device=device,
                                    dtype=torch.bfloat16)
        reset_counters()
        eng = dst.init_inference(model, dtype="bf16", device=device, **kw)
        toks.append(eng.generate(ids, max_new_tokens=32).cpu())
        _sync(device)
        c = read_counters()
        b5.append(c["decode_attention"])
        if plain_calls(c):
            fail(f"ckpt (d): plain versions ran: {plain_calls(c)}")
        del model, eng
        _free_if(device)
    del state
    if not torch.equal(toks[0], toks[1]):
        fail("ckpt (d): greedy tokens from the universal checkpoint differ "
             "from the in-memory weights'")
    want_b5 = cfg.n_layers * 32
    if b5 != [want_b5, want_b5]:
        fail(f"ckpt (d): decode kernel launches {b5}, expected "
             f"{cfg.n_layers} x 32 per generate")
    launches["decode_attention"] = launches.get("decode_attention", 0) + \
        sum(b5)
    phase("ckpt", f"(d) ds_to_universal {tag} -> {u_bytes / 1e9:.2f} GB in "
          f"{t_univ:.1f} s; init_inference(config={{'checkpoint': ...}}, "
          f"bf16).generate B=4 prompt 128 + 32 new: tokens identical to "
          f"init_inference(params=engine.module_state_dict()); decode kernel"
          f" launches {b5} = {cfg.n_layers} x 32 each, plain versions 0")
    shutil.rmtree(root, ignore_errors=True)
    get_checkpoint_engine().release()

    # ---- (c) fallback, corruption, retention, fsck, preemption, restore
    os.makedirs(root)
    small_dir = os.path.join(root, "small")
    ds_small = ckpt_dataset(cfg_small)
    res = {"divergence_sentinel": True, "on_divergence": "restore",
           "fault_injection": {"poison_grads_at": [CKPT_STEPS]},
           "preemption_handler": True, "ckpt_dir": small_dir}
    eng, loader = ckpt_engine(cfg_small, CKPT_SEED, res, device=device,
                              training_data=ds_small)
    it = iter(RepeatingLoader(loader))
    for _ in range(CKPT_STEPS):
        eng.train_batch(data_iter=it)
        eng.save_checkpoint(small_dir)
    good = eng.master.clone()
    loss = float(eng.train_batch(data_iter=it))     # poisoned -> restored
    if eng.global_steps != CKPT_STEPS or not torch.equal(eng.master, good):
        fail(f"ckpt (c): the poisoned step did not roll back to "
             f"global_step{CKPT_STEPS} (global_steps {eng.global_steps})")
    retried = float(eng.train_batch(data_iter=it))
    if not math.isfinite(retried) or math.isfinite(loss):
        fail(f"ckpt (c): poisoned loss {loss}, retried {retried}")
    eng.save_checkpoint(small_dir)                   # global_step3
    newest = f"global_step{CKPT_STEPS + 1}"
    os.remove(os.path.join(small_dir, newest, ".ds_commit"))
    eng.load_checkpoint(small_dir)                   # falls back
    if eng.global_steps != CKPT_STEPS or not torch.equal(eng.master, good):
        fail(f"ckpt (c): load_checkpoint did not fall back from the torn "
             f"{newest} to global_step{CKPT_STEPS}")
    try:
        eng.load_checkpoint(small_dir, tag=newest)
        fail(f"ckpt (c): the torn {newest}, named, loaded")
    except CheckpointCorruptError:
        pass
    eng._preempt.request()
    try:
        eng.train_batch(data_iter=it)
        fail("ckpt (c): a requested preemption did not stop train_batch")
    except TrainingPreempted:
        pass
    emergency = f"emergency_step{CKPT_STEPS}"
    if validate_tag(os.path.join(small_dir, emergency))[0] != COMMITTED:
        fail(f"ckpt (c): no committed {emergency}")
    del eng, loader
    _free_if(device)
    keep_dir = os.path.join(root, "keep")
    eng, loader = ckpt_engine(cfg_small, CKPT_SEED, {"keep_last": 1},
                              device=device, training_data=ds_small)
    it = iter(RepeatingLoader(loader))
    for _ in range(2):
        eng.train_batch(data_iter=it)
        eng.save_checkpoint(keep_dir)
    kept = sorted(os.listdir(keep_dir))
    if kept != ["global_step2", "latest"]:
        fail(f"ckpt (c): keep_last 1 left {kept}")
    del eng, loader
    _free_if(device)
    # fsck over every status: global_step1 edited, emergency truncated, a
    # stale tmp dir, a pre-protocol dir
    gs1 = os.path.join(small_dir, "global_step1")
    with open(os.path.join(gs1, "ds_manifest.json")) as f:
        m = json.load(f)
    m["global_step"] = 999
    with open(os.path.join(gs1, "ds_manifest.json"), "w") as f:
        json.dump(m, f)
    with open(os.path.join(small_dir, emergency, "count.npy"), "r+b") as f:
        f.truncate(8)
    os.makedirs(os.path.join(small_dir, ".crashed.tmp"))
    os.makedirs(os.path.join(small_dir, "legacy"))
    with open(os.path.join(small_dir, "legacy", "state.bin"), "wb") as f:
        f.write(b"old")
    report = port_fsck.fsck(small_dir, deep=True)
    statuses = {t["tag"]: t["status"] for t in report["tags"]}
    want = {"global_step1": BAD_MANIFEST, f"global_step{CKPT_STEPS}":
            COMMITTED, newest: NO_MARKER, emergency: PARTIAL,
            "legacy": LEGACY}
    rc_bad = port_fsck.main([small_dir])
    with open(os.path.join(small_dir, "latest"), "w") as f:
        f.write(f"global_step{CKPT_STEPS}")
    rc_good = port_fsck.main([small_dir])
    if statuses != want or report["stale_tmp_dirs"] != [".crashed.tmp"] or \
            (rc_bad, rc_good) != (1, 0):
        fail(f"ckpt (c): fsck statuses {statuses} (expected {want}), stale "
             f"{report['stale_tmp_dirs']}, exit codes {rc_bad}/{rc_good}")
    shutil.rmtree(root, ignore_errors=True)
    get_checkpoint_engine().release()
    phase("ckpt", f"(c) {cfg_small.n_layers} layers: the poisoned step "
          f"rolled back to global_step{CKPT_STEPS} (loss {loss}), retried "
          f"{retried:.4f}; torn {newest} -> fell back to "
          f"global_step{CKPT_STEPS}, named it raised CheckpointCorruptError;"
          f" keep_last 1 left {kept[0]}; preemption -> {emergency} committed"
          f" and TrainingPreempted; fsck {statuses}, stale "
          f"{report['stale_tmp_dirs']}, exit 1 then 0")
    out["seconds"] = time.time() - t_phase
    phase("ckpt", f"phase time {out['seconds']:.1f} s")
    return launches, out


def _free_if(device):
    if str(device).startswith("cuda"):
        _free()



# ----------------------------------------------------------------------
# phase train-offload: ZeRO-Offload and ZeRO-Infinity's optimizer swap
# (ROADMAP A12, first part).  (a) gpt_350m at the CLI's shape (micro 8,
# seq 1024, bf16, dots_saveable), full depth, from one seed and the same
# batches, with and without offload_optimizer cpu; (b) the same with nvme
# under OFFLOAD_SWAP_DIR; (c) ``ds_bench train --model gpt_2_7b --offload
# cpu`` as typed; (d) a Gemma-7B shape on one card; then the three host
# benches at the JAX package's defaults.
OFFLOAD_MODEL, OFFLOAD_STEPS = CLI_DEFAULTS["model"], 3
OFFLOAD_REL_TOL = E2E_TRAIN_REL_TOL        # phase 7's 1e-3
OFFLOAD_SWAP_DIR = os.path.join(REPO, ".tmp", "offload_swap")
# free disk the nvme run needs: its two fp32 moments with a tenth to spare
OFFLOAD_DISK_FACTOR = 1.1
# cut to 2 timed steps (the CLI's default 10 cost ~25 s more): the
# smoke passed 1000 s (PERF.md section 4)
OFFLOAD_CLI_STEPS = 2
OFFLOAD_CLI_ARGV = ["--model", "gpt_2_7b", "--offload", "cpu", "--steps",
                    str(OFFLOAD_CLI_STEPS)]
# The Gemma-7B shape (GEMMA_7B: 8.54 B parameters, 12 B a parameter of
# fp32 master and moments on the host, 102.5 GB) with per-layer remat,
# bf16 gradients (6 B a parameter on the card), micro 2 x gas 4 x seq
# 2048, GEMMA7_OFFLOAD_STEPS steps (one: the smoke passed 1000 s).
# FEATURES_LAYERS_GEMMA7_OFFLOAD: its depth, cut to what the host's RAM
# holds with 15 GB to spare.  The card's host reads MemTotal 108.4 GB and
# MemAvailable 103.6 GB, but the machine allows a run 96 GiB (103.1 GB):
# at 23 layers (7.15 B, 85.8 GB of master and moments) the run was ended
# for memory; at 20 (6.32 B, 75.9 GB) the whole smoke's process held 13.4
# GB before the run and 89.4 GB after its init, 13.7 GB under the limit;
# 19 layers (6.05 B, 72.6 GB) leave ~17 GB (PERF.md section 4)
FEATURES_LAYERS_GEMMA7_OFFLOAD = 19
GEMMA7_OFFLOAD_STEPS = 1
HOST_BENCHES = (["cpu_adam", "--numel", "50000000"],
                ["aio", "--size-mb", "256"],
                ["offload", "--numel", "100000000"])


def _meminfo():
    """{key: bytes} of /proc/meminfo."""
    out = {}
    with open("/proc/meminfo") as f:
        for line in f:
            key, val = line.split(":", 1)
            parts = val.split()
            out[key] = int(parts[0]) * (1024 if parts[1:] == ["kB"] else 1)
    return out


def _rss_gb():
    """This process's resident set now (VmRSS of /proc/self/status) and
    at its peak (getrusage's maxrss), GB."""
    import resource
    now = None
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                now = int(line.split()[1]) * 1024 / 1e9
    return now, resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * \
        1024 / 1e9


def phase_host():
    """The host's facts, on an early line: CPU model and count, RAM total
    and available, free disk under OFFLOAD_SWAP_DIR's parent, and the host's copy rate (bytes read and
    written by one torch copy of 1 GiB, the best of 3).  Returns them."""
    import shutil
    import torch
    from deepspeed_tpu_torch.ops.host_builder import cpu_model
    os.makedirs(os.path.dirname(OFFLOAD_SWAP_DIR), exist_ok=True)
    mem = _meminfo()
    src = torch.ones(1 << 28)
    dst = torch.empty_like(src)
    dst.copy_(src)
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        dst.copy_(src)
        best = min(best, time.perf_counter() - t0)
    facts = {"cpu": cpu_model(), "cpus": os.cpu_count(),
             "mem_total_gb": mem["MemTotal"] / 1e9,
             "mem_available_gb": mem["MemAvailable"] / 1e9,

             "disk_free_gb": shutil.disk_usage(
                 os.path.dirname(OFFLOAD_SWAP_DIR)).free / 1e9,
             "copy_gbps": 2 * src.numel() * 4 / best / 1e9}
    phase("host", f"{facts['cpu']} | {facts['cpus']} CPUs | MemTotal "
          f"{facts['mem_total_gb']:.1f} GB, MemAvailable "
          f"{facts['mem_available_gb']:.1f} GB | free disk under "
          f"{os.path.dirname(OFFLOAD_SWAP_DIR)}: "
          f"{facts['disk_free_gb']:.1f} GB | host copy "
          f"{facts['copy_gbps']:.1f} GB/s (read + write, 1 GiB)")
    return facts


def _crc(t):
    """crc32 of ``t``'s bytes (a host tensor's read in place)."""
    import zlib
    return zlib.crc32(t.detach().cpu().numpy())


def _offload_run(cfg, conf, batches, label, crc=True):
    """``initialize`` the model of ``cfg`` (seed 0) with ``conf`` and take
    a train_batch per batch, counters read around them.  Returns the
    record: losses, grad norms, counts, host Adam calls, the engine's
    offload facts, the master's crc32 (``crc``) and the peak device GB."""
    import torch
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.transformer import CausalTransformerLM
    from deepspeed_tpu_torch.ops import cpu_adam
    _free()
    torch.cuda.reset_peak_memory_stats()
    rss = [_rss_gb()[0]]
    t0 = time.time()
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=scale_embedding(CausalTransformerLM(cfg, device="cuda")
                              .init(0)), config=conf)
    torch.cuda.synchronize()
    t_init = time.time() - t0
    rss.append(_rss_gb()[0])
    reset_counters()
    cpu_adam.adam_update.calls = 0
    losses, norms, walls = [], [], []
    for b in batches:
        t0 = time.time()
        losses.append(float(engine.train_batch(batch=b)))
        torch.cuda.synchronize()
        walls.append((time.time() - t0) * 1e3)
        norms.append(engine.get_global_grad_norm())
        rss.append(_rss_gb()[0])
    r = {"label": label, "losses": losses, "norms": norms,
         "walls": walls, "counts": read_counters(), "rss_gb": rss,
         "adam_calls": cpu_adam.adam_update.calls, "init_s": t_init,
         "master_crc": _crc(engine.master) if crc else None,
         "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    off = engine._offload
    if off is not None:
        r.update(subgroups=len(off.subgroups),
                 subgroup_updates=off.subgroup_updates,
                 pieces=off.last_step["pieces"], last=dict(off.last_step))
        if off.swapper is not None:
            from deepspeed_tpu_torch.runtime.resilience import validate_tag
            st = off.swapper.store
            r.update(uses_io_uring=st._reader.uses_io_uring(),
                     swap_dir=off.swapper.swap_dir,
                     fsck=validate_tag(off.swapper.swap_dir)[0],
                     store=st.stats())
    if not all(math.isfinite(x) for x in losses):
        fail(f"train-offload {label}: non-finite loss {losses}")
    del engine
    _free()
    return r


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-12)


def phase_offload_vs_device(facts):
    """(a) and (b): gpt_350m at full depth from one seed and the same
    OFFLOAD_STEPS batches on the device path, with offload_optimizer cpu
    and with nvme.  The first loss bit for bit equal; later losses and
    grad norms within OFFLOAD_REL_TOL; B1 / B2 launches exact and equal,
    no B3 under offload, the host Adam once a sub-group a step; the nvme
    master's crc32 the cpu one's.  Returns the three records."""
    import shutil
    import numpy as np
    from deepspeed_tpu_torch.benchmarks.training import (ds_config,
                                                         model_config)
    d = CLI_DEFAULTS
    cfg = model_config(OFFLOAD_MODEL, d["seq"])
    need = OFFLOAD_DISK_FACTOR * 8 * cfg.num_params() / 1e9
    if facts["disk_free_gb"] < need:
        fail(f"train-offload (b): {facts['disk_free_gb']:.1f} GB free "
             f"under {os.path.dirname(OFFLOAD_SWAP_DIR)}, {need:.1f} GB "
             f"needed")
    rng = np.random.default_rng(21)
    batches = [{"input_ids": rng.integers(0, cfg.vocab_size,
                                          (d["batch"], d["seq"]))}
               for _ in range(OFFLOAD_STEPS)]
    shutil.rmtree(OFFLOAD_SWAP_DIR, ignore_errors=True)
    nvme = ds_config(d["batch"], d["gas"], offload="nvme")
    nvme["zero_optimization"]["offload_optimizer"]["nvme_path"] = \
        OFFLOAD_SWAP_DIR
    runs = [_offload_run(cfg, conf, batches, label) for label, conf in (
        ("device", ds_config(d["batch"], d["gas"])),
        ("cpu", ds_config(d["batch"], d["gas"], offload="cpu")),
        ("nvme", nvme))]
    shutil.rmtree(OFFLOAD_SWAP_DIR, ignore_errors=True)
    dev, cpu, nv = runs
    check_train_launches(dev["counts"], cfg, d["gas"], OFFLOAD_STEPS,
                         "train-offload (a) device path")
    for r in (cpu, nv):
        r["launched"] = check_train_launches(
            r["counts"], cfg, d["gas"], OFFLOAD_STEPS,
            f"train-offload {r['label']}", adam=False)
        if r["subgroup_updates"] != OFFLOAD_STEPS * r["subgroups"] or \
                r["adam_calls"] != OFFLOAD_STEPS * r["pieces"]:
            fail(f"train-offload {r['label']}: {r['subgroup_updates']} "
                 f"sub-group updates, {r['adam_calls']} host Adam calls; "
                 f"expected {OFFLOAD_STEPS} x {r['subgroups']} and "
                 f"{OFFLOAD_STEPS} x {r['pieces']}")
    if cpu["losses"][0] != dev["losses"][0]:
        fail(f"train-offload (a): first loss {cpu['losses'][0]!r} under "
             f"offload, {dev['losses'][0]!r} on the device path")
    rels = [max(_rel(a, b), _rel(na, nb)) for a, b, na, nb in zip(
        cpu["losses"], dev["losses"], cpu["norms"], dev["norms"])]
    if max(rels) > OFFLOAD_REL_TOL:
        fail(f"train-offload (a): losses {cpu['losses']} / {dev['losses']},"
             f" grad norms {cpu['norms']} / {dev['norms']}: rel "
             f"{max(rels):.2e} > {OFFLOAD_REL_TOL}")
    if nv["master_crc"] != cpu["master_crc"] or nv["fsck"] != "committed":
        fail(f"train-offload (b): nvme master crc32 {nv['master_crc']:#x} "
             f"vs cpu {cpu['master_crc']:#x}, swap dir fsck {nv['fsck']}")
    phase("train-offload", f"(a) {OFFLOAD_MODEL} {cfg.n_layers} layers, "
          f"{cfg.num_params() / 1e9:.3f} B params, micro {d['batch']} x seq "
          f"{d['seq']}, bf16, {OFFLOAD_STEPS} steps: losses device "
          f"{dev['losses']} vs offload cpu {cpu['losses']} (first bit for "
          f"bit, max rel {max(rels):.2e} with the grad norms, tol "
          f"{OFFLOAD_REL_TOL}); grad norms "
          f"{[round(x, 5) for x in dev['norms']]} / "
          f"{[round(x, 5) for x in cpu['norms']]}; launches "
          f"{cpu['launched']}, as the device path's, B3 "
          f"{dev['counts']['fused_adam']} vs 0; host Adam "
          f"{cpu['adam_calls']} calls ({cpu['subgroups']} sub-group x "
          f"{cpu['pieces']} pieces a step); peak {dev['peak_gb']:.1f} vs "
          f"{cpu['peak_gb']:.1f} GB; train_batch wall ms "
          f"{[round(x, 1) for x in dev['walls']]} vs "
          f"{[round(x, 1) for x in cpu['walls']]}")
    last = cpu["last"]
    phase("train-offload", f"(a) host step of the last call: wall "
          f"{last['wall_s'] * 1e3:.1f} ms, host Adam {last['update_s'] * 1e3:.1f}"
          f" ms, host waits {last['host_wait_s'] * 1e3:.1f} ms; D2H "
          f"{last['d2h_bytes'] / 1e9:.3f} GB in {last['d2h_ms']:.1f} ms "
          f"({last['d2h_gbps']:.1f} GB/s), H2D {last['h2d_bytes'] / 1e9:.3f}"
          f" GB in {last['h2d_ms']:.1f} ms ({last['h2d_gbps']:.1f} GB/s)")
    nl = nv["last"]
    phase("train-offload", f"(b) nvme under {OFFLOAD_SWAP_DIR}: uses_io_uring "
          f"{nv['uses_io_uring']}; master crc32 {nv['master_crc']:#010x} = "
          f"cpu's; swap dir fsck {nv['fsck']}; last step wall "
          f"{nl['wall_s'] * 1e3:.1f} ms, swap read {nl['swap_read_bytes'] / 1e9:.3f}"
          f" GB + written {nl['swap_write_bytes'] / 1e9:.3f} GB, "
          f"{(nl['swap_read_bytes'] + nl['swap_write_bytes']) / nl['wall_s'] / 1e9:.2f}"
          f" GB/s over the host step; train_batch wall ms "
          f"{[round(x, 1) for x in nv['walls']]}")
    return runs


def phase_offload_cli(base, base_dev_ms):
    """(c) ``ds_bench train`` with OFFLOAD_CLI_ARGV, its last train_batch
    profiled: its printout, exact launches without B3,
    its wall and device ms a train_batch, the host step's split and the
    peak device GB, beside phase 7's run of the same command without
    ``--offload`` (``base``: its result; ``base_dev_ms``: its profiled
    train_batch).  Returns (result, counts)."""
    import contextlib
    import io
    import torch
    from deepspeed_tpu_torch.benchmarks.training import main, model_config
    from deepspeed_tpu_torch.runtime.engine import DeepSpeedEngine
    d = dict(CLI_DEFAULTS, model="gpt_2_7b", steps=OFFLOAD_CLI_STEPS)
    cfg = model_config(d["model"], d["seq"])
    calls = d["steps"] + 1
    _free()
    torch.cuda.reset_peak_memory_stats()
    buf = io.StringIO()
    reset_counters()
    real, seen, prof = DeepSpeedEngine.train_batch, [], {}

    def train_batch(engine, *args, **kwargs):
        seen.append(1)
        if len(seen) < calls:
            return real(engine, *args, **kwargs)
        prof["ms"], prof["top"], _ = profile_device(
            lambda: prof.setdefault("loss", real(engine, *args, **kwargs)),
            1)
        return prof["loss"]
    DeepSpeedEngine.train_batch = train_batch
    try:
        with contextlib.redirect_stdout(buf):
            out = main(OFFLOAD_CLI_ARGV)
    finally:
        DeepSpeedEngine.train_batch = real
    counts = read_counters()
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    _free()
    phase("train-offload", f"(c) ds_bench train {' '.join(OFFLOAD_CLI_ARGV)}"
          f": " + " | ".join(buf.getvalue().split()))
    if not all(math.isfinite(x) for x in out["losses"]):
        fail(f"train-offload (c): non-finite loss {out['losses']}")
    check_train_launches(counts, cfg, d["gas"], calls,
                         "train-offload (c)", adam=False)
    last, dev_ms = out["offload_step"], prof["ms"]
    phase("train-offload", f"(c) gpt_2_7b offload cpu: "
          f"{out['ms_per_train_batch']:.1f} ms per train_batch on the wall "
          f"(the last of {calls} calls profiled), device {dev_ms:.1f} ms "
          f"that train_batch, busy share "
          f"{dev_ms / out['ms_per_train_batch']:.3f}; host step of the last "
          f"call {last['wall_s'] * 1e3:.1f} ms: host Adam "
          f"{last['update_s'] * 1e3:.1f} ms, host waits "
          f"{last['host_wait_s'] * 1e3:.1f} ms, D2H {last['d2h_gbps']:.1f} "
          f"GB/s, H2D {last['h2d_gbps']:.1f} GB/s; peak "
          f"{out['peak_gb']:.1f} GB | without --offload (phase 7): "
          f"{base['ms_per_train_batch']:.1f} ms a train_batch, device "
          f"{base_dev_ms:.1f} ms, peak {base['peak_gb']:.1f} GB")
    if out["peak_gb"] > base["peak_gb"] - 25:
        fail(f"train-offload (c): peak {out['peak_gb']:.1f} GB with "
             f"--offload cpu, {base['peak_gb']:.1f} GB without: less than "
             f"25 GB saved")
    for kname, k_ms in prof["top"]:
        phase("train-offload", f"  gpt_2_7b offload device ms/train_batch "
              f"{k_ms:.3f}  {kname[:90]}")
    return out, counts


def phase_offload_gemma(facts):
    """(d) the Gemma-7B shape at FEATURES_LAYERS_GEMMA7_OFFLOAD layers with
    offload_optimizer cpu and bf16 gradients, micro 2 x gas 4 x seq 2048,
    GEMMA7_OFFLOAD_STEPS steps on fresh random batches: finite losses,
    exact B1 / B2 launches and no B3.  Returns the record."""
    import numpy as np
    from deepspeed_tpu_torch.benchmarks.training import ds_config
    from deepspeed_tpu_torch.models.transformer import TransformerConfig
    full = TransformerConfig(**dict(GEMMA_7B, remat=True))
    if full.num_params() != GEMMA_PARAMS["Gemma-7B"] or full.head_dim != 256:
        fail(f"Gemma-7B shape: {full.num_params()} parameters, head dim "
             f"{full.head_dim}")
    cfg = dataclasses.replace(full, n_layers=FEATURES_LAYERS_GEMMA7_OFFLOAD)
    host_gb = 12 * cfg.num_params() / 1e9
    batch, gas = 2, 4
    rng = np.random.default_rng(23)
    batches = [{"input_ids": rng.integers(0, cfg.vocab_size,
                                          (gas, batch, GEMMA_TRAIN_SEQ))}
               for _ in range(GEMMA7_OFFLOAD_STEPS)]
    r = _offload_run(cfg, ds_config(batch, gas, offload="cpu",
                                    grad_accum_dtype="bfloat16"),
                     batches, "Gemma-7B", crc=False)
    check_train_launches(r["counts"], cfg, gas, GEMMA7_OFFLOAD_STEPS,
                         "train-offload (d)", adam=False)
    last = r["last"]
    phase("train-offload", f"(d) Gemma-7B shape, {cfg.n_layers} of "
          f"{full.n_layers} layers (16 heads of 256 over d 3072, vocab "
          f"256000, GeGLU, tied), {cfg.num_params() / 1e9:.3f} B params "
          f"({host_gb:.1f} GB of host master and moments; MemAvailable "
          f"{facts['mem_available_gb']:.1f} GB at the start; the process's "
          f"RSS before the run, after its init and after each step "
          f"{[round(x, 1) for x in r['rss_gb']]} GB, its peak so far "
          f"{_rss_gb()[1]:.1f} GB), offload cpu, bf16 gradients, micro "
          f"{batch} x gas {gas} x seq {GEMMA_TRAIN_SEQ}: init {r['init_s']:.1f} s, "
          f"losses {[round(x, 4) for x in r['losses']]}, train_batch wall "
          f"ms {[round(x, 1) for x in r['walls']]}, peak {r['peak_gb']:.1f} "
          f"GB; host step of the last call {last['wall_s'] * 1e3:.1f} ms: "
          f"host Adam {last['update_s'] * 1e3:.1f} ms, D2H "
          f"{last['d2h_gbps']:.1f} GB/s, H2D {last['h2d_gbps']:.1f} GB/s")
    return r


def phase_host_benches():
    """``ds_bench cpu_adam``, ``aio`` and ``offload`` at the JAX package's
    defaults, their JSON lines printed."""
    import contextlib
    import io
    from deepspeed_tpu_torch.benchmarks.__main__ import main as ds_bench
    for argv in HOST_BENCHES:
        buf = io.StringIO()
        t0 = time.time()
        with contextlib.redirect_stdout(buf):
            ds_bench(argv)
        for line in buf.getvalue().splitlines():
            phase("train-offload", f"ds_bench {' '.join(argv)}: {line}")
        phase("train-offload", f"ds_bench {argv[0]}: "
              f"{time.time() - t0:.1f} s")


def phase_train_offload(facts, base, base_dev_ms):
    """Phase train-offload, (a)-(d) and the host benches.  Returns
    {head dim: the B1 / B2 launches of its runs} and the device path's
    B3 launches."""
    t0 = time.time()
    runs = phase_offload_vs_device(facts)
    _, cli_counts = phase_offload_cli(base, base_dev_ms)
    gemma = phase_offload_gemma(facts)
    phase_host_benches()
    flash = ("flash_attention_fwd", "flash_attention_bwd_dq",
             "flash_attention_bwd_dkv")
    by_d = {64: {k: sum(r["counts"][k] for r in runs) for k in flash},
            80: {k: cli_counts[k] for k in flash},
            256: {k: gemma["counts"][k] for k in flash}}
    phase("train-offload", f"done in {time.time() - t0:.1f} s; B1 / B2 "
          f"launches by head dim {by_d}")
    return by_d, runs[0]["counts"]["fused_adam"]


# ----------------------------------------------------------------------
def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after the kernel phase")
    ap.add_argument("--ckpt-child", metavar="DIR", help=argparse.SUPPRESS)
    args = ap.parse_args()

    if args.ckpt_child:     # phase ckpt's resumed run, a process of its own
        import torch
        sys.path.insert(0, REPO)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        ckpt_child(args.ckpt_child)
        return

    t_start = time.time()
    import torch
    card = phase_device()
    if not os.path.isdir(os.path.join(REPO, "deepspeed_tpu_torch")):
        fail("deepspeed_tpu_torch/ is not beside chip_smoke.py")
    sys.path.insert(0, REPO)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    host = phase_host()

    phase_build()
    phase_sass()
    # (a) ds_report --kernel-gate: every library compatible, built
    phase_env_report()
    # a kernel that hangs (its warpgroups' turns out of step) ends the run
    # here, not at its time limit
    faulthandler.dump_traceback_later(KERNEL_PHASES_TIMEOUT, exit=True)
    errs = phase_kernels()
    errs.update(phase_train_kernels())
    errs.update(phase_biased_kernels())
    errs.update(phase_sparse_kernels())
    faulthandler.cancel_dump_traceback_later()
    if args.kernels_only:
        phase("done", f"kernels only, {time.time() - t_start:.1f} s")
        return

    cfg, model, t_init = build_model(32, seed=0)
    L = cfg.n_layers
    phase("model", f"llama2_7b width, {L} layers, "
          f"{sum(p.numel() for p in model.parameters()) / 1e9:.3f} B params,"
          f" bf16, init {t_init:.1f} s")

    # ---- main path: generate + serve, counters read around it ---------
    reset_counters()
    eng, ids, t_gen, gen_out = phase_generate(model, cfg)
    after_gen = read_counters()
    se, prompts, t_serve, serve_outs = phase_serve(eng, cfg)
    counts = read_counters()
    serve_margins = se.margins
    calls = se.stats["model_calls"]
    gen_calls = GEN_NEW                 # 1 prefill + 31 decode calls
    if after_gen["decode_attention"] != L * gen_calls:
        fail(f"decode kernel launched {after_gen['decode_attention']} times"
             f" in generate, expected {L} x {gen_calls}")
    if counts["ragged_paged_attention"] != L * calls:
        fail(f"ragged kernel launched {counts['ragged_paged_attention']} "
             f"times in serving, expected {L} x {calls} model calls")
    if counts["decode_attention"] != after_gen["decode_attention"]:
        fail("decode kernel launched outside generate")
    if plain_calls(counts):
        fail(f"plain versions ran on the main path: {plain_calls(counts)}")
    phase("generate", f"B=4 prompt 128 + 32 new: {t_gen:.3f} s, "
          f"{4 * 32 / t_gen:.1f} new tokens/s (prefill included), "
          f"decode kernel launches {after_gen['decode_attention']} = "
          f"{L} x {gen_calls}")
    n_new = 32 * len(prompts)
    phase("serve", f"12 prompts {[len(p) for p in prompts]} x 32 new, "
          f"8 slots: {t_serve:.3f} s, {n_new / t_serve:.1f} new tokens/s, "
          f"{calls} model calls ({se.scheduler.sched_stats['decode_steps']}"
          f" decode steps), ragged kernel launches "
          f"{counts['ragged_paged_attention']} = {L} x {calls}, "
          f"leak_report {{}}")
    se_steps = se.scheduler.sched_stats['decode_steps']
    del se
    torch.cuda.empty_cache()
    # the margins behind generate's greedy tokens, for the fp16 run
    gen_margins = teacher_margins(eng, gen_out, ids.shape[1])
    # generate's per-step time: its prefill alone, timed after the counted
    # main path, taken out of the generate wall time
    torch.cuda.synchronize()
    t0 = time.time()
    logits, _ = eng.forward(ids)
    torch.cuda.synchronize()
    t_prefill = time.time() - t0
    if tuple(logits.shape) != (4, 128, cfg.vocab_size) or \
            not torch.isfinite(logits).all():
        fail(f"prefill logits {tuple(logits.shape)} not finite or misshapen")
    phase("generate", f"prefill B=4 x 128: {t_prefill * 1e3:.1f} ms; "
          f"decode {(t_gen - t_prefill) * 1e3 / (gen_calls - 1):.2f} ms per "
          f"step ({4 * (gen_calls - 1) / (t_gen - t_prefill):.1f} tokens/s)")
    phase("timing", f"launches per decode step: decode_attention "
          f"{after_gen['decode_attention'] // gen_calls}, "
          f"ragged_paged_attention {counts['ragged_paged_attention'] // calls}"
          f" (one per layer per model call)")
    # B4's launches by form: one per layer per decode step (the decode
    # rows) and per bucketed prefill (the prefill tiles), by bucket
    dec_steps = se_steps
    b4_launches = b4_form_launches(L, dec_steps, SERVE_PROMPTS)
    phase("timing", f"ragged_paged_attention launches on the serve run by "
          f"form: {b4_launches} (of {counts['ragged_paged_attention']}: "
          f"{calls - dec_steps} prefill calls, {dec_steps} decode steps)")
    step_ms, device_ms, top, b4_ms = decode_step_ms(eng, cfg)
    phase("serve", f"pure decode step, 8 slots busy: {step_ms:.3f} ms "
          f"({8 * 1e3 / step_ms:.1f} tokens/s); device time "
          f"{device_ms:.3f} ms/step (profiler), busy share "
          f"{device_ms / step_ms:.3f}; B4 (ragged paged attention) "
          f"{b4_ms:.4f} ms/step, {b4_ms / device_ms:.3f} of the device time")
    for name, k_ms in top:
        phase("serve", f"  device ms/step {k_ms:.4f}  {name[:90]}")

    # ---- a TinyLlama-1.1B-shaped generate: B5 at head dim 64, group 8 --
    from deepspeed_tpu_torch.models.transformer import TransformerConfig
    t0 = time.time()
    dcfg, draft, _ = build_model(DRAFT_SHAPE["n_layers"], seed=1,
                                 cfg=TransformerConfig(**DRAFT_SHAPE))
    reset_counters()
    _, _, t_dgen, _ = phase_generate(draft, dcfg)
    d_counts = read_counters()
    d_want = dcfg.n_layers * gen_calls
    if d_counts["decode_attention"] != d_want or \
            d_counts["ragged_paged_attention"] or plain_calls(d_counts):
        fail(f"TinyLlama-shaped generate launches {d_counts}, expected "
             f"decode_attention {dcfg.n_layers} x {gen_calls} and nothing "
             f"else")
    phase("generate", f"TinyLlama-1.1B shape ({dcfg.n_layers} layers, "
          f"{dcfg.n_heads}/{dcfg.kv_heads} heads of {dcfg.head_dim}) bf16 "
          f"B=4 prompt 128 + 32 new: {t_dgen:.3f} s, decode kernel launches"
          f" {d_counts['decode_attention']} = {dcfg.n_layers} x {gen_calls},"
          f" plain versions 0")

    # ---- serve-features: each run counted on its own (serve_run), at the
    # cut depth of FEATURES_LAYERS_LLAMA --------------------------------
    del eng, model, draft
    _free()
    fcfg, fmodel, _ = build_model(FEATURES_LAYERS_LLAMA[0], seed=0)
    fdcfg, fdraft, _ = build_model(FEATURES_LAYERS_LLAMA[1], seed=1,
                                   cfg=TransformerConfig(**DRAFT_SHAPE))
    feat = phase_serve_features(fmodel, fcfg, [("TinyLlama-1.1B", fdraft)],
                                torch.bfloat16, exact=False, label="bf16")
    phase("serve-features", f"bf16 (a)-(d), Llama-2-7B {fcfg.n_layers} of "
          f"{L} layers, draft TinyLlama-1.1B shape {fdcfg.n_layers} of "
          f"{dcfg.n_layers} layers: {time.time() - t0:.1f} s")
    del fmodel, fdraft
    _free()

    # ---- fp16: phases 4 and 5 again, the same seed's weights in fp16 --
    import deepspeed_tpu_torch as dst
    cfg16, model16, _ = build_model(32, seed=0, dtype=torch.float16)
    f16 = serve_entry_points("llama2_7b fp16", model16, cfg16, "fp16")
    check_divergence(
        "fp16 generate vs bf16", [r.tolist() for r in gen_out.cpu()],
        [r.tolist() for r in f16["gen_out"].cpu()], [ids[0]] * len(ids),
        gen_margins, "bfloat16")
    check_divergence("fp16 serve vs bf16", serve_outs, f16["serve_outs"],
                     prompts, serve_margins, "bfloat16")
    step16, dev16, top16, _ = decode_step_ms(
        dst.init_inference(model16, dtype="fp16"), cfg16)
    phase("serve", f"fp16 pure decode step, 8 slots busy: {step16:.3f} ms, "
          f"device {dev16:.3f} ms/step (profiler), busy share "
          f"{dev16 / step16:.3f} (bf16 in this run: {step_ms:.3f} ms, "
          f"device {device_ms:.3f})")
    for name, k_ms in top16:
        phase("serve", f"  fp16 device ms/step {k_ms:.4f}  {name[:90]}")
    fp16_launches = b4_form_launches(L, f16["decode_steps"], SERVE_PROMPTS,
                                     "_fp16")
    del model16
    _free()

    # ---- serving at head dims 80 and 96: gpt_2_7b, the Phi-3-mini shape -
    hd_launches, cfg80, cfg96 = phase_serve_head_dims()
    # ---- serving at head dim 256: the Gemma-7B and Gemma-2B shapes ------
    g_launches, cfg_g7, cfg_g2 = phase_serve_gemma()
    hd_launches.update(g_launches)

    # ---- the benches as a user runs them, each counted on its own: (b)
    # ds_bench serving at its defaults (gpt2_125m, head dim 64), then
    # --model tiny (head dim 16); (c) ds_bench inference at its defaults
    # (tiny) ------------------------------------------------------------
    t0 = time.time()
    bench_launches = {}
    serve_runs = []
    for argv, gen_tokens in (([], 64), (BENCH_TINY_ARGS, 32)):
        _, rows, _, lens, max_seq = phase_bench_serving(argv)
        serve_runs.append((lens, max_seq, gen_tokens, rows))
        for name, n in rows.items():
            bench_launches[name] = bench_launches.get(name, 0) + n
    _, rows = phase_bench_inference()
    for name, n in rows.items():
        bench_launches[name] = bench_launches.get(name, 0) + n
    # gpt2_125m's B5 row counts its sequential prompts' prefills too
    bench_launches["decode_attention_gpt2_125m"] += bench_launches.pop(
        "decode_attention_gpt2_125m_prefill")
    phase("bench", f"phases (b)-(c) in {time.time() - t0:.1f} s; launches "
          f"by kernels JSON row {bench_launches}")

    rel, agree = phase_e2e()
    phase("e2e", f"2 layers full width, paged prefill T=128 + 4 decodes: "
          f"kernel vs plain logits rel err {rel:.3e} (tol {E2E_REL_TOL}), "
          f"argmax agreement {agree:.4f}")
    # (a)-(d) in fp32 at 2 layers, full width: tokens identical
    t0 = time.time()
    cfg2, m2, _ = build_model(2, seed=7, dtype=torch.float32)
    _, d2, _ = build_model(2, seed=8, dtype=torch.float32,
                           cfg=TransformerConfig(**DRAFT_SHAPE))
    phase_serve_features(m2, cfg2, [("TinyLlama-1.1B 2 layers", d2),
                                    ("the target's own weights", m2)],
                         torch.float32, exact=True, label="fp32 2-layer")
    phase("e2e", f"fp32 2-layer (a)-(d): {time.time() - t0:.1f} s")
    n_same, d_calls = phase_generate_vs_plain(d2)
    phase("e2e", f"fp32 2-layer TinyLlama-1.1B-shaped generate, B=4 prompt "
          f"128 + 32 new: tokens through B5 (head dim 64, group 8; "
          f"{d_calls} launches) identical to the plain versions', {n_same} "
          f"of 4 rows")
    del m2, d2
    _free()
    # head dims 80, 96 and 256, 2 layers of full width: bf16 logits
    # through B4 vs the plain versions, then fp32 greedy tokens through B5
    # and B4 vs the plain versions'
    for label, hcfg, seed in ((SERVE_D80_MODEL, cfg80, 12),
                              ("Phi-3-mini-4k shape", cfg96, 13),
                              ("Gemma-7B shape", cfg_g7, 14),
                              ("Gemma-2B shape", cfg_g2, 15)):
        rel, agree = phase_e2e(cfg=hcfg, seed=seed)
        phase("e2e", f"{label} (head dim {hcfg.head_dim}) 2 layers full "
              f"width, paged prefill T=128 + 4 decodes, bf16: kernel vs "
              f"plain logits rel err {rel:.3e} (tol {E2E_REL_TOL}), argmax "
              f"agreement {agree:.4f}")
        _, m2, _ = build_model(2, seed=seed, dtype=torch.float32, cfg=hcfg)
        n_same, g_calls = phase_generate_vs_plain(m2)
        s_same, s_calls = phase_serve_vs_plain(m2)
        phase("e2e", f"{label} 2 layers fp32: generate B=4 prompt 128 + 32 "
              f"new through B5 ({g_calls} launches) identical to the plain "
              f"versions' in {n_same} of 4 rows; serving 6 prompts x "
              f"{SERVE_NEW} new through B4 ({s_calls} launches) identical "
              f"in {s_same} of 6 requests")
        del m2
        _free()
    # the benches' tiny model (head dim 16), 2 layers fp32: greedy tokens
    # through B5 and B4 vs the plain versions'
    from deepspeed_tpu_torch.benchmarks.serving import \
        model_config as bench_config
    _, m2, _ = build_model(2, seed=16, dtype=torch.float32,
                           cfg=bench_config("tiny"))
    n_same, g_calls = phase_generate_vs_plain(m2)
    s_same, s_calls = phase_serve_vs_plain(m2)
    phase("e2e", f"tiny (head dim 16, 4 / 4 heads) 2 layers fp32: generate "
          f"B=4 prompt 128 + 32 new through B5 ({g_calls} launches) "
          f"identical to the plain versions' in {n_same} of 4 rows; serving "
          f"6 prompts x {SERVE_NEW} new through B4 ({s_calls} launches) "
          f"identical in {s_same} of 6 requests")
    del m2
    _free()

    # ---- training main paths, counters read around each run_benchmark --
    launches = {k: v for k, v in counts.items() if not k.endswith("_plain")}
    train_peaks = {}
    for name, (_, seq, _) in TRAIN_MODELS.items():
        out, train_counts, launched = phase_train(name)
        train_peaks[name] = out["peak_gb"]
        for k in launches:
            launches[k] += train_counts[k]
        phase("train", f"run_benchmark({name}): {out['n_layers']} layers, "
              f"{out['n_params'] / 1e9:.3f} B params, micro {TRAIN_BATCH} x "
              f"gas {TRAIN_GAS} x seq {seq}, bf16, AdamW lr 1e-4; "
              f"{out['ms_per_train_batch']:.1f} ms per train_batch, "
              f"{out['tokens_per_sec']:.1f} tokens/s, "
              f"{out['model_tflops']:.2f} TFLOP/s, MFU {out['mfu']:.4f} of "
              f"989 TFLOP/s; peak memory {out['peak_gb']:.1f} GB; losses "
              f"{[round(x, 4) for x in out['losses']]}")
        phase("train", f"launches in {TRAIN_STEPS + 1} train_batch calls of "
              f"{name}: {launched}; every other kernel 0, plain versions 0")
    # this slice's path: the Gemma-2B shape at head dim 256 (its flash
    # launches go to the D=256 rows, B3's to B3's row)
    gemma = phase_train_gemma()
    launches["fused_adam"] += gemma["fused_adam"]
    # the ds_bench train main paths: no flags (gpt_350m, the flash
    # kernels' D=64 forms), --model gpt_760m (D=96) and --model gpt_2_7b
    # (D=80), each counted on its own; B3's launches join its row, the
    # flash forms' go to their head dim's rows
    cli_counts, cli_runs, cli_devs = {}, {}, {}
    for model in (None, "gpt_760m", "gpt_2_7b"):
        label = cli_label(model)
        # phase (d): the default run's engine logs the timers' lines
        cli, counts_m, cli_launched, cli_ms, cli_dev, cli_top, policies = \
            phase_train_cli(model, timers=model is None)
        cli_counts[cli["model"]] = counts_m
        cli_runs[cli["model"]] = (cli, counts_m)
        cli_devs[cli["model"]] = cli_dev
        launches["fused_adam"] += counts_m["fused_adam"]
        phase("train", f"ds_bench train {label}: {cli['model']}, "
              f"{cli['n_layers']} layers, {cli['n_params'] / 1e9:.3f} B "
              f"params, head dim {CLI_HEAD_DIMS[cli['model']]}, micro "
              f"{cli['batch']} x gas {cli['gas']} x seq {cli['seq']}, "
              f"{cli['dtype']}, ZeRO {cli['zero_stage']}, AdamW lr 1e-4, "
              f"{cli['steps']} timed steps: {cli['ms_per_train_batch']:.1f} "
              f"ms per train_batch, {cli['tokens_per_sec']:.1f} tokens/s, "
              f"{cli['model_tflops']:.2f} TFLOP/s, MFU {cli['mfu']:.4f} of "
              f"989 TFLOP/s; peak memory {cli['peak_gb']:.1f} GB; losses "
              f"{[round(x, 4) for x in cli['losses']]}")
        phase("train", f"launches in {cli['steps'] + 1} train_batch calls "
              f"of ds_bench train {label}: {cli_launched}; every other "
              f"kernel 0, plain versions 0")
        phase("train", f"{cli['model']} one train_batch (the CLI's config):"
              f" {cli_ms:.1f} ms wall, device {cli_dev:.1f} ms (profiler), "
              f"busy share {cli_dev / cli_ms:.3f}")
        phase("train", f"{cli['model']} remat policy {cli['remat_policy']}:"
              f" the CLI run's peak {cli['peak_gb']:.1f} GB; one profiled "
              f"train_batch of one engine by policy: " + "; ".join(
                  f"{pol} device {ms:.1f} ms, peak {gb:.1f} GB"
                  for pol, (ms, gb) in policies.items()))
        for kname, k_ms in cli_top:
            phase("train", f"  {cli['model']} device ms/train_batch "
                  f"{k_ms:.3f}  {kname[:90]}")
    # the fp16 slice's main path, through the ds_bench train CLI
    fp16_out, fp16_counts, fp16_launched = phase_train_fp16_cli()
    for k in launches:
        launches[k] += fp16_counts[k]
    phase("train", f"ds_bench train {TRAIN_MODEL} fp16 ({FP16_SCHEDULER}, "
          f"loss scale from 2**{FP16_SCALE_POWER}): "
          f"{fp16_out['ms_per_train_batch']:.1f} ms per train_batch, "
          f"{fp16_out['tokens_per_sec']:.1f} tokens/s, "
          f"{fp16_out['model_tflops']:.2f} TFLOP/s, MFU "
          f"{fp16_out['mfu']:.4f} of 989 TFLOP/s; peak memory "
          f"{fp16_out['peak_gb']:.1f} GB; {fp16_out['skipped_steps']} of "
          f"{FP16_STEPS} steps skipped, final loss scale "
          f"{fp16_out['loss_scale']}; losses "
          f"{[round(x, 4) for x in fp16_out['losses']]}")
    phase("train", f"launches in {FP16_STEPS} fp16 train_batch calls "
          f"(skipped ones included): {fp16_launched}; every other kernel "
          f"0, plain versions 0")
    fixed = {}
    for name in TRAIN_MODELS:
        losses, step_ms, device_ms, top = phase_train_fixed(name)
        fixed[name] = (step_ms, device_ms)
        phase("train", f"{name} fixed batch, {FIXED_STEPS} steps: losses "
              f"{[round(x, 4) for x in losses]} (falling); one train_batch "
              f"{step_ms:.1f} ms wall, device {device_ms:.1f} ms (profiler), "
              f"busy share {device_ms / step_ms:.3f}")
        for kname, k_ms in top:
            phase("train", f"  {name} device ms/train_batch {k_ms:.3f}  "
                  f"{kname[:90]}")
        if name in FIXED_PLAIN:
            plain_losses, rel = phase_train_fixed_plain(name, losses)
            phase("train", f"{name} fixed batch through the plain versions "
                  f"(full width and depth): losses "
                  f"{[round(x, 4) for x in plain_losses]}, max rel "
                  f"{rel:.3e} from the kernels' (tol {FIXED_PLAIN_REL_TOL})")
    losses, skips, scales, step_ms, device_ms, top = phase_train_fixed_fp16()
    phase("train", f"{TRAIN_MODEL} fp16 fixed batch, {FP16_STEPS} steps: "
          f"losses {[round(x, 4) for x in losses]}; skipped "
          f"{[int(x) for x in skips]}; loss scale after each "
          f"{[int(x) for x in scales]}; the loss falls over the applied "
          f"steps")
    b_ms, b_dev = fixed[TRAIN_MODEL]
    phase("train", f"{TRAIN_MODEL} one train_batch, fp16 vs bf16: "
          f"{step_ms:.1f} vs {b_ms:.1f} ms wall, device {device_ms:.1f} vs "
          f"{b_dev:.1f} ms (profiler), busy share {device_ms / step_ms:.3f} "
          f"vs {b_dev / b_ms:.3f}")
    for kname, k_ms in top:
        phase("train", f"  {TRAIN_MODEL} fp16 device ms/train_batch "
              f"{k_ms:.3f}  {kname[:90]}")
    # 2-layer kernels vs plain: each model in bf16; GPT-Neo in fp32 too,
    # where no bf16 rounding blurs what its unscaled logits amplify; then
    # the head-dim-64 models (GPT-Neo-125M's unscaled logits with the
    # witness too)
    e2e_counts = {}
    for name, bf16 in [(n, True) for n in TRAIN_MODELS] + [
            ("gpt_neo_1_3b", False)] + [(n, True) for n in D64_MODELS] + [
            (n, True) for n in D80_96_MODELS]:
        r = phase_train_e2e(name, bf16=bf16,
                            witness=name.startswith("gpt_neo"))
        if bf16:
            e2e_counts[name] = r["counts"]
        phase("e2e", f"train {r['label']}, 2 layers full width, 2 "
              f"train_batch steps: losses kernels {r['lk']} vs plain "
              f"{r['lp']} (max rel {r['loss_rel']:.2e}); first grad norm "
              f"{r['nk']:.5f} vs {r['n_p']:.5f} (rel {r['norm_rel']:.2e}); "
              f"tol {E2E_TRAIN_REL_TOL}")
        phase("e2e", f"train {r['label']} state, worst parameter: m rel L2 "
              f"by step {[(f'{x:.3e}', n) for x, n in r['m_rels']]} (tol "
              f"by step {[f'{t:.3e}' for t in r['m_tols']]}), update after "
              f"2 steps rel L2 {r['upd_rel'][0]:.3e} ({r['upd_rel'][1]}; tol "
              f"{E2E_UPDATE_REL_TOL}); master max abs diff "
              f"{r['master_err']:.3e}")
        if r["witness_rels"]:
            phase("e2e", f"train {r['label']} witness, plain micro 1 x gas 4"
                  f" vs plain micro 2 x gas 2: m rel L2 by step "
                  f"{[(f'{x:.3e}', n) for x, n in r['witness_rels']]}")
    # head dim 256: the Gemma-2B shape, 2 layers of full width, bf16 and
    # (below) fp16
    from deepspeed_tpu_torch.models.transformer import TransformerConfig
    gemma_cfg = TransformerConfig(**GEMMA_TRAIN)
    r = phase_train_e2e("gemma_2b", cfg=gemma_cfg, seq=GEMMA_TRAIN_SEQ)
    phase("e2e", f"train Gemma-2B shape bf16 (head dim 256, 8/1 heads), 2 "
          f"layers full width, seq {GEMMA_TRAIN_SEQ}, 2 train_batch steps: "
          f"losses kernels {r['lk']} vs plain {r['lp']} (max rel "
          f"{r['loss_rel']:.2e}); first grad norm {r['nk']:.5f} vs "
          f"{r['n_p']:.5f} (rel {r['norm_rel']:.2e}); tol "
          f"{E2E_TRAIN_REL_TOL}; m rel L2 by step "
          f"{[(f'{x:.3e}', n) for x, n in r['m_rels']]} (tol "
          f"{E2E_M_REL_TOL}), update rel L2 {r['upd_rel'][0]:.3e} "
          f"({r['upd_rel'][1]}; tol {E2E_UPDATE_REL_TOL})")
    # fp16, 2 layers of full width: gpt_1b (D=128), gpt_350m (D=64) and
    # FP16_CLI_MODEL (its CLI head dim); the fp16 JSON rows take their
    # kernel engines' launches
    fp16_e2e_counts = {}
    for name, seq, label, fcfg in (
            (TRAIN_MODEL, TRAIN_SEQ, TRAIN_MODEL, None),
            (CLI_DEFAULTS["model"], CLI_DEFAULTS["seq"],
             f"{CLI_DEFAULTS['model']} (D=64)", None),
            (FP16_CLI_MODEL, D80_96_MODELS[FP16_CLI_MODEL][1],
             f"{FP16_CLI_MODEL} (D={CLI_HEAD_DIMS[FP16_CLI_MODEL]})", None),
            ("gemma_2b", GEMMA_TRAIN_SEQ, "Gemma-2B shape (D=256)",
             gemma_cfg)):
        r = phase_train_e2e_fp16(name, seq, cfg=fcfg)
        fp16_e2e_counts[name] = r["k"]["counts"]
        phase("e2e", f"train {label} fp16, 2 layers full width, "
              f"{FP16_E2E_STEPS} train_batch steps from loss scale "
              f"2**{FP16_E2E_SCALE_POWER}: skipped "
              f"{[int(x) for x in r['k']['skips']]} on both paths, loss "
              f"scales {[int(x) for x in r['k']['scales']]} on both; losses "
              f"kernels {[round(x, 5) for x in r['k']['losses']]} vs plain "
              f"{[round(x, 5) for x in r['p']['losses']]} (max rel "
              f"{r['loss_rel']:.2e}); first applied grad norm rel "
              f"{r['norm_rel']:.2e}; tol {E2E_TRAIN_REL_TOL}")
        phase("e2e", f"train {label} fp16 state, worst parameter: m rel L2 "
              f"by applied step "
              f"{[(f'{x:.3e}', n) for x, n in r['m_rels']]} (tol "
              f"{E2E_M_REL_TOL}), update rel L2 {r['upd_rel'][0]:.3e} "
              f"({r['upd_rel'][1]}; tol {E2E_UPDATE_REL_TOL})")

    # the last 2-layer run's masters (a Gemma-2B shape's: ~6 GB) go before
    # the next phase reads its peaks
    del r
    _free()

    # ---- phase train-a6a7: activation checkpointing and the rest of the
    # optimizers; B3's forms with bf16 gradients or moments take their
    # launches here ----------------------------------------------------
    t0 = time.time()
    # (a) the CLI's remat policy: the one nothing_saveable run against the
    # no-flags run above
    cli_n, counts_n, _, ms_n, dev_n, _, pol_n = phase_train_cli(
        policy=A6A7_POLICY)
    launches["fused_adam"] += counts_n["fused_adam"]
    cli_d, _ = cli_runs[CLI_DEFAULTS["model"]]
    rel = check_cli_policies(cli_runs[CLI_DEFAULTS["model"]],
                             (cli_n, counts_n))
    phase("train-a6a7", f"(a) ds_bench train {cli_label(policy=A6A7_POLICY)}"
          f": {cli_n['ms_per_train_batch']:.1f} ms per train_batch, MFU "
          f"{cli_n['mfu']:.4f}, peak {cli_n['peak_gb']:.1f} GB, one "
          f"train_batch device {dev_n:.1f} ms (before: {CLI_DEVICE_MS}); no "
          f"flags ({CLI_POLICY}): {cli_d['ms_per_train_batch']:.1f} ms, MFU "
          f"{cli_d['mfu']:.4f}, peak {cli_d['peak_gb']:.1f} GB; first loss "
          f"{cli_n['losses'][0]} under both, final grad norms "
          f"{cli_d['grad_norm']:.6f} / {cli_n['grad_norm']:.6f} (rel "
          f"{rel:.2e}, tol {A6A7_NORM_REL_TOL}); launches equal and exact")
    # (b) gpt_1b with bf16 moments and gradients
    out_b, launched_b, losses_b, peak_b, b3_bf16 = phase_train_bf16_state()
    b3_forms = {("bfloat16", "bfloat16"): b3_bf16}
    phase("train-a6a7", f"(b) {TRAIN_MODEL} bf16 moments and gradients: "
          f"{out_b['ms_per_train_batch']:.1f} ms per train_batch, peak "
          f"{out_b['peak_gb']:.1f} GB against {train_peaks[TRAIN_MODEL]:.1f}"
          f" GB with fp32 gradients and moments (run_benchmark({TRAIN_MODEL})"
          f" above, same batch shape); launches {launched_b}; fixed batch "
          f"{[round(x, 4) for x in losses_b]} (falling), peak {peak_b:.1f} "
          f"GB; m, v and the gradients bf16")
    # (c) the other optimizers, full depth
    _, forms_c = phase_train_optimizers()
    for form, n in forms_c.items():
        b3_forms[form] = b3_forms.get(form, 0) + n
    # (d) 2 layers, kernels vs plain
    for label, (blocks, form) in A6A7_E2E.items():
        r = phase_train_e2e(TRAIN_MODEL, blocks=blocks,
                            adam=form is not None)
        if form is not None:
            b3_forms[form] = b3_forms.get(form, 0) + \
                r["counts"]["fused_adam"]
        phase("train-a6a7", f"(d) {label}: {TRAIN_MODEL} 2 layers full "
              f"width, 2 train_batch steps: losses kernels {r['lk']} vs "
              f"plain {r['lp']} (max rel {r['loss_rel']:.2e}); first grad "
              f"norm rel {r['norm_rel']:.2e}; tol {E2E_TRAIN_REL_TOL}; m rel "
              f"L2 by step {[(f'{x:.3e}', n) for x, n in r['m_rels']]} (tol "
              f"{E2E_M_REL_TOL}), update rel L2 {r['upd_rel'][0]:.3e} "
              f"({r['upd_rel'][1]}; tol {E2E_UPDATE_REL_TOL})")
    # (f) a user block through checkpointing.checkpoint
    phase_checkpoint_block()
    phase("train-a6a7", f"done in {time.time() - t0:.1f} s; B3 launches "
          f"by form {b3_forms}")

    # ---- phase train-offload: the optimizer on the host (A12) ---------
    offload_flash, offload_b3 = phase_train_offload(
        host, cli_runs["gpt_2_7b"][0], cli_devs["gpt_2_7b"])
    launches["fused_adam"] += offload_b3

    # ---- phase ckpt: save, a new process resumes, serve the tag --------
    from deepspeed_tpu_torch.benchmarks.training import model_config
    ckpt_cfg = dataclasses.replace(model_config(TRAIN_MODEL, TRAIN_SEQ),
                                   n_layers=CKPT_LAYERS)
    ckpt_counts, _ = phase_ckpt(
        ckpt_cfg, dataclasses.replace(ckpt_cfg, n_layers=CKPT_SMALL_LAYERS))
    for k in launches:
        launches[k] += ckpt_counts.get(k, 0)
    _free()

    # ---- block-sparse entry point, counters read around its calls -----
    sparse_counts, t_sparse, sparse_err, sparse_err16 = phase_sparse_path()
    for k in launches:
        launches[k] += sparse_counts[k]
    # the fp16 calls' launches go to the fp16 row
    launches["sparse_attention"] -= len(SPARSE_PATH_FP16)
    phase("sparse", f"SparseSelfAttention x {len(SPARSE_PATH)} "
          f"{[f'{k} block {b} D={d}' for k, b, d in SPARSE_PATH]} bf16 and x "
          f"{len(SPARSE_PATH_FP16)} "
          f"{[f'{k} block {b} D={d}' for k, b, d in SPARSE_PATH_FP16]} fp16 "
          f"at B={SPARSE_B} S={SPARSE_S} H={SPARSE_H}: {t_sparse * 1e3:.1f} ms"
          f" wall, kernel launches {sparse_counts['sparse_attention']}, plain "
          f"versions 0; a key_padding_mask call took the dense path, a "
          f"gradient request raised")

    timing = phase_timing(cfg, SERVE_PROMPTS[:SERVE_SLOTS])
    for key, n in b4_launches.items():
        if key in timing:
            phase("timing", f"{key}: {timing[key]['ms']:.4f} ms x {n} "
                  f"serve-run launches, bound {timing[key]['bound_ms']:.4f} "
                  f"ms")
    timing.update(phase_timing_serving())
    timing.update(phase_timing_head_dims())
    timing.update(phase_timing_head_dim_256())
    timing.update(phase_timing_benches(*serve_runs[::-1]))
    timing.update(phase_train_timing(errs))
    biased = phase_biased_timing(errs)
    biased_d64 = phase_biased_timing(errs, BIASED_TIMING_D64, D=64, seed=79)
    phase_biased_timing(errs, BIASED_TIMING_D96, D=96, seed=80)
    phase_biased_timing(errs, BIASED_TIMING_D80, D=80, seed=81)
    phase_biased_timing(errs, BIASED_TIMING_D256, D=256, seed=82)
    sparse = phase_sparse_timing(sparse_err, sparse_err16)
    alibi_label, window_label = (b[0] for b in BIASED_TIMING[:2])
    ratio = (biased[("flash_attention_fwd_biased", window_label)]["ms"] /
             biased[("flash_attention_fwd_biased", alibi_label)]["ms"])
    phase("timing", f"biased forward, window 256 vs ALiBi at S=2048: "
          f"{ratio:.3f} of the time (the window's key-tile skip)")
    if ratio > 0.6:
        fail(f"the window-256 forward takes {ratio:.3f} of the ALiBi "
             f"forward's time: its key-tile skip does not work")
    sparse_label = "{} block {} D={}".format(*SPARSE_PATH[0])
    sparse_label16 = "{} block {} D={}".format(*SPARSE_PATH_FP16[0])
    for name in ("flash_attention_fwd_biased", "flash_attention_bwd_dq_biased",
                 "flash_attention_bwd_dkv_biased"):
        timing[name] = biased[(name, alibi_label)]
    timing["sparse_attention"] = sparse[("sparse_attention", sparse_label)]
    timing["sparse_attention_fp16"] = sparse[("sparse_attention_fp16",
                                              sparse_label16)]
    kernels = []
    pallas = "deepspeed_tpu/ops/pallas/"
    csrc = "deepspeed_tpu_torch/ops/csrc/"
    meta = {
        "decode_attention": (csrc + "decode_attention.cu",
                             pallas + "decode_attention.py:45"),
        "ragged_paged_attention": (csrc + "ragged_paged_attention.cu",
                                   pallas + "ragged_paged_attention.py:57"),
        "flash_attention_fwd": (csrc + "flash_attention_fwd.cu",
                                pallas + "flash_attention.py:85"),
        "flash_attention_bwd_dq": (csrc + "flash_attention_bwd.cu",
                                   pallas + "flash_attention.py:222"),
        "flash_attention_bwd_dkv": (csrc + "flash_attention_bwd.cu",
                                    pallas + "flash_attention.py:278"),
        "fused_adam": (csrc + "fused_adam.cu", pallas + "fused_adam.py:30"),
        "flash_attention_fwd_biased": (csrc + "flash_attention_fwd.cu",
                                       pallas + "flash_attention.py:92"),
        "flash_attention_bwd_dq_biased": (csrc + "flash_attention_bwd.cu",
                                          pallas + "flash_attention.py:229"),
        "flash_attention_bwd_dkv_biased": (csrc + "flash_attention_bwd.cu",
                                           pallas + "flash_attention.py:286"),
        "sparse_attention": (csrc + "sparse_attention.cu",
                             pallas + "sparse_attention.py:54"),
    }
    # B6's fp16 form: the fp16 calls of the entry point
    meta["sparse_attention_fp16"] = meta["sparse_attention"]
    launches["sparse_attention_fp16"] = len(SPARSE_PATH_FP16)
    # the fp16 forms of B1 and B2: rows of their own, with the launches of
    # the fp16 main path (the rows above count every main path)
    for name in ("flash_attention_fwd", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv"):
        meta[f"{name}_fp16"] = meta[name]
        timing[f"{name}_fp16"] = timing[(name, "fp16")]
        launches[f"{name}_fp16"] = fp16_counts[name]
    # PR 8's and this slice's forms: B5 and B4 in fp16 (launches of the
    # fp16 main paths), the verify window, the draft's group-8 decode step
    # and the chunks at an offset (launches of their serve-features runs),
    # B5 at head dim 64 (the TinyLlama-shaped generate's launches)
    spec = feat["spec_TinyLlama-1.1B"]
    for name, n in (("decode_attention_fp16", f16["gen_launches"]),
                    ("ragged_paged_attention_fp16",
                     fp16_launches["ragged_paged_attention_fp16"]),
                    ("ragged_paged_attention_prefill_512_fp16",
                     fp16_launches.get(
                         "ragged_paged_attention_prefill_512_fp16", 0)),
                    ("ragged_paged_attention_prefill_1024_fp16",
                     fp16_launches.get(
                         "ragged_paged_attention_prefill_1024_fp16", 0)),
                    ("ragged_paged_attention_verify",
                     spec["verify_launches"]),
                    ("ragged_paged_attention_draft_gqa8",
                     spec["draft_decode_launches"]),
                    ("ragged_paged_attention_chunk_at_offset",
                     feat["chunk"]["launches"]),
                    ("decode_attention_d64", d_counts["decode_attention"]),
                    ("ragged_paged_attention_draft_chunk_at_offset",
                     spec["draft_chunk_launches"])):
        meta[name] = meta["decode_attention" if name.startswith("decode")
                          else "ragged_paged_attention"]
        launches[name] = n
    # B5 and B4 at head dims 80, 96 and 256: rows of their own, with the
    # launches of the serving runs of gpt_2_7b (bf16, fp16, serve-features),
    # of the Phi-3-mini shape, of Gemma-7B (bf16, serve-features) and of
    # Gemma-2B (bf16 -- its draft decode steps in serve-features (c) too --
    # and fp16)
    for name, n in hd_launches.items():
        meta[name] = meta["decode_attention" if name.startswith("decode")
                          else "ragged_paged_attention"]
        launches[name] = n
    # this slice's: B5 and B4 at head dim 16 (the benches' tiny model) and
    # gpt2_125m's B4 and B5 rows, with the launches of the bench runs
    for name, n in bench_launches.items():
        meta[name] = meta["decode_attention" if name.startswith("decode")
                          else "ragged_paged_attention"]
        launches[name] = n
    # the D=64, D=96 and D=80 forms, rows of their own: the unbiased ones
    # with the launches of their ds_bench train run (no flags, --model
    # gpt_760m, --model gpt_2_7b), the fp16 forms at D=64 and at
    # FP16_CLI_MODEL's head dim with those of their fp16 2-layer run's
    # kernel engine, the biased D=64 ones with those of the BLOOM-560m and
    # GPT-Neo-125M 2-layer runs' kernel engines
    bloom_label = BIASED_TIMING_D64[0][0]
    fp16_models = (CLI_DEFAULTS["model"], FP16_CLI_MODEL)
    for base in ("flash_attention_fwd", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv"):
        for model, D in CLI_HEAD_DIMS.items():
            name = base + d_suffix(D)
            meta[name] = meta[base]
            launches[name] = cli_counts[model][base]
            if model in fp16_models:
                meta[f"{name}_fp16"] = meta[base]
                timing[f"{name}_fp16"] = timing[(name, "fp16")]
                launches[f"{name}_fp16"] = fp16_e2e_counts[model][base]
        biased_name = base + "_biased"
        meta[biased_name + d_suffix(64)] = meta[biased_name]
        timing[biased_name + d_suffix(64)] = biased_d64[
            (biased_name + d_suffix(64), bloom_label)]
        launches[biased_name + d_suffix(64)] = sum(
            e2e_counts[m][biased_name] for m in ("bloom_560m", "gpt_neo_125m"))
    # the D=256 forms (this slice's): the unbiased ones with the launches of
    # the Gemma-2B training run, their fp16 forms with those of its fp16
    # 2-layer run's kernel engine (the biased D=256 forms are on no path:
    # printed, not in the JSON)
    for base in ("flash_attention_fwd", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv"):
        name = base + d_suffix(256)
        meta[name] = meta[f"{name}_fp16"] = meta[base]
        launches[name] = gemma["counts"][base]
        timing[f"{name}_fp16"] = timing[(name, "fp16")]
        launches[f"{name}_fp16"] = fp16_e2e_counts["gemma_2b"][base]
    # phase train-offload's B1 / B2 launches join their head dim's rows:
    # gpt_350m's three runs D=64, gpt_2_7b's CLI run D=80, the Gemma-7B
    # shape's D=256
    for D, counts_d in offload_flash.items():
        for base, n in counts_d.items():
            launches[base + d_suffix(D)] += n
    # B3's forms with bf16 gradients or moments (this slice's): the
    # launches of phase train-a6a7
    for form in ADAM_NEW_FORMS:
        name = adam_form_name(*form)
        meta[name] = meta["fused_adam"]
        launches[name] = b3_forms.get(form, 0)
    # off the paths: timed and checked, launched by no run above
    meta[OFF_PATH_D256] = meta["decode_attention"]
    launches[OFF_PATH_D256] = 0
    for name, (source, replaces) in meta.items():
        t = timing[name]
        if not launches[name] and name != OFF_PATH_D256:
            fail(f"{name} never launched on the main paths")
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": t["max_abs_err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
    phase("done", f"all phases passed in {time.time() - t_start:.1f} s; "
          f"max abs err by dtype {{{', '.join(f'{k[0]}/{k[1]}: {v:.2e}' for k, v in errs.items())}}}")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
