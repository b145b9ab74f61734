#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py                 # every phase, Llama-2-7B, 32 layers
    python3 chip_smoke.py --kernels-only  # build + kernel check only

Builds the port's hand-written CUDA kernels from this checkout with
``nvcc`` (into ``deepspeed_tpu_torch/_build/``), holds each kernel against
its plain PyTorch version, then serves Llama-2-7B at full width (random
bf16 weights from a seeded generator) through the port's two serving
entry points -- ``init_inference(...).generate`` and
``create_serving_engine`` -- trains gpt_1b, BLOOM-1b7 and GPT-Neo-1.3B at
full width and depth through ``initialize(...).train_batch``, and calls
``SparseSelfAttention``, checking that those runs went through the
kernels.  Phases:

  1 device   card name and power limit (nvidia-smi)
  2 build    nvcc, one process per kernel source, all at once; the SASS
             of every bf16 and fp16 tensor-core kernel -- the flash
             kernels and B4's prefill kernel in both dtypes, B6's
             block-sparse kernel at every block and head dim -- holds
             wgmma (HGMMA) and TMA loads (UTMALDG)
  3 kernels  each kernel vs its plain version: fp32, bf16 and fp16 (the
             fp16 tensor-core tiles held to SDPA-fp16's error); serving
             attention MHA 32/32 and GQA 32/8; flash attention forward and
             backward at gpt_1b's shape, at GPT-Neo's global layers' (S=2048,
             unscaled logits), GQA 32/8 and S=1000; fused Adam over
             1,000,003 elements in both modes, and with its skip flag set
             (p, m, v unchanged bit for bit); the biased flash kernels with
             ALiBi at S=2048, windows 256 (S=2048, unscaled, GPT-Neo's local
             layers) and 100 (S=1000), ALiBi + window with GQA, a window
             past S (bf16 O, dQ, dK, dV of the tensor-core kernels: one
             ulp, or within 2x SDPA's error on the same inputs, both
             readings printed); decode attention where its key chunks
             meet a sequence's length; ragged paged attention's decode
             rows, bucketed prefills at 16, 512 and 1024, prefills after
             cached prefixes, pages 64 and 48, packed mixed batches with
             shared prefix pages, a 256-token chunk at start 512, the
             speculative verify window [8, 5], GQA 32/4 (group 8) at head
             dims 128 and 64 (TinyLlama-1.1B); the block-sparse kernel for
             layout
             blocks 16-128, head dims 64 and 128, causal, bidirectional
             and empty rows (bf16 B4 prefill and B6 outputs, which round P
             to bf16 in the product, under the same SDPA witness)
  4 generate init_inference(llama2_7b).generate, B=4, prompt 128, 32 new
  5 serve    create_serving_engine(max_batch=8, page_size=128,
             max_seq=2048).generate on 12 mixed-length prompts
    serve-features  bf16, full depth: (a) the prefix cache on 12 prompts
             sharing a 1024-token prefix, (b) the chunked scheduler (chunks
             of 256, SLO classes) on those 12 and an 1800-token prompt,
             (c) speculative decoding with a TinyLlama-1.1B-shaped draft,
             gamma 4, (d) decode_chunk 4, greedy and sampled (the sampled
             streams the same in reverse arrival order); exact launch
             counts; tokens vs monolithic baselines by the divergence rule;
             then phases 4 and 5 in fp16 (tokens vs bf16 by the same rule)
  6 e2e      full width, 2 layers: paged prefill + decode, kernels vs plain;
             (a)-(d) in fp32, tokens identical to the monolithic run (the
             draft also as the target's own weights)
  7 train    run_benchmark for gpt_1b (seq 1024), bloom_1b7 (ALiBi) and
             gpt_neo_1_3b (global / local window 256), seq 2048, micro 2,
             gas 4, bf16, AdamW; exact launches counted; a fixed batch's
             loss falls and one train_batch is profiled, for each; BLOOM's
             fixed batch again through the plain versions; 2 layers of
             each, kernels vs plain (losses, grad norm, then m and the
             update parameter by parameter; GPT-Neo in fp32 too, and two
             plain engines that split the batch differently, as a witness);
             fp16: gpt_1b through the ds_bench train CLI (--dtype fp16
             --scheduler WarmupDecayLR, the loss scale from 2**23: skipped
             steps, then applied ones; exact launches), a fixed fp16 batch
             (the loss falls over the applied steps; fp16 vs bf16 wall,
             device and busy share) and 2 layers kernels vs plain from
             2**29 (the same skip pattern and loss scales)
    ckpt     training that survives a restart, gpt_1b through
             initialize(training_data=...) at full width and depth, micro
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
             dims 64 and 128) at B=2, S=4096, 16 heads: launches counted,
             outputs vs the plain version; the key_padding_mask path and
             the refusal of a gradient request
  9 timing   each kernel at the main path's shapes vs its bound, its plain
             version and one PyTorch library call (a yardstick only), the
             flash kernels in bf16 and fp16 and at GPT-Neo's global
             layers' shape, the
             decode kernel also at Llama-2's whole context (len 4096), the
             ragged kernel's prefill tiles at the serve run's buckets 512
             and 1024 (beside B1's forward on the same work), B5 and B4 in
             fp16, the verify window, the TinyLlama decode step, the chunk
             at an offset; fused
             Adam held against its plain version over gpt_1b's 1.01 B
             parameters; the window-256 forward must take well under the
             ALiBi forward's time

The second-to-last line of stdout is the kernels JSON, the last line
``{"ok": true, "device": {...}}``.  Any failure exits non-zero before the
last line is printed.  It imports nothing of JAX or ``deepspeed_tpu``.
"""

import argparse
import dataclasses
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
REPO = os.path.dirname(os.path.abspath(__file__))


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def phase(name, msg):
    print(f"[{name}] {msg}", flush=True)


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


def phase_build():
    from deepspeed_tpu_torch.ops import op_builder
    t0 = time.time()
    logs = op_builder.build()
    dt = time.time() - t0
    phase("build", f"nvcc sm_90a, {len(logs)} kernel sources built in "
          f"{dt:.1f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                phase("build", f"{name}: {line.strip()}")
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
# the flash kernels' <bf16 or fp16, alibi, window>, B6's <block, head dim>
# (bf16), and B4's prefill kernel's <bf16 or fp16>
_DTYPE_ARG = {"13__nv_bfloat16": "bf16", "6__half": "fp16"}
_FLASH_ARGS = (r"I(13__nv_bfloat16|6__half)Lb([01])ELb([01])E",
               lambda x: _DTYPE_ARG.get(x) or bool(int(x)), 8)
SASS_TEMPLATES = {
    "flash_fwd_kernel": _FLASH_ARGS,
    "flash_bwd_dq_kernel": _FLASH_ARGS,
    "flash_bwd_dkv_kernel": _FLASH_ARGS,
    "sparse_tc_kernel": (r"ILi(\d+)ELi(\d+)E", int, 8),
    "ragged_prefill_tc_kernel": (r"I(13__nv_bfloat16|6__half)E",
                                 _DTYPE_ARG.get, 2),
}


def sass_counts(sass, kernel):
    """{template arguments: (HGMMA count, UTMALDG count)} of the
    tensor-core instantiations of template ``kernel`` in ``cuobjdump
    -sass`` output, read by SASS_TEMPLATES: e.g. the flash kernels' names
    end ``<kernel>I13__nv_bfloat16Lb<0|1>ELb<0|1>E`` (``I6__half...`` for
    fp16) and give keys (dtype, alibi, window)."""
    import re
    args, conv, _ = SASS_TEMPLATES[kernel]
    pat = re.compile(r"\d" + re.escape(kernel) + args)
    counts = {}
    for part in sass.split("Function : ")[1:]:
        m = pat.search(part.split("\n", 1)[0])
        if m:
            counts[tuple(conv(x) for x in m.groups())] = (
                len(re.findall(r"\bHGMMA\b", part)),
                len(re.findall(r"\bUTMALDG\b", part)))
    return counts


def phase_sass():
    """Counts HGMMA and UTMALDG in the SASS (cuobjdump -sass) of each bf16
    and fp16 instantiation of the tensor-core kernels; fails if one lacks
    either or an instantiation is missing."""
    import shutil
    from deepspeed_tpu_torch.ops import op_builder
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    for source, kernel in TENSOR_CORE_KERNELS:
        lib = op_builder._lib_path(source)
        run = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                             text=True, timeout=300)
        if run.returncode != 0:
            fail(f"cuobjdump -sass {lib.name}: {run.stderr.strip()[:300]}")
        counts = sass_counts(run.stdout, kernel)
        for args, (n_mma, n_tma) in sorted(counts.items()):
            phase("build", f"SASS {kernel}{list(args)}: {n_mma} HGMMA, "
                  f"{n_tma} UTMALDG")
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
    ``shared_pages`` > 0); :func:`_engine_state` builds the serve run's."""
    import torch
    from deepspeed_tpu_torch.ops.paged_attention import PagedAllocator
    n_pages = 160
    alloc = PagedAllocator(n_pages, page, max_pages_per_seq=16,
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


def _engine_state(needs, Hkv, D, dtype, gen):
    """K/V pools and block tables as the serving engine of phase 5 builds
    them (``ServingEngine.__init__`` / ``_admit``): 8 slots x 16 pages + the
    scratch page 0 in the pool, tables of max_seq/page columns plus the
    overrun column, which stays 0.  Slot s reserves ``needs[s]`` tokens;
    None is an idle slot, a row of zeros.  Pages recycled from a finished
    request come first, as mid-run."""
    import torch
    from deepspeed_tpu_torch.ops.paged_attention import PagedAllocator
    page, mpps = SERVE_PAGE, SERVE_MAX_SEQ // SERVE_PAGE
    n_pages = SERVE_SLOTS * mpps + 1
    alloc = PagedAllocator(n_pages, page, mpps, reserve_scratch=True)
    alloc.allocate("finished", 3 * page + 1)
    alloc.allocate("busy", 5 * page)
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


def phase_kernels():
    """Each kernel vs its plain version, at the main path's shapes and at
    edge cases; returns max abs err per kernel and dtype."""
    import torch
    from deepspeed_tpu_torch.ops.cuda.decode_attention import (
        DECODE_ROWS, decode_attention_cuda, decode_attention_plain,
        decode_plan)
    from deepspeed_tpu_torch.ops.cuda.ragged_paged_attention import (
        paged_attention_plain, ragged_paged_attention,
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

    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        dn = str(dtype).split(".")[-1]
        for Hkv in (32, 8):
            # B5: ragged lengths over S_max 2048, and generate's own calls
            # (B=4, cache 128 + 32, one int length for every sequence):
            # its prefill (T=128, length 128) and a decode (length 144)
            b5 = [(4, T, 2048, i32([T + 5, 700, 1500, 2048]))
                  for T in (1, 128)] + [(4, 128, 160, 128), (4, 1, 160, 144)]
            # then lengths where the decode form's key chunks meet a
            # sequence's end, at the wrapper's own plan for S_max 2048 --
            # one sequence for MHA, four (a ragged batch) for GQA, so that
            # the keys are split: T, chunk - 1, chunk, chunk + 1, chunk + 3
            # (T=4: the mask kpos <= len - T + t across the edge), two
            # chunks + 1, S_max - 1; and one int length over S_max 1536
            Be = 1 if Hkv == H else 4
            for T in (1, 4):
                n, c = decode_plan(Be, T, H, Hkv, 2048, dtype, "cuda")
                if T * H // Hkv <= DECODE_ROWS and n == 1:
                    fail(f"decode_attention B={Be} T={T} H{H}/{Hkv}: the "
                         f"chunk-edge cases take one chunk; they check "
                         f"nothing")
                edges = [x for x in (T, c - 1, c, c + 1, c + 3, 2 * c + 1,
                                     2047) if T <= x <= 2048]
                edges += [2047] * (-len(edges) % Be)
                b5 += [(Be, T, 2048, i32(edges[i:i + Be]))
                       for i in range(0, len(edges), Be)]
            b5.append((Be, 1, 1536, 1529))
            for B, T, S, lens in b5:
                q = _rand((B, T, H, D), dtype, gen)
                k = _rand((B, Hkv, S, D), dtype, gen)
                v = _rand((B, Hkv, S, D), dtype, gen)
                got = decode_attention_cuda(q, k, v, lens)
                want = reference(decode_attention_plain, q, k, v, lens)
                n, c = decode_plan(B, T, H, Hkv, S, dtype, "cuda")
                how = f"length {lens}" if isinstance(lens, int) else \
                    f"lengths {lens.tolist()}"
                note("decode_attention", dn, check_close(
                    f"decode_attention {dn} H{H}/{Hkv} B={B} T={T} "
                    f"S_max={S} {how} ({n} x {c} keys)", got, want))
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
                note("ragged_paged_attention", dn, check_output(
                    f"ragged_paged_attention {dn} H{H}/{Hkv} {label}", got,
                    exact, lambda: paged_sdpa(qq, kk, vv, tb, lens),
                    tiles(dtype, D, H // Hkv, kk.shape[2], [T])))
            # B4 packed front-end, mixed batches in one call: prefills,
            # decodes sharing prefix pages, partial pages; then decode rows
            # of 1-4 tokens (MHA: one decode launch of 4-row blocks) beside
            # a prefill
            packed = [([37, 1, 1, 128, 9, 1], [37, 300, 1000, 400, 521, 257])]
            if Hkv == H:
                packed.append(([3, 1, 4, 2, 200], [3, 640, 300, 1001, 329]))
            for q_lens, ctx in packed:
                tb, kk, vv = _paged_state(ctx, page, Hkv, D, dtype, gen,
                                          shared_pages=2)
                if not (tb[1, 0] == tb[2, 0] and tb[1, 1] == tb[2, 1]):
                    fail("packed case: prefix pages are not shared")
                qp = _rand((sum(q_lens), H, D), dtype, gen)
                got = ragged_paged_attention(qp, kk, vv, tb, ctx, q_lens)
                seqs, off = [], 0
                for s, ql in enumerate(q_lens):
                    seqs.append((qp[off:off + ql][None], tb[s:s + 1],
                                 i32([ctx[s]])))
                    off += ql
                kf, vf = kk.float(), vv.float()
                exact = torch.cat([paged_attention_plain(
                    x.float(), kf, vf, t, c)[0] for x, t, c in seqs])
                note("ragged_paged_attention", dn, check_output(
                    f"ragged_paged_attention {dn} H{H}/{Hkv} packed mixed "
                    f"q_lens {q_lens}", got, exact,
                    lambda: torch.cat([paged_sdpa(x, kk, vv, t, c)[0]
                                       for x, t, c in seqs]),
                    tiles(dtype, D, H // Hkv, page, q_lens)))
        # GQA 32/4 (group 8): Llama-2's width at head dim 128 (its decode
        # rows exceed DECODE_ROWS and take prefill tiles), then the
        # TinyLlama-1.1B draft's shape, head dim 64 (CUDA-core tiles
        # only): its decode step and a 256-token chunk at start 512
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
                note("ragged_paged_attention", dn, check_output(
                    f"ragged_paged_attention {dn} H{H}/4 D={Dg} {label}",
                    got, exact, lambda: paged_sdpa(qq, kk, vv, tb, lens),
                    tiles(dtype, Dg, H // 4, kk.shape[2], [T])))
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


def phase_train_kernels():
    """B1, B2 (dQ and dK/dV) and B3 vs their plain versions run in fp32
    on the kernels' own inputs: O and LSE of the forward; dQ, dK, dV of
    the backward from the kernel's own (O, LSE) and one dO (check_flash:
    bf16 and fp16 O, dQ, dK and dV also against SDPA's error).  B3 with
    its skip flag 0 against the plain version, and with the flag 1: p, m,
    v and the count unchanged, bit for bit."""
    import torch
    from deepspeed_tpu_torch.ops.adam import (AdamState, adam_hyper,
                                              fused_adam, reference_impl)
    from deepspeed_tpu_torch.ops.cuda.flash_attention import (
        flash_attention_bwd_cuda, flash_attention_fwd_cuda)
    gen = torch.Generator(device="cuda").manual_seed(4321)
    D = 128
    errs = {}

    def note(kernel, dn, e):
        errs[(kernel, dn)] = max(errs.get((kernel, dn), 0.0), e)

    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        dn = str(dtype).split(".")[-1]
        for label, B, S, H, Hkv, causal, scale in FLASH_CASES:
            scale = scale or 1.0 / math.sqrt(D)
            q = _rand((B, S, H, D), dtype, gen)
            k = _rand((B, S, Hkv, D), dtype, gen)
            v = _rand((B, S, Hkv, D), dtype, gen)
            dout = _rand((B, S, H, D), dtype, gen)
            out, lse = flash_attention_fwd_cuda(q, k, v, scale, causal)
            got = flash_attention_bwd_cuda(q, k, v, out, lse, dout, scale,
                                           causal)
            check_flash(note, "", f"{dn} {label} causal={causal}",
                        (q, k, v, dout), scale, causal, {}, out, lse, got)
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
    return errs


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


def phase_biased_kernels():
    """Biased B1 and B2 (ALiBi slopes, sliding windows) vs their plain
    versions run in fp32 on the kernels' own inputs, fp32, bf16 and fp16
    (check_flash)."""
    import torch
    from deepspeed_tpu_torch.models.transformer import alibi_slopes
    from deepspeed_tpu_torch.ops.cuda.flash_attention import (
        flash_attention_bwd_cuda, flash_attention_fwd_biased_cuda)
    gen = torch.Generator(device="cuda").manual_seed(5678)
    D = 128
    errs = {}

    def note(kernel, dn, e):
        errs[(kernel, dn)] = max(errs.get((kernel, dn), 0.0), e)

    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        dn = str(dtype).split(".")[-1]
        for label, B, S, H, Hkv, alibi, window, scale in BIASED_CASES:
            scale = scale or 1.0 / math.sqrt(D)
            bias = dict(alibi_slopes=alibi_slopes(H).cuda() if alibi
                        else None, window=window)
            q = _rand((B, S, H, D), dtype, gen)
            k = _rand((B, S, Hkv, D), dtype, gen)
            v = _rand((B, S, Hkv, D), dtype, gen)
            dout = _rand((B, S, H, D), dtype, gen)
            out, lse = flash_attention_fwd_biased_cuda(q, k, v, scale, True,
                                                       **bias)
            got = flash_attention_bwd_cuda(q, k, v, out, lse, dout, scale,
                                           True, **bias)
            check_flash(note, "_biased", f"{dn} {label}", (q, k, v, dout),
                        scale, True, bias, out, lse, got)
            del q, k, v, dout, out, lse, got
    return errs


def check_flash(note, kind, label, inputs, scale, causal, bias, out, lse,
                got):
    """The flash kernels' (O, LSE) and (dQ, dK, dV) on ``inputs`` (q, k, v,
    dO) vs the plain versions run in fp32 on the kernels' own inputs, O and
    LSE.  fp32 and LSE: check_close.  bf16 and fp16 O, dQ, dK, dV (the
    tensor-core kernels): check_witnessed, against SDPA in their dtype on
    the same inputs and the exact fp32 answer.  ``kind``: "" or "_biased",
    the kernels' names' suffix."""
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
    CUDA-core form) and bf16 (the tensor-core form, check_witnessed
    against SDPA with the expanded mask), causal and bidirectional
    layouts, and q blocks that see no key."""
    import numpy as np
    import torch
    from deepspeed_tpu_torch.ops.cuda.sparse_attention import \
        sparse_attention_cuda
    from deepspeed_tpu_torch.ops.sparse_attention import \
        sparse_attention_plain
    gen = torch.Generator(device="cuda").manual_seed(8765)
    B, H = 2, 16
    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
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
                    lambda: sparse_sdpa(q, k, v, layout, block, causal))
                worst[("sparse_attention", dn)] = max(
                    worst.get(("sparse_attention", dn), 0.0), e)
    return worst


# the block-sparse entry point's calls, and B6's timing cases: (layout
# kind, block, head dim) at bf16 B=2 S=4096 16 heads -- Fixed (block 16,
# unidirectional) and BigBird (block 64, bidirectional), each at head dim
# 64 (the reference's BERT-style users) and 128 (BLOOM's width)
SPARSE_PATH = [("fixed", 16, 64), ("fixed", 16, 128), ("bigbird", 64, 64),
               ("bigbird", 64, 128)]
SPARSE_B, SPARSE_S, SPARSE_H = 2, 4096, 16


def phase_sparse_path():
    """The block-sparse entry point as a user calls it: one
    ``SparseSelfAttention(config)`` per SPARSE_PATH case, called under
    ``torch.no_grad()`` on bf16 [B, S, H, D] CUDA tensors, counters read
    around the calls (each call launches the kernel once, no plain version
    runs).  Then each output is held against the plain version run in fp32
    on its inputs; a call with a ``key_padding_mask`` takes the dense path
    (the JAX package's rule) and launches nothing; and a call whose inputs
    need a gradient raises (the kernel is forward only)."""
    import torch
    from deepspeed_tpu_torch.ops.sparse_attention import (
        SparseSelfAttention, sparse_attention_plain)
    gen = torch.Generator(device="cuda").manual_seed(2468)
    B, S, H = SPARSE_B, SPARSE_S, SPARSE_H
    calls = []
    for kind, block, D in SPARSE_PATH:
        attn = SparseSelfAttention(_sparsity_config(kind, H, block),
                                   max_seq_length=S)
        calls.append((f"{kind} block {block} D={D}", attn,
                      *(_rand((B, S, H, D), torch.bfloat16, gen)
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
    err = 0.0
    for (label, attn, q, k, v), out in zip(calls, outs):
        if tuple(out.shape) != (B, S, H, q.shape[-1]) or \
                out.dtype != torch.bfloat16:
            fail(f"SparseSelfAttention {label}: output {out.dtype} "
                 f"{tuple(out.shape)}")
        causal = attn.sparsity_config.attention == "unidirectional"
        layout, block = attn.get_layout(S), attn.sparsity_config.block
        exact = sparse_attention_plain(q.float(), k.float(), v.float(),
                                       layout, block, causal=causal)
        err = max(err, check_output(
            f"SparseSelfAttention {label} B={B} S={S} H={H} bfloat16 "
            f"causal={causal}", out, exact,
            lambda: sparse_sdpa(q, k, v, layout, block, causal)))
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
    return counts, dt, err


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
        "sparse_attention": (spa.sparse_attention_cuda, "launches"),
        "decode_attention_plain": (da.decode_attention_plain, "calls"),
        "paged_attention_plain": (rp.paged_attention_plain, "calls"),
        "flash_attention_fwd_plain": (
            flash_attention.flash_attention_fwd_plain, "calls"),
        "flash_attention_bwd_plain": (
            flash_attention.flash_attention_bwd_plain, "calls"),
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
    model = CausalTransformerLM(cfg, device="cuda",
                                dtype=dtype or torch.bfloat16).init(seed)
    torch.cuda.synchronize()
    return cfg, model, time.time() - t0


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


def phase_e2e(B=4, T=128, steps=4):
    """2 layers at full width: paged prefill + decode through the kernels
    and through the plain versions, from identical states."""
    import numpy as np
    import torch
    cfg, model, _ = build_model(2, seed=7)
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


def _measure(fns, copies):
    """Device time (CUDA-graph replay) and eager time of each fn(i)."""
    out = {}
    for key, fn in fns.items():
        out[key] = graph_ms(fn, copies)
        out[key + "_eager"] = time_ms(fn)
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
              f"kernel {r['ms_eager']:.4f}, plain {r['plain_ms_eager']:.4f},"
              f" library {r['library_ms_eager']:.4f}; bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}), "
              f"{r['bound_ms'] / r['ms']:.3f} of bound, max abs err "
              f"{r['max_abs_err']:.3e}")
    return res


def _time_decode(name, dtype, B, S, L, copies, gen):
    """B5 at [B, T=1], one int length L over S_max S: kernel, plain and
    SDPA device times, bound and error (a phase_timing row)."""
    import torch
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops.cuda.decode_attention import (
        decode_attention_cuda, decode_attention_plain)
    H, Hkv, D = 32, 32, 128
    dn = str(dtype).split(".")[-1]
    q = _rand((copies, B, 1, H, D), dtype, gen)
    k = _rand((copies, B, Hkv, S, D), dtype, gen)
    v = _rand((copies, B, Hkv, S, D), dtype, gen)
    err = check_close(f"timing {name}",
                      decode_attention_cuda(q[0], k[0], v[0], L),
                      reference(decode_attention_plain, q[0], k[0], v[0], L))
    qs = q.transpose(2, 3).contiguous()
    times = _measure({
        "ms": lambda i: decode_attention_cuda(q[i % copies], k[i % copies],
                                              v[i % copies], L),
        "plain_ms": lambda i: decode_attention_plain(
            q[i % copies], k[i % copies], v[i % copies], L),
        "library_ms": lambda i: F.scaled_dot_product_attention(
            qs[i % copies], k[i % copies][:, :, :L],
            v[i % copies][:, :, :L])}, copies)
    nbytes = B * (2 * Hkv * L * D + 2 * H * D) * q.element_size()
    bound_ms, bound_by = _bound(nbytes, B * 4 * H * D * L, dn)
    return dict(max_abs_err=err, **times, bound_ms=bound_ms,
                bound_by=bound_by,
                shape=f"B={B} T=1 H={H} Hkv={Hkv} D={D} len={L} S_max={S} "
                      f"{dn}")


def _time_paged(name, dtype, needs, ctx, T, Hkv, D, copies, gen, H=32):
    """B4's rect front-end at [len(ctx), T] over the serve run's page pools
    (slot s reserves needs[s] tokens, holds ctx[s] with its last T the
    queries): kernel, plain and SDPA device times (SDPA over the gathered
    dense K/V with the causal-ragged mask), bound and error."""
    import torch
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops.cuda.decode_attention import DECODE_ROWS
    from deepspeed_tpu_torch.ops.cuda.ragged_paged_attention import (
        paged_attention_plain, ragged_paged_attention_rect,
        tensor_core_prefill)
    dn = str(dtype).split(".")[-1]
    B, group = len(ctx), H // Hkv
    states = [_engine_state(needs, Hkv, D, dtype, gen)
              for _ in range(copies)]
    lens = torch.tensor(ctx, dtype=torch.int32, device="cuda")
    q = _rand((copies, B, T, H, D), dtype, gen)
    tb, kp, vp = states[0]
    exact = paged_attention_plain(q[0].float(), kp.float(), vp.float(), tb,
                                  lens)
    tc = tensor_core_prefill(dtype, D, group, SERVE_PAGE) and \
        T * group > DECODE_ROWS
    err = check_output(f"timing {name}",
                       ragged_paged_attention_rect(q[0], kp, vp, tb, lens),
                       exact, lambda: paged_sdpa(q[0], kp, vp, tb, lens), tc)
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
    pairs = sum(int(p) + 1 for p in qpos.flatten().tolist())
    nbytes = (sum(2 * Hkv * c * D for c in ctx) + 2 * B * T * H * D) * \
        q.element_size()
    bound_ms, bound_by = _bound(nbytes, 4 * H * D * pairs, dn)
    return dict(max_abs_err=err, **times, bound_ms=bound_ms,
                bound_by=bound_by,
                shape=f"B={B} T={T} H={H} Hkv={Hkv} D={D} page={SERVE_PAGE}"
                      f" ctx={ctx} {dn}")


def phase_timing_serving():
    """This slice's forms at the shapes their main paths give them: B5 and
    B4 in fp16 (generate's decode step, the serve run's decode step and
    its 512 / 1024 prefills), and, in bf16, the speculative verify window
    [8, 5] (prefill tiles at group 1), the TinyLlama draft's decode step
    (group 8, head dim 64: CUDA-core tiles) and a 256-token chunk at start
    512."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(98)
    fp16, bf16 = torch.float16, torch.bfloat16
    prompts = SERVE_PROMPTS[:SERVE_SLOTS]
    needs = [p + SERVE_NEW for p in prompts]
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
        needs, [p + 16 for p in prompts], 1, DRAFT_SHAPE["n_kv_heads"],
        DRAFT_SHAPE["hidden_size"] // DRAFT_SHAPE["n_heads"], 4, gen)
    rows["ragged_paged_attention_chunk_at_offset"] = _time_paged(
        "ragged_paged_attention chunk T=256 at start 512", bf16,
        [1024 + SERVE_NEW], [768], CHUNK_TOKENS, 32, 128, 4, gen)
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
            st["spec_windows"], acceptance=snap["spec_acceptance_rate"],
            dt=dt)

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


def _free():
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def train_launches(cfg, gas, calls):
    """Kernel launches of ``calls`` train_batch calls of a model with
    config ``cfg``: per layer and micro-batch the flash forward twice
    (remat recomputes it in the backward) and each backward kernel once,
    then fused Adam once per call.  A layer with ALiBi slopes or a window
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
                 "fused_adam": calls})
    return want


def check_train_launches(counts, cfg, gas, calls, where):
    """Fails unless every kernel launched exactly :func:`train_launches`
    times and no plain version ran."""
    want = train_launches(cfg, gas, calls)
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


def phase_train_e2e(name=TRAIN_MODEL, bf16=True, steps=2, witness=False):
    """TRAIN_MODELS[name] at full width and its own seq, cut to its first
    2 layers (GPT-Neo: one global and one local layer), micro 2, gas 2,
    bf16 (or fp32): one engine through the kernels and one through the
    plain versions of attention and Adam, from one init, on the same
    batches.  Held: losses and the first grad norm; m after each step (see
    E2E_M_REL_TOL); the update after the last step; the key bias's moves.
    With ``witness`` a third engine runs the plain versions over the same
    batches split as micro 1 x gas 4, and its m is compared with the
    micro 2 x gas 2 plain engine's, step by step (see
    E2E_WITNESS_FACTOR)."""
    import dataclasses
    import numpy as np
    import torch
    from deepspeed_tpu_torch.benchmarks.training import (ds_config,
                                                         model_config)
    from deepspeed_tpu_torch.models.transformer import CausalTransformerLM
    from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
    from deepspeed_tpu_torch.runtime.engine import DeepSpeedEngine
    model, seq, vocab_size = TRAIN_MODELS[name]
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
        conf = ds_config(micro, gas)
        if not bf16:
            del conf["bf16"]
        engine = DeepSpeedEngine(
            CausalTransformerLM(cfg, device="cuda").init(5),
            DeepSpeedConfig(conf), backend=backend)
        if init is None:
            init = engine.master.clone()
        elif not torch.equal(engine.master, init):
            fail("train e2e: the engines start from different weights")
        losses, norms, moments = [], [], []
        for b in batches:
            ids = b["input_ids"].reshape(gas, micro, seq)
            losses.append(float(engine.train_batch(batch={"input_ids": ids})))
            norms.append(engine.get_global_grad_norm())
            moments.append(engine.opt_state.m.clone())
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
                witness_rels=witness_rels)


def phase_train_e2e_fp16(steps=FP16_E2E_STEPS):
    """gpt_1b at full width, cut to 2 layers, micro 2 x gas 2, in fp16 with
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
    cfg = dataclasses.replace(model_config(TRAIN_MODEL, TRAIN_SEQ),
                              n_layers=2)
    rng = np.random.default_rng(13)
    batches = [{"input_ids": rng.integers(0, cfg.vocab_size,
                                          (2, 2, TRAIN_SEQ))}
               for _ in range(steps)]
    conf = ds_config(2, 2, "fp16",
                     scheduler=scheduler_config(FP16_SCHEDULER, steps),
                     initial_scale_power=FP16_E2E_SCALE_POWER)
    runs, init = {}, None
    for backend in ("cuda", "plain"):
        engine = DeepSpeedEngine(
            CausalTransformerLM(cfg, device="cuda").init(5),
            DeepSpeedConfig(conf), backend=backend)
        if init is None:
            init = engine.master.clone()
        elif not torch.equal(engine.master, init):
            fail("train e2e fp16: the engines start from different weights")
        rec = dict(losses=[], skips=[], scales=[], norms=[], m=[])
        for b in batches:
            rec["losses"].append(float(engine.train_batch(batch=b)))
            rec["skips"].append(engine.last_step_overflowed())
            rec["scales"].append(engine.get_loss_scale())
            rec["norms"].append(engine.get_global_grad_norm())
            rec["m"].append(None if rec["skips"][-1] else
                            engine.opt_state.m.clone())
        rec["master"] = engine.master.clone()
        runs[backend] = rec
        names, sizes = zip(*[(n, p.numel())
                             for n, p in engine.module.named_parameters()])
        del engine
        _free()
    k, p = runs["cuda"], runs["plain"]
    differ = [i for i in range(steps) if k["skips"][i] != p["skips"][i]]
    if differ:
        fail(f"train e2e fp16: kernels and plain disagree on overflow at "
             f"steps {differ}: kernels {k['skips']}, plain {p['skips']}")
    if k["scales"] != p["scales"]:
        fail(f"train e2e fp16: loss scales {k['scales']} vs plain "
             f"{p['scales']}")
    applied = [i for i, s in enumerate(k["skips"]) if not s]
    if not k["skips"][0] or len(applied) < 3:
        fail(f"train e2e fp16: skip pattern {k['skips']}: the first step "
             f"must overflow and 3 or more must apply")
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(k["losses"],
                                                       p["losses"]))
    first = applied[0]
    norm_rel = abs(k["norms"][first] - p["norms"][first]) / \
        abs(p["norms"][first])

    def worst(a, b):
        rels = [((x - y).norm() / y.norm()).item()
                for x, y in zip(a.split(sizes), b.split(sizes))]
        i = max(range(len(rels)), key=rels.__getitem__)
        return rels[i], names[i]

    m_rels = [worst(k["m"][i], p["m"][i]) for i in applied]
    upd_rel = worst(k["master"] - init, p["master"] - init)
    if not np.isfinite(k["losses"]).all() or loss_rel > E2E_TRAIN_REL_TOL \
            or norm_rel > E2E_TRAIN_REL_TOL or \
            any(r > E2E_M_REL_TOL for r, _ in m_rels) or \
            upd_rel[0] > E2E_UPDATE_REL_TOL:
        fail(f"train e2e fp16: losses {k['losses']} vs plain {p['losses']} "
             f"(max rel {loss_rel:.2e}), grad norm rel {norm_rel:.2e} (tol "
             f"{E2E_TRAIN_REL_TOL}); m by applied step {m_rels} (tol "
             f"{E2E_M_REL_TOL}); update {upd_rel} (tol {E2E_UPDATE_REL_TOL})")
    return dict(k=k, p=p, applied=applied, loss_rel=loss_rel,
                norm_rel=norm_rel, m_rels=m_rels, upd_rel=upd_rel)


def phase_train_timing(errs):
    """B1, B2 (dQ, dK/dV) and B3 at the training path's shapes, attention
    B=2 S=1024 16 heads of 128 causal in bf16 and in fp16, Adam over
    gpt_1b's parameter count (held against its plain version there first,
    then timed with its skip flag 0 and 1): kernel, plain version, library
    call (SDPA in the same dtype) and bound.  Attention by CUDA-graph
    replay over 4 rotating input sets (more than the 50 MB L2); Adam
    (ms-scale) by CUDA events, eagerly.  Returns {kernel: row} for bf16
    and {(kernel, "fp16"): row} for fp16."""
    import torch
    import torch.nn.functional as F
    from deepspeed_tpu_torch.benchmarks.training import model_config
    from deepspeed_tpu_torch.ops.adam import (AdamState, adam_hyper,
                                              fused_adam, reference_impl)
    from deepspeed_tpu_torch.ops.cuda.flash_attention import (
        flash_attention_bwd_dkv_cuda, flash_attention_bwd_dq_cuda,
        flash_attention_fwd_cuda)
    from deepspeed_tpu_torch.ops.cuda.fused_adam import fused_adam_cuda
    from deepspeed_tpu_torch.ops.flash_attention import (
        flash_attention_bwd_plain, flash_attention_fwd_plain)
    cfg = model_config(TRAIN_MODEL, TRAIN_SEQ)
    gen = torch.Generator(device="cuda").manual_seed(77)
    B, S, H, D = TRAIN_BATCH, TRAIN_SEQ, cfg.n_heads, cfg.head_dim
    Hkv = cfg.kv_heads
    c = 4
    scale = 1.0 / math.sqrt(D)
    flops = {"fwd": 2 * B * H * S * S * D, "dq": 3 * B * H * S * S * D,
             "dkv": 4 * B * H * S * S * D}
    # each input read once, each output written once in the function's
    # dtype: O and dQ like q; dK and dV like k, at Hkv heads (the kernel's
    # fp32 per-query-head scratch is its own layout, not the function's)
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
        # library yardstick: SDPA in [B, H, S, D], forward and backward
        qt, kt, vt, dot = (x.transpose(2, 3).contiguous()
                           for x in (q, k, v, do))
        leaves = [[x[i].clone().requires_grad_() for x in (qt, kt, vt)]
                  for i in range(c)]

        def sdpa_fwd_bwd(i):
            a, b_, v_ = leaves[i]
            out = F.scaled_dot_product_attention(a, b_, v_, is_causal=True)
            torch.autograd.grad(out, (a, b_, v_), dot[i])

        fwd_ms = graph_ms(lambda i: flash_attention_fwd_cuda(
            q[i], k[i], v[i], scale), c)
        plain_fwd_ms = graph_ms(lambda i: flash_attention_fwd_plain(
            q[i], k[i], v[i], scale), c)
        plain_bwd_ms = graph_ms(lambda i: flash_attention_bwd_plain(
            q[i], k[i], v[i], o[i], lse[i], do[i], scale), c)
        lib_fwd_ms = graph_ms(lambda i: F.scaled_dot_product_attention(
            qt[i], kt[i], vt[i], is_causal=True), c)
        lib_bwd_ms = graph_ms(sdpa_fwd_bwd, c) - lib_fwd_ms
        dq_ms = graph_ms(lambda i: flash_attention_bwd_dq_cuda(
            q[i], k[i], v[i], do[i], lse[i], delta[i], scale), c)
        dkv_ms = graph_ms(lambda i: flash_attention_bwd_dkv_cuda(
            q[i], k[i], v[i], do[i], lse[i], delta[i], scale), c)
        shape = f"B={B} S={S} H={H}/{H} D={D} causal {dn}"
        for name, key, ms, plain_ms, lib_ms in (
                ("flash_attention_fwd", "fwd", fwd_ms, plain_fwd_ms,
                 lib_fwd_ms),
                ("flash_attention_bwd_dq", "dq", dq_ms, plain_bwd_ms,
                 lib_bwd_ms),
                ("flash_attention_bwd_dkv", "dkv", dkv_ms, plain_bwd_ms,
                 lib_bwd_ms)):
            bound_ms, bound_by = _bound(nbytes[key], flops[key], dn)
            row = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                       bound_ms=bound_ms, bound_by=bound_by, shape=shape,
                       max_abs_err=errs[(name, dn)])
            res[name if dt == torch.bfloat16 else (name, "fp16")] = row
        del q, k, v, do, o, lse, delta, qt, kt, vt, dot, leaves, outs
        _free()
    for name in ("flash_attention_fwd", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv"):
        phase("timing", f"{name}: fp16 {res[(name, 'fp16')]['ms']:.4f} ms "
              f"vs bf16 {res[name]['ms']:.4f} ms "
              f"({res[(name, 'fp16')]['ms'] / res[name]['ms']:.3f}x); "
              f"SDPA fp16 {res[(name, 'fp16')]['library_ms']:.4f} ms")

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
                                           **kw), iters=5, warmup=1)
    skip_ms = time_ms(lambda i: fused_adam_cuda(p, g, m, v, hyper,
                                                flags[1], **kw),
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
    for name, r in res.items():
        phase("timing", f"{name} [{r['shape']}]: device ms kernel "
              f"{r['ms']:.4f}, plain {r['plain_ms']:.4f}, library "
              f"{r['library_ms']:.4f}; bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}), {r['bound_ms'] / r['ms']:.3f} of bound")
    phase("timing", f"fused_adam with its skip flag set: {skip_ms:.4f} ms "
          f"(nothing read or written)")
    return res


# the timing cases at S=2048: (label, ALiBi, window, softmax scale) at
# bf16 B=2 S=2048 16 heads of 128 causal -- BLOOM-1b7's layers, GPT-Neo-
# 1.3B's local layers and its global layers (unscaled logits; no bias: the
# unbiased kernels); the first is the kernels JSON row of the biased ones
BIASED_TIMING = [("ALiBi (bloom_1b7)", True, None, 1.0 / math.sqrt(128)),
                 ("window 256 (gpt_neo_1_3b local)", False, 256, 1.0),
                 ("global (gpt_neo_1_3b)", False, None, 1.0)]


def phase_biased_timing(errs):
    """B1 and B2 (dQ, dK/dV) at the S=2048 training paths' shapes
    (BIASED_TIMING; biased kernels where there is a bias): kernel, plain
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
    B, S, H, D = TRAIN_BATCH, 2048, 16, 128
    dt, c = torch.bfloat16, 4
    gen = torch.Generator(device="cuda").manual_seed(78)
    q, k, v, do = (_rand((c, B, S, H, D), dt, gen) for _ in range(4))
    qt, kt, vt, dot = (x.transpose(2, 3).contiguous() for x in (q, k, v, do))
    pos = torch.arange(S, device="cuda")
    e, f4 = B * S * H * D * 2, B * H * S * 4
    res = {}
    for label, alibi, window, scale in BIASED_TIMING:
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
            q[i], k[i], v[i], scale, True, **kw), c)
        plain_bwd = graph_ms(lambda i: flash_attention_bwd_plain(
            q[i], k[i], v[i], o[i], lse[i], do[i], scale, True, **kw), c)
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
                   f"{key}{kind}"
            bound_ms, bound_by = _bound(nbytes[key], flops[key], "bfloat16")
            res[(name, label)] = dict(
                ms=times[key], plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=bound_ms, bound_by=bound_by,
                max_abs_err=errs[(name, "bfloat16")],
                shape=f"B={B} S={S} H={H}/{H} D={D} {label}, {pairs} (q, k) "
                      f"pairs, bf16")
        del outs, o, lse, delta, mask, leaves
        _free()
    del q, k, v, do, qt, kt, vt, dot
    _free()
    for (name, _), r in res.items():
        phase("timing", f"{name} [{r['shape']}]: device ms kernel "
              f"{r['ms']:.4f}, plain {r['plain_ms']:.4f}, library "
              f"{r['library_ms']:.4f}; bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}), {r['bound_ms'] / r['ms']:.3f} of bound")
    return res


def phase_sparse_timing(err):
    """B6 at the entry point's shapes (SPARSE_PATH): the bf16 kernel by
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
    dt, c = torch.bfloat16, 4
    gen = torch.Generator(device="cuda").manual_seed(79)
    res = {}
    for kind, block, D in SPARSE_PATH:
        layout, causal = _sparse_layout(kind, H, block, S)
        q, k, v = (_rand((c, B, S, H, D), dt, gen) for _ in range(3))
        qt, kt, vt = (x.transpose(2, 3).contiguous() for x in (q, k, v))
        mask = torch.as_tensor(expand_layout_mask(layout, block, S),
                               device="cuda")
        if causal:
            mask &= torch.ones((S, S), dtype=torch.bool,
                               device="cuda").tril()
        # the bf16 kernel's step tables on the card, made once, as
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
        bound_ms, bound_by = _bound(nbytes, flops, "bfloat16")
        label = f"{kind} block {block} D={D}"
        res[("sparse_attention", label)] = dict(
            ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
            bound_by=bound_by, max_abs_err=err,
            shape=f"B={B} S={S} H={H} {label} causal={causal}, "
                  f"{int(counts.sum())} of {H * (S // block) ** 2} blocks "
                  f"set, steps' union x{step_overhead(layout, block, causal):.3f}"
                  f" of their work, bf16")
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
# "ckpt").  gpt_1b at full width and depth, micro TRAIN_BATCH x gas
# TRAIN_GAS, seq TRAIN_SEQ, bf16, as in phase 7.
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

    phase_build()
    phase_sass()
    errs = phase_kernels()
    errs.update(phase_train_kernels())
    errs.update(phase_biased_kernels())
    errs.update(phase_sparse_kernels())
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
    gen_calls = 32                      # 1 prefill + 31 decode calls
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
    b4_launches = {"ragged_paged_attention": L * dec_steps}
    for prompt in SERVE_PROMPTS:
        key = f"ragged_paged_attention_prefill_{_prefill_need(prompt)[0]}"
        b4_launches[key] = b4_launches.get(key, 0) + L
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

    # ---- serve-features: each run counted on its own (serve_run) ------
    from deepspeed_tpu_torch.models.transformer import TransformerConfig
    t0 = time.time()
    dcfg, draft, _ = build_model(DRAFT_SHAPE["n_layers"], seed=1,
                                 cfg=TransformerConfig(**DRAFT_SHAPE))
    feat = phase_serve_features(model, cfg, [("TinyLlama-1.1B", draft)],
                                torch.bfloat16, exact=False, label="bf16")
    phase("serve-features", f"bf16 (a)-(d), Llama-2-7B {L} layers, draft "
          f"TinyLlama-1.1B shape {dcfg.n_layers} layers: "
          f"{time.time() - t0:.1f} s")
    del eng, model, draft
    _free()

    # ---- fp16: phases 4 and 5 again, the same seed's weights in fp16 --
    cfg16, model16, _ = build_model(32, seed=0, dtype=torch.float16)
    reset_counters()
    eng16, _, t_gen16, out16 = phase_generate(model16, cfg16, dtype="fp16")
    c16 = read_counters()
    if c16["decode_attention"] != L * gen_calls or \
            c16["ragged_paged_attention"] or plain_calls(c16):
        fail(f"fp16 generate launches {c16}, expected decode_attention "
             f"{L} x {gen_calls} and nothing else")
    teacher_margins(eng16, out16, ids.shape[1])        # finite or fail
    check_divergence(
        "fp16 generate vs bf16", [r.tolist() for r in gen_out.cpu()],
        [r.tolist() for r in out16.cpu()], [ids[0]] * len(ids),
        gen_margins, "bfloat16")
    reset_counters()
    se16, _, t_serve16, outs16 = phase_serve(eng16, cfg16)
    s16 = read_counters()
    calls16 = se16.stats["model_calls"]
    if s16["ragged_paged_attention"] != L * calls16 or \
            s16["decode_attention"] or plain_calls(s16):
        fail(f"fp16 serve launches {s16}, expected ragged_paged_attention "
             f"{L} x {calls16} and nothing else")
    check_divergence("fp16 serve vs bf16", serve_outs, outs16, prompts,
                     serve_margins, "bfloat16")
    phase("generate", f"fp16 B=4 prompt 128 + 32 new: {t_gen16:.3f} s, "
          f"decode kernel launches {c16['decode_attention']} = {L} x "
          f"{gen_calls}; logits finite")
    phase("serve", f"fp16 12 prompts x 32 new: {t_serve16:.3f} s, "
          f"{n_new / t_serve16:.1f} new tokens/s, ragged kernel launches "
          f"{s16['ragged_paged_attention']} = {L} x {calls16}, logits "
          f"finite, leak_report {{}}")
    step16, dev16, top16, _ = decode_step_ms(eng16, cfg16)
    phase("serve", f"fp16 pure decode step, 8 slots busy: {step16:.3f} ms, "
          f"device {dev16:.3f} ms/step (profiler), busy share "
          f"{dev16 / step16:.3f} (bf16 in this run: {step_ms:.3f} ms, "
          f"device {device_ms:.3f})")
    for name, k_ms in top16:
        phase("serve", f"  fp16 device ms/step {k_ms:.4f}  {name[:90]}")
    fp16_prefills = {}
    for prompt in SERVE_PROMPTS:
        b = _prefill_need(prompt)[0]
        fp16_prefills[b] = fp16_prefills.get(b, 0) + L
    se16_decode_steps = se16.scheduler.sched_stats["decode_steps"]
    del eng16, se16, model16
    _free()

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
    del m2, d2
    _free()

    # ---- training main paths, counters read around each run_benchmark --
    launches = {k: v for k, v in counts.items() if not k.endswith("_plain")}
    for name, (_, seq, _) in TRAIN_MODELS.items():
        out, train_counts, launched = phase_train(name)
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
    # where no bf16 rounding blurs what its unscaled logits amplify
    for name, bf16 in [(n, True) for n in TRAIN_MODELS] + [
            ("gpt_neo_1_3b", False)]:
        r = phase_train_e2e(name, bf16=bf16,
                            witness=name == "gpt_neo_1_3b")
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
    r = phase_train_e2e_fp16()
    phase("e2e", f"train {TRAIN_MODEL} fp16, 2 layers full width, "
          f"{FP16_E2E_STEPS} train_batch steps from loss scale "
          f"2**{FP16_E2E_SCALE_POWER}: skipped "
          f"{[int(x) for x in r['k']['skips']]}"
          f" on both paths, loss scales {[int(x) for x in r['k']['scales']]}"
          f" on both; losses kernels {[round(x, 5) for x in r['k']['losses']]}"
          f" vs plain {[round(x, 5) for x in r['p']['losses']]} (max rel "
          f"{r['loss_rel']:.2e}); first applied grad norm rel "
          f"{r['norm_rel']:.2e}; tol {E2E_TRAIN_REL_TOL}")
    phase("e2e", f"train {TRAIN_MODEL} fp16 state, worst parameter: m rel L2"
          f" by applied step {[(f'{x:.3e}', n) for x, n in r['m_rels']]} "
          f"(tol {E2E_M_REL_TOL}), update rel L2 {r['upd_rel'][0]:.3e} "
          f"({r['upd_rel'][1]}; tol {E2E_UPDATE_REL_TOL})")

    # ---- phase ckpt: save, a new process resumes, serve the tag --------
    from deepspeed_tpu_torch.benchmarks.training import model_config
    ckpt_cfg = model_config(TRAIN_MODEL, TRAIN_SEQ)
    ckpt_counts, _ = phase_ckpt(
        ckpt_cfg, dataclasses.replace(ckpt_cfg, n_layers=CKPT_SMALL_LAYERS))
    for k in launches:
        launches[k] += ckpt_counts.get(k, 0)
    _free()

    # ---- block-sparse entry point, counters read around its calls -----
    sparse_counts, t_sparse, sparse_err = phase_sparse_path()
    for k in launches:
        launches[k] += sparse_counts[k]
    phase("sparse", f"SparseSelfAttention x {len(SPARSE_PATH)} "
          f"{[f'{k} block {b} D={d}' for k, b, d in SPARSE_PATH]} at B="
          f"{SPARSE_B} S={SPARSE_S} H={SPARSE_H} bf16: {t_sparse * 1e3:.1f} ms"
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
    timing.update(phase_train_timing(errs))
    biased = phase_biased_timing(errs)
    sparse = phase_sparse_timing(sparse_err)
    alibi_label, window_label = (b[0] for b in BIASED_TIMING[:2])
    ratio = (biased[("flash_attention_fwd_biased", window_label)]["ms"] /
             biased[("flash_attention_fwd_biased", alibi_label)]["ms"])
    phase("timing", f"biased forward, window 256 vs ALiBi at S=2048: "
          f"{ratio:.3f} of the time (the window's key-tile skip)")
    if ratio > 0.6:
        fail(f"the window-256 forward takes {ratio:.3f} of the ALiBi "
             f"forward's time: its key-tile skip does not work")
    sparse_label = "{} block {} D={}".format(*SPARSE_PATH[0])
    for name in ("flash_attention_fwd_biased", "flash_attention_bwd_dq_biased",
                 "flash_attention_bwd_dkv_biased"):
        timing[name] = biased[(name, alibi_label)]
    timing["sparse_attention"] = sparse[("sparse_attention", sparse_label)]
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
    # the fp16 forms of B1 and B2: rows of their own, with the launches of
    # the fp16 main path (the rows above count every main path)
    for name in ("flash_attention_fwd", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv"):
        meta[f"{name}_fp16"] = meta[name]
        timing[f"{name}_fp16"] = timing[(name, "fp16")]
        launches[f"{name}_fp16"] = fp16_counts[name]
    # this slice's forms: B5 and B4 in fp16 (launches of the fp16 main
    # paths), the verify window, the draft's group-8 decode step and the
    # chunk at an offset (launches of their serve-features runs)
    spec = feat["spec_TinyLlama-1.1B"]
    for name, n in (("decode_attention_fp16", c16["decode_attention"]),
                    ("ragged_paged_attention_fp16",
                     L * se16_decode_steps),
                    ("ragged_paged_attention_prefill_512_fp16",
                     fp16_prefills.get(512, 0)),
                    ("ragged_paged_attention_prefill_1024_fp16",
                     fp16_prefills.get(1024, 0)),
                    ("ragged_paged_attention_verify",
                     spec["verify_launches"]),
                    ("ragged_paged_attention_draft_gqa8",
                     spec["draft_decode_launches"]),
                    ("ragged_paged_attention_chunk_at_offset",
                     feat["chunk"]["launches"])):
        meta[name] = meta["decode_attention" if name.startswith("decode")
                          else "ragged_paged_attention"]
        launches[name] = n
    for name, (source, replaces) in meta.items():
        t = timing[name]
        if not launches[name]:
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
