#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py                 # every phase, Llama-2-7B, 32 layers
    python3 chip_smoke.py --kernels-only  # build + kernel check only

Builds the port's hand-written CUDA kernels from this checkout with
``nvcc`` (into ``deepspeed_tpu_torch/_build/``), holds each kernel against
its plain PyTorch version, then serves Llama-2-7B at full width (random
bf16 weights from a seeded generator) through the port's two entry
points -- ``init_inference(...).generate`` and ``create_serving_engine``
-- and checks that those runs went through the kernels.  Phases:

  1 device   card name and power limit (nvidia-smi)
  2 build    nvcc, one process per kernel source, all at once
  3 kernels  each kernel vs its plain version: fp32 and bf16, MHA 32/32
             and GQA 32/8, D=128
  4 generate init_inference(llama2_7b).generate, B=4, prompt 128, 32 new
  5 serve    create_serving_engine(max_batch=8, page_size=128,
             max_seq=2048).generate on 12 mixed-length prompts
  6 e2e      full width, 2 layers: paged prefill + decode, kernels vs plain
  7 timing   each kernel at the main path's shapes vs its bound, its plain
             version and one PyTorch library call (a yardstick only)

The second-to-last line of stdout is the kernels JSON, the last line
``{"ok": true, "device": {...}}``.  Any failure exits non-zero before the
last line is printed.  It imports nothing of JAX or ``deepspeed_tpu``.
"""

import argparse
import json
import math
import os
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}   # dense, per dtype
# (atol, rtol) of a kernel against its plain version run in fp32 on the
# kernel's own inputs (see reference()):
TOL = {"float32": (1e-4, 1e-4),   # both in fp32; only the summation order
                                  # differs
       "bfloat16": (1e-5, 8e-3)}  # both round one fp32 result to bf16: at
                                  # most one bf16 ulp apart (<= 2**-7 of the
                                  # value), plus fp32 order noise near 0
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


def check_close(name, got, want):
    """Max abs error of kernel output ``got`` vs ``want``; fails outside
    the tolerance of their dtype."""
    import torch
    atol, rtol = TOL[str(got.dtype).split(".")[-1]]
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        fail(f"{name}: kernel output not finite")
    err = (got - want).abs()
    bad = err > atol + rtol * want.abs()
    max_err = err.max().item()
    if bad.any():
        fail(f"{name}: {int(bad.sum())} elements outside atol={atol} "
             f"rtol={rtol}, max abs err {max_err:.3e}")
    phase("kernels", f"{name}: max abs err {max_err:.3e} (atol {atol}, "
          f"rtol {rtol})")
    return max_err


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
        decode_attention_cuda, decode_attention_plain)
    from deepspeed_tpu_torch.ops.cuda.ragged_paged_attention import (
        paged_attention_plain, ragged_paged_attention,
        ragged_paged_attention_rect)
    gen = torch.Generator(device="cuda").manual_seed(1234)
    D, H, page = 128, 32, 128
    errs = {}

    def note(kernel, dn, e):
        errs[(kernel, dn)] = max(errs.get((kernel, dn), 0.0), e)

    def i32(x):
        return torch.tensor(x, dtype=torch.int32, device="cuda")

    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[-1]
        for Hkv in (32, 8):
            # B5: ragged lengths over S_max 2048, and generate's own calls
            # (B=4, cache 128 + 32, one int length for every sequence):
            # its prefill (T=128, length 128) and a decode (length 144)
            b5 = [(T, 2048, i32([T + 5, 700, 1500, 2048]))
                  for T in (1, 128)] + [(128, 160, 128), (1, 160, 144)]
            for T, S, lens in b5:
                q = _rand((4, T, H, D), dtype, gen)
                k = _rand((4, Hkv, S, D), dtype, gen)
                v = _rand((4, Hkv, S, D), dtype, gen)
                got = decode_attention_cuda(q, k, v, lens)
                want = reference(decode_attention_plain, q, k, v, lens)
                how = "int length" if isinstance(lens, int) else "lengths"
                note("decode_attention", dn, check_close(
                    f"decode_attention {dn} H{H}/{Hkv} B=4 T={T} S_max={S} "
                    f"{how}", got, want))
            # B4 rect front-end
            ctx = [1, 17, 128, 129, 300, 640, 1000, 2047]
            tables, kp, vp = _paged_state(ctx, page, Hkv, D, dtype, gen)
            cases = [("decode B=8 T=1 ragged", 1, tables, kp, vp, ctx)]
            t1, kp1, vp1 = _paged_state([128], page, Hkv, D, dtype, gen)
            cases.append(("prefill B=1 T=128", 128, t1, kp1, vp1, [128]))
            # the serve run's own calls: bucketed prefills of its 600- and
            # 511-token prompts, and a decode step with two idle slots
            for prompt in (600, 511):
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
            for label, T, tb, kk, vv, ctx in cases:
                qq = _rand((len(ctx), T, H, D), dtype, gen)
                got = ragged_paged_attention_rect(qq, kk, vv, tb, i32(ctx))
                want = reference(paged_attention_plain, qq, kk, vv, tb,
                                 i32(ctx))
                note("ragged_paged_attention", dn, check_close(
                    f"ragged_paged_attention {dn} H{H}/{Hkv} {label}",
                    got, want))
            # B4 packed front-end, mixed batch: shared prefix pages,
            # partial pages
            q_lens = [37, 1, 1, 128, 9, 1]
            ctx = [37, 300, 1000, 400, 521, 257]
            tb, kk, vv = _paged_state(ctx, page, Hkv, D, dtype, gen,
                                      shared_pages=2)
            if not (tb[1, 0] == tb[2, 0] and tb[1, 1] == tb[2, 1]):
                fail("packed case: prefix pages are not shared")
            qp = _rand((sum(q_lens), H, D), dtype, gen)
            got = ragged_paged_attention(qp, kk, vv, tb, ctx, q_lens)
            kf, vf = kk.float(), vv.float()
            outs, off = [], 0
            for s, ql in enumerate(q_lens):
                outs.append(paged_attention_plain(
                    qp[off:off + ql][None].float(), kf, vf, tb[s:s + 1],
                    i32([ctx[s]]))[0])
                off += ql
            note("ragged_paged_attention", dn, check_close(
                f"ragged_paged_attention {dn} H{H}/{Hkv} packed mixed", got,
                torch.cat(outs).to(dtype)))
    return errs


def _counters():
    from deepspeed_tpu_torch.ops.cuda import decode_attention as da
    from deepspeed_tpu_torch.ops.cuda import ragged_paged_attention as rp
    return da, rp


def reset_counters():
    da, rp = _counters()
    da.decode_attention_cuda.launches = 0
    da.decode_attention_plain.calls = 0
    rp.ragged_paged_attention_cuda.launches = 0
    rp.paged_attention_plain.calls = 0


def read_counters():
    da, rp = _counters()
    return {"decode_attention": da.decode_attention_cuda.launches,
            "ragged_paged_attention": rp.ragged_paged_attention_cuda.launches,
            "decode_attention_plain": da.decode_attention_plain.calls,
            "paged_attention_plain": rp.paged_attention_plain.calls}


def build_model(n_layers, seed):
    import torch
    from deepspeed_tpu_torch.models.transformer import (CausalTransformerLM,
                                                        TransformerConfig)
    cfg = TransformerConfig.llama2_7b(n_layers=n_layers)
    t0 = time.time()
    model = CausalTransformerLM(cfg, device="cuda",
                                dtype=torch.bfloat16).init(seed)
    torch.cuda.synchronize()
    return cfg, model, time.time() - t0


def phase_generate(model, cfg, B=4, S=128, new=32):
    import numpy as np
    import torch
    import deepspeed_tpu_torch as dst
    eng = dst.init_inference(model, dtype="bf16")
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
    return eng, ids, dt


def phase_serve(eng, cfg):
    import numpy as np
    import torch
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, (n,)).tolist()
               for n in SERVE_PROMPTS]
    se = eng.create_serving_engine(max_batch=SERVE_SLOTS,
                                   page_size=SERVE_PAGE,
                                   max_seq=SERVE_MAX_SEQ)
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
    return se, prompts, dt


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
    """Each kernel at the main path's decode shapes (bf16): kernel, plain
    version and library time, plus the bound.  Buffers rotate over more
    than the 50 MB L2 so each call reads its cache cold, as a layer of the
    decode loop does."""
    import torch
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops.cuda.decode_attention import (
        decode_attention_cuda, decode_attention_plain)
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
    for name, r in res.items():
        phase("timing", f"{name} [{r['shape']}]: device ms (graph replay) "
              f"kernel {r['ms']:.4f}, plain {r['plain_ms']:.4f}, library "
              f"{r['library_ms']:.4f}; eager ms per call (host included) "
              f"kernel {r['ms_eager']:.4f}, plain {r['plain_ms_eager']:.4f},"
              f" library {r['library_ms_eager']:.4f}; bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}), max abs err "
              f"{r['max_abs_err']:.3e}")
    return res


def decode_step_ms(eng, cfg, steps=16, profiled=4):
    """Wall ms of a pure decode step with all 8 serving slots busy, then
    the device time of ``profiled`` more steps by kernel (torch.profiler):
    returns (step ms, device ms per step, top kernels [(name, ms/step)])."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
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
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(profiled):
            se.step()
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
                us / 1e3 / profiled
    device_ms = sum(per_kernel.values())
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:8]
    del se
    torch.cuda.empty_cache()
    return ms, device_ms, top


# ----------------------------------------------------------------------
def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after the kernel phase")
    args = ap.parse_args()

    t_start = time.time()
    import torch
    card = phase_device()
    if not os.path.isdir(os.path.join(REPO, "deepspeed_tpu_torch")):
        fail("deepspeed_tpu_torch/ is not beside chip_smoke.py")
    sys.path.insert(0, REPO)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase_build()
    errs = phase_kernels()
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
    eng, ids, t_gen = phase_generate(model, cfg)
    after_gen = read_counters()
    se, prompts, t_serve = phase_serve(eng, cfg)
    counts = read_counters()
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
    if counts["decode_attention_plain"] or counts["paged_attention_plain"]:
        fail(f"plain versions ran on the main path: {counts}")
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
    del se
    torch.cuda.empty_cache()
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
    step_ms, device_ms, top = decode_step_ms(eng, cfg)
    phase("serve", f"pure decode step, 8 slots busy: {step_ms:.3f} ms "
          f"({8 * 1e3 / step_ms:.1f} tokens/s); device time "
          f"{device_ms:.3f} ms/step (profiler), busy share "
          f"{device_ms / step_ms:.3f}")
    for name, k_ms in top:
        phase("serve", f"  device ms/step {k_ms:.4f}  {name[:90]}")
    del eng, model
    torch.cuda.empty_cache()

    rel, agree = phase_e2e()
    phase("e2e", f"2 layers full width, paged prefill T=128 + 4 decodes: "
          f"kernel vs plain logits rel err {rel:.3e} (tol {E2E_REL_TOL}), "
          f"argmax agreement {agree:.4f}")

    timing = phase_timing(cfg, SERVE_PROMPTS[:SERVE_SLOTS])
    kernels = []
    meta = {
        "decode_attention": (
            "deepspeed_tpu_torch/ops/csrc/decode_attention.cu",
            "deepspeed_tpu/ops/pallas/decode_attention.py:45"),
        "ragged_paged_attention": (
            "deepspeed_tpu_torch/ops/csrc/ragged_paged_attention.cu",
            "deepspeed_tpu/ops/pallas/ragged_paged_attention.py:57"),
    }
    for name, (source, replaces) in meta.items():
        t = timing[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": counts[name],
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
