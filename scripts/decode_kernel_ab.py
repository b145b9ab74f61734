#!/usr/bin/env python3
"""A/B of source variants and split plans of the split-key decode body
(``ops/csrc/split_decode.cuh``) in both its kernels -- decode attention
(B5) and the decode rows of ragged paged attention (B4) -- on one card, in
one process.

    python3 scripts/decode_kernel_ab.py VARIANTS.json [--out DIR]
        [--head-dim 80 96 128 256] [--dtype bf16 fp16] [--profile]
        [--prefill]

VARIANTS.json maps a variant's name to ``{"dir": <sources>, "edits":
{<file>: [[regex, replacement], ...]}, "splits": [n, ...], "min_chunk":
keys}``, as in ``scripts/flash_kernel_ab.py`` (whose build it shares);
``splits``, when given, replaces the wrappers' split plan (``key_splits``)
by each listed count in turn: every sequence's keys in chunks of S_max /
n (rounded up to 64), n = 1 one block per (sequence, kv head), null the
wrappers' own plan; ``min_chunk`` sets that plan's shortest chunk of the
staged body (``DECODE_MIN_CHUNK_STAGED``; a parent from before that body
took 2048 there).  A call that does not
return within ``--case-timeout`` seconds (a kernel that deadlocks) ends
the run, naming its case.  ``--profile`` also prints, for each variant's
first plan, the device us a call of each split and combine kernel
(torch.profiler, 20 calls on one input set), and for each case the
wrapper's plan: the card's block slots for the form (the occupancy
query), the (sequence, kv head) pairs, the chunks per sequence and keys
per chunk, the blocks launched and the waves they take.  Each variant's
``decode_attention.cu`` and ``ragged_paged_attention.cu`` are built with
the op builder's nvcc flags into ``--out`` (default, gitignored:
``deepspeed_tpu_torch/_build/ab_decode``), with every split kernel's
registers and spills printed.  Then, for each dtype (``--dtype``, bf16
by default), variant and plan, at the main paths' decode shapes: B4 over
the serve run's 8 slots (page 128) -- the 1-row step (Llama-2-7B, 32 heads of 128) and its GQA 32 / 8 form
(4 rows), the speculative verify window [8, 5], the TinyLlama-1.1B
draft's step (32 / 4 heads of 64) and a Llama-2-70B-shaped step (64 / 8
heads of 128) -- and B5's generate step
(B=4, length 144 over a 160-token cache) at the same three attention
shapes, and at Llama-2-70B's at length 4096 (``--head-dim 128``, the
default; with ``256``: the Gemma-7B (16 / 16 heads of 256) and Gemma-2B
(8 / 1) shapes' B4 8-slot steps, Gemma-7B's verify window, and B5's
generate steps and length-4096 steps at both; with ``80`` / ``96``:
gpt_2_7b's (32 heads of 80) / the Phi-3-mini shape's (32 of 96) B4 8-slot
step, verify window [8, 5] and B5 step, the serving phases' forms, and B5
at 5 rows over 2048 keys (B=1) and over a 160-key cache (B=4); several
sets in one run with ``--head-dim 80 96 256``): the max abs error against
the plain version run in fp32, device ms by CUDA-graph replay over
rotating inputs (more than the 50 MB L2) beside SDPA's on the same inputs
and the bound (K/V and q bytes over 3.35 TB/s).  ``--prefill`` times,
instead, B4's prefill tiles at ``--head-dim``'s 80, 96 and 256 shapes of
the serving phases (buckets 512 and 1024 from the first token, the
256-token chunk at start 512; Gemma-7B's 16 heads and Gemma-2B's 8 over
one kv head at 256), each output's max abs error also over SDPA's and a
second call bit for bit; with ``--profile`` each case's blocks against
the SMs and each block's walk.  The first variant is timed again at the
end, so drift shows.
"""

import argparse
import json
import os
import sys
import threading
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCES = ("decode_attention", "ragged_paged_attention")
# B4 cases: (label, T, H, Hkv, D, tokens past each prompt)
PAGED = [("B4 1-row step H32/32", 1, 32, 32, 128, 16),
         ("B4 4-row step H32/8", 1, 32, 8, 128, 16),
         ("B4 verify window [8, 5] H32/32", 5, 32, 32, 128, 9),
         ("B4 TinyLlama step H32/4 D=64", 1, 32, 4, 64, 16),
         ("B4 Llama-2-70B-shaped step H64/8", 1, 64, 8, 128, 16)]
# B5 cases: (label, B, H, Hkv, D, S_max, length, rotating copies)
CONTIGUOUS = [("B5 step H32/32", 4, 32, 32, 128, 160, 144, 12),
              ("B5 TinyLlama step H32/4 D=64", 4, 32, 4, 64, 160, 144, 12),
              ("B5 Llama-2-70B-shaped step H64/8", 4, 64, 8, 128, 160, 144,
               12),
              ("B5 Llama-2-70B-shaped len 4096 H64/8", 4, 64, 8, 128, 4096,
               4096, 4)]

# --head-dim 256: the Gemma shapes of phase serve-d256
PAGED_256 = [("B4 Gemma-7B step H16/16 D=256", 1, 16, 16, 256, 16),
             ("B4 Gemma-7B verify window [8, 5] H16/16 D=256", 5, 16, 16,
              256, 9),
             ("B4 Gemma-2B step H8/1 D=256", 1, 8, 1, 256, 16)]
CONTIGUOUS_256 = [("B5 Gemma-7B step H16/16 D=256", 4, 16, 16, 256, 160,
                   144, 12),
                  ("B5 Gemma-2B step H8/1 D=256", 4, 8, 1, 256, 160, 144,
                   12),
                  ("B5 Gemma-7B len 4096 H16/16 D=256", 4, 16, 16, 256,
                   4096, 4096, 2),
                  ("B5 Gemma-2B len 4096 H8/1 D=256", 4, 8, 1, 256, 4096,
                   4096, 4)]

# --head-dim 80 / 96: gpt_2_7b's and the Phi-3-mini shape's one-row steps
# (MHA: every decode step is one row a kv head), as phase serve-d80-d96
# gives them
PAGED_D = {D: [(f"B4 8-slot step H32/32 D={D}", 1, 32, 32, D, 16),
               (f"B4 verify window [8, 5] H32/32 D={D}", 5, 32, 32, D, 9)]
           for D in (80, 96)}

# --prefill: B4's prefill tiles at the serving phases' shapes -- the serve
# run's buckets 512 and 1024 (its 511- and 600-token prompts) and the
# chunked scheduler's 256-token chunk at start 512 -- as (label, H, Hkv, D,
# T, reserved tokens, context): gpt_2_7b's and Phi-3-mini's 32 heads of 80
# and 96, Gemma-7B's 16 of 256 and Gemma-2B's 8 over one kv head
PREFILL = {
    D: [(f"B4 prefill T=512 H{H}/{Hkv} D={D}", H, Hkv, D, 512, 543, 512),
        (f"B4 prefill T=1024 H{H}/{Hkv} D={D}", H, Hkv, D, 1024, 1024, 1024)]
    + ([(f"B4 chunk T=256 at start 512 H{H}/{Hkv} D={D}", H, Hkv, D, 256,
         1056, 768)] if Hkv == H else [])
    for D, H, Hkv in ((80, 32, 32), (96, 32, 32), (256, 16, 16))}
PREFILL[256] += [(f"B4 prefill T={T} H8/1 D=256", 8, 1, 256, T, need, T)
                 for T, need in ((512, 543), (1024, 1024))]
# with 5 rows at 80 / 96 (T=5, MHA): a B5 call over 2048 keys whose 32
# (sequence, kv head) pairs the plan splits, and one over a 160-key cache
CONTIGUOUS_D = {D: [(f"B5 step H32/32 D={D}", 4, 32, 32, D, 160, 144, 12),
                    (f"B5 5-row B=1 len 2048 H32/32 D={D}", 1, 32, 32, D,
                     2048, 2048, 12, 5),
                    (f"B5 5-row B=4 len 144 H32/32 D={D}", 4, 32, 32, D, 160,
                     144, 12, 5)]
                for D in (80, 96)}


def cases(sm, torch, F, da, rp, paged=PAGED, contiguous=CONTIGUOUS,
          bf=None):
    """[(label, kernel fn(i), SDPA fn(i), copies, plain fp32 output of
    input 0, bound ms, plan fn())] at the shapes above, in dtype ``bf``
    (bf16 by default); plan() describes the wrapper's split plan."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    bf = bf or torch.bfloat16
    out = []
    prompts = sm.SERVE_PROMPTS[:sm.SERVE_SLOTS]
    for label, T, H, Hkv, D, off in paged:
        c = 4
        states = [sm._engine_state([p + sm.SERVE_NEW for p in prompts], Hkv,
                                   D, bf, gen) for _ in range(c)]
        ctx = [p + off for p in prompts]
        lens = torch.tensor(ctx, dtype=torch.int32, device="cuda")
        q = sm._rand((c, len(ctx), T, H, D), bf, gen)
        tb, kp, vp = states[0]
        want = rp.paged_attention_plain(q[0].float(), kp.float(), vp.float(),
                                        tb, lens)
        Smax = tb.shape[1] * sm.SERVE_PAGE
        dense = [tuple(x[t.long()].transpose(1, 2).reshape(
            len(ctx), Hkv, Smax, D) for x in (k_, v_)) for t, k_, v_ in states]
        qpos = lens.long()[:, None] - T + torch.arange(T, device="cuda")
        mask = (torch.arange(Smax, device="cuda")[None, None] <=
                qpos[:, :, None])[:, None]
        qs = q.transpose(2, 3).contiguous()
        nbytes = sum(2 * Hkv * n * D + 2 * T * H * D for n in ctx) * 2
        out.append((
            label,
            lambda i, q=q, st=states, lens=lens: rp.ragged_paged_attention_rect(
                q[i], st[i][1], st[i][2], st[i][0], lens),
            lambda i, qs=qs, dn=dense, m=mask, g=Hkv != H:
                F.scaled_dot_product_attention(qs[i], dn[i][0], dn[i][1],
                                               attn_mask=m, enable_gqa=g),
            c, want, nbytes / sm.HBM_BYTES_PER_S * 1e3,
            lambda T=T, H=H, Hkv=Hkv, D=D, Smax=Smax, n=len(ctx): plan_text(
                da, rp, "ragged_decode_slots", n * Hkv, T * (H // Hkv), Smax,
                D, bf)))
    for label, B, H, Hkv, D, S, L, c, *rows in contiguous:
        T = rows[0] if rows else 1
        q = sm._rand((c, B, T, H, D), bf, gen)
        k = sm._rand((c, B, Hkv, S, D), bf, gen)
        v = sm._rand((c, B, Hkv, S, D), bf, gen)
        want = da.decode_attention_plain(q[0].float(), k[0].float(),
                                         v[0].float(), L)
        qs = q.transpose(2, 3).contiguous()
        nbytes = B * (2 * Hkv * L * D + 2 * T * H * D) * 2
        mask = (torch.arange(L, device="cuda")[None] <=
                L - T + torch.arange(T, device="cuda")[:, None])
        out.append((
            label,
            lambda i, q=q, k=k, v=v, L=L: da.decode_attention_cuda(
                q[i], k[i], v[i], L),
            lambda i, qs=qs, k=k, v=v, L=L, g=Hkv != H, m=mask:
                F.scaled_dot_product_attention(
                    qs[i], k[i][:, :, :L], v[i][:, :, :L], attn_mask=m,
                    enable_gqa=g),
            c, want, nbytes / sm.HBM_BYTES_PER_S * 1e3,
            lambda B=B, T=T, H=H, Hkv=Hkv, D=D, S=S: plan_text(
                da, rp, "decode_attention_slots", B * Hkv, T * (H // Hkv),
                S, D, bf)))
    return out


def prefill_cases(sm, torch, F, rp, head_dims, bf):
    """The PREFILL cases at ``head_dims`` in dtype ``bf``, as
    :func:`cases` gives them; the 8th item is SDPA's max abs error against
    the plain version run in fp32 (the error the fp16 rule scales)."""
    gen = torch.Generator(device="cuda").manual_seed(6)
    out = []
    for D in head_dims:
        for label, H, Hkv, _, T, need, ctx in PREFILL.get(D, []):
            c = 4
            states = [sm._engine_state([need], Hkv, D, bf, gen)
                      for _ in range(c)]
            lens = torch.tensor([ctx], dtype=torch.int32, device="cuda")
            q = sm._rand((c, 1, T, H, D), bf, gen)
            tb, kp, vp = states[0]
            want = rp.paged_attention_plain(q[0].float(), kp.float(),
                                            vp.float(), tb, lens)
            Smax = tb.shape[1] * sm.SERVE_PAGE
            dense = [tuple(x[t.long()].transpose(1, 2).reshape(
                1, Hkv, Smax, D) for x in (k_, v_)) for t, k_, v_ in states]
            qpos = lens.long()[:, None] - T + torch.arange(T, device="cuda")
            mask = (torch.arange(Smax, device="cuda")[None, None] <=
                    qpos[:, :, None])[:, None]
            qs = q.transpose(2, 3).contiguous()

            def lib(i, qs=qs, dn=dense, m=mask, g=Hkv != H):
                return F.scaled_dot_product_attention(
                    qs[i], dn[i][0], dn[i][1], attn_mask=m, enable_gqa=g)
            sdpa_err = (lib(0).transpose(1, 2).float() - want).abs().max()
            nbytes, flops = sm.paged_work([ctx], T, H, Hkv, D,
                                          q.element_size())
            bound = sm._bound(nbytes, flops,
                              str(bf).split(".")[-1])[0]
            out.append((
                label,
                lambda i, q=q, st=states, lens=lens:
                    rp.ragged_paged_attention_rect(q[i], st[i][1], st[i][2],
                                                   st[i][0], lens),
                lib, c, want, bound,
                lambda T=T, H=H, Hkv=Hkv, D=D, ctx=ctx: prefill_plan_text(
                    rp, T, H // Hkv, Hkv, D, ctx, bf),
                sdpa_err.item()))
    return out


def prefill_plan_text(rp, T, group, Hkv, D, ctx, dtype):
    """The blocks of a one-sequence prefill call against the card's 132
    SMs, and the longest walk (K/V tiles of its heaviest block)."""
    tc = rp.tensor_core_prefill(dtype, D, group, 128)
    plan = rp.plan_launch([T], group, tc)
    keys = rp.tc_keys(D) if tc else 16
    walks = [-(-(ctx - T + min(T, (int(qt) + 1) * plan.q_tile)) // keys)
             for qt in plan.qtile_of_tile]
    blocks = len(walks) * Hkv
    return (f"{len(walks)} q tiles x {Hkv} kv heads = {blocks} blocks (132 "
            f"SMs), walks {walks} tiles of {keys} keys")


def plan_text(da, rp, entry, pairs, rows, S_max, D, dtype):
    """The wrapper's split plan of a decode launch, as text: the card's
    block slots for the form, the pairs, chunks x keys, blocks and waves."""
    if rows > da.DECODE_ROWS:
        return f"prefill form ({rows} rows a kv head)"
    slots = da._decode_slots("cuda", rows, D, da._DTYPE_CODES[dtype],
                             entry=entry)
    n, chunk = rp.decode_rows_splits(pairs, 1, S_max, slots, rows, dtype, D)
    blocks = n * pairs
    return (f"slots {slots}, pairs {pairs}, {n} chunk(s) x {chunk} keys, "
            f"{blocks} blocks, {-(-blocks // slots)} wave(s)")


def watchdog(limit):
    """A thread that ends the process when ``state[0]`` (the case being
    run) stays the same for ``limit`` seconds; returns ``state``."""
    state = ["build"]

    def watch():
        last, since = None, time.time()
        while True:
            time.sleep(1)
            if state[0] != last:
                last, since = state[0], time.time()
            elif last != "build" and time.time() - since > limit:
                print(f"HANG: {last} ran over {limit} s", flush=True)
                os._exit(3)
    threading.Thread(target=watch, daemon=True).start()
    return state


def kernel_us(torch, fn, reps=20):
    """{kernel name: device us a call} of fn(0) by torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    fn(0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn(0)
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", 0) or \
            getattr(e, "cuda_time_total", 0)
        if t:
            out[e.key] = t / reps
    return out


def kernel_name(k):
    """A profiler key's kernel and template arguments, without the
    parameter list."""
    import re
    m = re.search(r"(\w+_kernel<[^()]*>)", k) or re.search(r"(\w+_kernel)",
                                                           k)
    return m.group(1)[-70:] if m else k[:60]


def chunks_of(S, n):
    """(chunks, keys per chunk) of S keys cut n ways, chunks a multiple of
    64 keys, as the wrapper's plan gives them."""
    c = -(-(-(-S // n)) // 64) * 64
    return -(-S // c), c


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("variants", help="JSON file of variants")
    ap.add_argument("--out", default=os.path.join(
        REPO, "deepspeed_tpu_torch", "_build", "ab_decode"))
    ap.add_argument("--head-dim", type=int, choices=(80, 96, 128, 256),
                    nargs="+", default=[128], help="128: the Llama / "
                    "TinyLlama shapes (head dims 64 and 128); 256: the "
                    "Gemma shapes; 80 / 96: gpt_2_7b's / Phi-3-mini's")
    ap.add_argument("--dtype", choices=("bf16", "fp16"), nargs="+",
                    default=["bf16"])
    ap.add_argument("--case-timeout", type=float, default=120.0)
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--prefill", action="store_true",
                    help="B4's prefill tiles at --head-dim's 80, 96 and "
                    "256 shapes instead of the decode cases")
    args = ap.parse_args()
    state = watchdog(args.case_timeout)
    sys.path.insert(0, REPO)
    import torch
    import torch.nn.functional as F
    import chip_smoke as sm
    from flash_kernel_ab import build, use
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    from deepspeed_tpu_torch.ops.cuda import decode_attention as da
    from deepspeed_tpu_torch.ops.cuda import ragged_paged_attention as rp
    with open(args.variants) as fh:
        variants = json.load(fh)
    os.makedirs(args.out, exist_ok=True)
    t0 = time.time()
    libs = build(variants, args.out, SOURCES)
    print(f"built in {time.time() - t0:.1f} s", flush=True)
    for name in variants:
        for src in SOURCES:
            with open(os.path.join(args.out, name, f"{src}.log")) as fh:
                usage = sm.ptxas_usage(fh.read())
            for kernel, (regs, st, ld) in usage.items():
                if "split" in kernel or "prefill_tc" in kernel:
                    print(f"{name} {src}: {kernel[:110]}: {regs} registers, "
                          f"spills {st}/{ld} B", flush=True)
    card_splits, card_least = da.key_splits, da.DECODE_MIN_CHUNK_STAGED
    for dn in args.dtype:
        dtype = torch.float16 if dn == "fp16" else torch.bfloat16
        todo = []
        if args.prefill:
            todo += prefill_cases(sm, torch, F, rp, args.head_dim, dtype)
        elif 128 in args.head_dim:
            todo += cases(sm, torch, F, da, rp, bf=dtype)
        for D in (80, 96):
            if D in args.head_dim and not args.prefill:
                todo += cases(sm, torch, F, da, rp, PAGED_D[D],
                              CONTIGUOUS_D[D], dtype)
        if 256 in args.head_dim and not args.prefill:
            todo += cases(sm, torch, F, da, rp, PAGED_256, CONTIGUOUS_256,
                          dtype)
        lib_ms = {case[0]: sm.graph_ms(case[2], case[3]) for case in todo}
        for name in list(variants) + list(variants)[:1]:
            use(libs, name, variants[name], SOURCES)
            da._slots.clear()
            da.DECODE_MIN_CHUNK_STAGED = variants[name].get("min_chunk",
                                                            card_least)
            for j, n in enumerate(variants[name].get("splits", [None])):
                da.key_splits = rp.key_splits = card_splits if n is None \
                    else (lambda pairs, S, slots, least=0, n=n:
                          chunks_of(S, n))
                for label, fn, _, c, want, bound, plan, *sd in todo:
                    state[0] = f"{name} {dn} splits {n} {label}"
                    got = fn(0)
                    err = (got.float() - want).abs().max().item()
                    same = torch.equal(got, fn(0))
                    ms = sm.graph_ms(fn, c)
                    vs = f" ({err / sd[0]:.2f}x SDPA's)" if sd else ""
                    print(f"{name} {dn} splits {n or 'card'} {label}: "
                          f"device ms {ms:.4f} (SDPA {lib_ms[label]:.4f}), "
                          f"{bound / ms:.3f} of bound {bound:.4f}, max abs "
                          f"err {err:.2e}{vs}"
                          f"{'' if same else ', REPEAT DIFFERS'}",
                          flush=True)
                    if args.profile and j == 0:
                        print(f"{name} {dn} splits {n or 'card'} {label}: "
                              f"plan {plan()}", flush=True)
                        us = kernel_us(torch, fn)
                        print(f"{name} {dn} splits {n or 'card'} {label}: "
                              f"profile " + ", ".join(
                                  f"{kernel_name(k)} {v:.2f} us"
                                  for k, v in us.items()
                                  if "split" in k or "combine" in k or
                                  "prefill" in k),
                              flush=True)
        del todo
        torch.cuda.empty_cache()
    da.key_splits = rp.key_splits = card_splits
    da.DECODE_MIN_CHUNK_STAGED = card_least
    state[0] = "done"
    print(f"done in {time.time() - t0:.1f} s")


if __name__ == "__main__":
    main()
