#!/usr/bin/env python3
"""A/B of two trees' serving kernels on one card, in one run: parent,
change, change, parent.

    git archive <parent> | tar -x -C .tmp/parent     # .tmp is gitignored
    python3 scripts/serving_kernel_ab.py --parent .tmp/parent \\
        [--change .] [--cases decode] [--out results.json]

Each tree runs in a process of its own (the two trees' wrappers differ),
which puts the tree first on ``sys.path``, builds its kernel sources with
its own op builder, and times, by CUDA-graph replay over rotating input
sets (more than the 50 MB L2), bf16, at the main paths' shapes of
``chip_smoke.py``:

* B4 decode: the serve run's 8-slot decode step (Llama-2-7B, 32 heads of
  128, page 128), MHA and GQA 32/8; the speculative verify window [8, 5]
  (MHA, 5 tokens a slot); the TinyLlama-1.1B draft's decode step (32 / 4
  heads of 64: group 8); Llama-2-70B's attention shape (64 / 8 heads of
  128: group 8);
* B5: generate's decode step (B=4, length 144 over a 160-token cache) at
  Llama-2-7B's, TinyLlama-1.1B's and Llama-2-70B's attention shapes (a
  tree whose B5 refuses a head dim reports it and times nothing);
* B4 prefill: the serve run's bucketed prefills at 512 and 1024 (B=1,
  length = bucket), and B1's forward (``flash_attention_fwd_cuda``) on
  the same q and dense K/V -- the same work;
* B4 prefill at head dim 64: the TinyLlama-1.1B draft's 256-token chunk
  at start 512 and its bucket-512 prefill (32 / 4 heads: group 8), and a
  bucket-512 prefill at gpt2_125m's shape (12 heads of 64: group 1), each
  beside SDPA with the causal-ragged mask (``chip_smoke._time_paged``);
* B6: ``SparseSelfAttention``'s four cases (Fixed block 16 and BigBird
  block 64, head dims 64 and 128, B=2, S=4096, 16 heads).

``--cases decode`` times the B4 decode and B5 cases alone.  ``--head-dim
80 96 256`` times, instead, B4 at those head dims at the serving phases'
shapes: the prefill buckets 512 and 1024 and the 256-token chunk at start
512 (B=1; gpt_2_7b's 32 heads of 80, the Phi-3-mini shape's 32 of 96,
Gemma-7B's 16 of 256, and at buckets also Gemma-2B's 8 over one kv head)
and the speculative verify window [8, 5] (MHA), in ``--dtype`` bf16 or
fp16, with B1's forward on the same work beside the buckets (a prompt
prefilled from its first token is B1's causal attention).  Beside each:
SDPA on the same inputs (a yardstick, never the port's path), and the
kernel's max abs error against its plain version run in fp32.  Prints one
line per (tree, case) and writes every number, with the card's name and
power limit, to ``--out`` (default, gitignored:
``deepspeed_tpu_torch/_build/ab_serving.json``).
"""

import argparse
import importlib.util
import json
import math
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCES = ("sparse_attention", "ragged_paged_attention", "flash_attention_fwd",
           "decode_attention")


def _smoke():
    """This checkout's chip_smoke.py, loaded by path: its helpers import
    ``deepspeed_tpu_torch`` only when called, so they use the tree first
    on sys.path."""
    spec = importlib.util.spec_from_file_location(
        "ab_chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# --head-dim: (label, H, Hkv, D, T, tokens reserved, context)
HEAD_DIM_CASES = {
    D: [(f"B4 prefill T=512 H{H}/{Hkv} D={D}", H, Hkv, D, 512, 543, 512),
        (f"B4 prefill T=1024 H{H}/{Hkv} D={D}", H, Hkv, D, 1024, 1024,
         1024)]
    + ([(f"B4 chunk T=256 at start 512 H{H}/{Hkv} D={D}", H, Hkv, D, 256,
         1056, 768)] if Hkv == H else [])
    for D, H, Hkv in ((80, 32, 32), (96, 32, 32), (256, 16, 16))}
HEAD_DIM_CASES[256] += [(f"B4 prefill T={T} H8/1 D=256", 8, 1, 256, T,
                         need, T) for T, need in ((512, 543), (1024, 1024))]


def head_dim_cases(sm, head_dims, dtype, gen):
    """{label: numbers} of HEAD_DIM_CASES and the verify window at
    ``head_dims``."""
    import torch
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops.cuda.flash_attention import \
        flash_attention_fwd_cuda
    from deepspeed_tpu_torch.ops.cuda.ragged_paged_attention import (
        paged_attention_plain, ragged_paged_attention_rect)
    dn = str(dtype).split(".")[-1]
    prompts = sm.SERVE_PROMPTS[:sm.SERVE_SLOTS]
    res = {}
    for D in head_dims:
        todo = [(label, H, Hkv, Dh, T, [need], [ctx]) for
                label, H, Hkv, Dh, T, need, ctx in HEAD_DIM_CASES[D]]
        H = 16 if D == 256 else 32
        todo.append((f"B4 verify window [8, 5] H{H}/{H} D={D}", H, H, D,
                     sm.SPEC_GAMMA + 1, [p + sm.SERVE_NEW for p in prompts],
                     [p + 9 for p in prompts]))
        for label, H, Hkv, Dh, T, needs, ctx in todo:
            c, B = 4, len(ctx)
            states = [sm._engine_state(needs, Hkv, Dh, dtype, gen)
                      for _ in range(c)]
            lens = torch.tensor(ctx, dtype=torch.int32, device="cuda")
            q = sm._rand((c, B, T, H, Dh), dtype, gen)
            tb, kp, vp = states[0]
            want = paged_attention_plain(q[0].float(), kp.float(),
                                         vp.float(), tb, lens)
            err = (ragged_paged_attention_rect(q[0], kp, vp, tb, lens)
                   .float() - want).abs().max().item()
            Smax = tb.shape[1] * sm.SERVE_PAGE
            dense = [tuple(x[t.long()].transpose(1, 2).reshape(
                B, Hkv, Smax, Dh) for x in (k_, v_)) for t, k_, v_ in states]
            qpos = lens.long()[:, None] - T + torch.arange(T, device="cuda")
            mask = (torch.arange(Smax, device="cuda")[None, None] <=
                    qpos[:, :, None])[:, None]
            qs = q.transpose(2, 3).contiguous()
            sdpa_err = (F.scaled_dot_product_attention(
                qs[0], dense[0][0], dense[0][1], attn_mask=mask,
                enable_gqa=Hkv != H).transpose(1, 2).float() - want
            ).abs().max().item()
            r = dict(ms=sm.graph_ms(lambda i: ragged_paged_attention_rect(
                q[i], states[i][1], states[i][2], states[i][0], lens), c),
                sdpa_ms=sm.graph_ms(
                    lambda i: F.scaled_dot_product_attention(
                        qs[i], dense[i][0], dense[i][1], attn_mask=mask,
                        enable_gqa=Hkv != H), c),
                bound_ms=sm._bound(*sm.paged_work(ctx, T, H, Hkv, Dh, 2),
                                   dn)[0],
                max_abs_err=err, sdpa_max_abs_err=sdpa_err)
            if ctx == [T]:        # a prompt from its first token: B1's work
                kv = [tuple(x[:, :, :T].transpose(1, 2).contiguous()
                            for x in d) for d in dense]
                r["b1_ms"] = sm.graph_ms(lambda i: flash_attention_fwd_cuda(
                    q[i], kv[i][0], kv[i][1], 1.0 / math.sqrt(Dh)), c)
                del kv
            res[f"{label} {dn}"] = r
            del states, dense, q, qs, want
            torch.cuda.empty_cache()
    return res


def worker(tree, cases, head_dims=(), dtypes=("bf16",)):
    """Times one tree's kernels; prints one JSON line of results."""
    sys.path.insert(0, os.path.abspath(tree))
    import torch
    import torch.nn.functional as F
    import deepspeed_tpu_torch
    if os.path.dirname(os.path.abspath(deepspeed_tpu_torch.__file__)) != \
            os.path.join(os.path.abspath(tree), "deepspeed_tpu_torch"):
        sys.exit(f"imported {deepspeed_tpu_torch.__file__}, not {tree}")
    from deepspeed_tpu_torch.ops import op_builder
    from deepspeed_tpu_torch.ops import sparse_attention as sa
    from deepspeed_tpu_torch.ops.cuda import decode_attention as da
    from deepspeed_tpu_torch.ops.cuda import sparse_attention as spa
    from deepspeed_tpu_torch.ops.cuda.flash_attention import \
        flash_attention_fwd_cuda
    from deepspeed_tpu_torch.ops.cuda.ragged_paged_attention import (
        paged_attention_plain, ragged_paged_attention_rect)
    sm = _smoke()
    sources = SOURCES if cases == "all" or head_dims else \
        ("ragged_paged_attention", "decode_attention")
    t0 = time.time()
    op_builder.build(tuple(n for n in op_builder.SIGNATURES
                           if op_builder.SIGNATURES[n][0] in sources))
    build_s = time.time() - t0
    gen = torch.Generator(device="cuda").manual_seed(31)
    if head_dims:
        res = {}
        for dn in dtypes:
            res.update(head_dim_cases(sm, head_dims, torch.float16
                                      if dn == "fp16" else torch.bfloat16,
                                      gen))
        print(json.dumps({"tree": tree, "build_s": build_s, "results": res}),
              flush=True)
        return
    bf = torch.bfloat16
    H, D = 32, 128
    res = {}

    def err(got, exact):
        return (got.float() - exact).abs().max().item()

    # B4 decode rows: 8 slots, the serve run's first 8 prompts (T tokens
    # a slot, ctx_off tokens past the prompt)
    prompts = sm.SERVE_PROMPTS[:sm.SERVE_SLOTS]
    for label, T, Hq, Hkv, Dh, ctx_off in (
            ("B4 decode 8 slots H32/32", 1, 32, 32, 128, 16),
            ("B4 decode 8 slots H32/8", 1, 32, 8, 128, 16),
            ("B4 verify window [8, 5] H32/32", 5, 32, 32, 128, 9),
            ("B4 TinyLlama decode H32/4 D=64", 1, 32, 4, 64, 16),
            ("B4 Llama-2-70B-shaped decode H64/8", 1, 64, 8, 128, 16)):
        ctx = [p + ctx_off for p in prompts]
        lens = torch.tensor(ctx, dtype=torch.int32, device="cuda")
        c = 4
        states = [sm._engine_state([p + sm.SERVE_NEW for p in prompts], Hkv,
                                   Dh, bf, gen) for _ in range(c)]
        q = sm._rand((c, len(ctx), T, Hq, Dh), bf, gen)
        tb, kp, vp = states[0]
        e = err(ragged_paged_attention_rect(q[0], kp, vp, tb, lens),
                paged_attention_plain(q[0].float(), kp.float(), vp.float(),
                                      tb, lens))
        Smax = tb.shape[1] * sm.SERVE_PAGE
        dense = [tuple(x[t.long()].transpose(1, 2).reshape(
            len(ctx), Hkv, Smax, Dh) for x in (k_, v_))
            for t, k_, v_ in states]
        qpos = lens.long()[:, None] - T + torch.arange(T, device="cuda")
        mask = (torch.arange(Smax, device="cuda")[None, None] <=
                qpos[:, :, None])[:, None]
        qs = q.transpose(2, 3).contiguous()
        ms = sm.graph_ms(lambda i: ragged_paged_attention_rect(
            q[i], states[i][1], states[i][2], states[i][0], lens), c)
        lib = sm.graph_ms(lambda i: F.scaled_dot_product_attention(
            qs[i], dense[i][0], dense[i][1], attn_mask=mask,
            enable_gqa=Hkv != Hq), c)
        nbytes = sum(2 * Hkv * n * Dh + 2 * T * Hq * Dh for n in ctx) * 2
        res[label] = dict(
            ms=ms, sdpa_ms=lib, bound_ms=nbytes / sm.HBM_BYTES_PER_S * 1e3,
            max_abs_err=e)
        del states, dense, q, qs
        torch.cuda.empty_cache()

    # B5: generate's decode step, B=4, length 144 over a 160-token cache
    B, S, L = 4, 160, 144
    for label, Hq, Hkv, Dh in (("B5 generate step H32/32", 32, 32, 128),
                               ("B5 TinyLlama generate step H32/4 D=64", 32,
                                4, 64),
                               ("B5 Llama-2-70B-shaped generate step H64/8",
                                64, 8, 128)):
        if Dh not in da.HEAD_DIMS:
            res[label] = dict(refused=f"head_dim {Dh} not in "
                                      f"{da.HEAD_DIMS}")
            continue
        c = 12
        q = sm._rand((c, B, 1, Hq, Dh), bf, gen)
        k = sm._rand((c, B, Hkv, S, Dh), bf, gen)
        v = sm._rand((c, B, Hkv, S, Dh), bf, gen)
        e = err(da.decode_attention_cuda(q[0], k[0], v[0], L),
                da.decode_attention_plain(q[0].float(), k[0].float(),
                                          v[0].float(), L))
        qs = q.transpose(2, 3).contiguous()
        ms = sm.graph_ms(lambda i: da.decode_attention_cuda(
            q[i], k[i], v[i], L), c)
        lib = sm.graph_ms(lambda i: F.scaled_dot_product_attention(
            qs[i], k[i][:, :, :L], v[i][:, :, :L], enable_gqa=Hkv != Hq), c)
        nbytes = B * (2 * Hkv * L * Dh + 2 * Hq * Dh) * 2
        res[label] = dict(
            ms=ms, sdpa_ms=lib, bound_ms=nbytes / sm.HBM_BYTES_PER_S * 1e3,
            max_abs_err=e)
        del q, k, v, qs
        torch.cuda.empty_cache()
    if cases != "all":
        print(json.dumps({"tree": tree, "build_s": build_s, "results": res}),
              flush=True)
        return

    # B4 prefill at the serve run's buckets 512 and 1024, and B1 on the
    # same work
    for prompt in (511, 600):
        bucket, need = sm._prefill_need(prompt)
        c = 4
        states = [sm._engine_state([need], 32, D, bf, gen) for _ in range(c)]
        blen = torch.tensor([bucket], dtype=torch.int32, device="cuda")
        q = sm._rand((c, 1, bucket, H, D), bf, gen)
        tb, kp, vp = states[0]
        e = err(ragged_paged_attention_rect(q[0], kp, vp, tb, blen),
                paged_attention_plain(q[0].float(), kp.float(), vp.float(),
                                      tb, blen))
        dense = [tuple(x[t.long()].transpose(1, 2).reshape(1, 32, -1, D)
                       [:, :, :bucket].contiguous() for x in (k_, v_))
                 for t, k_, v_ in states]
        kb1 = [tuple(x.transpose(1, 2).contiguous() for x in kv)
               for kv in dense]
        qs = q.transpose(2, 3).contiguous()
        ms = sm.graph_ms(lambda i: ragged_paged_attention_rect(
            q[i], states[i][1], states[i][2], states[i][0], blen), c)
        b1 = sm.graph_ms(lambda i: flash_attention_fwd_cuda(
            q[i], kb1[i][0], kb1[i][1], 1.0 / math.sqrt(D)), c)
        lib = sm.graph_ms(lambda i: F.scaled_dot_product_attention(
            qs[i], dense[i][0], dense[i][1], is_causal=True), c)
        pairs = bucket * (bucket + 1) // 2
        bound = max(4 * bucket * H * D * 2 / sm.HBM_BYTES_PER_S,
                    4 * H * D * pairs / sm.PEAK_FLOPS["bfloat16"]) * 1e3
        res[f"B4 prefill T={bucket}"] = dict(
            ms=ms, b1_ms=b1, sdpa_ms=lib, bound_ms=bound, max_abs_err=e)
        del states, dense, kb1, q, qs

    # B4 prefill tiles at head dim 64 (a parent whose tensor-core tiles
    # take head dim 128 only runs them on its CUDA-core tiles)
    _, need512 = sm._prefill_need(511)
    for label, Hq, Hkv, T, need, ctx in (
            ("B4 TinyLlama chunk T=256 at start 512 H32/4 D=64", 32, 4,
             sm.CHUNK_TOKENS, 1024 + sm.SERVE_NEW, 768),
            ("B4 TinyLlama prefill T=512 H32/4 D=64", 32, 4, 512, need512,
             512),
            ("B4 gpt2_125m-shaped prefill T=512 H12/12 D=64", 12, 12, 512,
             need512, 512)):
        r = sm._time_paged(label, bf, [need], [ctx], T, Hkv, 64, 4, gen,
                           H=Hq)
        res[label] = dict(ms=r["ms"], sdpa_ms=r["library_ms"],
                          bound_ms=r["bound_ms"],
                          max_abs_err=r["max_abs_err"])
        torch.cuda.empty_cache()

    # B6: SparseSelfAttention's cases
    B, S, Hs = sm.SPARSE_B, sm.SPARSE_S, sm.SPARSE_H
    for kind, block, d in sm.SPARSE_PATH:
        cfg = sm._sparsity_config(kind, Hs, block)
        layout = cfg.make_layout(S)
        causal = cfg.attention == "unidirectional"
        c = 4
        q, k, v = (sm._rand((c, B, S, Hs, d), bf, gen) for _ in range(3))
        kw = ({"steps": spa.card_steps(layout, block, causal, "cuda")}
              if hasattr(spa, "card_steps") else
              {"tables": spa.card_tables(layout, causal, "cuda")})
        with torch.no_grad():
            e = err(spa.sparse_attention_cuda(q[0], k[0], v[0], layout,
                                              block, causal=causal, **kw),
                    sa.sparse_attention_plain(q[0].float(), k[0].float(),
                                              v[0].float(), layout, block,
                                              causal=causal))
        mask = torch.as_tensor(sa.expand_layout_mask(layout, block, S),
                               device="cuda")
        if causal:
            mask &= torch.ones((S, S), dtype=torch.bool,
                               device="cuda").tril()
        qt, kt, vt = (x.transpose(2, 3).contiguous() for x in (q, k, v))
        ms = sm.graph_ms(lambda i: spa.sparse_attention_cuda(
            q[i], k[i], v[i], layout, block, causal=causal, **kw), c)
        lib = sm.graph_ms(lambda i: F.scaled_dot_product_attention(
            qt[i], kt[i], vt[i], attn_mask=mask), c)
        table, counts, _ = spa.layout_tables(layout, causal)
        flops = B * spa.sparse_flops(layout, block, causal, d)
        nbytes = 4 * B * S * Hs * d * 2 + table.nbytes + counts.nbytes
        res[f"B6 {kind} block {block} D={d}"] = dict(
            ms=ms, sdpa_ms=lib, max_abs_err=e,
            bound_ms=max(nbytes / sm.HBM_BYTES_PER_S,
                         flops / sm.PEAK_FLOPS["bfloat16"]) * 1e3)
        del q, k, v, qt, kt, vt, mask
        torch.cuda.empty_cache()
    print(json.dumps({"tree": tree, "build_s": build_s, "results": res}),
          flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="the parent commit's tree")
    ap.add_argument("--change", default=REPO, help="this tree (default)")
    ap.add_argument("--out", default=os.path.join(
        REPO, "deepspeed_tpu_torch", "_build", "ab_serving.json"))
    ap.add_argument("--cases", choices=("all", "decode"), default="all",
                    help="decode: the B4 decode and B5 cases alone")
    ap.add_argument("--head-dim", type=int, nargs="+", choices=(80, 96, 256),
                    default=[], help="B4's prefill, chunk and verify-window "
                    "shapes at these head dims instead")
    ap.add_argument("--dtype", nargs="+", choices=("bf16", "fp16"),
                    default=["bf16"], help="with --head-dim")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        return worker(args.worker, args.cases, args.head_dim, args.dtype)
    if not args.parent:
        ap.error("--parent is required")
    import torch
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    runs = []
    for label, tree in (("parent", args.parent), ("change", args.change),
                        ("change", args.change), ("parent", args.parent)):
        extra = (["--head-dim", *map(str, args.head_dim), "--dtype",
                  *args.dtype] if args.head_dim else [])
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--worker", tree, "--cases", args.cases,
                               *extra],
                              capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            sys.exit(f"{label} ({tree}) failed:\n{proc.stdout[-3000:]}\n"
                     f"{proc.stderr[-3000:]}")
        run = json.loads(proc.stdout.strip().splitlines()[-1])
        run["label"] = label
        runs.append(run)
        for case, r in run["results"].items():
            if "refused" in r:
                print(f"{label} {case}: refused ({r['refused']})",
                      flush=True)
                continue
            extra = f", B1 {r['b1_ms']:.4f}" if "b1_ms" in r else ""
            vs = (f" ({r['max_abs_err'] / r['sdpa_max_abs_err']:.2f}x "
                  f"SDPA's)" if r.get("sdpa_max_abs_err") else "")
            print(f"{label} {case}: {r['ms']:.4f} ms (SDPA "
                  f"{r['sdpa_ms']:.4f}{extra}; bound {r['bound_ms']:.4f}), "
                  f"max abs err {r['max_abs_err']:.2e}{vs}", flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump({"card": card, "runs": runs}, fh, indent=1)


if __name__ == "__main__":
    main()
