#!/usr/bin/env python3
"""A/B of source variants and split plans of the port's decode-attention
kernel (B5), on one card, in one process.

    python3 scripts/decode_kernel_ab.py VARIANTS.json [--out DIR]

VARIANTS.json maps a variant's name to ``{"dir": <sources>, "edits":
{<file>: [[regex, replacement], ...]}, "slots": N}``, as in
``scripts/flash_kernel_ab.py`` (whose build it shares); ``slots``, when
given, replaces the card's block slots in the wrapper's split plan
(``decode_plan``): 1 keeps one block per (sequence, kv head), a large
number splits every sequence into DECODE_MIN_CHUNK-key chunks.  Each
variant's ``decode_attention.cu`` is built with the op builder's nvcc
flags into ``--out`` (default, gitignored: ``deepspeed_tpu_torch/_build/
ab_decode``).  Then, for each variant, at Llama-2-7B's decode shapes (B=4,
T=1, 32 query heads of 128, bf16; 32 kv heads and GQA with 8): generate's
step (len 144 over a 160-token cache), the whole context (len 4096) and a
half-full 2048-token cache (len 1000): the split plan, the max abs error
against the plain version run in fp32, and device ms by CUDA-graph replay
over rotating caches (more than the 50 MB L2) beside SDPA's on the same
inputs and the bound (K/V and q bytes over 3.35 TB/s).  The first variant
is timed again at the end, so drift shows.
"""

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCES = ("decode_attention",)
# (B, S_max, len, Hkv, rotating copies) at H = 32, D = 128
SHAPES = [(4, 160, 144, 32, 12), (4, 160, 144, 8, 12),
          (4, 4096, 4096, 32, 2), (4, 4096, 4096, 8, 4),
          (4, 2048, 1000, 32, 4)]


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("variants", help="JSON file of variants")
    ap.add_argument("--out", default=os.path.join(
        REPO, "deepspeed_tpu_torch", "_build", "ab_decode"))
    args = ap.parse_args()
    sys.path.insert(0, REPO)
    import torch
    import torch.nn.functional as F
    from chip_smoke import _rand, graph_ms, reference
    from flash_kernel_ab import build, use
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    from deepspeed_tpu_torch.ops.cuda import decode_attention as da
    with open(args.variants) as fh:
        variants = json.load(fh)
    os.makedirs(args.out, exist_ok=True)
    t0 = time.time()
    libs = build(variants, args.out, SOURCES)
    print(f"built in {time.time() - t0:.1f} s", flush=True)
    card_slots = da._decode_slots
    gen = torch.Generator(device="cuda").manual_seed(5)
    H, D = 32, 128
    cases = []
    for B, S, L, Hkv, c in SHAPES:
        q = _rand((c, B, 1, H, D), torch.bfloat16, gen)
        k = _rand((c, B, Hkv, S, D), torch.bfloat16, gen)
        v = _rand((c, B, Hkv, S, D), torch.bfloat16, gen)
        qs = q.transpose(2, 3).contiguous()
        lib = graph_ms(lambda i: F.scaled_dot_product_attention(
            qs[i], k[i][:, :, :L], v[i][:, :, :L], enable_gqa=Hkv != H), c)
        want = reference(da.decode_attention_plain, q[0], k[0], v[0], L)
        bound = B * (2 * Hkv * L * D + 2 * H * D) * 2 / 3.35e12 * 1e3
        cases.append((f"len {L} S_max {S} H{H}/{Hkv}", B, S, L, Hkv, c,
                      (q, k, v), want, lib, bound))
    for name in list(variants) + list(variants)[:1]:
        use(libs, name, SOURCES)
        slots = variants[name].get("slots")
        da._decode_slots = card_slots if slots is None else \
            (lambda *a, n=slots: n)
        for label, B, S, L, Hkv, c, (q, k, v), want, lib, bound in cases:
            got = da.decode_attention_cuda(q[0], k[0], v[0], L)
            err = (got.float() - want.float()).abs().max().item()
            ms = graph_ms(lambda i: da.decode_attention_cuda(
                q[i], k[i], v[i], L), c)
            n, chunk = da.decode_plan(B, 1, H, Hkv, S, torch.bfloat16,
                                      q.device)
            print(f"{name} {label}: {n} x {chunk} keys, device ms {ms:.4f} "
                  f"(SDPA {lib:.4f}), {bound / ms:.3f} of bound "
                  f"{bound:.4f}, max abs err {err:.2e}", flush=True)
    da._decode_slots = card_slots
    print(f"done in {time.time() - t0:.1f} s")


if __name__ == "__main__":
    main()
