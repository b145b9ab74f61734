#!/usr/bin/env python3
"""A/B of source variants of the port's flash-attention kernels, on one
card, in one process.

    python3 scripts/flash_kernel_ab.py VARIANTS.json [--out DIR]
        [--head-dim 64 [80 96 ...]] [--dtype bf16 [fp16]]

VARIANTS.json maps a variant's name to ``{"dir": <sources>, "edits":
{<file>: [[regex, replacement], ...]}}``: the variant is a copy of the
directory (default ``deepspeed_tpu_torch/ops/csrc``; a ``git archive`` of
another commit's csrc works too) with each regex replaced (each must
match).  ``"dkv_sums_group": false`` marks sources whose dK/dV kernel
writes fp32 per query head at every GQA group > 1 (a commit before the
head-dim-256 cluster body): the wrappers then allocate and sum as for the
other head dims.  Every variant's ``flash_attention_fwd.cu`` and
``flash_attention_bwd.cu`` are built with the op builder's nvcc flags, all
at once, into ``--out`` with their logs (default, gitignored:
``deepspeed_tpu_torch/_build/ab``).  Then, for each variant and dtype
(bf16, or fp16 too): forward, dQ and dK/dV against the plain versions run
in fp32 on a few edge cases -- S=1000 (ragged last tiles), GQA,
non-causal, windows and ALiBi (relative L2 of O, dQ, dK, dV; max LSE
error; in fp16 also each output's max abs and relative L2 error against
the exact answer and against the plain version on the kernels' own O and
LSE, over SDPA's in fp16 on the same inputs: the fp16 rule holds where
all four are at most 2) -- and device ms by
CUDA-graph replay over 4 rotating input sets at the training paths'
shapes (B=2, 16 heads of 128, causal: S=1024; S=2048 with ALiBi, window
256, and unscaled; with ``--head-dim 64``: gpt_350m's B=8 S=1024, 16
heads, and B=2 S=2048 with ALiBi and with window 256, 16 heads of 64;
``--head-dim 96``: gpt_760m's B=8 S=1024, 16 heads, and B=2 S=2048 with
ALiBi; ``--head-dim 80``: gpt_2_7b's B=8 S=1024, 32 heads, and B=2 S=2048
with ALiBi, 32 heads; ``--head-dim 256``: Gemma-2B's B=2
S=2048, 8 heads over one kv head, and B=2 S=2048 with ALiBi and with a
window of 256, 8 heads);
the first variant is timed again at the
end, so drift shows.  Beside the three kernels each shape times the
backward as the training path calls it (``flash_attention_bwd_cuda``:
delta, dQ, dK/dV and, at a GQA group, the group sum and cast), the pair
dQ + dK/dV, and SDPA's backward (forward and backward less forward), with
each one's factor against the last.  A variant whose library has no delta
kernel is a commit from before it (its dK/dV kernel writes fp32 per query
head at every group): it is driven as that commit's wrappers drove it --
delta by eager PyTorch, the group sum and cast at every group.  Several
head dims run one after the other on one build.  Last, the HGMMA and
WARPGROUP.DEPBAR counts of each variant's bf16 kernels at those head dims
(a DEPBAR after every HGMMA means ptxas serialised the wgmma pipeline);
right after the build, the registers and spill bytes of each variant's
bf16 / fp16 dQ and dK/dV kernels at those head dims (ptxas);
``--build-only`` stops there (a new body's first call on the card).

To time a change against its parent commit in one call, unpack the
parent's sources into the gitignored ``.tmp/`` and name both:

    mkdir -p .tmp/parent
    git archive <parent> deepspeed_tpu_torch/ops/csrc | tar -x -C .tmp/parent
    echo '{"parent": {"dir": ".tmp/parent/deepspeed_tpu_torch/ops/csrc"},
           "change": {"dir": "deepspeed_tpu_torch/ops/csrc"}}' > .tmp/ab.json
    python3 scripts/flash_kernel_ab.py .tmp/ab.json --head-dim 64

The parent is timed first and again last.
"""

import argparse
import ctypes
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCES = ("flash_attention_fwd", "flash_attention_bwd")
CASES = [  # (label, B, S, H, Hkv, causal, ALiBi, window, scale)
    ("S=1000 H4/2 causal", 1, 1000, 4, 2, True, False, None, None),
    ("S=1000 H4/2 non-causal", 1, 1000, 4, 2, False, False, None, None),
    ("window 100 S=1000", 2, 1000, 16, 16, True, False, 100, None),
    ("ALiBi+window 200 GQA S=640", 2, 640, 32, 8, True, True, 200, None),
    ("ALiBi S=2048", 1, 2048, 4, 4, True, True, None, None),
    ("window 256 scale 1 S=2048", 1, 2048, 4, 4, True, False, 256, 1.0)]
SHAPES = {  # head dim -> [(label, B, S, ALiBi, window, scale[, heads[,
    # kv heads]])], 16 heads unless a shape names its own, as many kv heads
    # as heads unless it names them
    128: [("S=1024", 2, 1024, False, None, None),
          ("ALiBi S=2048", 2, 2048, True, None, None),
          ("window 256 S=2048", 2, 2048, False, 256, 1.0),
          ("global S=2048", 2, 2048, False, None, 1.0)],
    64: [("gpt_350m B=8 S=1024", 8, 1024, False, None, None),
         ("ALiBi S=2048", 2, 2048, True, None, None),
         ("window 256 S=2048", 2, 2048, False, 256, 1.0),
         # blocks of up to 64 key tiles: the cost of a tile apart from a
         # block's start and end
         ("long B=1 S=8192", 1, 8192, False, None, None)],
    96: [("gpt_760m B=8 S=1024", 8, 1024, False, None, None),
         ("ALiBi S=2048", 2, 2048, True, None, None)],
    80: [("gpt_2_7b B=8 S=1024 H32", 8, 1024, False, None, None, 32),
         ("ALiBi S=2048 H32", 2, 2048, True, None, None, 32)],
    256: [("gemma_2b B=2 S=2048 H8/1", 2, 2048, False, None, None, 8, 1),
          ("ALiBi S=2048 H8", 2, 2048, True, None, None, 8),
          ("window 256 S=2048 H8", 2, 2048, False, 256, 1 / 16, 8)]}


def build(variants, out, sources=SOURCES):
    """Copy, edit and compile each variant's ``sources`` (all nvcc
    processes at once); returns {(variant, source): ctypes library}."""
    from deepspeed_tpu_torch.ops import op_builder
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    procs = {}
    for name, spec in variants.items():
        d = os.path.join(out, name)
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(os.path.join(REPO, spec.get(
            "dir", "deepspeed_tpu_torch/ops/csrc")), d)
        for f, subs in spec.get("edits", {}).items():
            with open(os.path.join(d, f)) as fh:
                text = fh.read()
            for pat, rep in subs:
                text, n = re.subn(pat, rep, text)
                if not n:
                    sys.exit(f"{name}: {pat!r} matches nothing in {f}")
            with open(os.path.join(d, f), "w") as fh:
                fh.write(text)
        for src in sources:
            cmd = [nvcc, *op_builder.ARCH_FLAGS, *op_builder.NVCC_FLAGS,
                   "-o", os.path.join(d, f"lib{src}.so"),
                   os.path.join(d, f"{src}.cu")]
            procs[(name, src)] = subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)
    libs = {}
    for (name, src), proc in procs.items():
        log = proc.communicate()[0]
        with open(os.path.join(out, name, f"{src}.log"), "w") as fh:
            fh.write(log)
        if proc.returncode:
            sys.exit(f"{name}: nvcc failed for {src}:\n{log[-3000:]}")
        spills = sorted({ln.strip() for ln in log.splitlines()
                         if "spill" in ln and " 0 bytes spill" not in ln})
        print(f"{name} {src}: built; spills {spills or 'none'}", flush=True)
        libs[(name, src)] = ctypes.CDLL(
            os.path.join(out, name, f"lib{src}.so"))
    return libs


_SUMS_GROUP = []   # the wrapper module's own dkv_sums_group


def use(libs, name, spec, sources=SOURCES):
    """Point the wrappers at variant ``name``'s libraries (``spec``: its
    entry in VARIANTS.json); returns whether the variant is from before the
    delta kernel (see the module's docstring)."""
    from deepspeed_tpu_torch.ops import op_builder
    from deepspeed_tpu_torch.ops.cuda import flash_attention as fa
    if not _SUMS_GROUP:
        _SUMS_GROUP.append(fa.dkv_sums_group)
    fa.dkv_sums_group = (_SUMS_GROUP[0] if spec.get("dkv_sums_group", True)
                         else lambda head_dim, dtype: False)
    legacy = False
    for kernel, (src, symbol, argtypes) in op_builder.SIGNATURES.items():
        if src in sources:
            fn = getattr(libs[(name, src)], symbol, None)
            if fn is None:
                legacy = True
                op_builder._loaded.pop(kernel, None)
                continue
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            op_builder._loaded[kernel] = fn
    return legacy


def legacy_dkv(fa, kw):
    """The dK/dV wrapper of a commit from before the delta kernel: its
    kernel writes fp32 [B, S, H, D] at every group."""
    import torch
    from deepspeed_tpu_torch.ops import op_builder

    def call(q, k, v, dout, lse, delta, scale, causal=True):
        B, S, H, D = q.shape
        slopes, w = (fa._bias_args(q, kw["alibi_slopes"], kw["window"], "ab")
                     if fa.is_biased(**kw) else (0, 0))
        dk = torch.empty(q.shape, dtype=torch.float32, device=q.device)
        dv = torch.empty_like(dk)
        rc = op_builder.load("flash_attention_bwd_dkv")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            slopes, B, S, H, k.shape[2], D, int(bool(causal)),
            fa._DTYPE_CODES[q.dtype], w, float(scale), fa._stream(q))
        if rc:
            raise RuntimeError(f"dK/dV launch failed: CUDA error {rc}")
        return dk, dv
    return call


def kernels(fa, kw, legacy=False):
    """(forward, dQ, dK/dV, the backward as called) for bias ``kw``,
    biased where needed; ``legacy``: as a commit from before the delta
    kernel drove them."""
    import torch
    biased = fa.is_biased(kw["alibi_slopes"], kw["window"])
    if biased:
        fwd = lambda *a: fa.flash_attention_fwd_biased_cuda(*a, **kw)
        dq = lambda *a: fa.flash_attention_bwd_dq_biased_cuda(*a, **kw)
        dkv = lambda *a: fa.flash_attention_bwd_dkv_biased_cuda(*a, **kw)
    else:
        fwd, dq, dkv = (fa.flash_attention_fwd_cuda,
                        fa.flash_attention_bwd_dq_cuda,
                        fa.flash_attention_bwd_dkv_cuda)
    bias = kw if biased else {}
    if not legacy:
        return fwd, dq, dkv, lambda *a: fa.flash_attention_bwd_cuda(*a,
                                                                    **bias)
    dkv = legacy_dkv(fa, kw)

    def called(q, k, v, o, lse, dout, scale, causal=True):
        B, S, H, D = q.shape
        delta = (dout.float() * o.float()).sum(-1).transpose(1, 2)
        delta = delta.contiguous()
        dq_ = dq(q, k, v, dout, lse, delta, scale, causal)
        dk, dv = dkv(q, k, v, dout, lse, delta, scale, causal)
        g = H // k.shape[2]
        return (dq_, dk.view(B, S, -1, g, D).sum(3).to(k.dtype),
                dv.view(B, S, -1, g, D).sum(3).to(v.dtype))
    return fwd, dq, dkv, called


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("variants", help="JSON file of variants")
    ap.add_argument("--out", default=os.path.join(
        REPO, "deepspeed_tpu_torch", "_build", "ab"))
    ap.add_argument("--head-dim", type=int, choices=sorted(SHAPES),
                    nargs="+", default=[128])
    ap.add_argument("--dtype", choices=("bf16", "fp16"), nargs="+",
                    default=["bf16"])
    ap.add_argument("--build-only", action="store_true",
                    help="stop after the build and the spill reading")
    args = ap.parse_args()
    sys.path.insert(0, REPO)
    import torch
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    with open(args.variants) as fh:
        variants = json.load(fh)
    os.makedirs(args.out, exist_ok=True)
    t0 = time.time()
    libs = build(variants, args.out)
    print(f"built in {time.time() - t0:.1f} s", flush=True)
    print_usage(variants, args.out, args.head_dim)
    if args.build_only:
        return
    gen = torch.Generator(device="cuda").manual_seed(1)
    for dn in args.dtype:
        dtype = torch.float16 if dn == "fp16" else torch.bfloat16
        for D in args.head_dim:
            run_head_dim(D, variants, libs, gen, args.out, dtype)
    print(f"done in {time.time() - t0:.1f} s")


def print_usage(variants, out, head_dims):
    """Each variant's registers and spill bytes (ptxas) of its bf16 / fp16
    backward kernels at ``head_dims``: the spill reading of a change."""
    from chip_smoke import ptxas_usage
    for name in variants:
        with open(os.path.join(out, name, "flash_attention_bwd.log")) as fh:
            usage = ptxas_usage(fh.read())
        for kernel, (regs, st, ld) in sorted(usage.items()):
            m = re.search(r"flash_bwd_(dq|dkv)_kernel<(__nv_bfloat16|__half),"
                          r" (\w+), (\w+), (\d+)>", kernel)
            if m and int(m.group(5)) in head_dims:
                print(f"{name} {m.group(1)}<{m.group(2)}, alibi={m.group(3)},"
                      f" window={m.group(4)}, D={m.group(5)}>: {regs} "
                      f"registers, spills {st}/{ld} B", flush=True)


def sdpa_backward_ms(q, k, v, do, scale, kw, c):
    """Device ms of SDPA's backward (forward and backward, less forward) on
    the c input sets [c, B, S, H, D]: ALiBi as a float mask (slope * key,
    -inf above the diagonal), a window as a boolean one; a GQA group's kv
    heads repeated for it.  The yardstick of the backward, not the port's
    path."""
    import torch
    import torch.nn.functional as F
    from chip_smoke import graph_ms
    S, H = q.shape[2], q.shape[3]
    qt, kt, vt, dot = (x.transpose(2, 3).contiguous() for x in (q, k, v, do))
    if k.shape[3] != H:
        kt, vt = (x.repeat_interleave(H // k.shape[3], 2) for x in (kt, vt))
    pos = torch.arange(S, device=q.device)
    allowed = pos[:, None] >= pos[None, :]
    mask = None
    if kw["window"]:
        allowed &= pos[:, None] - pos[None, :] < kw["window"]
        mask = allowed
    if kw["alibi_slopes"] is not None:
        mask = (kw["alibi_slopes"][:, None, None] * pos.float()[None, None]
                ).masked_fill(~allowed, float("-inf")).to(q.dtype)[None]
    leaves = [[x[i].clone().requires_grad_() for x in (qt, kt, vt)]
              for i in range(c)]

    def fwd(i, xs):
        return F.scaled_dot_product_attention(
            *xs, attn_mask=mask, is_causal=mask is None, scale=scale)

    def fwd_bwd(i):
        torch.autograd.grad(fwd(i, leaves[i]), leaves[i], dot[i])

    ms = graph_ms(fwd_bwd, c) - graph_ms(
        lambda i: fwd(i, (qt[i], kt[i], vt[i])), c)
    del leaves, qt, kt, vt, dot
    return ms


def run_head_dim(D, variants, libs, gen, out, dtype):
    """The checks, timings and SASS counts of every variant at head dim
    ``D`` in ``dtype`` (bf16 or fp16)."""
    import torch
    from chip_smoke import WITNESS_FACTOR, _abs_rel, graph_ms, sdpa_witness
    from deepspeed_tpu_torch.models.transformer import alibi_slopes
    from deepspeed_tpu_torch.ops.cuda import flash_attention as fa
    from deepspeed_tpu_torch.ops.flash_attention import (
        flash_attention_bwd_plain, flash_attention_fwd_plain)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    def rel(got, want):
        return ((got.float() - want).norm() / want.norm()).item()

    cases = []
    for label, B, S, H, Hkv, causal, alibi, window, scale in CASES:
        q, dout = rnd(B, S, H, D), rnd(B, S, H, D)
        k, v = rnd(B, S, Hkv, D), rnd(B, S, Hkv, D)
        kw = dict(alibi_slopes=alibi_slopes(H).cuda() if alibi else None,
                  window=window)
        scale = scale or 1 / math.sqrt(D)
        f32 = [x.float() for x in (q, k, v, dout)]
        o, lse = flash_attention_fwd_plain(*f32[:3], scale, causal, **kw)
        dq, dk, dv = flash_attention_bwd_plain(*f32[:3], o, lse, f32[3],
                                               scale, causal, **kw)
        sdpa = (sdpa_witness(q, k, v, dout, scale, causal, **kw)
                if dtype == torch.float16 else None)
        cases.append((label, (q, k, v, dout), scale, causal, kw,
                      (o, lse, dq, dk, dv), sdpa))
    for name, spec in variants.items():
        legacy = use(libs, name, spec)
        held = getattr(libs[(name, "flash_attention_bwd")],
                       "ds_flash_attention_bwd_dkv_clusters", None)
        if D == 256 and held is not None:
            held.argtypes = [ctypes.c_int] * 2
            held.restype = ctypes.c_int
            code = 2 if dtype == torch.float16 else 1
            print(f"{name} D=256 dK/dV clusters the card holds at once "
                  f"(cudaOccupancyMaxActiveClusters): " + ", ".join(
                      f"group {g}: {held(g, code)}" for g in (1, 2, 8)),
                  flush=True)
        for label, (q, k, v, dout), scale, causal, kw, want, sdpa in cases:
            fwd, *_, called = kernels(fa, kw, legacy)
            o, lse = fwd(q, k, v, scale, causal)
            dq, dk, dv = called(q, k, v, o, lse, dout, scale, causal)
            print(f"{name} D={D} {label}: O rel L2 {rel(o, want[0]):.2e}, "
                  f"LSE max err {(lse - want[1]).abs().max().item():.2e}, dQ "
                  f"{rel(dq, want[2]):.2e}, dK {rel(dk, want[3]):.2e}, dV "
                  f"{rel(dv, want[4]):.2e}", flush=True)
            if sdpa is None:
                continue
            # the fp16 rule: errors over SDPA-fp16's, against the exact
            # answer and against the plain version on the kernels' O, LSE
            f32 = [x.float() for x in (q, k, v, dout)]
            plain = (want[0],) + tuple(flash_attention_bwd_plain(
                *f32[:3], o.float(), lse, f32[3], scale, causal, **kw))
            ratios = []
            for i, (nm, got) in enumerate(zip(("O", "dQ", "dK", "dV"),
                                              (o, dq, dk, dv))):
                exact = want[0] if i == 0 else want[i + 1]
                s_abs, s_rel = _abs_rel(sdpa[i], exact)
                k_abs, k_rel = _abs_rel(got, exact)
                p_abs, p_rel = _abs_rel(got, plain[i])
                r = max(k_abs / s_abs, k_rel / s_rel, p_abs / s_abs,
                        p_rel / s_rel)
                ratios.append(f"{nm} {k_abs / s_abs:.2f}/{k_rel / s_rel:.2f}"
                              f" vs exact, {p_abs / s_abs:.2f}/"
                              f"{p_rel / s_rel:.2f} vs plain"
                              f"{'' if r <= WITNESS_FACTOR else ' OVER'}")
            print(f"{name} D={D} {label} fp16 rule (kernel / SDPA-fp16 max "
                  f"abs / rel L2): " + "; ".join(ratios), flush=True)
    c, shapes = 4, []
    for label, B, S, alibi, window, scale, *heads in SHAPES[D]:
        H = heads[0] if heads else 16
        Hkv = heads[1] if len(heads) > 1 else H
        x = [torch.randn((c, B, S, h, D), generator=gen,
                         device="cuda").to(dtype)
             for h in (H, Hkv, Hkv, H)]
        kw = dict(alibi_slopes=alibi_slopes(H).cuda() if alibi else None,
                  window=window)
        shapes.append((label, x, scale or 1 / math.sqrt(D), kw))
    sdpa_bwd = {label: sdpa_backward_ms(q, k, v, do, scale, kw, c)
                for label, (q, k, v, do), scale, kw in shapes}
    print(f"device ms SDPA backward D={D}: " + " | ".join(
        f"{label} {ms:.4f}" for label, ms in sdpa_bwd.items()), flush=True)
    for name in list(variants) + list(variants)[:1]:
        legacy = use(libs, name, variants[name])
        row = []
        for label, (q, k, v, do), scale, kw in shapes:
            fwd, dq, dkv, called = kernels(fa, kw, legacy)
            outs = [fwd(q[i], k[i], v[i], scale, True) for i in range(c)]
            o = torch.stack([x[0] for x in outs])
            lse = torch.stack([x[1] for x in outs])
            delta = (do.float() * o.float()).sum(-1).transpose(2, 3)
            delta = delta.contiguous()
            f_ms = graph_ms(lambda i: fwd(q[i], k[i], v[i], scale, True), c)
            q_ms = graph_ms(lambda i: dq(q[i], k[i], v[i], do[i], lse[i],
                                         delta[i], scale, True), c)
            d_ms = graph_ms(lambda i: dkv(q[i], k[i], v[i], do[i], lse[i],
                                          delta[i], scale, True), c)
            p_ms = graph_ms(lambda i: (
                dq(q[i], k[i], v[i], do[i], lse[i], delta[i], scale, True),
                dkv(q[i], k[i], v[i], do[i], lse[i], delta[i], scale,
                    True)), c)
            c_ms = graph_ms(lambda i: called(q[i], k[i], v[i], o[i], lse[i],
                                             do[i], scale, True), c)
            ref = sdpa_bwd[label]
            row.append(f"{label} fwd {f_ms:.4f} dQ {q_ms:.4f} dK/dV "
                       f"{d_ms:.4f} pair {p_ms:.4f} ({p_ms / ref:.2f}x SDPA"
                       f" bwd) as called {c_ms:.4f} ({c_ms / ref:.2f}x)")
            del outs, o, lse, delta
        print(f"device ms {name} D={D} {dtype}: " + " | ".join(row),
              flush=True)
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    for name in variants:
        for src in SOURCES:
            sass = subprocess.run(
                [tool, "-sass", os.path.join(out, name, f"lib{src}.so")],
                capture_output=True, text=True).stdout
            for part in sass.split("Function : ")[1:]:
                head = part.split("\n", 1)[0]
                m = re.search(r"(flash_\w+_kernel)I13__nv_bfloat16Lb(\d)ELb"
                              r"(\d)ELi(\d+)E", head)
                if m and int(m.group(4)) == D:
                    print(f"SASS {name} {m.group(1)}<bf16, alibi="
                          f"{m.group(2)}, window={m.group(3)}, D={D}>: HGMMA "
                          f"{len(re.findall(r'HGMMA', part))}, DEPBAR "
                          f"{len(re.findall(r'WARPGROUP.DEPBAR', part))}")


if __name__ == "__main__":
    main()
