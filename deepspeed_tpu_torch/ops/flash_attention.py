"""Flash attention for training: forward, backward and the autograd
function that joins them.

Counterpart of ``deepspeed_tpu/ops/pallas/flash_attention.py``.  The
forward returns ``(O, LSE)`` as ``_flash_fwd`` does; the backward
recomputes the probabilities from the saved fp32 LSE, as ``_flash_bwd``
and the TPU kernels do.  :class:`FlashAttentionFunction` saves
``q, k, v, O, LSE`` and runs its forward and backward either through the
hand-written CUDA kernels (``ops/cuda/flash_attention.py``) or through
the plain PyTorch versions here -- the latter for CPU tensors, and for the
smoke test's comparison and the tests (``backend="plain"``).

Any sequence length is taken by both: the kernels mask their ragged last
tile, where the JAX entry routes a non-tiling S to ``reference_attention``.
The ALiBi / sliding-window (biased) variants are not ported (ROADMAP A16).
"""

import math

import torch

from deepspeed_tpu_torch.ops.cuda.flash_attention import (
    flash_attention_bwd_cuda, flash_attention_fwd_cuda)
from deepspeed_tpu_torch.ops.decode_attention import resolve_backend

_NEG = -1e30


def _expand_kv(k, v, H):
    """GQA: repeat each kv head over its group of query heads (jnp.repeat
    along the head axis)."""
    rep = H // k.shape[2]
    if rep == 1:
        return k, v
    return (k.repeat_interleave(rep, dim=2), v.repeat_interleave(rep, dim=2))


def _scores(q, k, scale, causal):
    """fp32 scale * Q K^T [B, H, S, S] with the causal mask at -1e30."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        S = q.shape[1]
        pos = torch.arange(S, device=q.device)
        s = s.masked_fill(~(pos[:, None] >= pos[None, :]), _NEG)
    return s


def flash_attention_fwd_plain(q, k, v, softmax_scale, causal=True):
    """Plain forward: (O [B, S, H, D] in q's dtype, LSE fp32 [B, H, S]),
    the values ``_flash_fwd`` returns, in fp32 dense arithmetic."""
    flash_attention_fwd_plain.calls += 1
    k, v = _expand_kv(k, v, q.shape[2])
    s = _scores(q, k, softmax_scale, causal)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return out.to(q.dtype), lse


flash_attention_fwd_plain.calls = 0


def flash_attention_bwd_plain(q, k, v, out, lse, dout, softmax_scale,
                              causal=True):
    """Plain backward, the port of ``_flash_bwd``: dense fp32 einsums from
    the saved LSE, dK/dV summed over the GQA group.  Returns (dq, dk, dv)
    in the dtypes of q, k, v."""
    flash_attention_bwd_plain.calls += 1
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    kf, vf = _expand_kv(k, v, H)
    qf, kf, vf = q.float(), kf.float(), vf.float()
    gf, of = dout.float(), out.float()
    s = _scores(qf, kf, softmax_scale, causal)
    p = torch.exp(s - lse[..., None])                    # [B, H, S, S]
    dv = torch.einsum("bhqk,bqhd->bkhd", p, gf)
    dp = torch.einsum("bqhd,bkhd->bhqk", gf, vf)
    delta = torch.sum(gf * of, dim=-1)                   # [B, S, H]
    ds = p * (dp - delta.transpose(1, 2)[..., None]) * softmax_scale
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf)
    if Hkv != H:
        dk = dk.reshape(B, S, Hkv, H // Hkv, D).sum(3)
        dv = dv.reshape(B, S, Hkv, H // Hkv, D).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


flash_attention_bwd_plain.calls = 0


class FlashAttentionFunction(torch.autograd.Function):
    """``apply(q, k, v, softmax_scale, causal, backend)``: O [B, S, H, D].
    ``backend`` is "cuda" (the kernels) or "plain" (the versions above),
    as :func:`ops.decode_attention.resolve_backend` returns it.  The
    counterpart of the custom VJP ``_flash_attention``."""

    @staticmethod
    def forward(ctx, q, k, v, softmax_scale, causal, backend):
        if backend == "cuda":
            q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
            out, lse = flash_attention_fwd_cuda(q, k, v, softmax_scale,
                                                causal)
        else:
            out, lse = flash_attention_fwd_plain(q, k, v, softmax_scale,
                                                 causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.softmax_scale, ctx.causal, ctx.backend = (softmax_scale, causal,
                                                      backend)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        if ctx.backend == "cuda":
            dq, dk, dv = flash_attention_bwd_cuda(
                q, k, v, out, lse, dout.contiguous(), ctx.softmax_scale,
                ctx.causal)
        else:
            dq, dk, dv = flash_attention_bwd_plain(
                q, k, v, out, lse, dout, ctx.softmax_scale, ctx.causal)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, causal=True, softmax_scale=None,
                    alibi_slopes=None, window=None, backend="auto"):
    """q: [B, S, H, D]; k/v: [B, S, Hkv, D] (Hkv divides H).  Differentiable
    in q, k and v.  ``backend``: "auto" (the kernels for CUDA tensors, the
    plain versions for CPU tensors), "cuda" or "plain"."""
    if alibi_slopes is not None or window is not None:
        raise NotImplementedError(
            "flash attention with ALiBi slopes or a sliding window (the "
            "biased kernels) is not ported yet (ROADMAP A16)")
    B, S, H, D = q.shape
    if k.shape[2] == 0 or H % k.shape[2]:
        raise ValueError(f"kv heads {k.shape[2]} do not divide q heads {H}")
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(D)
    return FlashAttentionFunction.apply(q, k, v, float(scale), bool(causal),
                                        resolve_backend(backend, q))
