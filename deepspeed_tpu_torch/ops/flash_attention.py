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

ALiBi slopes and a sliding window (the biased kernels): the scores get
``slope[h] * key`` after the scale, and keys ``window`` or more rows before
the query are masked, before the causal mask -- the values
``reference_attention`` gives with :func:`alibi_window_bias`, which the
plain versions add to their scores.  The slopes are
constants: they take no gradient (the JAX entry's ``stop_gradient``).  A
window of 0 or None is unlimited, so a call with no slopes and such a
window (GPT-Neo's global layers) takes the unbiased kernels; both compute
the same values, and the unbiased ones skip the bias arithmetic.
"""

import math

import torch

from deepspeed_tpu_torch.ops.cuda.flash_attention import (
    flash_attention_bwd_cuda, flash_attention_fwd_biased_cuda,
    flash_attention_fwd_cuda, is_biased)
from deepspeed_tpu_torch.ops.decode_attention import resolve_backend

_NEG = -1e30


def _expand_kv(k, v, H):
    """GQA: repeat each kv head over its group of query heads (jnp.repeat
    along the head axis)."""
    rep = H // k.shape[2]
    if rep == 1:
        return k, v
    return (k.repeat_interleave(rep, dim=2), v.repeat_interleave(rep, dim=2))


def alibi_window_bias(Sq, Sk, slopes=None, window=None, device=None):
    """Additive attention bias for ALiBi slopes and/or a sliding window, as
    the JAX package builds it: ALiBi is ``slope * kpos`` ([1, H, 1, Sk];
    the row-constant part cancels in the softmax) and the window allows
    ``qpos - kpos < w`` ([1, 1, Sq, Sk], -1e30 elsewhere), ``w <= 0``
    meaning unlimited.  Query rows are aligned to the END of the key range
    (``Sq != Sk`` decode).  On ``device`` (default: the slopes' device, the
    CPU for a list); None when neither is given."""
    bias = None
    if slopes is not None:
        slopes = torch.as_tensor(slopes, dtype=torch.float32, device=device)
        device = slopes.device
        bias = (slopes[None, :, None, None] *
                torch.arange(Sk, dtype=torch.float32,
                             device=device)[None, None, None, :])
    if window is not None:
        qpos = torch.arange(Sq, device=device)[:, None] + (Sk - Sq)
        kpos = torch.arange(Sk, device=device)[None, :]
        w = int(window)
        allowed = (qpos - kpos < w) | (w <= 0)
        wbias = torch.where(allowed, 0.0, _NEG).to(torch.float32)[None, None]
        bias = wbias if bias is None else bias + wbias
    return bias


def _scores(q, k, scale, causal, alibi_slopes=None, window=None):
    """fp32 scale * Q K^T [B, H, S, S] (k already expanded to H heads),
    plus :func:`alibi_window_bias`, with the causal mask at -1e30 --
    ``_mask_bias`` of the TPU kernels."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    S = q.shape[1]
    bias = alibi_window_bias(S, S, alibi_slopes,
                             window if window and window > 0 else None,
                             device=q.device)
    if bias is not None:
        s = s + bias
    if causal:
        pos = torch.arange(S, device=q.device)
        s = s.masked_fill(~(pos[:, None] >= pos[None, :]), _NEG)
    return s


def flash_attention_fwd_plain(q, k, v, softmax_scale, causal=True,
                              alibi_slopes=None, window=None):
    """Plain forward: (O [B, S, H, D] in q's dtype, LSE fp32 [B, H, S]),
    the values ``_flash_fwd`` returns, in fp32 dense arithmetic;
    ``alibi_slopes`` (fp32 [H]) and ``window`` as the biased kernels take
    them."""
    flash_attention_fwd_plain.calls += 1
    k, v = _expand_kv(k, v, q.shape[2])
    s = _scores(q, k, softmax_scale, causal, alibi_slopes, window)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return out.to(q.dtype), lse


flash_attention_fwd_plain.calls = 0


def flash_attention_bwd_delta_plain(out, dout):
    """Plain delta, the backward's row term: ``sum_d dO * O`` in fp32,
    [B, H, S] from O and dO [B, S, H, D] -- ``_flash_bwd_pallas``'s
    ``delta``, the plain version of ``flash_attention_bwd_delta_cuda``."""
    flash_attention_bwd_delta_plain.calls += 1
    return (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()


flash_attention_bwd_delta_plain.calls = 0


def flash_attention_bwd_plain(q, k, v, out, lse, dout, softmax_scale,
                              causal=True, alibi_slopes=None, window=None):
    """Plain backward, the port of ``_flash_bwd``: dense fp32 einsums from
    the saved LSE, dK/dV summed over the GQA group.  With a bias it
    recomputes P with the same bias (``_flash_bwd`` itself takes none; its
    biased oracle is ``jax.grad`` of the biased reference).  Returns (dq,
    dk, dv) in the dtypes of q, k, v."""
    flash_attention_bwd_plain.calls += 1
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    kf, vf = _expand_kv(k, v, H)
    qf, kf, vf = q.float(), kf.float(), vf.float()
    gf = dout.float()
    s = _scores(qf, kf, softmax_scale, causal, alibi_slopes, window)
    p = torch.exp(s - lse[..., None])                    # [B, H, S, S]
    dv = torch.einsum("bhqk,bqhd->bkhd", p, gf)
    dp = torch.einsum("bqhd,bkhd->bhqk", gf, vf)
    delta = flash_attention_bwd_delta_plain(out, dout)   # [B, H, S]
    ds = p * (dp - delta[..., None]) * softmax_scale
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf)
    if Hkv != H:
        dk = dk.reshape(B, S, Hkv, H // Hkv, D).sum(3)
        dv = dv.reshape(B, S, Hkv, H // Hkv, D).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


flash_attention_bwd_plain.calls = 0


class FlashAttentionFunction(torch.autograd.Function):
    """``apply(q, k, v, softmax_scale, causal, backend, alibi_slopes,
    window)``: O [B, S, H, D].  ``backend`` is "cuda" (the kernels) or
    "plain" (the versions above), as
    :func:`ops.decode_attention.resolve_backend` returns it; the biased
    kernels run when ``alibi_slopes`` (fp32 [H], no gradient) or a
    ``window`` > 0 is given.  The counterpart of the custom VJP
    ``_flash_attention``."""

    @staticmethod
    def forward(ctx, q, k, v, softmax_scale, causal, backend,
                alibi_slopes=None, window=None):
        if backend == "cuda":
            q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
            if is_biased(alibi_slopes, window):
                out, lse = flash_attention_fwd_biased_cuda(
                    q, k, v, softmax_scale, causal, alibi_slopes, window)
            else:
                out, lse = flash_attention_fwd_cuda(q, k, v, softmax_scale,
                                                    causal)
        else:
            out, lse = flash_attention_fwd_plain(q, k, v, softmax_scale,
                                                 causal, alibi_slopes, window)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.softmax_scale, ctx.causal, ctx.backend = (softmax_scale, causal,
                                                      backend)
        ctx.alibi_slopes, ctx.window = alibi_slopes, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        if ctx.backend == "cuda":
            dq, dk, dv = flash_attention_bwd_cuda(
                q, k, v, out, lse, dout.contiguous(), ctx.softmax_scale,
                ctx.causal, ctx.alibi_slopes, ctx.window)
        else:
            dq, dk, dv = flash_attention_bwd_plain(
                q, k, v, out, lse, dout, ctx.softmax_scale, ctx.causal,
                ctx.alibi_slopes, ctx.window)
        # the slopes are constants and the window an int: no gradient
        return dq, dk, dv, None, None, None, None, None


def flash_attention(q, k, v, causal=True, softmax_scale=None,
                    alibi_slopes=None, window=None, backend="auto"):
    """q: [B, S, H, D]; k/v: [B, S, Hkv, D] (Hkv divides H).  Differentiable
    in q, k and v.  ``alibi_slopes``: [H] (a tensor, list or array; moved
    to q's device as fp32, no gradient); ``window``: an int, 0 or None for
    unlimited.  ``backend``: "auto" (the kernels for CUDA tensors, the
    plain versions for CPU tensors), "cuda" or "plain"."""
    B, S, H, D = q.shape
    if k.shape[2] == 0 or H % k.shape[2]:
        raise ValueError(f"kv heads {k.shape[2]} do not divide q heads {H}")
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(D)
    if alibi_slopes is not None:
        alibi_slopes = torch.as_tensor(alibi_slopes).detach().to(
            device=q.device, dtype=torch.float32).contiguous()
        if tuple(alibi_slopes.shape) != (H,):
            raise ValueError(f"alibi_slopes must have one slope per query "
                             f"head ({H},), got "
                             f"{tuple(alibi_slopes.shape)}")
    window = int(window) if window is not None and int(window) > 0 else None
    return FlashAttentionFunction.apply(q, k, v, float(scale), bool(causal),
                                        resolve_backend(backend, q),
                                        alibi_slopes, window)
