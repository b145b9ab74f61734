"""Attention ops of the training path: the plain reference and the
dispatching entry.

Counterpart of ``deepspeed_tpu/ops/attention.py``.  :func:`attention` is
the one entry the model's training forward calls.  It has the backend
vocabulary of the serving ops ("auto" | "cuda" | "plain", see
``ops/decode_attention.resolve_backend``): on a CUDA tensor the flash
kernels launch or the call raises -- there is no counterpart of the JAX
package's warn-and-fall-back path.  :func:`reference_attention` is the
plain softmax attention the tests hold everything against.
"""

import math
from typing import Optional

import torch

from deepspeed_tpu_torch.ops.flash_attention import (  # noqa: F401
    alibi_window_bias, flash_attention)


def reference_attention(q, k, v, causal=True, bias=None, segment_ids=None,
                        softmax_scale: Optional[float] = None,
                        logit_softcap: Optional[float] = None):
    """Plain softmax attention.

    q: [B, S, H, D]; k/v: [B, S, Hkv, D] (Hkv divides H -> GQA).  Softmax
    in fp32 regardless of the input dtype; matmuls in the input dtype."""
    orig_dtype = q.dtype
    B, Sq, H, D = q.shape
    Hkv = k.shape[2]
    if Hkv != H:
        rep = H // Hkv
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(D)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    if logit_softcap:
        logits = logit_softcap * torch.tanh(logits / logit_softcap)
    Sk = k.shape[1]
    if bias is not None:
        logits = logits + bias
    if causal:
        qi = torch.arange(Sq, device=q.device)[:, None] + (Sk - Sq)
        ki = torch.arange(Sk, device=q.device)[None, :]
        logits = logits.masked_fill(~(qi >= ki)[None, None], -1e30)
    if segment_ids is not None:
        seg = segment_ids[:, :, None] == segment_ids[:, None, :]
        logits = logits.masked_fill(~seg[:, None], -1e30)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)
    return out.to(orig_dtype)


def attention(q, k, v, causal=True, softmax_scale=None, backend="auto",
              alibi_slopes=None, window=None, logit_softcap=None):
    """Dispatching attention entry: flash attention through the CUDA
    kernels for CUDA tensors (``"auto"``/``"cuda"``), through its plain
    versions for CPU tensors (``"auto"``) or on request (``"plain"``).
    ``alibi_slopes`` ([H]) and ``window`` (an int, 0/None = unlimited) go
    to :func:`flash_attention`'s biased kernels -- where the JAX entry's
    reference path materialises :func:`alibi_window_bias`, the same values.
    Logit softcaps raise (ROADMAP A16)."""
    if logit_softcap:
        raise NotImplementedError("attention logit softcap is not ported "
                                  "yet (ROADMAP A16)")
    return flash_attention(q, k, v, causal=causal,
                           softmax_scale=softmax_scale,
                           alibi_slopes=alibi_slopes, window=window,
                           backend=backend)
