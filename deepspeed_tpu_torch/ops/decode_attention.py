"""Decode (inference) attention with a contiguous KV cache.

Counterpart of ``deepspeed_tpu/ops/decode_attention.py``.  The cache is a
static-shape buffer [B, Hkv, max_seq, D] that :func:`update_cache` writes
IN PLACE (the PyTorch counterpart of the JAX package's buffer donation),
and attention masks positions at or past the valid length.  Two compute
paths behind one API, picked by :func:`resolve_backend`: the CUDA kernel
(``ops/csrc/decode_attention.cu``) for CUDA tensors, the plain PyTorch
version for CPU tensors.
"""

from dataclasses import dataclass

import torch

from deepspeed_tpu_torch.ops.cuda.decode_attention import (
    decode_attention_cuda, decode_attention_plain)

# public vocabulary of the attention backend switch (serving.attention_backend)
ATTENTION_BACKENDS = ("auto", "cuda", "plain")
_JAX_SPELLINGS = ("jnp", "pallas", "pallas-interpret")


def validate_backend(backend) -> str:
    """The backend name ("auto" for None); raises a one-line ValueError
    on anything outside :data:`ATTENTION_BACKENDS`."""
    if backend is None:
        return "auto"
    if backend in ATTENTION_BACKENDS:
        return backend
    if backend in _JAX_SPELLINGS:
        raise ValueError(f"attention backend {backend!r} is the JAX "
                         f"package's spelling; expected one of "
                         f"{ATTENTION_BACKENDS}")
    raise ValueError(f"unknown attention backend {backend!r}; expected one "
                     f"of {ATTENTION_BACKENDS}")


def resolve_backend(backend, tensor) -> str:
    """"cuda" or "plain" for ``tensor``.  ``"auto"``/None: the kernel for a
    CUDA tensor, the plain version for a CPU tensor; ``"cuda"``: the kernel
    (its wrapper raises on CPU tensors); ``"plain"``: the plain version
    (the smoke test's comparison and the tests)."""
    backend = validate_backend(backend)
    if backend == "auto":
        return "cuda" if tensor.is_cuda else "plain"
    return backend


@dataclass
class KVCache:
    k: torch.Tensor   # [B, Hkv, S_max, D] (or [L, ...] stacked per layer)
    v: torch.Tensor
    length: int       # valid prefix length (host int)


def init_cache(batch, max_seq, n_kv_heads, head_dim, dtype=torch.bfloat16,
               device=None) -> KVCache:
    shape = (batch, n_kv_heads, max_seq, head_dim)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device),
                   length=0)


def update_cache(cache: KVCache, k_new, v_new) -> KVCache:
    """Append [B, T, Hkv, D] (model layout) at ``cache.length``.  Writes
    ``cache.k``/``cache.v`` IN PLACE and returns a KVCache over the same
    buffers with the new length.  Raises when ``length + T`` exceeds the
    buffer, where JAX's ``dynamic_update_slice`` silently clamps."""
    start, T = int(cache.length), k_new.shape[1]
    S = cache.k.shape[2]
    if start + T > S:
        raise ValueError(f"KV cache overflow: {start} + {T} tokens > "
                         f"max_seq {S}")
    cache.k[:, :, start:start + T] = k_new.transpose(1, 2).to(cache.k.dtype)
    cache.v[:, :, start:start + T] = v_new.transpose(1, 2).to(cache.v.dtype)
    return KVCache(k=cache.k, v=cache.v, length=start + T)


def decode_attention(q, cache: KVCache, softmax_scale=None, backend="auto",
                     lengths=None, bias=None, logit_softcap=None):
    """q: [B, T, H, D] (T=1 decode or T=prompt prefill, already appended
    to the cache); attends over cache[:length] with fp32 softmax.
    ``lengths``: optional int32 [B] tensor of per-sequence lengths on q's
    device (default: ``cache.length`` for every sequence)."""
    if bias is not None or logit_softcap:
        raise NotImplementedError(
            "decode attention with an additive bias (ALiBi / local windows) "
            "or a logit softcap is not ported yet (ROADMAP A16)")
    lens = cache.length if lengths is None else lengths
    if resolve_backend(backend, q) == "cuda":
        return decode_attention_cuda(q, cache.k, cache.v, lens,
                                     softmax_scale=softmax_scale)
    return decode_attention_plain(q, cache.k, cache.v, lens,
                                  softmax_scale=softmax_scale)
