"""Block-sparse self-attention.

Counterpart of ``deepspeed_tpu/ops/sparse_attention/
sparse_self_attention.py`` (the reference's ``SparseSelfAttention`` /
``SparseAttentionUtils`` over its Triton sddmm/softmax/dsd kernels).  Two
paths behind one API, as in the JAX package:

* the hand-written block-sparse kernel (``ops/cuda/sparse_attention.py``),
  which walks only the set blocks of the static layout -- for CUDA tensors
  whose length tiles by the layout block and that carry no
  ``key_padding_mask``;
* :func:`sparse_attention_plain`, the dense masked softmax (O(S^2)): the
  plain version the kernel is held against, the path for CPU tensors, and
  -- because the JAX package's own jnp path serves those inputs -- the
  path for a ``key_padding_mask`` (a per-batch mask the static-layout
  kernel does not take).  That is what the API computes for such inputs,
  not a fallback: ``backend="cuda"`` on them raises.

A length that does not tile by the layout block raises on both paths (the
JAX package's dense path cannot expand the layout over it either): pad it
with :class:`SparseAttentionUtils` first.
"""

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from deepspeed_tpu_torch.ops.cuda.sparse_attention import (
    card_steps, card_tables, sparse_attention_cuda)
from deepspeed_tpu_torch.ops.decode_attention import (resolve_backend,
                                                      validate_backend)
from deepspeed_tpu_torch.ops.sparse_attention.sparsity_config import (
    DenseSparsityConfig, SparsityConfig)


def expand_layout_mask(layout: np.ndarray, block: int, seq_len: int
                       ) -> np.ndarray:
    """[H, nb, nb] block layout -> [H, S, S] boolean attention mask."""
    n = seq_len // block
    lay = np.asarray(layout[:, :n, :n])
    return np.repeat(np.repeat(lay, block, axis=1), block, axis=2)


def sparse_attention_plain(q, k, v, layout, block, causal=False,
                           softmax_scale=None, key_padding_mask=None):
    """Dense masked block-sparse attention, the JAX package's jnp path:
    fp32 logits and softmax over the expanded layout (and causal) mask,
    ``key_padding_mask`` [B, S] (True = keep) applied too, and rows whose
    layout row is empty set to 0 as the kernel leaves them.  q/k/v:
    [B, S, H, D]."""
    sparse_attention_plain.calls += 1
    B, S, H, D = q.shape
    if S % block:
        # the JAX jnp path fails here too, broadcasting a [H, S//block *
        # block] mask against [.., S, S] logits
        raise ValueError(f"sequence length {S} does not tile by the layout "
                         f"block {block}; pad it first "
                         f"(SparseAttentionUtils.pad_to_block_size)")
    scale = softmax_scale if softmax_scale is not None else D ** -0.5
    mask = torch.as_tensor(expand_layout_mask(np.asarray(layout), block, S),
                           device=q.device)                   # [H, S, S]
    if causal:
        mask = mask & torch.ones((S, S), dtype=torch.bool,
                                 device=q.device).tril()
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    logits = logits.masked_fill(~mask[None], -1e30)
    if key_padding_mask is not None:
        keep = torch.as_tensor(key_padding_mask, device=q.device).bool()
        logits = logits.masked_fill(~keep[:, None, None, :], -1e30)
    probs = torch.softmax(logits, dim=-1)
    # a row that sees no key would average V uniformly: zero it, as the
    # kernel's empty rows are
    probs = probs * mask.any(-1)[None, :, :, None]
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)


sparse_attention_plain.calls = 0


def sparse_attention(q, k, v, layout: np.ndarray, block: int,
                     causal: bool = False,
                     softmax_scale: Optional[float] = None,
                     key_padding_mask=None, backend="auto", tables=None,
                     steps=None):
    """Block-sparse attention.  q/k/v: [B, S, H, D]; layout [H, nb, nb].

    ``backend``: "auto" (the kernel for CUDA tensors, the plain version
    for CPU tensors), "cuda" or "plain".  Inputs with a
    ``key_padding_mask`` take the plain version on any device (the JAX
    package's rule); ``backend="cuda"`` raises for them, and for a length
    that does not tile by ``block``, which no path takes.  ``tables`` /
    ``steps``: the layout's ``card_tables`` (fp32 kernel) / ``card_steps``
    (bf16 and fp16 kernel) already on the card (made per call when
    None)."""
    backend = validate_backend(backend)
    S = q.shape[1]
    kernel_ok = key_padding_mask is None and S % block == 0
    if not kernel_ok:
        if backend == "cuda":
            raise ValueError("the block-sparse kernel needs a length that "
                             "tiles by the layout block and no "
                             "key_padding_mask")
        return sparse_attention_plain(q, k, v, layout, block, causal=causal,
                                      softmax_scale=softmax_scale,
                                      key_padding_mask=key_padding_mask)
    if resolve_backend(backend, q) == "cuda":
        return sparse_attention_cuda(q, k, v, layout, block, causal=causal,
                                     softmax_scale=softmax_scale,
                                     tables=tables, steps=steps)
    return sparse_attention_plain(q, k, v, layout, block, causal=causal,
                                  softmax_scale=softmax_scale)


class SparseSelfAttention:
    """Parity surface of the reference's ``sparse_self_attention.py``:
    layouts from ``sparsity_config``, cached per sequence length, and the
    kernel's tables beside them (``card_tables`` for fp32 inputs,
    ``card_steps`` for bf16 and fp16), uploaded once per (length, causal,
    device, form).  ``backend`` as in :func:`sparse_attention`."""

    def __init__(self, sparsity_config: Optional[SparsityConfig] = None,
                 key_padding_mask_mode: str = "add",
                 attn_mask_mode: str = "mul", max_seq_length: int = 2048,
                 backend="auto"):
        self.sparsity_config = sparsity_config or DenseSparsityConfig(
            num_heads=4)
        self.key_padding_mask_mode = key_padding_mask_mode
        self.attn_mask_mode = attn_mask_mode
        self.backend = validate_backend(backend)
        self._layout_cache = {}
        self._table_cache = {}

    def get_layout(self, seq_len: int) -> np.ndarray:
        if seq_len not in self._layout_cache:
            self._layout_cache[seq_len] = \
                self.sparsity_config.make_layout(seq_len)
        return self._layout_cache[seq_len]

    def __call__(self, q, k, v, key_padding_mask=None, causal=None):
        sc = self.sparsity_config
        if causal is None:
            causal = getattr(sc, "attention", "bidirectional") == \
                "unidirectional"
        S = q.shape[1]
        layout, tables = self.get_layout(S), {}
        if self.backend != "plain" and q.is_cuda and \
                key_padding_mask is None and S % sc.block == 0:
            fp32 = q.dtype == torch.float32
            key = (S, bool(causal), q.device, fp32)
            if key not in self._table_cache:
                self._table_cache[key] = (
                    {"tables": card_tables(layout, causal, q.device)} if fp32
                    else {"steps": card_steps(layout, sc.block, causal,
                                              q.device)})
            tables = self._table_cache[key]
        return sparse_attention(q, k, v, layout, sc.block, causal=causal,
                                key_padding_mask=key_padding_mask,
                                backend=self.backend, **tables)

    forward = __call__


class SparseAttentionUtils:
    """Parity helpers (the reference's ``sparse_attention_utils.py``):
    pad / unpad sequences to block multiples."""

    @staticmethod
    def pad_to_block_size(block_size: int, input_ids=None,
                          attention_mask=None, inputs_embeds=None,
                          pad_token_id: int = 0):
        seq = (input_ids if input_ids is not None else inputs_embeds)
        S = seq.shape[1]
        pad = (-S) % block_size
        out = []
        for t, fill in ((input_ids, pad_token_id), (attention_mask, 0),
                        (inputs_embeds, 0)):
            if t is None:
                out.append(None)
                continue
            t = torch.as_tensor(t)
            widths = [0, 0] * (t.dim() - 2) + [0, pad]   # dim 1's end
            out.append(F.pad(t, widths, value=fill))
        return pad, *out

    @staticmethod
    def unpad_sequence_output(pad_len: int, sequence_output):
        if pad_len:
            return sequence_output[:, :-pad_len]
        return sequence_output
