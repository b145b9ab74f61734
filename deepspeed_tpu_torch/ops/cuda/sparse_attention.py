"""Block-sparse attention: the CUDA kernel's wrapper and its host tables.

Replaces ``deepspeed_tpu/ops/pallas/sparse_attention.py``: the kernel
``_sparse_kernel`` (``ops/csrc/sparse_attention.cu``) and its host side
``sparse_attention_pallas``; :func:`layout_tables` and :func:`sparse_flops`
are the port's own copies of the functions of the same names there.  The
layout is static config: :func:`card_tables` puts its tables on the card,
and ``SparseSelfAttention`` keeps them with its per-length layout cache.
Forward only, as on the TPU: a
call whose inputs need a gradient raises.  The plain version (the JAX
package's dense-masked path) and the dispatching API are in
``ops/sparse_attention/sparse_self_attention.py``.
"""

import numpy as np
import torch

from deepspeed_tpu_torch.ops import op_builder
from deepspeed_tpu_torch.ops.cuda.decode_attention import _DTYPE_CODES

SPARSE_BLOCKS = (16, 32, 64, 128)   # layout blocks the kernel is built for
SPARSE_HEAD_DIMS = (64, 128)


def layout_tables(layout: np.ndarray, causal: bool):
    """[H, nb, nb] boolean layout -> (table [H, nb, max_active] int32,
    counts [H, nb] int32, max_active).  With ``causal`` the upper triangle
    is dropped (those blocks would be fully masked anyway)."""
    lay = np.asarray(layout).astype(bool)
    H, nq, nk = lay.shape
    if causal:
        lay = lay & (np.arange(nq)[:, None] >= np.arange(nk)[None, :])
    counts = lay.sum(-1).astype(np.int32)                    # [H, nq]
    max_active = max(int(counts.max()), 1)
    table = np.zeros((H, nq, max_active), np.int32)
    for h in range(H):
        for qi in range(nq):
            idx = np.nonzero(lay[h, qi])[0]
            table[h, qi, :len(idx)] = idx
    return table, counts, max_active


def sparse_flops(layout, block, causal, head_dim):
    """Operations of one batch row: proportional to the set blocks, 4 *
    set blocks * block^2 * head_dim (two products of 2 flops per
    multiply-add)."""
    _, counts, _ = layout_tables(np.asarray(layout), causal)
    return 4 * int(counts.sum()) * block * block * head_dim


def card_tables(layout, causal, device):
    """(counts, table, max_active) of ``layout`` [H, nb, nb] as the kernel
    reads them: the :func:`layout_tables` arrays on ``device``.  The
    layout is static config: a caller that reuses one (as
    ``SparseSelfAttention`` does per sequence length) uploads them once and
    passes them back as ``tables``."""
    table, counts, max_active = layout_tables(layout, causal)
    return (torch.as_tensor(counts, device=device),
            torch.as_tensor(table, device=device), max_active)


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def sparse_attention_cuda(q, k, v, layout, block, causal=False,
                          softmax_scale=None, tables=None):
    """Launch the block-sparse kernel.  q/k/v: [B, S, H, D] CUDA tensors of
    one dtype (fp32 or bf16), D in :data:`SPARSE_HEAD_DIMS`, S a multiple
    of ``block`` (in :data:`SPARSE_BLOCKS`); ``layout``: [H, >= S/block,
    >= S/block] (numpy, static); ``tables``: :func:`card_tables` of its
    first S/block rows and columns on q's device (made here when None).
    Returns O [B, S, H, D] in q's dtype."""
    name = "sparse_attention_cuda"
    ts = (q, k, v)
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        raise NotImplementedError(
            "the block-sparse attention kernel is forward only, as the TPU "
            "kernel is: its backward is not ported (ROADMAP A15); call it "
            "under torch.no_grad() or with inputs that need no gradient")
    if not all(t.is_cuda for t in ts):
        raise ValueError(f"{name} needs CUDA tensors; use the plain version "
                         f"for CPU tensors")
    if q.dtype not in _DTYPE_CODES or any(t.dtype != q.dtype for t in ts):
        raise ValueError(f"{name} takes float32 or bfloat16 tensors of one "
                         f"dtype, got {[t.dtype for t in ts]}")
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"{name}: q, k, v must share one [B, S, H, D] "
                         f"shape, got {[tuple(t.shape) for t in ts]}")
    B, S, H, D = q.shape
    if D not in SPARSE_HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {D} not in {SPARSE_HEAD_DIMS}")
    if block not in SPARSE_BLOCKS or S % block:
        raise ValueError(f"{name}: layout block {block} must be one of "
                         f"{SPARSE_BLOCKS} and divide S={S}")
    if not all(t.is_contiguous() for t in ts) or \
            any(t.data_ptr() % 16 for t in ts):
        raise ValueError(f"{name} needs contiguous 16-byte aligned tensors")
    if B * H > 65535:
        raise ValueError(f"{name}: batch * heads {B * H} exceeds the grid "
                         f"limit 65535")
    nb = S // block
    lay = np.asarray(layout)
    if lay.ndim != 3 or lay.shape[0] != H or min(lay.shape[1:]) < nb:
        raise ValueError(f"{name}: layout {lay.shape} does not cover {H} "
                         f"heads x {nb} blocks")
    if tables is None:
        tables = card_tables(lay[:, :nb, :nb], causal, q.device)
    counts, table, max_active = tables
    scale = softmax_scale if softmax_scale is not None else D ** -0.5
    out = torch.empty_like(q)
    fn = op_builder.load("sparse_attention")
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            counts.data_ptr(), table.data_ptr(), B, S, H, D, block,
            max_active, int(bool(causal)), _DTYPE_CODES[q.dtype],
            float(scale), _stream(q))
    if rc != 0:
        raise RuntimeError(f"block-sparse attention kernel launch failed: "
                           f"CUDA error {rc}")
    sparse_attention_cuda.launches += 1
    return out


sparse_attention_cuda.launches = 0
