"""Ragged paged attention: the CUDA kernel's wrapper, its two front-ends,
and its plain PyTorch version.

Replaces ``deepspeed_tpu/ops/pallas/ragged_paged_attention.py``
(``_ragged_kernel`` / ``_ragged_call``).  The kernel source is
``ops/csrc/ragged_paged_attention.cu``.  Front-ends, as in the JAX
package:

* :func:`ragged_paged_attention` -- packed ``[total_q, H, D]`` queries
  with host ``q_lens`` (a mixed prefill + decode batch in one launch);
* :func:`ragged_paged_attention_rect` -- rectangular ``[B, T, H, D]``
  queries, every sequence ``q_len = T`` (the serving path's shape).

Each front-end launches the kernel for CUDA tensors and runs the plain
version for CPU tensors; nothing else picks between them.  The plain
version, :func:`paged_attention_plain`, is the port of the jnp gather path
of ``deepspeed_tpu/ops/paged_attention.py``.  Unlike the TPU kernel, the
CUDA kernel reads the packed queries in place (per-sequence row offsets),
so no q_tile-padded copy of q is made.
"""

import functools
import math

import numpy as np
import torch

from deepspeed_tpu_torch.ops import op_builder
from deepspeed_tpu_torch.ops.cuda.decode_attention import (HEAD_DIMS,
                                                           _DTYPE_CODES,
                                                           dense_attention)

DEFAULT_Q_TILE = 8


def _pack_metadata(q_lens, q_tile):
    """Per-sequence padded row starts and tile maps for a packed stack
    (the JAX package's tiling: sequence s owns ceil(q_lens[s] / q_tile)
    tiles).  Returns (starts, seq_of_tile, qtile_of_tile, total_padded)."""
    starts, seq_of_tile, qtile_of_tile = [], [], []
    off = 0
    for s, ql in enumerate(q_lens):
        starts.append(off)
        n_t = -(-ql // q_tile)
        seq_of_tile.extend([s] * n_t)
        qtile_of_tile.extend(range(n_t))
        off += n_t * q_tile
    return (np.asarray(starts, np.int32),
            np.asarray(seq_of_tile, np.int32),
            np.asarray(qtile_of_tile, np.int32), off)


def paged_attention_plain(q, k_pages, v_pages, block_tables, lengths,
                          softmax_scale=None):
    """Gather each sequence's pages into its logical view, then masked
    attention over the valid ragged prefix.  q: [B, T, H, D];
    k_pages/v_pages: [P, Hkv, page, D]; block_tables: [B, max_pages];
    lengths: [B] tokens stored including the T queries."""
    paged_attention_plain.calls += 1
    B, T, H, D = q.shape
    Hkv, page = k_pages.shape[1], k_pages.shape[2]
    S = block_tables.shape[1] * page
    tbl = block_tables.long()
    # [B, max_pages, Hkv, page, D] -> [B, Hkv, S, D]
    k = k_pages[tbl].transpose(1, 2).reshape(B, Hkv, S, D)
    v = v_pages[tbl].transpose(1, 2).reshape(B, Hkv, S, D)
    return dense_attention(q, k, v, lengths, softmax_scale)


paged_attention_plain.calls = 0


def _check_int32(name, t, shape):
    if t.dtype != torch.int32 or not t.is_cuda or not t.is_contiguous() or \
            tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must be a contiguous int32 CUDA tensor of "
                         f"shape {tuple(shape)}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def ragged_paged_attention_cuda(q, k_pages, v_pages, block_tables, ctx_lens,
                                q_lens, q_offs, seq_of_tile, qtile_of_tile,
                                q_tile, softmax_scale=None):
    """Launch the kernel on the current stream.  q: packed [total_q, H, D];
    k_pages/v_pages: [P, Hkv, page, D]; every metadata argument is an
    int32 CUDA tensor: block_tables [B, max_pages], ctx_lens / q_lens /
    q_offs [B] (q_offs = row of each sequence's first query in q),
    seq_of_tile / qtile_of_tile [n_tiles].  Returns [total_q, H, D]."""
    total_q, H, D = q.shape
    if not (q.is_cuda and k_pages.is_cuda and v_pages.is_cuda):
        raise ValueError("ragged_paged_attention_cuda needs CUDA tensors; "
                         "use the plain version for CPU tensors")
    if q.dtype not in _DTYPE_CODES or k_pages.dtype != q.dtype or \
            v_pages.dtype != q.dtype:
        raise ValueError(f"ragged_paged_attention_cuda takes float32 or "
                         f"bfloat16 q/k/v of one dtype, got {q.dtype}/"
                         f"{k_pages.dtype}/{v_pages.dtype}")
    if k_pages.dim() != 4 or k_pages.shape != v_pages.shape or \
            k_pages.shape[3] != D or H % k_pages.shape[1] != 0:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, pages "
                         f"{tuple(k_pages.shape)}/{tuple(v_pages.shape)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D} not in {HEAD_DIMS}")
    if not (q.is_contiguous() and k_pages.is_contiguous() and
            v_pages.is_contiguous()):
        raise ValueError("ragged_paged_attention_cuda needs contiguous "
                         "q/k_pages/v_pages")
    if k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
        raise ValueError("ragged_paged_attention_cuda needs 16-byte aligned "
                         "pages (the kernel reads them in 16-byte vectors)")
    B, max_pages = block_tables.shape
    n_tiles = seq_of_tile.shape[0]
    _check_int32("block_tables", block_tables, (B, max_pages))
    for name, t in (("ctx_lens", ctx_lens), ("q_lens", q_lens),
                    ("q_offs", q_offs)):
        _check_int32(name, t, (B,))
    _check_int32("seq_of_tile", seq_of_tile, (n_tiles,))
    _check_int32("qtile_of_tile", qtile_of_tile, (n_tiles,))
    Hkv, page = k_pages.shape[1], k_pages.shape[2]
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(D)
    out = torch.empty_like(q)
    fn = op_builder.load("ragged_paged_attention")
    rc = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            out.data_ptr(), ctx_lens.data_ptr(), q_lens.data_ptr(),
            q_offs.data_ptr(), seq_of_tile.data_ptr(),
            qtile_of_tile.data_ptr(), block_tables.data_ptr(), n_tiles,
            max_pages, H, Hkv, page, int(q_tile), D, _DTYPE_CODES[q.dtype],
            float(scale), torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ragged paged attention kernel launch failed: "
                           f"CUDA error {rc}")
    ragged_paged_attention_cuda.launches += 1
    return out


ragged_paged_attention_cuda.launches = 0


def _device_int32(x, device):
    return torch.as_tensor(np.asarray(x, np.int32)).to(device)


def ragged_paged_attention(q, k_pages, v_pages, block_tables, ctx_lens,
                           q_lens, softmax_scale=None,
                           q_tile=DEFAULT_Q_TILE):
    """Mixed prefill+decode attention over a packed ragged batch.

    q: [total_q, H, D] -- sequence b's rows are
    ``q[sum(q_lens[:b]) : sum(q_lens[:b+1])]`` (its LAST q_lens[b] tokens,
    already in the cache); block_tables: [B, max_pages]; ctx_lens: [B]
    tokens stored per sequence including the queries; q_lens: [B] host
    ints.  Returns [total_q, H, D]."""
    total_q = q.shape[0]
    q_lens = [int(x) for x in np.asarray(q_lens).reshape(-1)]
    if not q_lens or min(q_lens) < 1 or sum(q_lens) != total_q:
        raise ValueError(f"bad q_lens {q_lens} for {total_q} query rows")
    if not q.is_cuda:
        ctx = torch.as_tensor(np.asarray(ctx_lens).reshape(-1))
        outs, off = [], 0
        for s, ql in enumerate(q_lens):
            outs.append(paged_attention_plain(
                q[off:off + ql][None], k_pages, v_pages,
                block_tables[s:s + 1], ctx[s:s + 1], softmax_scale)[0])
            off += ql
        return torch.cat(outs, dim=0)
    q_tile = int(min(q_tile, max(q_lens)))
    _, sot, qot, _ = _pack_metadata(q_lens, q_tile)
    offs = np.concatenate([[0], np.cumsum(q_lens)[:-1]])
    dev = q.device
    ctx = (ctx_lens.to(dev, torch.int32) if torch.is_tensor(ctx_lens)
           else _device_int32(ctx_lens, dev))
    return ragged_paged_attention_cuda(
        q, k_pages, v_pages, block_tables.to(dev, torch.int32).contiguous(),
        ctx.reshape(-1).contiguous(), _device_int32(q_lens, dev),
        _device_int32(offs, dev), _device_int32(sot, dev),
        _device_int32(qot, dev), q_tile, softmax_scale)


@functools.lru_cache(maxsize=64)
def _rect_metadata(B, T, q_tile, device):
    """(q_lens, q_offs, seq_of_tile, qtile_of_tile) device tensors of a
    rectangular batch -- they depend only on the shape, so each serving
    shape uploads them once instead of once per layer."""
    n_qt = -(-T // q_tile)
    return (_device_int32(np.full(B, T), device),
            _device_int32(np.arange(B) * T, device),
            _device_int32(np.repeat(np.arange(B), n_qt), device),
            _device_int32(np.tile(np.arange(n_qt), B), device))


def ragged_paged_attention_rect(q, k_pages, v_pages, block_tables, lengths,
                                softmax_scale=None, q_tile=DEFAULT_Q_TILE):
    """Rectangular front-end: q [B, T, H, D] -- the last T tokens of each
    sequence (T=1 decode, T>1 bucketed prefill); lengths: [B] valid
    tokens including the T new ones.  Every row of every sequence is a
    real query row (``q_lens = T``), as in the JAX package: bucket-padded
    prefill rows attend to the padding keys the same prefill wrote."""
    if not q.is_cuda:
        return paged_attention_plain(q, k_pages, v_pages, block_tables,
                                     lengths, softmax_scale)
    B, T, H, D = q.shape
    q_tile = int(min(q_tile, T))
    q_lens, q_offs, sot, qot = _rect_metadata(B, T, q_tile, q.device)
    out = ragged_paged_attention_cuda(
        q.reshape(B * T, H, D), k_pages, v_pages, block_tables, lengths,
        q_lens, q_offs, sot, qot, q_tile, softmax_scale)
    return out.reshape(B, T, H, D)
