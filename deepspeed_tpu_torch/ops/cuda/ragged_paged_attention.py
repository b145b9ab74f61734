"""Ragged paged attention: the CUDA kernel's wrapper, its launch plan, its
two front-ends, and its plain PyTorch version.

Replaces ``deepspeed_tpu/ops/pallas/ragged_paged_attention.py``
(``_ragged_kernel`` / ``_ragged_call``).  The kernel source is
``ops/csrc/ragged_paged_attention.cu``.  Front-ends, as in the JAX
package:

* :func:`ragged_paged_attention` -- packed ``[total_q, H, D]`` queries
  with host ``q_lens`` (a mixed prefill + decode batch in one call);
* :func:`ragged_paged_attention_rect` -- rectangular ``[B, T, H, D]``
  queries, every sequence ``q_len = T`` (the serving path's shape).

Each front-end launches the kernel for CUDA tensors and runs the plain
version for CPU tensors; nothing else picks between them.  The plain
version, :func:`paged_attention_plain`, is the port of the jnp gather path
of ``deepspeed_tpu/ops/paged_attention.py``.  Unlike the TPU kernel, the
CUDA kernel reads the packed queries in place (per-sequence row offsets),
so no q_tile-padded copy of q is made.

Where the TPU kernel runs every sequence as q_tile-token tiles,
:func:`plan_launch` sends each sequence to one of two forms: decode rows
(``q_len * group <= DECODE_ROWS``: every serving decode step, a
speculative verify window of up to 8 tokens at group 1, a group-8 draft's
decode step) to the split-key decode body shared with B5, and the rest to
prefill tiles -- the tensor-core kernel's 128-row tiles where
:func:`tensor_core_prefill` holds (bf16 or fp16, the serving engine's page
sizes), else the CUDA-core tiles (fp32, other groups and pages).  That
choice is by dtype and shape, made here, and not a fallback: both forms
are this wrapper's kernel, counted in the same ``launches``.  Every form
takes head dims 64, 80, 96, 128 and 256; head dim 16 (the benches'
``tiny`` model) takes the decode rows and the CUDA-core tiles in every
dtype (``HEAD_DIMS``, :data:`TC_HEAD_DIMS`); another raises
``NotImplementedError`` naming ROADMAP A16.
"""

import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from deepspeed_tpu_torch.ops import op_builder
from deepspeed_tpu_torch.ops.cuda.decode_attention import (DECODE_ROWS,
                                                           HEAD_DIMS,
                                                           _DTYPE_CODES,
                                                           _decode_slots,
                                                           dense_attention,
                                                           key_splits,
                                                           min_chunk)
from deepspeed_tpu_torch.ops.cuda.flash_attention import check_head_dim

DEFAULT_Q_TILE = 8
TC_ROWS = 128   # query rows (tokens x group heads) of a tensor-core tile
# the head dims of the tensor-core prefill tiles (every one of HEAD_DIMS
# but 16, whose 32-byte rows are a quarter of a TMA box)
TC_HEAD_DIMS = (64, 80, 96, 128, 256)


def tc_keys(head_dim):
    """Keys of the tensor-core tile's K/V tile: 128, and 64 at head dim
    256, where 128-key tiles beside a 128-row Q tile would not fit a
    block's shared memory (``ops/csrc/ragged_paged_attention.cu``)."""
    return 64 if head_dim == 256 else 128


def tensor_core_prefill(dtype, head_dim, group, page_size):
    """Whether prefill tiles take the wgmma + TMA kernel: bf16 or fp16,
    a head dim of :data:`TC_HEAD_DIMS` (64, 80, 96, 128 or 256: each has
    a tensor-core instantiation; 16 has none), a GQA group dividing 64 (a warpgroup's 64
    rows hold whole tokens) and a page size that is a multiple of the K/V
    tile's keys (:func:`tc_keys`: 128, 64 at 256) or a multiple of 8 rows
    dividing them (each TMA box starts on a swizzle atom; a row of D
    columns is 64-column boxes of 128-byte swizzle rows, zero-filled past
    D at 80 and 96).  The serving engine's page 128 and a page of 16 take
    it at every head dim.  Other shapes take the CUDA-core tiles."""
    keys = tc_keys(head_dim)
    return (dtype in (torch.bfloat16, torch.float16)
            and head_dim in TC_HEAD_DIMS and 64 % group == 0
            and (page_size % keys == 0 or
                 (keys % page_size == 0 and page_size % 8 == 0)))


class LaunchPlan(NamedTuple):
    """What one wrapper call launches (host arrays)."""
    decode_seqs: np.ndarray     # int32: the sequences of the decode form
    decode_rows: int            # most rows per kv head among them (0: none)
    seq_of_tile: np.ndarray     # int32: the prefill tiles' sequences
    qtile_of_tile: np.ndarray   # int32: and their tile index in it
    q_tile: int                 # tokens per prefill tile
    tensor_cores: bool          # the prefill tiles' form


def plan_launch(q_lens, group, tensor_cores, q_tile=DEFAULT_Q_TILE):
    """Split a call's sequences by form.  A sequence of ``q_len * group``
    <= DECODE_ROWS rows per kv head takes the decode form, whole; the
    others are cut into prefill tiles of ``TC_ROWS // group`` tokens
    (tensor cores; the tiles with the most keys first) or ``min(q_tile,
    longest prefill)`` tokens (CUDA cores, the JAX tiling's order)."""
    dec = [s for s, ql in enumerate(q_lens) if ql * group <= DECODE_ROWS]
    pre = [s for s, ql in enumerate(q_lens) if ql * group > DECODE_ROWS]
    pre_lens = [q_lens[s] for s in pre]
    tokens = TC_ROWS // group if tensor_cores else \
        int(min(q_tile, max(pre_lens, default=1)))
    _, sot, qot, _ = _pack_metadata(pre_lens, tokens)
    sot = np.asarray(pre, np.int32)[sot]
    if tensor_cores:
        order = np.argsort(-qot, kind="stable")
        sot, qot = sot[order], qot[order]
    return LaunchPlan(np.asarray(dec, np.int32),
                      max((q_lens[s] * group for s in dec), default=0),
                      sot, qot, tokens, bool(tensor_cores))


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


def decode_rows_splits(n_dec, Hkv, S_max, slots, rows, dtype, head_dim):
    """(chunks per sequence, keys per chunk) of the decode rows' launch:
    :func:`key_splits` over n_dec * Hkv (sequence, kv head) pairs in chunks
    of at least :func:`min_chunk` keys -- B5's rule, on the body the two
    kernels share."""
    return key_splits(n_dec * Hkv, S_max, slots,
                      min_chunk(rows, dtype, head_dim))


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
                                q_tile, softmax_scale=None, decode_seqs=None,
                                decode_rows=0):
    """Launch the kernel on the current stream.  q: packed [total_q, H, D];
    k_pages/v_pages: [P, Hkv, page, D]; every metadata argument is an
    int32 CUDA tensor: block_tables [B, max_pages], ctx_lens / q_lens /
    q_offs [B] (q_offs = row of each sequence's first query in q);
    seq_of_tile / qtile_of_tile [n_tiles]: the prefill tiles of ``q_tile``
    tokens (``TC_ROWS // group`` where :func:`tensor_core_prefill` holds);
    decode_seqs [n_dec]: the sequences of the decode form, at most
    ``decode_rows`` <= DECODE_ROWS rows per kv head each.  One call --
    counted once in ``launches`` -- runs the decode form's kernel (and its
    combine, when a sequence's keys are split) and the prefill tiles'
    kernel, each where it has work.  Returns [total_q, H, D]."""
    total_q, H, D = q.shape
    check_head_dim("ragged_paged_attention_cuda", D, HEAD_DIMS)
    if not (q.is_cuda and k_pages.is_cuda and v_pages.is_cuda):
        raise ValueError("ragged_paged_attention_cuda needs CUDA tensors; "
                         "use the plain version for CPU tensors")
    if q.dtype not in _DTYPE_CODES or k_pages.dtype != q.dtype or \
            v_pages.dtype != q.dtype:
        raise ValueError(f"ragged_paged_attention_cuda takes float32, "
                         f"bfloat16 or float16 q/k/v of one dtype, got "
                         f"{q.dtype}/{k_pages.dtype}/{v_pages.dtype}")
    if k_pages.dim() != 4 or k_pages.shape != v_pages.shape or \
            k_pages.shape[3] != D or H % k_pages.shape[1] != 0:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, pages "
                         f"{tuple(k_pages.shape)}/{tuple(v_pages.shape)}")
    if not (q.is_contiguous() and k_pages.is_contiguous() and
            v_pages.is_contiguous()):
        raise ValueError("ragged_paged_attention_cuda needs contiguous "
                         "q/k_pages/v_pages")
    if q.data_ptr() % 16 or k_pages.data_ptr() % 16 or \
            v_pages.data_ptr() % 16:
        raise ValueError("ragged_paged_attention_cuda needs 16-byte aligned "
                         "q and pages (the kernels read them in 16-byte "
                         "vectors and TMA boxes)")
    B, max_pages = block_tables.shape
    n_tiles = seq_of_tile.shape[0]
    n_dec = 0 if decode_seqs is None else decode_seqs.shape[0]
    _check_int32("block_tables", block_tables, (B, max_pages))
    for name, t in (("ctx_lens", ctx_lens), ("q_lens", q_lens),
                    ("q_offs", q_offs)):
        _check_int32(name, t, (B,))
    _check_int32("seq_of_tile", seq_of_tile, (n_tiles,))
    _check_int32("qtile_of_tile", qtile_of_tile, (n_tiles,))
    if n_dec:
        _check_int32("decode_seqs", decode_seqs, (n_dec,))
        if not 1 <= decode_rows <= DECODE_ROWS:
            raise ValueError(f"decode_rows {decode_rows} outside [1, "
                             f"{DECODE_ROWS}]")
    P, Hkv, page = k_pages.shape[:3]
    group = H // Hkv
    tensor_cores = bool(n_tiles) and tensor_core_prefill(q.dtype, D, group,
                                                         page)
    if tensor_cores and q_tile != TC_ROWS // group:
        raise ValueError(f"the tensor-core prefill tiles hold "
                         f"{TC_ROWS // group} tokens at group {group}, got "
                         f"q_tile {q_tile} (see plan_launch)")
    code = _DTYPE_CODES[q.dtype]
    n_split, chunk, part = 1, max_pages * page, None
    if n_dec:
        slots = _decode_slots(q.device, decode_rows, D, code,
                              entry="ragged_decode_slots")
        n_split, chunk = decode_rows_splits(n_dec, Hkv, max_pages * page,
                                            slots, decode_rows, q.dtype, D)
        # the chunks' (acc, m, l), from the caching allocator on this stream
        if n_split > 1:
            part = torch.empty(n_dec * Hkv * n_split * decode_rows * (D + 2),
                               dtype=torch.float32, device=q.device)
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(D)
    out = torch.empty_like(q)
    fn = op_builder.load("ragged_paged_attention")

    def ptr(t):
        return None if t is None or not t.numel() else t.data_ptr()

    rc = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            out.data_ptr(), ctx_lens.data_ptr(), q_lens.data_ptr(),
            q_offs.data_ptr(), block_tables.data_ptr(), ptr(decode_seqs),
            ptr(part), ptr(seq_of_tile), ptr(qtile_of_tile), n_dec,
            int(decode_rows), n_split, chunk, n_tiles, int(q_tile),
            int(tensor_cores), max_pages, total_q, P, H, Hkv, page, D, code,
            float(scale), torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ragged paged attention kernel launch failed: "
                           f"CUDA error {rc}")
    ragged_paged_attention_cuda.launches += 1
    return out


ragged_paged_attention_cuda.launches = 0


def _device_int32(x, device):
    return torch.as_tensor(np.asarray(x, np.int32)).to(device)


def _plan_tensors(plan, device):
    """(decode_seqs, seq_of_tile, qtile_of_tile) of a plan on ``device``."""
    return tuple(_device_int32(x, device) for x in
                 (plan.decode_seqs, plan.seq_of_tile, plan.qtile_of_tile))


def _launch(q, k_pages, v_pages, block_tables, ctx, q_lens, q_offs, plan,
            dev_plan, softmax_scale):
    dec, sot, qot = dev_plan
    return ragged_paged_attention_cuda(
        q, k_pages, v_pages, block_tables, ctx, q_lens, q_offs, sot, qot,
        plan.q_tile, softmax_scale, decode_seqs=dec,
        decode_rows=plan.decode_rows)


def ragged_paged_attention(q, k_pages, v_pages, block_tables, ctx_lens,
                           q_lens, softmax_scale=None,
                           q_tile=DEFAULT_Q_TILE):
    """Mixed prefill+decode attention over a packed ragged batch.

    q: [total_q, H, D] -- sequence b's rows are
    ``q[sum(q_lens[:b]) : sum(q_lens[:b+1])]`` (its LAST q_lens[b] tokens,
    already in the cache); block_tables: [B, max_pages]; ctx_lens: [B]
    tokens stored per sequence including the queries; q_lens: [B] host
    ints.  ``q_tile`` sizes the CUDA-core prefill tiles.  Returns
    [total_q, H, D]."""
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
    group = q.shape[1] // k_pages.shape[1]
    plan = plan_launch(q_lens, group, tensor_core_prefill(
        q.dtype, q.shape[2], group, k_pages.shape[2]), q_tile)
    offs = np.concatenate([[0], np.cumsum(q_lens)[:-1]])
    dev = q.device
    ctx = (ctx_lens.to(dev, torch.int32) if torch.is_tensor(ctx_lens)
           else _device_int32(ctx_lens, dev))
    return _launch(q, k_pages, v_pages,
                   block_tables.to(dev, torch.int32).contiguous(),
                   ctx.reshape(-1).contiguous(), _device_int32(q_lens, dev),
                   _device_int32(offs, dev), plan, _plan_tensors(plan, dev),
                   softmax_scale)


@functools.lru_cache(maxsize=64)
def _rect_plan(B, T, group, tensor_cores, q_tile, device):
    """(plan, q_lens, q_offs, device plan) of a rectangular batch -- they
    depend only on the shape, so each serving shape uploads them once
    instead of once per layer."""
    plan = plan_launch([T] * B, group, tensor_cores, q_tile)
    return (plan, _device_int32(np.full(B, T), device),
            _device_int32(np.arange(B) * T, device),
            _plan_tensors(plan, device))


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
    group = H // k_pages.shape[1]
    plan, q_lens, q_offs, dev_plan = _rect_plan(
        B, T, group, tensor_core_prefill(q.dtype, D, group, k_pages.shape[2]),
        int(q_tile), q.device)
    out = _launch(q.reshape(B * T, H, D), k_pages, v_pages, block_tables,
                  lengths, q_lens, q_offs, plan, dev_plan, softmax_scale)
    return out.reshape(B, T, H, D)
