"""Decode attention over a contiguous KV cache: the CUDA kernel's wrapper
and its plain PyTorch version.

Replaces ``deepspeed_tpu/ops/pallas/decode_attention.py``
(``_decode_kernel`` / ``decode_attention_pallas``).  The kernel source is
``ops/csrc/decode_attention.cu``.  :func:`decode_attention_plain` is the
port of the jnp path of ``deepspeed_tpu/ops/decode_attention.py``: the CPU
tests run it, and the smoke test holds the kernel against it on the card.
Nothing on the main path calls it when a card is present.

One semantic difference, inherited from the JAX package: a query row that
sees no key at all (only possible when ``length < T``) is 0 from the
kernel but a uniform average of V from the plain version.  No caller
produces such rows.
"""

import math

import torch

from deepspeed_tpu_torch.ops import op_builder
from deepspeed_tpu_torch.ops.cuda.flash_attention import check_head_dim

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# the kernel's head dims, in both forms (and B4's, in all of its forms but
# the tensor-core prefill tiles, which 16 does not take): 16 is the
# benches' ``tiny`` model, served on the CUDA-core bodies at every row
# count and dtype
HEAD_DIMS = (16, 64, 80, 96, 128, 256)
# The decode form (at most DECODE_ROWS query rows per kv head) splits each
# sequence's keys into chunks of at least DECODE_MIN_CHUNK keys, one block
# each, merged in chunk order by a second kernel when a sequence spans
# several.  The tensor-core body at head dims 64-128 (5-8 rows, bf16 /
# fp16; the kernel's ``kTensorCores``) finishes a chunk so fast that a
# split pays for the merge only from DECODE_MIN_CHUNK_TC keys on; shorter
# chunks cost more than they save at the serving shapes, also when few
# (sequence, kv head) pairs leave most of the card idle (PERF.md §6).
# At head dims 80, 96 and 256 (STAGED_HEAD_DIMS) the tensor-core body is
# the staged one (``kStaged``: K and V streamed through shared memory in
# 64-key tiles, two consumer groups taking tiles in turn): a chunk of
# DECODE_MIN_CHUNK_STAGED keys keeps both groups busy, so a few (sequence,
# kv head) pairs -- Gemma-2B has one kv head -- spread over the card.
# Shorter chunks split a 144-key step that one block finishes sooner
# (PERF.md §6).  At 80 and 96 it takes 5-8 rows (gpt_2_7b's verify
# window) where its chunks hold STAGED_ROWS_KEYS keys or more.  One query
# row a kv head at those head dims (the MHA decode steps of gpt_2_7b,
# Phi-3-mini and Gemma-7B) takes the staged body too where its chunks hold
# STAGED_ONE_ROW_KEYS keys or more -- a long sequence's block streamed too
# slowly on the CUDA-core body -- and keeps the CUDA-core body and its plan
# over shorter ones (:func:`staged`).
DECODE_ROWS = 8
DECODE_MIN_CHUNK = 512
DECODE_MIN_CHUNK_TC = 2048
DECODE_MIN_CHUNK_STAGED = 128
STAGED_HEAD_DIMS = (80, 96, 256)
STAGED_ONE_ROW_KEYS = 512      # split_decode.cuh kStagedOneRowKeys
STAGED_ROWS_KEYS = 512         # split_decode.cuh kStagedRowsKeys
_slots = {}   # (entry, device index, rows, head dim, dtype code) -> blocks


def _lengths_tensor(lengths, B, device):
    if isinstance(lengths, int):
        return torch.full((B,), lengths, dtype=torch.int32, device=device)
    return lengths.to(device=device, dtype=torch.int32).reshape(B)


def dense_attention(q, k, v, lengths, softmax_scale=None):
    """Masked attention of the last T tokens of each sequence over a dense
    cache view.  q: [B, T, H, D]; k/v: [B, Hkv, S, D]; lengths: int or [B]
    valid tokens (queries included).  fp32 logits and softmax, matmuls in
    the input dtype -- the jnp oracle's arithmetic."""
    B, T, H, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    if Hkv != H:
        rep = H // Hkv
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(D)
    logits = torch.einsum("bqhd,bhkd->bhqk", q, k).float() * scale
    lens = _lengths_tensor(lengths, B, q.device)
    kpos = torch.arange(S, device=q.device)
    qpos = lens[:, None] - T + torch.arange(T, device=q.device)[None, :]
    mask = kpos[None, None, :] <= qpos[:, :, None]            # [B, T, S]
    logits = logits.masked_fill(~mask[:, None], -1e30)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bhkd->bqhd", probs.to(v.dtype), v)
    return out.to(q.dtype)


def decode_attention_plain(q, k, v, lengths, softmax_scale=None):
    """Plain version of the kernel: same arguments, same result."""
    decode_attention_plain.calls += 1
    return dense_attention(q, k, v, lengths, softmax_scale)


decode_attention_plain.calls = 0


def staged(rows, dtype, head_dim, chunk):
    """Whether a decode launch of ``rows`` query rows per kv head in chunks
    of ``chunk`` keys runs the staged body (``kStaged`` and
    ``launch_split`` in ``ops/csrc/split_decode.cuh``): bf16 or fp16 at
    STAGED_HEAD_DIMS, 5-8 rows (at 80 and 96 over chunks of
    STAGED_ROWS_KEYS keys and up), or one row over chunks of
    STAGED_ONE_ROW_KEYS keys and up."""
    if dtype not in (torch.bfloat16, torch.float16) or \
            head_dim not in STAGED_HEAD_DIMS:
        return False
    if rows > 4:
        return head_dim == 256 or chunk >= STAGED_ROWS_KEYS
    return rows == 1 and chunk >= STAGED_ONE_ROW_KEYS


def min_chunk(rows, dtype, head_dim):
    """The shortest key chunk a decode launch of ``rows`` query rows per kv
    head at ``head_dim`` splits into: on the tensor-core bodies (5-8 rows
    in bf16 or fp16) DECODE_MIN_CHUNK_STAGED at 256 and STAGED_ROWS_KEYS
    at 80 and 96 (the staged body, which chunks that long take; 512 keys
    read best there) and DECODE_MIN_CHUNK_TC at 64 and 128; on the
    CUDA-core body (1-4 rows, fp32 at any row count, and head dim 16 at
    any row count) and the one-row staged body DECODE_MIN_CHUNK, which is
    STAGED_ONE_ROW_KEYS: a split plan always takes the staged body where
    it is staged at all."""
    if rows <= 4 or dtype not in (torch.bfloat16, torch.float16) or \
            head_dim == 16:
        return DECODE_MIN_CHUNK
    if head_dim == 256:
        return DECODE_MIN_CHUNK_STAGED
    return STAGED_ROWS_KEYS if head_dim in STAGED_HEAD_DIMS else \
        DECODE_MIN_CHUNK_TC


def key_splits(pairs, S_max, slots, least=DECODE_MIN_CHUNK):
    """(chunks per sequence, keys per chunk) of the split-key decode body
    (``ops/csrc/split_decode.cuh``) over ``pairs`` (sequence, kv head)
    pairs of up to S_max keys: each sequence's keys split only as far as
    the pairs' blocks still fit the ``slots`` blocks the card holds at once
    (one wave: a second would run on a part of the card), in chunks of at
    least ``least`` keys (:func:`min_chunk`) rounded up to 64."""
    n = max(1, min(slots // max(pairs, 1), S_max // least))
    chunk = -(-max(S_max, 1) // n)
    chunk = -(-chunk // 64) * 64
    return -(-max(S_max, 1) // chunk), chunk


def decode_splits(B, T, H, Hkv, S_max, slots, dtype, head_dim):
    """(chunks per sequence, keys per chunk) of a launch: the decode form
    (:func:`key_splits` over B * Hkv pairs); the prefill form takes one."""
    rows = T * (H // Hkv)
    if rows > DECODE_ROWS:
        return 1, max(S_max, 1)
    return key_splits(B * Hkv, S_max, slots,
                      min_chunk(rows, dtype, head_dim))


def _decode_slots(device, rows, head_dim, dtype_code,
                  entry="decode_attention_slots"):
    """Blocks of a split-key decode kernel the card holds at once (the
    occupancy query of C entry ``entry``), cached per entry, device, row
    count, head dim and dtype."""
    index = torch.device(device).index
    key = (entry, torch.cuda.current_device() if index is None else index,
           rows, head_dim, dtype_code)
    if key not in _slots:
        slots = op_builder.load(entry)(rows, head_dim, dtype_code)
        if slots <= 0:
            raise RuntimeError(f"decode attention occupancy query failed: "
                               f"CUDA error {-slots}")
        _slots[key] = slots
    return _slots[key]


def decode_plan(B, T, H, Hkv, S_max, D, dtype, device):
    """(chunks per sequence, keys per chunk) that
    :func:`decode_attention_cuda` launches for these shapes on ``device``
    (a CUDA device: the split follows its occupancy)."""
    rows = T * (H // Hkv)
    slots = _decode_slots(device, rows, D, _DTYPE_CODES[dtype]) \
        if rows <= DECODE_ROWS else 0
    return decode_splits(B, T, H, Hkv, S_max, slots, dtype, D)


def decode_attention_cuda(q, k, v, lengths, softmax_scale=None):
    """Launch the decode kernel on the current stream.

    q: [B, T, H, D]; k/v: [B, Hkv, S_max, D] (contiguous, same dtype as q:
    float32, bfloat16 or float16, D in :data:`HEAD_DIMS`, else
    ``NotImplementedError`` naming ROADMAP A16); lengths: a Python int
    shared by every sequence, or an int32 CUDA tensor [B].  Returns a new
    [B, T, H, D] tensor in q's dtype."""
    B, T, H, D = q.shape
    check_head_dim("decode_attention_cuda", D, HEAD_DIMS)
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError("decode_attention_cuda needs CUDA tensors; use the "
                         "plain version for CPU tensors")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or \
            v.dtype != q.dtype:
        raise ValueError(f"decode_attention_cuda takes float32, bfloat16 or "
                         f"float16 q/k/v of one dtype, got {q.dtype}/"
                         f"{k.dtype}/{v.dtype}")
    if k.dim() != 4 or k.shape != v.shape or k.shape[0] != B or \
            k.shape[3] != D or H % k.shape[1] != 0:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("decode_attention_cuda needs contiguous q/k/v")
    if q.data_ptr() % 16 or k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("decode_attention_cuda needs 16-byte aligned "
                         "q/k/v (the kernel reads them in 16-byte vectors)")
    Hkv, S = k.shape[1], k.shape[2]
    if isinstance(lengths, int):
        lens, length_all = None, lengths
        if not 0 <= lengths <= S:
            raise ValueError(f"length {lengths} outside [0, {S}]")
    else:
        if lengths.dtype != torch.int32 or not lengths.is_cuda or \
                lengths.shape != (B,) or not lengths.is_contiguous():
            raise ValueError("lengths must be a contiguous int32 CUDA "
                             f"tensor of shape ({B},)")
        lens, length_all = lengths, 0
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(D)
    out = torch.empty_like(q)
    n_split, chunk = decode_plan(B, T, H, Hkv, S, D, q.dtype, q.device)
    # the chunks' (acc, m, l), from the caching allocator on this stream
    part = None if n_split == 1 else torch.empty(
        B * Hkv * n_split * T * (H // Hkv) * (D + 2), dtype=torch.float32,
        device=q.device)
    fn = op_builder.load("decode_attention")
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lens is None else lens.data_ptr(),
            None if part is None else part.data_ptr(), length_all, B, T, H,
            Hkv, S, D, _DTYPE_CODES[q.dtype], n_split, chunk, float(scale),
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"decode attention kernel launch failed: CUDA "
                           f"error {rc}")
    decode_attention_cuda.launches += 1
    return out


decode_attention_cuda.launches = 0
