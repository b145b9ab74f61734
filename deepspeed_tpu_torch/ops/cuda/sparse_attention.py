"""Block-sparse attention: the CUDA kernel's wrapper and its host tables.

Replaces ``deepspeed_tpu/ops/pallas/sparse_attention.py``: the kernel
``_sparse_kernel`` (``ops/csrc/sparse_attention.cu``) and its host side
``sparse_attention_pallas``; :func:`layout_tables` and :func:`sparse_flops`
are the port's own copies of the functions of the same names there.  The
kernel has two forms, chosen by dtype: fp32 walks :func:`layout_tables`
on the CUDA cores; bf16 and fp16 run on the tensor cores over 64-row
query tiles and 64-key steps gathered from the layout,
:func:`step_tables`.  The
layout is static config: :func:`card_tables` and :func:`card_steps` put
the tables on the card, and ``SparseSelfAttention`` keeps them with its
per-length layout cache.  Forward only, as on the TPU: a
call whose inputs need a gradient raises.  The plain version (the JAX
package's dense-masked path) and the dispatching API are in
``ops/sparse_attention/sparse_self_attention.py``.
"""

import numpy as np
import torch

from deepspeed_tpu_torch.ops import op_builder
from deepspeed_tpu_torch.ops.cuda.flash_attention import check_head_dim

SPARSE_BLOCKS = (16, 32, 64, 128)   # layout blocks the kernel is built for
SPARSE_HEAD_DIMS = (64, 128)
# the C entry's dtype codes: fp32 on the CUDA cores, bf16 and fp16 on the
# tensor cores -- this kernel's own, so that a dtype another kernel takes
# reaches this one only when it is built for it
SPARSE_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


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


STEP_ROWS = 64     # query rows of a bf16 tile, keys of one of its steps
STEP_WIDTH = 8     # int32 words per step: pair mask, 4 key rows, padding
EDGE_BIT = 1 << 16  # the step needs the element mask (see step_tables)


def step_tables(layout: np.ndarray, block: int, causal: bool):
    """The tensor-core (bf16 / fp16) kernel's schedule of layout [H, nb,
    nb] at block ``block``.

    Query tile t is rows [64 t, 64 t + 64): 64 / block q blocks at blocks
    16 and 32, one q block at 64, half of one at 128.  Its keys are the
    union of the key units its q blocks set -- a unit is one key block at
    blocks up to 64, a 64-key half of one at 128 -- in ascending order,
    taken 64 keys at a time: 64 / unit slots per step, the last step
    padded with its first unit.  Each step is STEP_WIDTH int32: word 0 the
    pair mask, bit (i * slots + j) set when q block i of the tile sees the
    unit in slot j (the layout sets the pair and, when causal, the key
    block is not above the q block), plus EDGE_BIT when some pair of the
    step is unset or lies on the diagonal, so that the kernel masks
    elements; words 1-4 the first key row of each slot.  With ``causal``,
    units wholly above the tile's last row are left out.

    Returns (counts [H, n_tiles] int32: steps of each tile, starts [H,
    n_tiles] int32: its first step's row in ``steps``, steps [max(n, 1),
    STEP_WIDTH] int32), n_tiles = ceil(nb * block / 64)."""
    lay = np.asarray(layout).astype(bool)
    H, nb, _ = lay.shape
    S = nb * block
    unit = min(block, STEP_ROWS)
    slots = STEP_ROWS // unit
    n_tiles = -(-S // STEP_ROWS)
    if causal:
        lay = lay & (np.arange(nb)[:, None] >= np.arange(nb)[None, :])
    counts = np.zeros((H, n_tiles), np.int32)
    starts = np.zeros((H, n_tiles), np.int32)
    rows = []
    for h in range(H):
        for t in range(n_tiles):
            r0 = t * STEP_ROWS
            qbs = list(range(r0 // block,
                             min(nb, -(-(r0 + STEP_ROWS) // block))))
            # sees[i, u]: q block i of the tile sees key unit u
            sees = np.repeat(lay[h, qbs], block // unit, axis=1)
            if causal:   # units wholly above the tile's last row
                sees[:, np.arange(sees.shape[1]) * unit > r0 + STEP_ROWS - 1
                     ] = False
            units = np.nonzero(sees.any(0))[0]
            starts[h, t] = len(rows)
            counts[h, t] = -(-len(units) // slots)
            for g in range(0, len(units), slots):
                grp = list(units[g:g + slots])
                mask, edge = 0, len(grp) < slots
                for i, qb in enumerate(qbs):
                    for j, u in enumerate(grp):
                        if sees[i, u]:
                            mask |= 1 << (i * slots + j)
                            # a key of the unit past the q block's first row
                            edge |= causal and \
                                (u + 1) * unit - 1 > max(qb * block, r0)
                        else:
                            edge = True
                grp += [grp[0]] * (slots - len(grp))
                rows.append([mask | (EDGE_BIT if edge else 0)] +
                            [u * unit for u in grp] + [0] * (
                                STEP_WIDTH - 1 - slots))
    steps = np.asarray(rows or [[0] * STEP_WIDTH], np.int32).reshape(
        -1, STEP_WIDTH)
    return counts, starts, steps


def step_overhead(layout, block, causal):
    """(q, k) elements the bf16 kernel's steps compute over those the
    layout sets (:func:`layout_tables`' blocks): the cost of taking the
    union of a tile's key blocks, 64 keys at a time."""
    counts, _, _ = step_tables(layout, block, causal)
    _, set_counts, _ = layout_tables(layout, causal)
    return (int(counts.sum()) * STEP_ROWS * STEP_ROWS /
            max(1, int(set_counts.sum()) * block * block))


def card_steps(layout, block, causal, device):
    """:func:`step_tables` of ``layout`` on ``device``, as the bf16 kernel
    reads them; like :func:`card_tables`, made once per layout."""
    return tuple(torch.as_tensor(x, device=device)
                 for x in step_tables(layout, block, causal))


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
                          softmax_scale=None, tables=None, steps=None):
    """Launch the block-sparse kernel.  q/k/v: [B, S, H, D] CUDA tensors of
    one dtype (:data:`SPARSE_DTYPES`: fp32, bf16 or fp16), D in
    :data:`SPARSE_HEAD_DIMS`, S a multiple of ``block`` (in
    :data:`SPARSE_BLOCKS`); ``layout``: [H, >= S/block, >= S/block] (numpy,
    static).  The fp32 form reads ``tables`` (:func:`card_tables`), the
    bf16 and fp16 form ``steps`` (:func:`card_steps`),
    of the layout's first S/block rows and columns on q's device; each is
    made here when None, which a CUDA-graph capture cannot do.  Returns O
    [B, S, H, D] in q's dtype."""
    name = "sparse_attention_cuda"
    ts = (q, k, v)
    if q.dim() == 4:
        check_head_dim(name, q.shape[3], SPARSE_HEAD_DIMS)
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        raise NotImplementedError(
            "the block-sparse attention kernel is forward only, as the TPU "
            "kernel is: its backward is not ported (ROADMAP A15); call it "
            "under torch.no_grad() or with inputs that need no gradient")
    if q.dtype not in SPARSE_DTYPES or any(t.dtype != q.dtype for t in ts):
        raise ValueError(f"{name} takes float32, bfloat16 or float16 "
                         f"tensors of one dtype, got "
                         f"{[t.dtype for t in ts]}")
    if not all(t.is_cuda for t in ts):
        raise ValueError(f"{name} needs CUDA tensors; use the plain version "
                         f"for CPU tensors")
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"{name}: q, k, v must share one [B, S, H, D] "
                         f"shape, got {[tuple(t.shape) for t in ts]}")
    B, S, H, D = q.shape
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
    ptrs, max_active = [None] * 5, 1
    if q.dtype == torch.float32:
        if tables is None:
            tables = card_tables(lay[:, :nb, :nb], causal, q.device)
        counts, table, max_active = tables
        ptrs[:2] = counts.data_ptr(), table.data_ptr()
    else:
        if steps is None:
            steps = card_steps(lay[:, :nb, :nb], block, causal, q.device)
        ptrs[2:] = (t.data_ptr() for t in steps)
    scale = softmax_scale if softmax_scale is not None else D ** -0.5
    out = torch.empty_like(q)
    fn = op_builder.load("sparse_attention")
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), *ptrs,
            B, S, H, D, block, max_active, int(bool(causal)),
            SPARSE_DTYPES[q.dtype], float(scale), _stream(q))
    if rc != 0:
        raise RuntimeError(f"block-sparse attention kernel launch failed: "
                           f"CUDA error {rc}")
    sparse_attention_cuda.launches += 1
    return out


sparse_attention_cuda.launches = 0
