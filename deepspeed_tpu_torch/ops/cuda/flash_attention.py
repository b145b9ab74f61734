"""Flash attention for training: the CUDA kernels' wrappers.

Replaces ``deepspeed_tpu/ops/pallas/flash_attention.py``: the forward
``_fwd_kernel`` and ``_fwd_kernel_biased`` (``ops/csrc/
flash_attention_fwd.cu``) and the backward's ``_bwd_dq_kernel``,
``_bwd_dkv_kernel`` and their biased variants (both in
``ops/csrc/flash_attention_bwd.cu``).  One C entry per kernel takes the
bias too; the unbiased and the biased (ALiBi slopes and/or a sliding
window) launches have wrappers and launch counts of their own, as the TPU
kernels are separate functions.  :func:`flash_attention_bwd_cuda` is the
port of the host side ``_flash_bwd_pallas``: it forms ``delta = sum(dO *
O)`` in fp32 by a kernel of its own (:func:`flash_attention_bwd_delta_cuda`)
and launches both backward kernels.  The dK/dV kernel returns dK and dV
as the function does -- k's dtype at the kv heads -- at a GQA group of 1,
and at every group where it sums the group on the card
(:func:`dkv_sums_group`: the bf16 / fp16 forms at head dim 256, whose
blocks of one key tile form a thread-block cluster over the group's query
heads); elsewhere it writes fp32 per query head at a group > 1, which
:func:`flash_attention_bwd_cuda` sums over the group and casts.  The
plain versions are in ``ops/flash_attention.py``, with the
``torch.autograd.Function`` that picks between them.  The kernels are
built for head dims 64, 80, 96, 128 and 256 (:data:`FLASH_HEAD_DIMS`,
each a template instantiation of the same bodies; the bf16 / fp16
forward at 64, 80, 96 and 256 and dQ and dK/dV at 64, 80 and 96 are
persistent bodies of their own, which run each tile's elementwise work
under the products of its neighbours; at 80 and 96 -- gpt_2_7b's and
gpt_760m's -- a tile is two 64-column boxes, whose columns past the head
dim TMA fills with zeros, and q, k, v and dO are read as they are: no
padded copy; 256 -- Gemma's -- takes 64-key K/V tiles); any other head
dim raises ``NotImplementedError`` naming ROADMAP A16, as
:func:`check_head_dim` does at the entry points' construction.
"""

import torch

from deepspeed_tpu_torch.ops import op_builder

# the C entries' dtype codes: fp32 on the CUDA cores, bf16 and fp16 on the
# tensor cores
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# the head dims the flash kernels are built for
FLASH_HEAD_DIMS = (64, 80, 96, 128, 256)


def dkv_sums_group(head_dim, dtype) -> bool:
    """Whether the dK/dV kernel sums a GQA group on the card, and so
    returns dK and dV in k's dtype at the kv heads at every group: its
    bf16 and fp16 forms at head dim 256.  Its fp32 forms and the other
    head dims write fp32 per query head at a group > 1 (k's dtype at a
    group of 1)."""
    return head_dim == 256 and dtype in (torch.bfloat16, torch.float16)


def check_head_dim(name, head_dim, head_dims=FLASH_HEAD_DIMS):
    """Raise ``NotImplementedError`` naming ROADMAP A16 unless a kernel
    takes ``head_dim``."""
    if head_dim not in head_dims:
        raise NotImplementedError(
            f"{name}: head_dim {head_dim} not in {tuple(head_dims)}: the "
            f"kernels at other head dims are not ported yet (ROADMAP A16); "
            f"the plain versions take it on the CPU")


def _check(name, q, k, v, *more):
    """Head dim, device, dtype, shape, contiguity and alignment of q [B, S,
    H, D], k/v [B, S, Hkv, D] and same-shape-as-q tensors ``more``."""
    ts = (q, k, v) + more
    if q.dim() != 4:
        raise ValueError(f"{name}: q must be [B, S, H, D], got "
                         f"{tuple(q.shape)}")
    check_head_dim(name, q.shape[3])
    if not all(t.is_cuda for t in ts):
        raise ValueError(f"{name} needs CUDA tensors; use the plain version "
                         f"for CPU tensors")
    if q.dtype not in _DTYPE_CODES or any(t.dtype != q.dtype for t in ts):
        raise ValueError(f"{name} takes float32, bfloat16 or float16 "
                         f"tensors of one dtype, got {[t.dtype for t in ts]}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape or \
            k.shape[:2] != q.shape[:2] or k.shape[3] != q.shape[3] or \
            q.shape[2] % k.shape[2] != 0 or \
            any(t.shape != q.shape for t in more):
        raise ValueError(f"{name}: shape mismatch "
                         f"{[tuple(t.shape) for t in ts]}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError(f"{name} needs contiguous tensors")
    if any(t.data_ptr() % 16 for t in ts):
        raise ValueError(f"{name} needs 16-byte aligned tensors (the kernels "
                         f"read them in 16-byte vectors)")
    if q.shape[0] * q.shape[2] > 65535:
        raise ValueError(f"{name}: batch * heads {q.shape[0] * q.shape[2]} "
                         f"exceeds the grid limit 65535")


def _check_rows(name, t, B, H, S):
    if t.dtype != torch.float32 or tuple(t.shape) != (B, H, S) or \
            not t.is_contiguous() or not t.is_cuda:
        raise ValueError(f"{name} must be a contiguous float32 CUDA tensor "
                         f"of shape {(B, H, S)}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def _bias_args(q, alibi_slopes, window, name):
    """(slopes pointer or 0, window int) for the C entries.  Slopes: a
    contiguous fp32 [H] tensor on q's card, one per QUERY head; window: an
    int, None or <= 0 for none.  A biased launch needs at least one."""
    if alibi_slopes is None and not (window and window > 0):
        raise ValueError(f"{name} needs ALiBi slopes or a window > 0; the "
                         f"unbiased wrapper serves neither")
    ptr = 0
    if alibi_slopes is not None:
        H = q.shape[2]
        if alibi_slopes.dtype != torch.float32 or \
                tuple(alibi_slopes.shape) != (H,) or \
                alibi_slopes.device != q.device or \
                not alibi_slopes.is_contiguous():
            raise ValueError(f"{name}: ALiBi slopes must be a contiguous "
                             f"float32 tensor of shape ({H},) on {q.device},"
                             f" got {alibi_slopes.dtype} "
                             f"{tuple(alibi_slopes.shape)} on "
                             f"{alibi_slopes.device}")
        ptr = alibi_slopes.data_ptr()
    w = int(window) if window and window > 0 else 0
    if w >= 2 ** 31 - 128:
        raise ValueError(f"{name}: window {w} does not fit the kernel's int")
    return ptr, w


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _fwd(q, k, v, softmax_scale, causal, slopes, window):
    B, S, H, D = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    fn = op_builder.load("flash_attention_fwd")
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), slopes, B, S, H, k.shape[2], D,
            int(bool(causal)), _DTYPE_CODES[q.dtype], window,
            float(softmax_scale), _stream(q))
    if rc != 0:
        raise RuntimeError(f"flash attention forward kernel launch failed: "
                           f"CUDA error {rc}")
    return out, lse


def flash_attention_fwd_cuda(q, k, v, softmax_scale, causal=True):
    """Launch the forward kernel.  q: [B, S, H, D]; k/v: [B, S, Hkv, D].
    Returns (O [B, S, H, D] in q's dtype, LSE fp32 [B, H, S])."""
    _check("flash_attention_fwd_cuda", q, k, v)
    out = _fwd(q, k, v, softmax_scale, causal, 0, 0)
    flash_attention_fwd_cuda.launches += 1
    return out


flash_attention_fwd_cuda.launches = 0


def flash_attention_fwd_biased_cuda(q, k, v, softmax_scale, causal=True,
                                    alibi_slopes=None, window=None):
    """Launch the biased forward kernel: ``alibi_slopes`` (fp32 [H] on the
    card) adds ``slope[h] * key`` to the scores, ``window`` masks keys
    ``window`` or more rows back and skips the key tiles it cannot reach.
    Returns (O, LSE) as :func:`flash_attention_fwd_cuda`."""
    name = "flash_attention_fwd_biased_cuda"
    _check(name, q, k, v)
    slopes, w = _bias_args(q, alibi_slopes, window, name)
    out = _fwd(q, k, v, softmax_scale, causal, slopes, w)
    flash_attention_fwd_biased_cuda.launches += 1
    return out


flash_attention_fwd_biased_cuda.launches = 0


def _dq(q, k, v, dout, lse, delta, softmax_scale, causal, slopes, window):
    B, S, H, D = q.shape
    _check_rows("lse", lse, B, H, S)
    _check_rows("delta", delta, B, H, S)
    dq = torch.empty_like(q)
    fn = op_builder.load("flash_attention_bwd_dq")
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), slopes, B, S, H,
            k.shape[2], D, int(bool(causal)), _DTYPE_CODES[q.dtype], window,
            float(softmax_scale), _stream(q))
    if rc != 0:
        raise RuntimeError(f"flash attention dQ kernel launch failed: CUDA "
                           f"error {rc}")
    return dq


def flash_attention_bwd_dq_cuda(q, k, v, dout, lse, delta, softmax_scale,
                                causal=True):
    """Launch the dQ kernel: dQ [B, S, H, D] in q's dtype.  lse/delta: fp32
    [B, H, S]."""
    _check("flash_attention_bwd_dq_cuda", q, k, v, dout)
    dq = _dq(q, k, v, dout, lse, delta, softmax_scale, causal, 0, 0)
    flash_attention_bwd_dq_cuda.launches += 1
    return dq


flash_attention_bwd_dq_cuda.launches = 0


def flash_attention_bwd_dq_biased_cuda(q, k, v, dout, lse, delta,
                                       softmax_scale, causal=True,
                                       alibi_slopes=None, window=None):
    """Launch the biased dQ kernel (bias as in
    :func:`flash_attention_fwd_biased_cuda`)."""
    name = "flash_attention_bwd_dq_biased_cuda"
    _check(name, q, k, v, dout)
    slopes, w = _bias_args(q, alibi_slopes, window, name)
    dq = _dq(q, k, v, dout, lse, delta, softmax_scale, causal, slopes, w)
    flash_attention_bwd_dq_biased_cuda.launches += 1
    return dq


flash_attention_bwd_dq_biased_cuda.launches = 0


def _dkv(q, k, v, dout, lse, delta, softmax_scale, causal, slopes, window):
    B, S, H, D = q.shape
    _check_rows("lse", lse, B, H, S)
    _check_rows("delta", delta, B, H, S)
    if k.shape[2] == H or dkv_sums_group(D, q.dtype):
        # the function's own outputs: k's dtype at the kv heads
        dk, dv = torch.empty_like(k), torch.empty_like(v)
    else:
        dk = torch.empty(q.shape, dtype=torch.float32, device=q.device)
        dv = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    fn = op_builder.load("flash_attention_bwd_dkv")
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            slopes, B, S, H, k.shape[2], D, int(bool(causal)),
            _DTYPE_CODES[q.dtype], window, float(softmax_scale), _stream(q))
    if rc != 0:
        raise RuntimeError(f"flash attention dK/dV kernel launch failed: "
                           f"CUDA error {rc}")
    return dk, dv


def flash_attention_bwd_dkv_cuda(q, k, v, dout, lse, delta, softmax_scale,
                                 causal=True):
    """Launch the dK/dV kernel: (dK, dV).  At group 1 (k at as many heads
    as q), and at every group where :func:`dkv_sums_group` holds (bf16 and
    fp16 at head dim 256), they are the function's outputs, in k's dtype
    at [B, S, Hkv, D]; otherwise, at a larger group, each is fp32 [B, S,
    H, D] -- one block of rows per QUERY head, not yet summed over the
    group (the caller sums and casts)."""
    _check("flash_attention_bwd_dkv_cuda", q, k, v, dout)
    out = _dkv(q, k, v, dout, lse, delta, softmax_scale, causal, 0, 0)
    flash_attention_bwd_dkv_cuda.launches += 1
    return out


flash_attention_bwd_dkv_cuda.launches = 0


def flash_attention_bwd_dkv_biased_cuda(q, k, v, dout, lse, delta,
                                        softmax_scale, causal=True,
                                        alibi_slopes=None, window=None):
    """Launch the biased dK/dV kernel (bias as in
    :func:`flash_attention_fwd_biased_cuda`); outputs as
    :func:`flash_attention_bwd_dkv_cuda`."""
    name = "flash_attention_bwd_dkv_biased_cuda"
    _check(name, q, k, v, dout)
    slopes, w = _bias_args(q, alibi_slopes, window, name)
    out = _dkv(q, k, v, dout, lse, delta, softmax_scale, causal, slopes, w)
    flash_attention_bwd_dkv_biased_cuda.launches += 1
    return out


flash_attention_bwd_dkv_biased_cuda.launches = 0


def flash_attention_bwd_delta_cuda(out, dout):
    """Launch the delta kernel: ``delta = sum_d dO * O`` in fp32 [B, H, S]
    from O and dO [B, S, H, D] in their own dtype -- the backward's row
    term, one pass.  Its plain version is ``flash_attention_bwd_delta_plain``
    in ``ops/flash_attention.py``."""
    name = "flash_attention_bwd_delta_cuda"
    _check(name, out, out, out, dout)
    B, S, H, D = out.shape
    delta = torch.empty((B, H, S), dtype=torch.float32, device=out.device)
    fn = op_builder.load("flash_attention_bwd_delta")
    rc = fn(out.data_ptr(), dout.data_ptr(), delta.data_ptr(), B, S, H, D,
            _DTYPE_CODES[out.dtype], _stream(out))
    if rc != 0:
        raise RuntimeError(f"flash attention delta kernel launch failed: "
                           f"CUDA error {rc}")
    flash_attention_bwd_delta_cuda.launches += 1
    return delta


flash_attention_bwd_delta_cuda.launches = 0


def is_biased(alibi_slopes, window) -> bool:
    """True when the call needs the biased kernels: ALiBi slopes, or a
    window > 0 (a window of 0 or None is unlimited)."""
    return alibi_slopes is not None or bool(window and window > 0)


def flash_attention_bwd_cuda(q, k, v, out, lse, dout, softmax_scale,
                             causal=True, alibi_slopes=None, window=None):
    """The backward from the saved (q, k, v, O, LSE) and the cotangent dO:
    (dq, dk, dv) in the dtypes of q, k, v, through the biased kernels when
    :func:`is_biased`.  The port of ``_flash_bwd_pallas``'s host side: the
    delta kernel, dQ, dK/dV, and at a GQA group > 1 the group sum and
    cast where the dK/dV kernel does not sum the group itself
    (:func:`dkv_sums_group`); at group 1, and at every group where it
    does, dK and dV are the kernel's own tensors, neither summed nor
    cast."""
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    # delta_i = sum_d dO_i * O_i, the softmax-jacobian row term (fp32)
    delta = flash_attention_bwd_delta_cuda(out, dout)
    if is_biased(alibi_slopes, window):
        dq = flash_attention_bwd_dq_biased_cuda(
            q, k, v, dout, lse, delta, softmax_scale, causal, alibi_slopes,
            window)
        dk, dv = flash_attention_bwd_dkv_biased_cuda(
            q, k, v, dout, lse, delta, softmax_scale, causal, alibi_slopes,
            window)
    else:
        dq = flash_attention_bwd_dq_cuda(q, k, v, dout, lse, delta,
                                         softmax_scale, causal)
        dk, dv = flash_attention_bwd_dkv_cuda(q, k, v, dout, lse, delta,
                                              softmax_scale, causal)
    group = H // Hkv
    if group > 1 and not dkv_sums_group(D, q.dtype):        # GQA group sum
        dk = dk.view(B, S, Hkv, group, D).sum(3).to(k.dtype)
        dv = dv.view(B, S, Hkv, group, D).sum(3).to(v.dtype)
    return dq, dk, dv
