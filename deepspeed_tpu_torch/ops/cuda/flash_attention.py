"""Flash attention for training: the CUDA kernels' wrappers.

Replaces ``deepspeed_tpu/ops/pallas/flash_attention.py``: the forward
``_fwd_kernel`` (``ops/csrc/flash_attention_fwd.cu``) and the backward's
``_bwd_dq_kernel`` and ``_bwd_dkv_kernel`` (both in
``ops/csrc/flash_attention_bwd.cu``).  :func:`flash_attention_bwd_cuda` is
the port of the host side ``_flash_bwd_pallas``: it computes
``delta = sum(dO * O)`` in fp32, launches both backward kernels and sums the
per-query-head fp32 dK/dV over the GQA group.  The plain versions are in
``ops/flash_attention.py``, with the ``torch.autograd.Function`` that picks
between them.
"""

import torch

from deepspeed_tpu_torch.ops import op_builder
from deepspeed_tpu_torch.ops.cuda.decode_attention import (HEAD_DIMS,
                                                           _DTYPE_CODES)


def _check(name, q, k, v, *more):
    """Device, dtype, shape, contiguity and alignment of q [B, S, H, D],
    k/v [B, S, Hkv, D] and same-shape-as-q tensors ``more``."""
    ts = (q, k, v) + more
    if not all(t.is_cuda for t in ts):
        raise ValueError(f"{name} needs CUDA tensors; use the plain version "
                         f"for CPU tensors")
    if q.dtype not in _DTYPE_CODES or any(t.dtype != q.dtype for t in ts):
        raise ValueError(f"{name} takes float32 or bfloat16 tensors of one "
                         f"dtype, got {[t.dtype for t in ts]}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape or \
            k.shape[:2] != q.shape[:2] or k.shape[3] != q.shape[3] or \
            q.shape[2] % k.shape[2] != 0 or \
            any(t.shape != q.shape for t in more):
        raise ValueError(f"{name}: shape mismatch "
                         f"{[tuple(t.shape) for t in ts]}")
    if q.shape[3] not in HEAD_DIMS:
        raise ValueError(f"head_dim {q.shape[3]} not in {HEAD_DIMS}")
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


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def flash_attention_fwd_cuda(q, k, v, softmax_scale, causal=True):
    """Launch the forward kernel.  q: [B, S, H, D]; k/v: [B, S, Hkv, D].
    Returns (O [B, S, H, D] in q's dtype, LSE fp32 [B, H, S])."""
    _check("flash_attention_fwd_cuda", q, k, v)
    B, S, H, D = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    fn = op_builder.load("flash_attention_fwd")
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), B, S, H, k.shape[2], D, int(bool(causal)),
            _DTYPE_CODES[q.dtype], float(softmax_scale), _stream(q))
    if rc != 0:
        raise RuntimeError(f"flash attention forward kernel launch failed: "
                           f"CUDA error {rc}")
    flash_attention_fwd_cuda.launches += 1
    return out, lse


flash_attention_fwd_cuda.launches = 0


def flash_attention_bwd_dq_cuda(q, k, v, dout, lse, delta, softmax_scale,
                                causal=True):
    """Launch the dQ kernel: dQ [B, S, H, D] in q's dtype.  lse/delta: fp32
    [B, H, S]."""
    _check("flash_attention_bwd_dq_cuda", q, k, v, dout)
    B, S, H, D = q.shape
    _check_rows("lse", lse, B, H, S)
    _check_rows("delta", delta, B, H, S)
    dq = torch.empty_like(q)
    fn = op_builder.load("flash_attention_bwd_dq")
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), B, S, H,
            k.shape[2], D, int(bool(causal)), _DTYPE_CODES[q.dtype],
            float(softmax_scale), _stream(q))
    if rc != 0:
        raise RuntimeError(f"flash attention dQ kernel launch failed: CUDA "
                           f"error {rc}")
    flash_attention_bwd_dq_cuda.launches += 1
    return dq


flash_attention_bwd_dq_cuda.launches = 0


def flash_attention_bwd_dkv_cuda(q, k, v, dout, lse, delta, softmax_scale,
                                 causal=True):
    """Launch the dK/dV kernel: (dK, dV), each fp32 [B, S, H, D] -- one
    block of rows per QUERY head, not yet summed over the GQA group."""
    _check("flash_attention_bwd_dkv_cuda", q, k, v, dout)
    B, S, H, D = q.shape
    _check_rows("lse", lse, B, H, S)
    _check_rows("delta", delta, B, H, S)
    dk = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    dv = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    fn = op_builder.load("flash_attention_bwd_dkv")
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            B, S, H, k.shape[2], D, int(bool(causal)),
            _DTYPE_CODES[q.dtype], float(softmax_scale), _stream(q))
    if rc != 0:
        raise RuntimeError(f"flash attention dK/dV kernel launch failed: "
                           f"CUDA error {rc}")
    flash_attention_bwd_dkv_cuda.launches += 1
    return dk, dv


flash_attention_bwd_dkv_cuda.launches = 0


def flash_attention_bwd_cuda(q, k, v, out, lse, dout, softmax_scale,
                             causal=True):
    """The backward from the saved (q, k, v, O, LSE) and the cotangent dO:
    (dq, dk, dv) in the dtypes of q, k, v.  The port of
    ``_flash_bwd_pallas``'s host side."""
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    # delta_i = sum_d dO_i * O_i, the softmax-jacobian row term (fp32)
    delta = (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    dq = flash_attention_bwd_dq_cuda(q, k, v, dout, lse, delta,
                                     softmax_scale, causal)
    dk, dv = flash_attention_bwd_dkv_cuda(q, k, v, dout, lse, delta,
                                          softmax_scale, causal)
    group = H // Hkv
    dk = dk.view(B, S, Hkv, group, D).sum(3).to(k.dtype)   # GQA group sum
    dv = dv.view(B, S, Hkv, group, D).sum(3).to(v.dtype)
    return dq, dk, dv
