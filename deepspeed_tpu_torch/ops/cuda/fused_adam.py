"""Fused Adam: the CUDA kernel's wrapper.

Replaces ``deepspeed_tpu/ops/pallas/fused_adam.py`` (``_adam_kernel`` /
``fused_adam_pallas``); the kernel source is ``ops/csrc/fused_adam.cu``.
The plain PyTorch version is ``ops/adam.py:reference_impl``, where the
dispatch (:func:`deepspeed_tpu_torch.ops.adam.fused_adam`) lives.
"""

import torch

from deepspeed_tpu_torch.ops import op_builder

# the C entry's dtype codes of g and of the moments
_CODES = {torch.float32: 0, torch.bfloat16: 1}
N_HYPER = 5     # lr, beta1, 1 - beta1, c1, c2


def fused_adam_cuda(params, grads, m, v, hyper, skip, count, beta2, eps,
                    weight_decay, adamw_mode):
    """One Adam step, IN PLACE on ``params`` (fp32), ``m`` and ``v``
    (both fp32, or both bf16: stored by stochastic rounding), contiguous
    CUDA tensors of one size; ``grads``: same size, fp32 or bf16.
    ``hyper``: fp32 [5] on the card, (lr, beta1, 1 - beta1, c1, c2) with
    c1/c2 the bias corrections 1 - beta**count (1.0 when off); ``skip``:
    an int32 scalar on the card, nonzero to leave params, m and v as they
    are (fp16's overflow); ``count``: the int32 count of applied steps on
    the card (it seeds bf16 moments' rounding bits; the caller advances
    it).  None of them is read on the host."""
    for name, t in (("params", params), ("grads", grads), ("m", m),
                    ("v", v)):
        if not t.is_cuda:
            raise ValueError(f"fused_adam_cuda needs CUDA tensors ({name} is "
                             f"on {t.device}); use the plain version for CPU "
                             f"tensors")
        if not t.is_contiguous():
            raise ValueError(f"fused_adam_cuda needs contiguous buffers "
                             f"({name} is not)")
        if t.numel() != params.numel() or t.device != params.device:
            raise ValueError(f"fused_adam_cuda: {name} has {t.numel()} "
                             f"elements on {t.device}, params "
                             f"{params.numel()} on {params.device}")
    if params.dtype != torch.float32:
        raise ValueError(f"fused_adam_cuda: params must be float32, got "
                         f"{params.dtype}")
    if m.dtype not in _CODES or v.dtype != m.dtype:
        raise ValueError(f"fused_adam_cuda: m and v must both be float32 or "
                         f"both bfloat16, got {m.dtype} and {v.dtype}")
    if grads.dtype not in _CODES:
        raise ValueError(f"fused_adam_cuda: grads must be float32 or "
                         f"bfloat16, got {grads.dtype}")
    for name, t, dtype, numel in (("hyper", hyper, torch.float32, N_HYPER),
                                  ("skip", skip, torch.int32, 1),
                                  ("count", count, torch.int32, 1)):
        if t.dtype != dtype or t.numel() != numel or \
                t.device != params.device or not t.is_contiguous():
            raise ValueError(f"fused_adam_cuda: {name} must be a contiguous "
                             f"{dtype} tensor of {numel} element(s) on "
                             f"{params.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    n = params.numel()
    if n == 0:
        return params
    fn = op_builder.load("fused_adam")
    rc = fn(params.data_ptr(), grads.data_ptr(), m.data_ptr(), v.data_ptr(),
            n, _CODES[grads.dtype], _CODES[m.dtype], int(bool(adamw_mode)),
            hyper.data_ptr(), skip.data_ptr(), count.data_ptr(),
            float(beta2), float(1.0 - beta2), float(eps),
            float(weight_decay),
            torch.cuda.current_stream(params.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused Adam kernel launch failed: CUDA error {rc}")
    fused_adam_cuda.launches += 1
    return params


fused_adam_cuda.launches = 0
