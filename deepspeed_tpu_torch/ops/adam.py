"""Fused Adam over flat buffers.

Counterpart of ``deepspeed_tpu/ops/adam.py``.  The update is written once
over a flat 1-D fp32 buffer (the engine keeps its master parameters,
gradients and moments each in one such buffer).  :func:`fused_adam` runs
it as ONE launch of the hand-written CUDA kernel (``ops/csrc/
fused_adam.cu``, wrapper in ``ops/cuda/fused_adam.py``) for CUDA tensors
and as :func:`reference_impl`, the plain PyTorch version, for CPU tensors.

Unlike the functional JAX version, both paths update ``params`` and the
moments IN PLACE (the kernel's contract, and no second 4-byte-per-param
copy of anything); they return ``(params, new_state)`` for the same
calling shape.  ``AdamState.step`` is a host int, so computing the bias
corrections never waits for the device.
"""

from typing import NamedTuple

import numpy as np
import torch

from deepspeed_tpu_torch.ops.cuda.fused_adam import fused_adam_cuda
from deepspeed_tpu_torch.ops.decode_attention import resolve_backend


class AdamState(NamedTuple):
    m: torch.Tensor     # fp32, like params
    v: torch.Tensor     # fp32, like params
    step: int           # steps taken


def init_state(params_flat: torch.Tensor) -> AdamState:
    return AdamState(m=torch.zeros_like(params_flat, dtype=torch.float32),
                     v=torch.zeros_like(params_flat, dtype=torch.float32),
                     step=0)


def bias_corrections(step, beta1, beta2, bias_correction=True):
    """(c1, c2) = (1 - beta1**step, 1 - beta2**step) in fp32, as the JAX
    code computes them from a float32 step (1.0 each when off)."""
    if not bias_correction:
        return 1.0, 1.0
    sf = np.float32(step)
    one = np.float32(1.0)
    return (float(one - np.power(np.float32(beta1), sf)),
            float(one - np.power(np.float32(beta2), sf)))


def reference_impl(params, grads, state: AdamState, lr=1e-3, beta1=0.9,
                   beta2=0.999, eps=1e-8, weight_decay=0.0, adamw_mode=True,
                   bias_correction=True):
    """One Adam/AdamW step on flat buffers, plain PyTorch: the update of
    ``multi_tensor_adam.cu`` (ADAM_MODE 0/1).  ``params`` (fp32) and the
    moments are updated in place; returns (params, state).  Each op is a
    separate rounding, in the order the CUDA kernel rounds them; the
    divisors are 0-dim tensors, so they divide (a Python-scalar divisor
    may be turned into a multiply by its reciprocal)."""
    reference_impl.calls += 1
    step = state.step + 1
    c1, c2 = (torch.tensor(c, dtype=torch.float32, device=params.device)
              for c in bias_corrections(step, beta1, beta2, bias_correction))
    g = grads.float()
    p = params
    if not adamw_mode and weight_decay:   # L2-regularised Adam (mode 1)
        g = g + p * weight_decay
    m, v = state.m, state.v
    m.mul_(beta1).add_(g * (1.0 - beta1))
    v.mul_(beta2).add_((g * g) * (1.0 - beta2))
    update = (m / c1) / (torch.sqrt(v / c2) + eps)
    if adamw_mode and weight_decay:       # decoupled decay (mode 0)
        update = update + p * weight_decay
    p.sub_(update * lr)
    return params, AdamState(m=m, v=v, step=step)


reference_impl.calls = 0


def fused_adam(params, grads, state: AdamState, lr=1e-3, beta1=0.9,
               beta2=0.999, eps=1e-8, weight_decay=0.0, adamw_mode=True,
               bias_correction=True, backend="auto"):
    """Dispatching entry: the CUDA kernel for CUDA tensors (``"auto"`` or
    ``"cuda"``; the latter raises on CPU tensors), the plain version for
    CPU tensors or ``backend="plain"``.  In place; returns (params,
    state)."""
    kw = dict(lr=lr, beta1=beta1, beta2=beta2, eps=eps,
              weight_decay=weight_decay, adamw_mode=adamw_mode,
              bias_correction=bias_correction)
    if resolve_backend(backend, params) == "plain":
        return reference_impl(params, grads, state, **kw)
    step = state.step + 1
    c1, c2 = bias_corrections(step, beta1, beta2, bias_correction)
    fused_adam_cuda(params, grads, state.m, state.v, lr=lr, beta1=beta1,
                    beta2=beta2, eps=eps, weight_decay=weight_decay,
                    adamw_mode=adamw_mode, c1=c1, c2=c2)
    return params, AdamState(m=state.m, v=state.v, step=step)

