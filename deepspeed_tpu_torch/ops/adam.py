"""Fused Adam over flat buffers.

Counterpart of ``deepspeed_tpu/ops/adam.py``.  The update is written once
over a flat 1-D fp32 buffer (the engine keeps its master parameters,
gradients and moments each in one such buffer).  :func:`fused_adam` runs
it as ONE launch of the hand-written CUDA kernel (``ops/csrc/
fused_adam.cu``, wrapper in ``ops/cuda/fused_adam.py``) for CUDA tensors
and as :func:`reference_impl`, the plain PyTorch version, for CPU tensors.

Unlike the functional JAX version, both paths update ``params`` and the
moments IN PLACE (the kernel's contract, and no second 4-byte-per-param
copy of anything); they return ``(params, state)`` for the same calling
shape.  The per-step scalars live on the params' device, as the TPU kernel
reads them through scalar prefetch: :func:`adam_hyper` computes ``(lr,
beta1, 1 - beta1, c1, c2)`` there from ``AdamState.count``, the number of
APPLIED steps (an int32 scalar tensor), with lr and beta1 either numbers
or 0-dim fp32 tensors from a schedule.  A ``skip`` flag (an int32 scalar,
fp16's overflow) leaves params, m, v and the count as they are, so a
skipped step neither moves the weights nor advances the bias correction
and the schedules -- optax's count inside the JAX engine's
``where(overflow, old, new)``.  Nothing here reads a device value back to
the host.
"""

from typing import NamedTuple

import torch

from deepspeed_tpu_torch.ops.cuda.fused_adam import fused_adam_cuda
from deepspeed_tpu_torch.ops.decode_attention import resolve_backend

# elements per piece of the plain version: its temporaries stay a few
# hundred MB however large the buffer
_CHUNK = 1 << 25


class AdamState(NamedTuple):
    m: torch.Tensor       # fp32, like params
    v: torch.Tensor       # fp32, like params
    count: torch.Tensor   # int32 scalar on params' device: applied steps


def init_state(params_flat: torch.Tensor) -> AdamState:
    return AdamState(m=torch.zeros_like(params_flat, dtype=torch.float32),
                     v=torch.zeros_like(params_flat, dtype=torch.float32),
                     count=torch.zeros((), dtype=torch.int32,
                                       device=params_flat.device))


def _f32(x, device):
    """A 0-dim fp32 tensor on ``device``: ``x`` itself when it is one, else
    filled on the device (no host-to-device copy, so no wait)."""
    if torch.is_tensor(x):
        return x.to(torch.float32)
    return torch.full((), x, dtype=torch.float32, device=device)


def adam_hyper(count, lr, beta1, beta2, bias_correction=True):
    """The kernel's scalar buffer, fp32 [5] on ``count``'s device: (lr,
    beta1, 1 - beta1, c1, c2) for the step after ``count`` applied steps,
    c = 1 - beta**(count + 1) in fp32 as optax's ``bias_correction`` (1.0
    when off).  ``lr``/``beta1``: numbers, or 0-dim fp32 tensors on that
    device (schedules evaluated at ``count``).  A number beta1 gives
    1 - beta1 rounded once from double, as the JAX code's Python float; a
    scheduled one is subtracted in fp32, as optax's
    ``inject_hyperparams`` does."""
    dev = count.device
    t = count.to(torch.float32) + 1.0
    if bias_correction:
        c1 = 1.0 - torch.pow(beta1, t)
        c2 = 1.0 - torch.pow(beta2, t)
    else:
        c1 = c2 = 1.0
    omb1 = 1.0 - beta1
    return torch.stack([_f32(x, dev) for x in (lr, beta1, omb1, c1, c2)])


def reference_impl(params, grads, state: AdamState, hyper, skip=None,
                   beta2=0.999, eps=1e-8, weight_decay=0.0, adamw_mode=True):
    """One Adam/AdamW step on flat buffers, plain PyTorch: the update of
    ``multi_tensor_adam.cu`` (ADAM_MODE 0/1) with the scalars of ``hyper``
    (:func:`adam_hyper`).  ``params`` (fp32) and the moments are updated in
    place, piece by piece, unless ``skip`` (an int32 scalar tensor) is
    nonzero; the count advances by 1 - skip.  Returns (params, state).
    Each op is a separate rounding, in the order the CUDA kernel rounds
    them; the scalars are 0-dim tensors, so the divisions divide (a
    Python-scalar divisor may be turned into a multiply by its
    reciprocal)."""
    reference_impl.calls += 1
    lr, b1, omb1, c1, c2 = hyper.unbind()
    keep = None if skip is None else skip.bool()
    for lo in range(0, params.numel(), _CHUNK):
        sl = slice(lo, lo + _CHUNK)
        p, m, v = params[sl], state.m[sl], state.v[sl]
        g = grads[sl].float()
        if not adamw_mode and weight_decay:   # L2-regularised Adam (mode 1)
            g = g + p * weight_decay
        m_new = m * b1 + g * omb1
        v_new = v * beta2 + (g * g) * (1.0 - beta2)
        update = (m_new / c1) / (torch.sqrt(v_new / c2) + eps)
        if adamw_mode and weight_decay:       # decoupled decay (mode 0)
            update = update + p * weight_decay
        p_new = p - update * lr
        for old, new in ((p, p_new), (m, m_new), (v, v_new)):
            old.copy_(new if keep is None else torch.where(keep, old, new))
    _advance(state.count, skip)
    return params, state


reference_impl.calls = 0


def _advance(count, skip):
    if skip is None:
        count.add_(1)
    else:
        count.sub_(skip).add_(1)


def fused_adam(params, grads, state: AdamState, hyper, skip=None,
               beta2=0.999, eps=1e-8, weight_decay=0.0, adamw_mode=True,
               backend="auto"):
    """Dispatching entry: the CUDA kernel for CUDA tensors (``"auto"`` or
    ``"cuda"``; the latter raises on CPU tensors), the plain version for
    CPU tensors or ``backend="plain"``.  ``hyper``: :func:`adam_hyper`;
    ``skip``: None or an int32 scalar tensor.  In place; returns (params,
    state)."""
    kw = dict(beta2=beta2, eps=eps, weight_decay=weight_decay,
              adamw_mode=adamw_mode)
    if resolve_backend(backend, params) == "plain":
        return reference_impl(params, grads, state, hyper, skip, **kw)
    if skip is None:
        skip = torch.zeros((), dtype=torch.int32, device=params.device)
    fused_adam_cuda(params, grads, state.m, state.v, hyper, skip, **kw)
    _advance(state.count, skip)
    return params, state
