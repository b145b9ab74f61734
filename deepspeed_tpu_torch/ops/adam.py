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

The moments are fp32, or bf16 (``moment_dtype``: the JAX package's
``_scale_by_adam_dtyped``): then each step widens m and v to fp32, takes
the update from the fp32 m and v, and stores them back by stochastic
rounding (:func:`sr_round`, the JAX ``_sr_cast``) with 16 bits of a
counter hash of (step, moment, element index) -- the port's own bits, the
same in the kernel and here, not JAX's threefry ones.
"""

from typing import NamedTuple

import torch

from deepspeed_tpu_torch.ops.cuda.fused_adam import fused_adam_cuda
from deepspeed_tpu_torch.ops.decode_attention import resolve_backend
from deepspeed_tpu_torch.utils.hashing import MASK32, mix32

# elements per piece of the plain version: its temporaries stay a few
# hundred MB however large the buffer
_CHUNK = 1 << 25


# the stochastic rounding's base seed (the kernel's kSrSeed): fixed, as
# the JAX step folds its count into the fixed key(0)
SR_SEED = 0x5EED


class AdamState(NamedTuple):
    m: torch.Tensor       # fp32 or bf16, like params
    v: torch.Tensor       # the same dtype as m
    count: torch.Tensor   # int32 scalar on params' device: applied steps


def init_state(params_flat: torch.Tensor,
               moment_dtype=torch.float32) -> AdamState:
    return AdamState(m=torch.zeros_like(params_flat, dtype=moment_dtype),
                     v=torch.zeros_like(params_flat, dtype=moment_dtype),
                     count=torch.zeros((), dtype=torch.int32,
                                       device=params_flat.device))


def sr_round(x32, step, moment, start=0):
    """``x32`` (contiguous fp32) rounded to bf16 stochastically: 16 random
    bits added to each fp32 bit pattern, whose low half is then cut off --
    unbiased in expectation, the JAX ``_sr_cast``.  The bits of element i
    are the kernel's ``sr_bits``: a hash of (``step``, ``moment``, ``start``
    + i), with ``step`` an integer tensor (the applied count plus one) and
    ``moment`` 0 for m, 1 for v.  int64 arithmetic masked to 32 bits, so
    the CUDA kernel's uint32 arithmetic gives the same bits."""
    key = mix32(mix32((step.long() & MASK32) ^ SR_SEED) ^ moment)
    idx = torch.arange(start, start + x32.numel(), dtype=torch.int64,
                       device=x32.device)
    bits = mix32((idx & MASK32) ^ mix32((idx >> 32) ^ key)) >> 16
    b = (((x32.view(torch.int32).long() & MASK32) + bits.view(x32.shape))
         & 0xFFFF0000) >> 16
    return torch.where(b >= 0x8000, b - 0x10000, b).to(
        torch.int16).view(torch.bfloat16)


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
    (:func:`adam_hyper`).  ``params`` (fp32) and the moments (fp32, or
    bf16: widened, then stored by :func:`sr_round`) are updated in
    place, piece by piece, unless ``skip`` (an int32 scalar tensor) is
    nonzero; the count advances by 1 - skip.  Returns (params, state).
    Each op is a separate rounding, in the order the CUDA kernel rounds
    them; the scalars are 0-dim tensors, so the divisions divide (a
    Python-scalar divisor may be turned into a multiply by its
    reciprocal)."""
    reference_impl.calls += 1
    lr, b1, omb1, c1, c2 = hyper.unbind()
    keep = None if skip is None else skip.bool()
    sr = state.m.dtype == torch.bfloat16
    step = state.count.long() + 1
    for lo in range(0, params.numel(), _CHUNK):
        sl = slice(lo, lo + _CHUNK)
        p, m, v = params[sl], state.m[sl], state.v[sl]
        g = grads[sl].float()
        if not adamw_mode and weight_decay:   # L2-regularised Adam (mode 1)
            g = g + p * weight_decay
        m_new = m.float() * b1 + g * omb1
        v_new = v.float() * beta2 + (g * g) * (1.0 - beta2)
        update = (m_new / c1) / (torch.sqrt(v_new / c2) + eps)
        if adamw_mode and weight_decay:       # decoupled decay (mode 0)
            update = update + p * weight_decay
        p_new = p - update * lr
        if sr:
            m_new = sr_round(m_new, step, 0, lo)
            v_new = sr_round(v_new, step, 1, lo)
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
    fused_adam_cuda(params, grads, state.m, state.v, hyper, skip,
                    state.count, **kw)
    _advance(state.count, skip)
    return params, state
