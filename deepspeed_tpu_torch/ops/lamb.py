"""Fused LAMB over a flat buffer: the op surface.

Counterpart of ``deepspeed_tpu/ops/lamb.py`` (``fused_lamb``, the
reference's ``csrc/lamb/fused_lamb_cuda.cu``): one LAMB step over a flat
buffer whose tensors are marked by ``segment_ids``, with the trust ratio
per segment CLIPPED to [``min_coeff``, ``max_coeff``].  A plain PyTorch
function, as the JAX one is plain XLA.  It is not the engine's LAMB
(``runtime/optimizers.Lamb``, optax's rule: an unclipped ratio per param
leaf); the two ratios differ on purpose.
"""

from typing import NamedTuple

import torch


class LambState(NamedTuple):
    m: torch.Tensor
    v: torch.Tensor
    step: torch.Tensor     # int32 scalar


def init_state(params_flat):
    return LambState(m=torch.zeros_like(params_flat, dtype=torch.float32),
                     v=torch.zeros_like(params_flat, dtype=torch.float32),
                     step=torch.zeros((), dtype=torch.int32,
                                      device=params_flat.device))


def reference_impl(params, grads, state: LambState, segment_ids=None,
                   num_segments=1, lr=1e-3, beta1=0.9, beta2=0.999, eps=1e-6,
                   weight_decay=0.0, max_coeff=10.0, min_coeff=0.01):
    """One LAMB step; returns (new params in params' dtype, new state).
    ``segment_ids``: int tensor like ``params`` (all one segment if
    None)."""
    g = grads.float()
    p = params.float()
    step = state.step + 1
    m = beta1 * state.m + (1.0 - beta1) * g
    v = beta2 * state.v + (1.0 - beta2) * g * g
    sf = step.float()
    m_hat = m / (1.0 - torch.pow(torch.tensor(beta1), sf))
    v_hat = v / (1.0 - torch.pow(torch.tensor(beta2), sf))
    update = m_hat / (torch.sqrt(v_hat) + eps) + weight_decay * p
    if segment_ids is None:
        segment_ids = torch.zeros_like(p, dtype=torch.int64)
        num_segments = 1
    seg = segment_ids.long()
    w_norm = torch.sqrt(torch.zeros(num_segments, device=p.device)
                        .index_add_(0, seg, p * p))
    u_norm = torch.sqrt(torch.zeros(num_segments, device=p.device)
                        .index_add_(0, seg, update * update))
    ratio = torch.where((w_norm > 0) & (u_norm > 0),
                        torch.clamp(w_norm / u_norm, min_coeff, max_coeff),
                        torch.ones_like(w_norm))
    new_p = p - lr * ratio[seg] * update
    return new_p.to(params.dtype), LambState(m=m, v=v, step=step)


fused_lamb = reference_impl
